"""Device meshes for the z-first engine: the stand-ins for the JAX
package's ``jax.sharding.Mesh`` with axes ``("x", "y")`` and for
``lax.ppermute`` inside its ``shard_map``.

A mesh of ``mx * my`` shards splits the two horizontal axes of every
z-first field ``(K, 6, A, B)`` into blocks ``(K, 6, A/mx, B/my)``; shard
``(ix, iy)`` has the rank ``ix * my + iy`` (the JAX package's ``_lin``).
The per-shard code of a step is the same code for both transports:

- ``ShardMesh(mx, my, device= | devices=)`` holds every shard in one process
  (the counterpart of JAX's single-controller ``shard_map`` over
  ``jax.devices()``).  ``run`` drives the per-shard code of all shards in
  lockstep, one Python thread a shard with exactly one running at a time
  (shard 0, 1, ... up to the next exchange, then the exchange, then again),
  so the order of every launch is fixed and a CUDA graph can capture the
  whole sharded step.  A ``ppermute`` round is a set of tensor copies; a
  shard that receives nothing gets zeros, as under ``lax.ppermute``.
- ``DistMesh(mx, my, group=None)`` is one shard per rank of a
  ``torch.distributed`` group: a round is one ``dist.batch_isend_irecv`` of
  that round's point-to-point ops (NCCL on CUDA tensors, gloo on CPU
  tensors); nothing is staged through the host here.

Inside ``run`` the per-shard code reaches its mesh through ``current()``,
as JAX code reaches the axes of its ``shard_map``.  Both transports keep a
``Tally`` of every exchange op: its kind and the bytes of its per-shard
payload (what the JAX package's HLO tally counts,
``parallel/analyze.py``), and the bytes actually moved between shards.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from .._device import resolve_device

PERMUTE = "collective-permute"

_ctx = threading.local()


def current():
    """``(mesh, rank)`` of the shard whose code this thread runs (inside
    ``mesh.run``); raises elsewhere."""
    got = getattr(_ctx, "shard", None)
    if got is None:
        raise RuntimeError("no mesh: call this inside mesh.run(...)")
    return got


class _Shard:
    """The context ``run`` sets while one shard's code runs."""

    def __init__(self, mesh, rank):
        self.mesh, self.rank = mesh, rank

    def __enter__(self):
        self.saved = getattr(_ctx, "shard", None)
        _ctx.shard = (self.mesh, self.rank)

    def __exit__(self, *exc):
        _ctx.shard = self.saved


def ppermute(x, axis, perm):
    """Start ``lax.ppermute(x, axis, perm)`` from the calling shard and
    return its handle: ``.wait()`` gives the tensor this shard receives
    (zeros where no pair sends to it).  ``axis``: ``"x"``, ``"y"`` or
    ``("x", "y")``; ``perm``: ``(source, destination)`` index pairs along
    that axis (linear ranks for both axes)."""
    mesh, rank = current()
    return mesh._permute(rank, x.contiguous(), mesh.global_pairs(axis, perm))


@dataclasses.dataclass
class Tally:
    """Exchange ops since the last ``reset``: per kind, their number and the
    bytes of their per-shard payloads (each op once, as in one shard's
    program), and ``moved``: the bytes that crossed between shards (all
    shards of a ``ShardMesh``; the ones this rank sent on a ``DistMesh``)."""
    counts: dict = dataclasses.field(default_factory=dict)
    bytes_: dict = dataclasses.field(default_factory=dict)
    moved: int = 0
    largest: list = dataclasses.field(default_factory=list)  # (bytes, kind,
    #                                                        #  shape), top 10

    def reset(self):
        self.counts, self.bytes_, self.moved, self.largest = {}, {}, 0, []

    def add(self, kind, nbytes, moved, shape=()):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes_[kind] = self.bytes_.get(kind, 0) + int(nbytes)
        self.moved += int(moved)
        self.largest = sorted(self.largest + [(int(nbytes), kind,
                                               tuple(shape))],
                              reverse=True)[:10]


class _Done:
    """The handle of an exchange that has completed."""

    def __init__(self, value):
        self.value = value

    def wait(self):
        return self.value


class _MeshBase:
    def __init__(self, mx: int, my: int):
        mx, my = int(mx), int(my)
        if mx < 1 or my < 1:
            raise ValueError(f"mesh shape ({mx}, {my})")
        self.shape = {"x": mx, "y": my}
        self.size = mx * my
        self.tally = Tally()

    def coords(self, rank: int):
        return divmod(rank, self.shape["y"])

    def rank_of(self, ix: int, iy: int) -> int:
        return ix * self.shape["y"] + iy

    def global_pairs(self, axis, perm):
        """``{source rank: destination rank}`` of a ``ppermute``."""
        mx, my = self.shape["x"], self.shape["y"]
        out = {}
        if axis == "x":
            for iy in range(my):
                for i, j in perm:
                    out[self.rank_of(i, iy)] = self.rank_of(j, iy)
        elif axis == "y":
            for ix in range(mx):
                for i, j in perm:
                    out[self.rank_of(ix, i)] = self.rank_of(ix, j)
        elif tuple(axis) == ("x", "y"):
            out = {int(i): int(j) for i, j in perm}
        else:
            raise ValueError(f"unknown mesh axis {axis!r}")
        if len(set(out.values())) != len(out):
            raise ValueError("a ppermute round repeats a destination")
        return out

    def block(self, rank: int, A: int, B: int):
        """``(slice along a, slice along b)`` of shard ``rank`` in a field
        of horizontal extents ``(A, B)``."""
        mx, my = self.shape["x"], self.shape["y"]
        if A % mx or B % my:
            raise ValueError(f"extents ({A}, {B}) do not split over the "
                             f"mesh ({mx}, {my})")
        a, b = A // mx, B // my
        ix, iy = self.coords(rank)
        return slice(ix * a, (ix + 1) * a), slice(iy * b, (iy + 1) * b)

    def _cut(self, v, rank, A, B, device):
        sa, sb = self.block(rank, A, B)
        return v[..., sa, sb].to(device).contiguous()


def _horizontal_extents(d):
    v = next(iter(d.values()))
    return v.shape[-2], v.shape[-1]


class ShardMesh(_MeshBase):
    """Every shard in this process: shard ``r`` is a dict of contiguous
    ``(K, 6, a, b)`` blocks on ``devices[r]`` (``device=`` puts them all on
    one device, default ``cuda``; raises when absent).  A sharded state is
    the list of the shards' dicts, in rank order."""

    def __init__(self, mx: int, my: int, device=None, devices=None):
        super().__init__(mx, my)
        if devices is not None:
            if device is not None:
                raise ValueError("pass device= or devices=, not both")
            devices = [resolve_device(d) for d in devices]
            if len(devices) != self.size:
                raise ValueError(f"{len(devices)} devices for a mesh of "
                                 f"{self.size} shards")
        else:
            devices = [resolve_device(device)] * self.size
        self.devices = devices
        # a CUDA graph can hold the sharded step when every shard is on one
        # device (copies between cards are not captured here)
        self.graphs = len(set(devices)) == 1
        self._lock = None
        self._workers = None     # one thread a shard, made at the first run

    # -- layout -------------------------------------------------------------
    def shard(self, d):
        """A global z-first dict as the list of the shards' dicts (fresh
        contiguous blocks on each shard's device)."""
        A, B = _horizontal_extents(d)
        return [{k: self._cut(v, r, A, B, self.devices[r])
                 for k, v in d.items()} for r in range(self.size)]

    def gather(self, s):
        """The list of the shards' dicts back as one global dict on the
        first shard's device."""
        mx, my = self.shape["x"], self.shape["y"]
        dev = self.devices[0]
        out = {}
        for k in s[0]:
            rows = [torch.cat([s[self.rank_of(ix, iy)][k].to(dev)
                               for iy in range(my)], dim=-1)
                    for ix in range(mx)]
            out[k] = torch.cat(rows, dim=-2)
        return out

    # -- SPMD driver ---------------------------------------------------------
    def run(self, fn, *sharded):
        """``[fn(r, *(arg[r] for arg in sharded)) for r in ranks]``, the
        shards' code in lockstep (see the module's docstring).  Each shard's
        thread runs on its device and on the caller's current stream there,
        so that a CUDA graph being captured by the caller takes every
        shard's launches."""
        n = self.size
        if n == 1:
            with _Shard(self, 0):
                return [fn(0, *(arg[0] for arg in sharded))]
        streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                   for d in self.devices]
        if self._workers is None:
            self._workers = [_Worker() for _ in range(n)]
        lock = _Lockstep(n)
        self._lock = lock
        try:
            for r, w in enumerate(self._workers):
                w.idle.clear()
                w.jobs.put((lock.body, (self, r, fn,
                                        tuple(arg[r] for arg in sharded),
                                        self.devices[r], streams[r])))
            lock.finish()
        finally:
            for w in self._workers:
                w.idle.wait()
            self._lock = None
        return lock.results

    def close(self):
        """Stop the shards' threads (they are made again by the next
        ``run``)."""
        workers, self._workers = self._workers, None
        for w in workers or ():
            w.idle.clear()
            w.jobs.put(None)
        for w in workers or ():
            w.idle.wait()

    def _permute(self, rank, x, pairs):
        if self._lock is None:          # one shard: the pairs are local
            return _Done(self._exchange([x], pairs)[0])
        return _Done(self._lock.collective(
            rank, x, lambda xs: self._exchange(xs, pairs)))

    def _exchange(self, xs, pairs):
        """Every shard's payload ``xs[r]`` in; what each receives out."""
        recv = [None] * self.size
        moved = 0
        for src, dst in pairs.items():
            recv[dst] = xs[src].to(self.devices[dst], copy=True)
            if src != dst:
                moved += xs[src].numel() * xs[src].element_size()
        for r in range(self.size):
            if recv[r] is None:
                recv[r] = torch.zeros_like(xs[r])
        self.tally.add(PERMUTE, xs[0].numel() * xs[0].element_size(), moved,
                       xs[0].shape)
        return recv


class _Worker:
    """A shard's thread, kept for the mesh's life: it runs the jobs put in
    its queue one after the other (a thread made anew for every call would
    set up the library's per-thread state each time)."""

    def __init__(self):
        import queue
        self.jobs = queue.Queue()
        self.idle = threading.Event()
        self.idle.set()
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            job = self.jobs.get()
            if job is None:                 # close()
                self.idle.set()
                return
            fn, args = job
            try:
                fn(*args)
            finally:
                self.idle.set()


class _Aborted(Exception):
    """Another shard failed: this one stops at its next exchange."""


class _Lockstep:
    """One shard's thread runs at a time, in rank order between exchanges
    (a baton: ``turn``).  At an exchange each shard posts its payload and
    hands on; the last one runs the exchange for all and hands back to
    shard 0."""

    def __init__(self, n):
        self.n = n
        self.cv = threading.Condition()
        self.turn = 0
        self.error = None
        self.posted = [None] * n
        self.seq = [0] * n
        self.out = None
        self.results = [None] * n

    def _wait(self, r):
        with self.cv:
            self.cv.wait_for(lambda: self.turn == r or self.error is not None)
            if self.error is not None:
                raise _Aborted()

    def _hand(self, r):
        with self.cv:
            self.turn = r
            self.cv.notify_all()

    def _fail(self, err):
        with self.cv:
            if self.error is None:
                self.error = err
            self.cv.notify_all()

    def body(self, mesh, r, fn, args, device, stream):
        try:
            self._wait(r)
            with _Shard(mesh, r), _on(device, stream):
                self.results[r] = fn(r, *args)
            if any(s != self.seq[r] for s in self.seq[r + 1:]):
                raise RuntimeError("the shards ran different numbers of "
                                   "exchanges")
            self._hand(r + 1)
        except _Aborted:
            pass
        except BaseException as err:
            # raised again in the caller's thread (``finish``); the other
            # shards stop at their next exchange
            self._fail(err)
            if not isinstance(err, Exception):
                raise

    def collective(self, r, x, op):
        self.posted[r] = x
        self.seq[r] += 1
        if r < self.n - 1:
            self._hand(r + 1)
        else:
            if len(set(self.seq)) != 1:
                raise RuntimeError("the shards ran different numbers of "
                                   "exchanges")
            self.out = op(self.posted)
            self.posted = [None] * self.n
            self._hand(0)
        self._wait(r)
        got = self.out[r]
        if r == self.n - 1:
            self.out = None
        return got

    def finish(self):
        with self.cv:
            self.cv.wait_for(lambda: self.turn == self.n
                             or self.error is not None)
        if self.error is not None:
            raise self.error


class _on:
    """The device and (for CUDA) the stream of one shard's thread."""

    def __init__(self, device, stream):
        self.device, self.stream = device, stream

    def __enter__(self):
        self.ctx = []
        if self.device.type == "cuda":
            self.ctx = [torch.cuda.device(self.device),
                        torch.cuda.stream(self.stream)]
        for c in self.ctx:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.ctx):
            c.__exit__(*exc)


class _Pending:
    """The handle of a ``DistMesh`` exchange in flight."""

    def __init__(self, recv, works):
        self.recv, self.works = recv, works

    def wait(self):
        for w in self.works:
            w.wait()
        self.works = []
        return self.recv


class DistMesh(_MeshBase):
    """One shard per rank of a ``torch.distributed`` group of ``mx * my``
    ranks (the default group when ``group`` is None), the rank order the
    JAX package's (``ix * my + iy``).  A sharded state is this rank's dict
    of blocks.  Exchanges run NCCL on CUDA tensors and gloo on CPU tensors,
    as the group's backend says; ``wait`` on a handle waits for its
    point-to-point ops."""

    def __init__(self, mx: int, my: int, group=None):
        import torch.distributed as dist
        super().__init__(mx, my)
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs an initialized process group "
                               "(torch.distributed.init_process_group)")
        self.group = group
        world = dist.get_world_size(group)
        if world != self.size:
            raise ValueError(f"a {mx} x {my} mesh needs {self.size} ranks, "
                             f"the group has {world}")
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group)).lower()
        if self.backend == "nccl":
            self._check_gpus()
        self.graphs = False
        self._ops = 0
        # the first point-to-point op of a NCCL group wants every rank:
        # one barrier here makes the communicator
        dist.barrier(group=group)

    def _check_gpus(self):
        gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if gpus < self.size:
            raise RuntimeError(f"NCCL puts one rank on each GPU: {self.size} "
                               f"ranks, {gpus} GPUs")

    def _peer(self, r):
        import torch.distributed as dist
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                  r)

    def shard(self, d):
        """This rank's blocks of a global z-first dict (on the dict's
        device; every rank holds the same global dict)."""
        A, B = _horizontal_extents(d)
        return {k: self._cut(v, self.rank, A, B, v.device)
                for k, v in d.items()}

    def gather(self, s):
        """Every rank's blocks back as one global dict, on every rank."""
        import torch.distributed as dist
        mx, my = self.shape["x"], self.shape["y"]
        out = {}
        for k, v in s.items():
            parts = [torch.empty_like(v) for _ in range(self.size)]
            dist.all_gather(parts, v.contiguous(), group=self.group)
            rows = [torch.cat([parts[self.rank_of(ix, iy)]
                               for iy in range(my)], dim=-1)
                    for ix in range(mx)]
            out[k] = torch.cat(rows, dim=-2)
        return out

    def run(self, fn, *local):
        """``fn(rank, *local)`` for this rank's shard."""
        with _Shard(self, self.rank):
            return fn(self.rank, *local)

    def _permute(self, rank, x, pairs):
        import torch.distributed as dist
        if x.is_cuda:
            self._check_gpus()
        self._ops += 1
        tag = self._ops
        ops = []
        dst = pairs.get(rank)
        src = next((s for s, d in pairs.items() if d == rank), None)
        recv = torch.zeros_like(x)
        moved = 0
        if dst is not None and dst != rank:
            ops.append(dist.P2POp(dist.isend, x, self._peer(dst),
                                  group=self.group, tag=tag))
            moved = x.numel() * x.element_size()
        if src is not None and src != rank:
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(src),
                                  group=self.group, tag=tag))
        elif src == rank:
            recv = x.clone()
        self.tally.add(PERMUTE, x.numel() * x.element_size(), moved, x.shape)
        works = dist.batch_isend_irecv(ops) if ops else []
        return _Pending(recv, works)
