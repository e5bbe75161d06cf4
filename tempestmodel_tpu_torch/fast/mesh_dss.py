"""Mesh-distributed DSS for the z-first engine.

Counterpart of the JAX package's ``fast/mesh_dss.py``, the analog of the
reference's per-patch-pair exchange buffers (``Connectivity.h:67``,
``Connectivity.cpp:47-749``): every message between two shards is computed
STATICALLY from the cube edge table (``grid/geometry.edge_meta``) and the
mesh shape, grouped per ordered shard pair, and scheduled into ``ppermute``
rounds by a greedy edge colouring of the shard-pair graph (each round a
partial permutation).  Each shard receives exactly the line segments its
own panel-edge nodes need.

Layout: z-first local blocks ``(K, 6, a, b)`` per field, ``a = A/mx`` and
``b = A/my``.  All fields ride in one payload, stacked along the level axis
(U | V | Rt | Rho | W [| Tracers]); here the exchange also works on that
stack, one ``(ktot, 6, a, b)`` tensor, so each pair sum, exchange and edge
add is one operation for every field.

The host side (``build_edge_routing``, ``expected_exchange_bytes``,
``routing_stats``) gives the JAX package's messages and rounds one for one.
The exchange (``make_state_dss_mesh``) runs inside ``mesh.run`` of a
``parallel.mesh`` transport and is plain tensor code (the JAX package's is
XLA): pair sums, the cross-shard element pairs (one line each way along each
split axis), the routed panel-edge segments with the covariant U/V rotation
of ``TransformHaloVelocities`` (``GridPatchCSGLL.cpp:1783``), then the
1/mult normalization.  Contributions are added to an edge in the JAX
package's order (by link, then by position), so the overlap schedule equals
the inline one bit for bit and every transport gives the same bits.

One deliberate difference from the JAX package: every element pair along a
(inside the block, then across the x split) is summed before any pair along
b, the order of the single-device DSS.  The JAX package sums both axes'
pairs inside the block first, so where a shard boundary meets an element
boundary of the other axis its four-node sums round differently from its
single-device DSS (1e-16 relative in float64).  Here the sharded DSS gives
the single-device DSS's bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..grid.geometry import EDGE_LEFT, EDGE_RIGHT, EDGE_BOTTOM, EDGE_TOP
from ..parallel import mesh as pmesh

FIELDS = ("U", "V", "Rt", "Rho", "W")


# ---------------------------------------------------------------------------
# static routing (host side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Msg:
    """One statically-routed segment of one panel-edge link."""
    link: int            # index into edge_meta
    src: tuple           # (ix, iy) source shard
    dst: tuple           # (ix, iy) destination shard
    src_lo: int          # offsets within the source shard's line chunk
    src_hi: int
    dst_lo: int          # offsets within the destination shard's chunk
    dst_hi: int
    g0: int              # GLOBAL dest-line positions (rotation slicing)
    g1: int
    flip: bool


def _edge_chunks(e: int, mx: int, my: int, A: int):
    """(n_chunks, chunk_len) of an edge line over the mesh."""
    if e in (EDGE_LEFT, EDGE_RIGHT):
        return my, A // my
    return mx, A // mx


def _edge_dev(e: int, j: int, mx: int, my: int):
    """Shard coords owning chunk j of a panel edge line."""
    if e == EDGE_LEFT:
        return (0, j)
    if e == EDGE_RIGHT:
        return (mx - 1, j)
    if e == EDGE_BOTTOM:
        return (j, 0)
    return (j, my - 1)


def build_edge_routing(edge_meta, mx: int, my: int, A: int):
    """Static message list + ppermute round schedule.

    Returns (local_msgs, rounds) where ``rounds`` is a list of rounds,
    each a list of ``((src, dst), [Msg, ...])`` with distinct sources and
    distinct destinations (a partial permutation — one ppermute each).
    """
    msgs = []
    for li, (pa, e, qa, qe, flip) in enumerate(edge_meta):
        nd, cld = _edge_chunks(e, mx, my, A)
        ns, cls_ = _edge_chunks(qe, mx, my, A)
        for j in range(nd):
            t0, t1 = j * cld, (j + 1) * cld
            s0, s1 = (A - t1, A - t0) if flip else (t0, t1)
            for i in range(ns):
                c0, c1 = i * cls_, (i + 1) * cls_
                lo, hi = max(s0, c0), min(s1, c1)
                if lo >= hi:
                    continue
                g0, g1 = (A - hi, A - lo) if flip else (lo, hi)
                msgs.append(Msg(
                    link=li, src=_edge_dev(qe, i, mx, my),
                    dst=_edge_dev(e, j, mx, my),
                    src_lo=lo - c0, src_hi=hi - c0,
                    dst_lo=g0 - t0, dst_hi=g1 - t0, g0=g0, g1=g1,
                    flip=bool(flip)))

    local = [m for m in msgs if m.src == m.dst]
    pairs = {}
    for m in msgs:
        if m.src != m.dst:
            pairs.setdefault((m.src, m.dst), []).append(m)
    # deterministic per-pair message order (payload packing order)
    for v in pairs.values():
        v.sort(key=lambda m: (m.link, m.g0))

    # greedy edge colouring: each round is a partial permutation
    rounds = []
    for key in sorted(pairs):
        for r in rounds:
            if all(k[0] != key[0] and k[1] != key[1] for k, _ in r):
                r.append((key, pairs[key]))
                break
        else:
            rounds.append([(key, pairs[key])])
    return local, rounds


def expected_exchange_bytes(edge_meta, mx: int, my: int, A: int,
                            ktot: int, itemsize: int) -> int:
    """EXACT per-shard payload bytes of the exchange ops of ONE inline- or
    overlap-schedule DSS call (what ``parallel.analyze.collective_report``
    tallies): 2 cross-pair line ppermutes per split axis plus one (ktot,
    L_round) ppermute per routed edge round."""
    _, rounds = build_edge_routing(edge_meta, mx, my, A)
    a, b = A // mx, A // my
    total = 0
    if mx > 1:
        total += 2 * ktot * 6 * b * itemsize
    if my > 1:
        total += 2 * ktot * 6 * a * itemsize
    for rnd in rounds:
        L = max(sum(m.src_hi - m.src_lo for m in ms) for _, ms in rnd)
        total += ktot * L * itemsize
    return total


def routing_stats(edge_meta, mx: int, my: int, A: int):
    """(n_rounds, n_messages, line_units_moved).

    ``line_units_moved`` counts exchanged line elements (x K levels x
    dtype bytes gives exchange bytes); a mesh-wide sum of the 24 lines
    would move 24*A units per shard per call whatever the mesh size.
    """
    local, rounds = build_edge_routing(edge_meta, mx, my, A)
    n_msgs = sum(len(ms) for r in rounds for _, ms in r)
    units = sum(m.src_hi - m.src_lo for r in rounds for _, ms in r
                for m in ms)
    return len(rounds), n_msgs, units


# ---------------------------------------------------------------------------
# per-shard building blocks on (K, 6, a, b) blocks; each returns a fresh
# tensor and never writes into its argument
# ---------------------------------------------------------------------------

def _pair_sum_a_(f, p: int):
    """The element-boundary pair sums along a (axis 2) of a (K, 6, a, b)
    block, IN PLACE on a tensor the caller made."""
    if f.shape[2] > p:
        s = f[:, :, p - 1:-1:p] + f[:, :, p::p]
        f[:, :, p - 1:-1:p] = s
        f[:, :, p::p] = s
    return f


def _pair_sum_b_(f, p: int):
    """The same along b (the last axis), in place."""
    if f.shape[-1] > p:
        s = f[..., p - 1:-1:p] + f[..., p::p]
        f[..., p - 1:-1:p] = s
        f[..., p::p] = s
    return f


def local_pair_sum(f, p: int):
    """Element-boundary pair sums interior to the local block (z-first):
    along a, then along b."""
    return _pair_sum_b_(_pair_sum_a_(f.clone(), p), p)


def _extract_edge(s, pa: int, e: int):
    """Local chunk of a panel edge line, (K, clen) (a view)."""
    if e == EDGE_LEFT:
        return s[:, pa, 0, :]
    if e == EDGE_RIGHT:
        return s[:, pa, -1, :]
    if e == EDGE_BOTTOM:
        return s[:, pa, :, 0]
    return s[:, pa, :, -1]


def _add_edge(s, pa: int, e: int, line):
    """``line`` added to a panel edge chunk of ``s`` IN PLACE (the caller
    passes a tensor it has made)."""
    _extract_edge(s, pa, e).add_(line)
    return s


def _pair_sum_line(ln, p: int):
    """1-D element pair sums along axis 2 of a (K, 6, L) line tensor.
    The slice expressions of ``local_pair_sum``, so that line-level and
    block-level results agree BITWISE."""
    L = ln.shape[2]
    ln = ln.clone()
    if L > p:
        s = ln[:, :, p - 1:-1:p] + ln[:, :, p::p]
        ln[:, :, p - 1:-1:p] = s
        ln[:, :, p::p] = s
    return ln


@dataclasses.dataclass
class _Plan:
    """What one shard sends and receives in each DSS call (static)."""
    sends: list       # per round: [(qa, qe, lo, hi), ...] or None
    recv_lens: list   # per round: the payload length this shard reads, or 0
    L: list           # per round: the buffer width
    perms: list       # per round: [(src rank, dst rank), ...]
    links: list       # [(pa, e, offset, length)] to this shard, link order
    gather: np.ndarray   # contributions' columns in the source stack
    rot: np.ndarray      # (4, n) rotation rows of those columns


def make_state_dss_mesh(edge_meta, e_rot, mx: int, my: int, A: int,
                        p: int, nz: int, overlap: bool = False):
    """Build ``dss_state(d, inv_mult_local) -> d`` for the per-shard code
    inside ``mesh.run`` of a ``parallel.mesh`` transport of shape
    ``(mx, my)``.

    ``e_rot``: host numpy (4, n_links, A) destination-edge covariant
    rotation rows [m00, m01, m10, m11] (``FastGeometry.e_rot``).

    ``overlap``: the halo-overlap schedule — every exchange is posted from
    line-only arithmetic before the interior pair sums of the block, and
    the routed edge rounds are waited for after them (on a ``DistMesh`` the
    point-to-point ops are in flight meanwhile; the reference's
    Isend-early / Wait-late, ``Grid.cpp:627-665``).  The results equal the
    inline schedule's bit for bit.  The output fields are views along the
    level axis of one contiguous stack."""
    e_rot = np.asarray(e_rot, np.float64)
    edge_meta = [tuple(int(x) for x in m) for m in edge_meta]
    local_msgs, rounds = build_edge_routing(edge_meta, mx, my, A)
    a, b = A // mx, A // my
    clen = {EDGE_LEFT: b, EDGE_RIGHT: b, EDGE_BOTTOM: a, EDGE_TOP: a}
    plans, dev_plans = {}, {}

    def lin(dev):
        return dev[0] * my + dev[1]

    def plan(rank):
        if rank in plans:
            return plans[rank]
        me = divmod(rank, my)
        sends, recv_lens, Ls, perms, recv_msgs = [], [], [], [], []
        for rnd in rounds:
            Ls.append(max(sum(m.src_hi - m.src_lo for m in ms)
                          for _, ms in rnd))
            perms.append([(lin(k[0]), lin(k[1])) for k, _ in rnd])
            send = [ms for k, ms in rnd if k[0] == me]
            sends.append(None if not send else [
                (edge_meta[m.link][2], edge_meta[m.link][3], m.src_lo,
                 m.src_hi) for m in send[0]])
            got = [ms for k, ms in rnd if k[1] == me]
            recv_msgs.append(got[0] if got else [])
            recv_lens.append(sum(m.src_hi - m.src_lo for m in recv_msgs[-1]))
        # the source stack: the received payloads (rounds this shard reads),
        # then the four boundary lines (6 panels each, flattened)
        col, base = {}, 0
        contribs = []
        for ri, ms in enumerate(recv_msgs):
            off = 0
            for m in ms:
                ln = m.src_hi - m.src_lo
                contribs.append((m, base + off))
                off += ln
            base += recv_lens[ri]
        for e in (EDGE_LEFT, EDGE_RIGHT, EDGE_BOTTOM, EDGE_TOP):
            col[e] = base
            base += 6 * clen[e]
        for m in local_msgs:
            if m.dst != me:
                continue
            qa, qe = edge_meta[m.link][2], edge_meta[m.link][3]
            contribs.append((m, col[qe] + qa * clen[qe] + m.src_lo))
        contribs.sort(key=lambda t: (t[0].link, t[0].g0))
        gather, rot, links = [], [], []
        for m, start in contribs:
            ln = m.src_hi - m.src_lo
            cols = np.arange(start, start + ln)
            gather.append(cols[::-1] if m.flip else cols)
            rot.append(e_rot[:, m.link, m.g0:m.g1])
            pa, e = edge_meta[m.link][0], edge_meta[m.link][1]
            if links and links[-1][:2] == (pa, e):
                links[-1] = (pa, e, links[-1][2], links[-1][3] + ln)
            else:
                off = links[-1][2] + links[-1][3] if links else 0
                links.append((pa, e, off, ln))
        for pa, e, _, ln in links:
            if ln != clen[e]:
                raise AssertionError("an edge chunk is not covered once")
        plans[rank] = _Plan(
            sends=sends, recv_lens=recv_lens, L=Ls, perms=perms, links=links,
            gather=(np.concatenate(gather) if gather
                    else np.zeros(0, np.int64)),
            rot=np.concatenate(rot, axis=1) if rot else np.zeros((4, 0)))
        return plans[rank]

    def device_plan(rank, ref):
        """The gather index and rotation rows on ``ref``'s device and in
        its dtype (made at the first call, outside any graph capture: a
        captured step runs one warm-up step first)."""
        key = (rank, ref.device, ref.dtype)
        if key not in dev_plans:
            pl = plan(rank)
            dev_plans[key] = (
                torch.as_tensor(pl.gather, dtype=torch.long,
                                device=ref.device),
                torch.as_tensor(np.ascontiguousarray(pl.rot),
                                dtype=ref.dtype, device=ref.device))
        return dev_plans[key]

    def layout(d):
        """U | V | Rt | Rho | W [| Tracers]: extra scalar fields (the flat
        species-major tracer block) ride after W and are not rotated."""
        flds = list(FIELDS) + [k for k in d if k not in FIELDS]
        offs, o = {}, 0
        for f in flds:
            offs[f] = (o, o + d[f].shape[0])
            o += d[f].shape[0]
        return flds, offs

    def cross(first, last, axis, n):
        """The width-1 line exchange of one split axis: (the new first line,
        the new last line)."""
        hr = pmesh.ppermute(first, axis, [(i, i - 1) for i in range(1, n)])
        hl = pmesh.ppermute(last, axis, [(i, i + 1) for i in range(n - 1)])
        recv_r, recv_l = hr.wait(), hl.wait()
        return recv_l + first, last + recv_r

    def post_edges(rank, lines):
        """Start every routed round from the boundary lines ``lines`` (four
        (ktot, 6, clen) tensors, left, right, bottom, top)."""
        pl = plan(rank)
        ref = lines[0]
        by_edge = dict(zip((EDGE_LEFT, EDGE_RIGHT, EDGE_BOTTOM, EDGE_TOP),
                           lines))
        handles = []
        for send, L, perm in zip(pl.sends, pl.L, pl.perms):
            if send is None:
                buf = ref.new_zeros((ref.shape[0], L))
            else:
                parts = [by_edge[qe][:, qa, lo:hi] for qa, qe, lo, hi in send]
                buf = torch.cat(parts, dim=1)
                if buf.shape[1] < L:
                    buf = torch.cat([buf, buf.new_zeros(
                        (buf.shape[0], L - buf.shape[1]))], dim=1)
            handles.append(pmesh.ppermute(buf, ("x", "y"), perm))
        return handles

    def apply_edges(rank, X, lines, handles):
        """Wait for the rounds and add every contribution to this shard's
        edges, rotated into the destination's covariant basis, by link."""
        pl = plan(rank)
        recvs = [h.wait() for h in handles]
        parts = [r[:, :n] for r, n in zip(recvs, pl.recv_lens) if n]
        parts += [ln.reshape(ln.shape[0], -1) for ln in lines]
        if not pl.links:
            return X
        idx, rot = device_plan(rank, X)
        seg = torch.cat(parts, dim=1).index_select(1, idx)
        su, sv = seg[0:nz], seg[nz:2 * nz]
        ru = rot[0][None] * su + rot[1][None] * sv
        rv = rot[2][None] * su + rot[3][None] * sv
        val = torch.cat([ru, rv, seg[2 * nz:]], dim=0)
        for pa, e, off, ln in pl.links:
            _add_edge(X, pa, e, val[:, off:off + ln])
        return X

    def finish(X, inv_mult, flds, offs):
        Y = X * inv_mult[None]
        return {f: Y[offs[f][0]:offs[f][1]] for f in flds}

    def dss_state_inline(d, inv_mult):
        _, rank = pmesh.current()
        flds, offs = layout(d)
        # every pair along a (inside the block, then across the x split)
        # before any along b, as on one device
        X = _pair_sum_a_(torch.cat([d[f] for f in flds], dim=0), p)
        if mx > 1:
            nf, nl = cross(X[:, :, 0, :], X[:, :, -1, :], "x", mx)
            X[:, :, -1, :] = nl
            X[:, :, 0, :] = nf
        X = _pair_sum_b_(X, p)
        if my > 1:
            nf, nl = cross(X[..., 0], X[..., -1], "y", my)
            X[..., -1] = nl
            X[..., 0] = nf
        lines = [X[:, :, 0, :].clone(), X[:, :, -1, :].clone(),
                 X[..., 0].clone(), X[..., -1].clone()]
        handles = post_edges(rank, lines)
        X = apply_edges(rank, X, lines, handles)
        return finish(X, inv_mult, flds, offs)

    def dss_state_overlap(d, inv_mult):
        """The inline schedule's arithmetic, reordered so that every
        exchange depends only on O(surface) line arithmetic: the boundary
        lines' pair sums and the cross-shard exchanges, then the routed
        rounds are posted, and only then the interior block pair sum runs
        before the rounds are waited for."""
        _, rank = pmesh.current()
        flds, offs = layout(d)
        X0 = torch.cat([d[f] for f in flds], dim=0)
        # column boundary lines (a = 0 / a = -1): summed across the x split,
        # then pair-summed along b
        ncf, ncl = X0[:, :, 0, :], X0[:, :, -1, :]
        if mx > 1:
            ncf, ncl = cross(ncf.contiguous(), ncl.contiguous(), "x", mx)
        ncf = _pair_sum_line(ncf, p)
        ncl = _pair_sum_line(ncl, p)
        # row boundary lines, pair-summed along a, corners patched with the
        # cross-x results (the inline schedule's cross-y operands carry the
        # cross-x contributions at shard corners)
        nrf = _pair_sum_line(X0[..., 0], p)
        nrl = _pair_sum_line(X0[..., -1], p)
        nrf[:, :, 0] = ncf[:, :, 0]
        nrf[:, :, -1] = ncl[:, :, 0]
        nrl[:, :, 0] = ncf[:, :, -1]
        nrl[:, :, -1] = ncl[:, :, -1]
        if my > 1:
            nrf, nrl = cross(nrf, nrl, "y", my)
        # panel-edge lines from line-level results only (the row lines
        # carry final corner values; the column lines get them patched)
        left = ncf.clone()
        left[:, :, 0] = nrf[:, :, 0]
        left[:, :, -1] = nrl[:, :, 0]
        right = ncl.clone()
        right[:, :, 0] = nrf[:, :, -1]
        right[:, :, -1] = nrl[:, :, -1]
        lines = [left, right, nrf, nrl]
        handles = post_edges(rank, lines)
        # interior block arithmetic — independent of every exchange above
        X = local_pair_sum(X0, p)
        X[:, :, 0, :] = ncf
        X[:, :, -1, :] = ncl
        X[..., 0] = nrf
        X[..., -1] = nrl
        X = apply_edges(rank, X, lines, handles)
        return finish(X, inv_mult, flds, offs)

    return dss_state_overlap if overlap else dss_state_inline
