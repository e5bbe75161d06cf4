"""The two Laplacian passes of the nu4 hyperdiffusion tail, one kernel each:
the CUDA kernels' wrappers and their plain versions.

Counterpart of the JAX package's ``fast/hyper_pallas.py`` (``nu4_pass1``,
``nu4_pass2``).  The Strang tail is two horizontal Laplacian passes with a
DSS between them and one after: pass 1 produces the unscaled Laplacian
"work" fields of the five state fields, pass 2 applies the scaled second
Laplacian to the DSSed work fields and adds the result onto the state.  The
DSS calls stay outside (``engine.apply_dss``).

Restriction, as in the JAX package: order-4 hyperviscosity with a 3-D
Jacobian that is constant in z and the same on levels and interfaces (true
for the Gal-Chen vertical of ``grid/geometry.py``: jac3d = (ztop - zs) *
jac2d on every level), so that the Laplacian's 1/J needs (6, A, B) metric
reads only.  ``supported()`` says whether a configuration is inside;
others take the plain tensor code of ``engine.step_after_subcycle``.

The kernels (``csrc/hyper.cu``) are not shaped like the TPU ones; see the
note there for their design and their bound on the card.  A block owns a
band of whole element rows of one panel and walks a run of levels, staging
each level's spans in a ring of shared-memory stages; the launch shape
(``hyper_launch_shape``) and the copy width (``copy_width``) are chosen
here and checked by the C side.  ``nu4_pass1`` and ``nu4_pass2`` launch the
kernels for CUDA tensors — or raise — and run the plain versions only for
tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import re
from typing import Any, NamedTuple

import numpy as np
import torch

from .._device import np_dtype
from ..kernels import build, stencils
from ..kernels.counts import launch_counts

FIELDS = ("U", "V", "Rt", "Rho", "W")
MAX_P = 8        # nodes per element edge the kernels' tiles are sized for


def supported(fg, cfg) -> bool:
    """Whether the two kernels cover this configuration.  A statement about
    the configuration only.  Order-4 hyperviscosity; the level and the
    interface Jacobian each constant in z AND equal to each other (the
    kernels use ``jac3d[0]`` for W's Laplacian where the plain tail uses
    ``jac3d_int``); whole elements of at most ``MAX_P`` nodes an edge.  Any
    grid the engine takes: the passes read neither the x-z switch, nor the
    layout, nor the wrap (the DSS between them does).  (The TPU kernels'
    further conditions on ``A`` and ``p`` are about their tiles and are not
    carried over.)"""
    jac, jac_i = fg.jac3d, fg.jac3d_int
    # equal up to the rounding of the geometry's dtype (1e-12 in float64)
    rtol = max(1e-12, 2.0 * torch.finfo(jac.dtype).eps)
    return (cfg.hypervis_order == 4 and fg.vo >= 1 and fg.p <= MAX_P
            and fg.A % fg.p == 0 and fg.B % fg.p == 0
            and bool((jac == jac[0:1]).all())
            and bool((jac_i == jac_i[0:1]).all())
            and bool(torch.allclose(jac[0], jac_i[0], rtol=rtol, atol=0.0)))


@dataclasses.dataclass
class HyperStatics:
    """What the two passes need beside the fields, built once per
    configuration (``hyper_statics``)."""
    m2d: Any      # (8, P, A, B): c2aa, c2ab, c2ba, c2bb, j2, 1/j2, jl, 1/jl
    #             # with j2 = jac2d and jl = jac3d[0]
    ds: Any       # 1-D tensor: D[s, i] / delta, then S[i, s] / delta, along
    #             # a, then along b (``stencils.element_matrices``)
    p: int
    ds_host: Any  # the values of ``ds`` on the host (float64 numpy): the
    #             # kernels take them by value


def hyper_statics(fg) -> HyperStatics:
    """The metric stack and the element matrices on the device and in the
    dtype of ``fg``."""
    dtype, dev = fg.inv_mult.dtype, fg.inv_mult.device
    j2 = fg.jac2d
    jl = fg.jac3d[0]
    m2d = torch.stack([fg.c2_aa, fg.c2_ab, fg.c2_ba, fg.c2_bb,
                       j2, 1.0 / j2, jl, 1.0 / jl]).contiguous()
    host = np.concatenate(
        [m.ravel() for m in stencils.element_matrices(fg)]).astype(
            np_dtype(dtype))
    ds = torch.as_tensor(host, device=dev)
    return HyperStatics(m2d=m2d, ds=ds, p=fg.p,
                        ds_host=host.astype(np.float64))


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic: element-local p-point sums, the
# z-constant metric, the multiply by 1/J)
# ---------------------------------------------------------------------------

def _mats(st: HyperStatics):
    """((Dd, Wd) along a, (Dd, Wd) along b): ``Dd[s, i] = D[s, i] / delta``
    for the strong derivative, ``Wd[s, i] = S[i, s] / delta`` for the weak
    one."""
    p = st.p
    m = st.ds.reshape(4, p, p)
    return (m[0], m[1].T), (m[2], m[3].T)


def _da(x, M):
    """Element-local sum along a: ``out_i = sum_s M[s, i] * x_s``."""
    K, P, A, B = x.shape
    p = M.shape[0]
    return torch.matmul(M.T, x.reshape(K, P, A // p, p, B)).reshape(x.shape)


def _db(x, M):
    """The same along b."""
    K, P, A, B = x.shape
    p = M.shape[0]
    return torch.matmul(x.reshape(K, P, A, B // p, p), M).reshape(x.shape)


def _scalar_lap(f, m, mats):
    c2aa, c2ab, c2ba, c2bb, _, _, jl, jlinv = m
    (Dd, Wd), (Ddb, Wdb) = mats
    da = _da(f, Dd)
    db = _db(f, Ddb)
    ga = jl * (c2aa * da + c2ab * db)
    gb = jl * (c2ba * da + c2bb * db)
    return -(_da(ga, Wd) + _db(gb, Wdb)) * jlinv


def _vector_upd(u, v, nu_div, nu_vort, m, mats):
    c2aa, c2ab, c2ba, c2bb, j2, j2inv, _, _ = m
    (Dd, Wd), (Ddb, Wdb) = mats
    con_u = c2aa * u + c2ab * v
    con_v = c2ba * u + c2bb * v
    div = (_da(j2 * con_u, Dd) + _db(j2 * con_v, Ddb)) * j2inv
    curl = (_da(v, Dd) - _db(u, Ddb)) * j2inv
    wda_div = -_da(div, Wd)
    wdb_div = -_db(div, Wdb)
    wda_curl = -_da(curl, Wd)
    wdb_curl = -_db(curl, Wdb)
    du = nu_div * wda_div - nu_vort * j2 * (
        c2ba * wda_curl + c2bb * wdb_curl)
    dv = nu_div * wdb_div + nu_vort * j2 * (
        c2aa * wda_curl + c2ab * wdb_curl)
    return du, dv


def nu4_pass1_plain(d, fg, statics: HyperStatics = None):
    """Plain PyTorch version of ``nu4_pass1``."""
    st = hyper_statics(fg) if statics is None else statics
    mats = _mats(st)
    m = [st.m2d[i][None] for i in range(8)]
    wu, wv = _vector_upd(d["U"], d["V"], 1.0, 1.0, m, mats)
    out = {"U": -wu, "V": -wv}
    for k in ("Rt", "Rho", "W"):
        out[k] = _scalar_lap(d[k], m, mats)
    return out


def nu4_pass2_plain(d, work, nu_s, nu_d, nu_v, dt, fg,
                    statics: HyperStatics = None):
    """Plain PyTorch version of ``nu4_pass2``."""
    st = hyper_statics(fg) if statics is None else statics
    mats = _mats(st)
    m = [st.m2d[i][None] for i in range(8)]
    du, dv = _vector_upd(work["U"], work["V"], float(nu_d), float(nu_v), m,
                         mats)
    out = {"U": d["U"] + float(dt) * du, "V": d["V"] + float(dt) * dv}
    for k in ("Rt", "Rho", "W"):
        out[k] = d[k] - float(dt) * float(nu_s) * _scalar_lap(
            work[k], m, mats)
    return out


# ---------------------------------------------------------------------------
# launch shape and copy width
# ---------------------------------------------------------------------------

SMS = 132                  # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448          # shared memory a block can have
MAX_THREADS = 256          # the kernel's __launch_bounds__
BAR_BYTES = 64             # the ring's mbarriers
MAX_RING = 4
NTILES = 6                 # J u^a, then div, curl and the three fluxes
SMEM_SM = 233472           # shared memory of an SM (a block takes 1 KB more)
# the rule's constants, fitted to the sweeps of kernels/tune_tail.py on an
# H100 (both passes, float32 and float64, the flagship and the bubble's
# planes): threads a block at least (where the rows allow), a ring's depth,
# a block's set-up in levels, and the registers a thread of the p = 4
# instantiations takes (the build's -Xptxas -v report; chip_smoke.py prints
# both) by bytes a value
MIN_THREADS = 64
RING = 2
SETUP_LEVELS = 0.5
REGISTERS = {4: 128, 8: 240}


def blocks_per_sm(threads: int, smem: int, esize: int) -> int:
    """Blocks an SM holds at once: by registers, shared memory and warps."""
    warps = -(-threads // 32)
    return max(1, min(65536 // (warps * 32 * REGISTERS[esize]),
                      SMEM_SM // (smem + 1024), 64 // warps, 32))


class HyperLaunch(NamedTuple):
    """Launch shape of ``nu4_pass1`` / ``nu4_pass2``: a block owns ``rows``
    whole element rows (a multiple of p dividing A) and ``cols`` columns (a
    multiple of p dividing B) of one panel, one thread a segment of p nodes
    (``threads`` = rows * cols / p), and walks ``levels`` of the nz + 1
    steps (W has one interface more) with a ring of ``ring`` stages in
    ``smem`` bytes of shared memory; ``blocks`` blocks in all."""
    rows: int
    cols: int
    levels: int
    ring: int
    threads: int
    smem: int
    blocks: int


def hyper_smem_bytes(rows: int, cols: int, ring: int, pass2: bool,
                     esize: int) -> int:
    """Shared memory of a block, as ``csrc/hyper.cu`` lays it out: the
    mbarriers, ``ring`` stages of 5 (pass 2: 10) field slots, then the
    ``NTILES`` tiles; a slot and a tile hold rows * cols values, rounded up
    to 16 bytes."""
    v16 = 16 // esize
    tile = -(-rows * cols // v16) * v16
    return BAR_BYTES + ((10 if pass2 else 5) * ring + NTILES) * tile * esize


@functools.lru_cache(maxsize=None)
def hyper_launch_shape(nz: int, P: int, A: int, B: int, p: int, dtype,
                       pass2: bool, rows=None, cols=None, levels=None,
                       ring=None) -> HyperLaunch:
    """The launch shape of ``nu4_pass1`` (``pass2`` False) or ``nu4_pass2``
    on (nz | nz + 1, P, A, B) fields.  The keywords override the rule
    (``kernels/tune_tail.py`` sweeps them).  Cached: a launch asks for its
    shape on the host every time.

    The rule: whole rows where one element row of them fits
    ``MAX_THREADS`` threads (a thread a segment: B threads; else the widest
    column band that does, whose rows are then copied one by one); the
    fewest element rows that give ``MIN_THREADS`` threads; a ring of
    ``RING`` stages (one for runs of one level); and the runs (the kernel
    splits the nz + 1 steps evenly over them; ``levels`` in the result is
    the longest) that give the fewest waves of blocks on the card's
    ``SMS`` SMs (``blocks_per_sm``) times the levels a block walks plus
    its set-up (``SETUP_LEVELS``), the most blocks among equals: a launch
    whose blocks all fit in one wave wants them short enough to fill it, a
    launch of several waves wants a short last one.  Raises where no shape
    fits."""
    esize = 4 if dtype == torch.float32 else 8
    if p < 1 or p > MAX_P or A % p or B % p:
        raise ValueError(f"the nu4 kernels take 1 <= p <= {MAX_P} with "
                         f"whole elements, got A={A} B={B} p={p}")
    if (nz + 1) * P * A * B >= 2 ** 31:
        raise ValueError(f"field too large: (nz+1)*P*A*B="
                         f"{(nz + 1) * P * A * B}")
    widths = [c for c in range(p, B + 1, p) if B % c == 0
              and c <= MAX_THREADS]
    if cols is not None and cols not in widths:
        raise ValueError(f"cols must be a multiple of p={p} dividing B={B} "
                         f"of at most {MAX_THREADS}, got {cols}")
    TB = cols if cols is not None else max(widths)
    heights = [r for r in range(p, A + 1, p) if A % r == 0
               and r * TB // p <= MAX_THREADS]
    if rows is not None and rows not in heights:
        raise ValueError(f"rows must be a multiple of p={p} dividing A={A} "
                         f"that keeps {MAX_THREADS} threads, got {rows}")
    TA = rows if rows is not None else next(
        (r for r in heights if r * TB // p >= MIN_THREADS), max(heights))
    steps = nz + 1
    bands = (A // TA) * (B // TB) * P

    def shape(lv, r):
        """lv: the longest run (the kernel splits the steps evenly)."""
        if not (1 if lv == 1 else 2) <= r <= MAX_RING:
            # a stage is refilled once the level before it is done, so a
            # run of two levels or more needs two stages
            raise ValueError(f"ring depth {r} out of range for runs of "
                             f"{lv} levels")
        return HyperLaunch(TA, TB, lv, r, TA * TB // p,
                           hyper_smem_bytes(TA, TB, r, pass2, esize),
                           bands * math.ceil(steps / lv))

    if levels is not None:
        if int(levels) < 1:
            raise ValueError(f"levels a block must be >= 1, got {levels}")
        lv = math.ceil(steps / math.ceil(steps / min(int(levels), steps)))
        sh = shape(lv, int(ring) if ring is not None
                   else (1 if lv == 1 else RING))
    else:
        # the fewest waves of blocks times the levels a block walks
        best = None
        for runs in range(1, steps + 1):
            lv = math.ceil(steps / runs)
            r = int(ring) if ring is not None else (1 if lv == 1 else RING)
            if r < (1 if lv == 1 else 2) or r > MAX_RING:
                continue
            sh = shape(lv, r)
            if sh.smem > SMEM_MAX:
                continue
            slots = SMS * blocks_per_sm(sh.threads, sh.smem, esize)
            cost = (math.ceil(sh.blocks / slots) * (lv + SETUP_LEVELS),
                    -sh.blocks)
            if best is None or cost < best[0]:
                best = (cost, sh)
        if best is None:
            raise ValueError(f"no band of the nu4 kernels fits A={A} B={B} "
                             f"p={p} in {SMEM_MAX} bytes of shared memory")
        sh = best[1]
    if sh.smem > SMEM_MAX:
        raise ValueError(f"no band of the nu4 kernels fits A={A} B={B} "
                         f"p={p} in {SMEM_MAX} bytes of shared memory")
    return sh


def copy_width(B: int, cols: int, esize: int, ptrs) -> int:
    """Bytes a staging copy moves at a time: 16 (bulk copies of whole
    spans) where a row of B values, a band's row of ``cols`` values and
    every pointer of ``ptrs`` (ints; 0 for an absent one) are 16-byte
    multiples, else 8 (``cp.async``) where they are 8-byte multiples, else
    one value."""
    for nbytes in (16, 8):
        if nbytes >= esize and (B * esize) % nbytes == 0 \
                and (cols * esize) % nbytes == 0 \
                and all(q % nbytes == 0 for q in ptrs):
            return nbytes
    return esize


_ENTRY = re.compile(r"nu4_kernelI([fd])Li(\d)ELb([01])E")


def kernel_resources() -> dict:
    """Registers and spill bytes of the kernel's eight instantiations as
    ``nvcc -Xptxas -v`` reported them at the build, keyed ``f32 p4
    pass1``, ``f64 generic pass2``, ... (empty before a build)."""
    out = {}
    for name, use in build.ptxas_usage("hyper").items():
        m = _ENTRY.search(name)
        if m:
            out[f"{'f32' if m.group(1) == 'f' else 'f64'} "
                f"{'p4' if m.group(2) == '4' else 'generic'} "
                f"pass{int(m.group(3)) + 1}"] = use
    return out


def _inputs(x, base):
    """The tensors a launch stages: the five fields, then pass 2's base."""
    return [x[k] for k in FIELDS] + ([base[k] for k in FIELDS]
                                     if base is not None else [])


def launch_config(x, base, st: HyperStatics, launch=None) -> dict:
    """What a launch on the fields ``x`` (pass 2: with ``base``) takes: its
    launch shape (``launch``, default the rule's) and its copy width."""
    u = x["U"]
    nz, P, A, B = u.shape
    sh = launch or hyper_launch_shape(nz, P, A, B, st.p, u.dtype,
                                      base is not None)
    return dict(sh._asdict(), copy=copy_width(
        B, sh.cols, u.element_size(),
        [t.data_ptr() for t in _inputs(x, base)]))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, d, st: HyperStatics, ref=None):
    """Raises on what the kernels do not take; returns (nz, P, A, B)."""
    u = d["U"] if ref is None else ref
    if u.dim() != 4 or u.dtype not in (torch.float32, torch.float64):
        raise ValueError("state fields must be float32/float64 "
                         "(K, P, A, B) tensors")
    nz, P, A, B = u.shape
    for k in FIELDS:
        f = d[k]
        rows = nz + 1 if k == "W" else nz
        if tuple(f.shape) != (rows, P, A, B) or f.dtype != u.dtype \
                or f.device != u.device or not f.is_contiguous():
            raise ValueError(
                f"{name}[{k!r}] must be a contiguous ({rows}, {P}, {A}, "
                f"{B}) tensor of the state's dtype and device")
    p = st.p
    if p > MAX_P or A % p != 0 or B % p != 0:
        raise ValueError(f"panels must hold whole elements of at most "
                         f"{MAX_P} nodes an edge, got A={A} B={B} p={p}")
    if tuple(st.m2d.shape) != (8, P, A, B) or st.m2d.dtype != u.dtype \
            or st.m2d.device != u.device or not st.m2d.is_contiguous():
        raise ValueError("the metric stack must be a contiguous (8, P, A, "
                         "B) tensor of the state's dtype and device")
    if st.ds.numel() != 4 * p * p or st.ds.dtype != u.dtype \
            or st.ds.device != u.device or st.ds_host.size != 4 * p * p:
        raise ValueError("the element matrices do not match the state")
    return nz, P, A, B


def _launch(name, x, base, scal, st: HyperStatics, launch=None):
    """One launch on CUDA tensors; ``launch`` overrides the rule's shape."""
    u = x["U"]
    nz, P, A, B = u.shape
    sh = launch or hyper_launch_shape(nz, P, A, B, st.p, u.dtype,
                                      base is not None)
    lib = build.library("hyper")
    fn = lib.nu4_f32 if u.dtype == torch.float32 else lib.nu4_f64
    with torch.cuda.device(u.device):
        outs = [torch.empty_like(x[k]) for k in FIELDS]
        ins = _inputs(x, base)
        copy = copy_width(B, sh.cols, u.element_size(),
                          [t.data_ptr() for t in ins])
        tensors = ins + [None] * (10 - len(ins)) + [st.m2d] + outs
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if t is None else t.data_ptr() for t in tensors])
        scal = (ctypes.c_double * (4 + st.ds_host.size))(
            *scal, *st.ds_host.tolist())
        ints = (ctypes.c_int * 11)(nz, P, A, B, st.p, int(base is not None),
                                   sh.rows, sh.cols, sh.levels, sh.ring,
                                   copy)
        err = fn(ptrs, scal, ints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (returned {err}: "
                           f"-1 a shape or copy width it does not take, -2 "
                           f"too much shared memory, else cudaGetLastError)")
    launch_counts[name] += 1
    return dict(zip(FIELDS, outs))


def nu4_pass1(d, fg, statics: HyperStatics = None):
    """Work fields ``{-wu, -wv, lap(Rt), lap(Rho), lap(W)}`` with ``(wu,
    wv) = vector_upd(U, V, 1, 1)``; one kernel launch.  Returns fresh
    tensors.  ``statics``: ``hyper_statics(fg)`` (built on the fly when
    absent)."""
    st = hyper_statics(fg) if statics is None else statics
    _check("d", d, st)
    dev = d["U"].device.type
    if dev == "cpu":
        return nu4_pass1_plain(d, fg, st)
    if dev != "cuda":
        raise ValueError(f"unsupported device {d['U'].device}")
    return _launch("nu4_pass1", d, None, (1.0, 1.0, 0.0, 0.0), st)


def nu4_pass2(d, work, nu_s, nu_d, nu_v, dt, fg,
              statics: HyperStatics = None):
    """``U + dt * du``, ``V + dt * dv`` with ``(du, dv) = vector_upd(wU, wV,
    nu_d, nu_v)`` and ``X - dt * nu_s * lap(wX)`` for Rt, Rho, W, where
    ``w*`` are the DSSed work fields; one kernel launch.  Returns fresh
    tensors: ``d`` is not written."""
    st = hyper_statics(fg) if statics is None else statics
    _check("d", d, st)
    _check("work", work, st, ref=d["U"])
    dev = d["U"].device.type
    if dev == "cpu":
        return nu4_pass2_plain(d, work, nu_s, nu_d, nu_v, dt, fg, st)
    if dev != "cuda":
        raise ValueError(f"unsupported device {d['U'].device}")
    return _launch("nu4_pass2", work, d,
                   (float(nu_d), float(nu_v), float(dt),
                    float(dt) * float(nu_s)), st)
