"""One explicit RK stage of the nonhydrostatic dynamics in one kernel: the
CUDA kernel's wrapper and its plain version.

Counterpart of the JAX package's ``fast/stage_pallas.py``
(``fused_stage``).  One launch computes, for every node and level, the
vertical 2-3-diagonal operators (w_n, du/dxi, dv/dxi, the interface
velocity and the penalty upwinding), the element-local horizontal
derivatives, the vector-invariant momentum, Exner-gradient and buoyancy
tendencies, the weak-form Rt/Rho flux divergences, the two-term RK base
combination and the axpy; it writes the updated U, V, Rt, Rho and the
vertical curl term ``ucz_x``.  With ``"Tracers"`` in the evaluation state the
same launch advects every species on the mass fluxes that carry Rho (the
flat species-major field ``(ntr * nz, P, A, B)``, its base combined like the
others').  W follows outside the kernel: ``dW =
interp_n2i @ ucz_x`` is one matrix product, and the W finish is either
applied here (``defer_w=False``) or handed to ``dss_cuda.dss_uvw``
(``defer_w=True``), which folds it into the (U, V, W) DSS.

On an x-z slice (``fg.xz_zero``) the engine slot that holds the physical V
("V", or "U" on an (a, b)-swapped grid) gets only the vertical penalty
increment, as in ``engine.horizontal_tendency``.  The stage holds no DSS, so
the periodic wrap of a Cartesian grid asks nothing of it.

The kernel (``csrc/stage.cu``) is not shaped like the TPU one; see the note
there for its design and its bound on the card.  Its launch shape (the tile
of whole elements, the levels a block walks, the depth of its ring of level
slabs in shared memory, the species per group of flux tiles) comes from
``stage_launch_shape``, and the width of its asynchronous copies from
``copy_width``; both are plain Python, so the CPU tests hold the rules.
``fused_stage`` launches the kernel for CUDA tensors — or raises — and runs
``fused_stage_plain`` only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import re
from typing import Any

import numpy as np
import torch

from .._device import np_dtype
from ..kernels import build, stencils
from ..kernels.counts import launch_counts
from . import dss_cuda, tracers
from .engine import FastGeometry, colop, horizontal_tendency

MAX_P = 8        # nodes per element edge the kernel's tiles are sized for
STATE4 = ("U", "V", "Rt", "Rho")
# the kernel's code for ``fg.xz_zero``
XZ_CODES = {None: 0, "U": 1, "V": 2}

# Stencil windows of the kernel, per operator: level rows read levels
# k + offset (Dn2n, Pl, Pr) or interfaces k + offset (Ii2n); the penalty
# weights Wl, Wr act on interior element edges, edge j lying on interface
# j + 1, so their offsets (-1, 0) are the interfaces k and k + 1; interface
# rows (In2i) read levels i + offset.  ``csrc/stage.cu`` has the same
# columns as constants.
LAYOUT = [("Ii2n", (0, 1)), ("Dn2n", (-1, 0, 1)), ("In2i", (-2, -1, 0, 1)),
          ("Wl", (-1, 0)), ("Wr", (-1, 0)), ("Pl", (-1, 0, 1)),
          ("Pr", (-1, 0, 1))]
NCOLS = sum(len(o) for _, o in LAYOUT) + 2       # + s_lev, s_int
NREC = 24        # values of a level's record of the table in the kernel

# The kernel's launch shape (kernels/tune_fused.py sweeps it).  A block is
# a tile of whole elements of about TARGET_THREADS nodes (a warp on one row,
# at most MAX_IDLE of the last tiles idle, never more than MAX_THREADS where
# a smaller tile exists); its ring of level slabs is RING stages deep, fewer
# where a deeper one would leave an SM fewer than MIN_RESIDENT threads; the
# levels are cut into as few chunks (of at least MIN_LEVELS) as give the
# grid TARGET_WAVES waves of resident blocks.  At the flagship's shapes on an
# NVIDIA H100 80GB HBM3 at 700 W this rule's shape was within 2.3 % (f32)
# and 0.7 % (f64) of the fastest of up to 220 swept, with and without
# tracers (PERF.md section 6).
TARGET_THREADS = 128
MAX_THREADS = 256
MAX_IDLE = 0.1
RING = 4
MIN_RESIDENT = 512
MIN_LEVELS = 4
TARGET_WAVES = 2.5
SMS = 132                      # streaming multiprocessors of an H100
SM_SMEM = 233472               # shared memory of one H100 SM
BLOCK_RESERVE = 1024           # ... of which each block keeps this much
# registers a thread of the kernel takes, by value size and tracers (as
# `nvcc -Xptxas -v` reports them for sm_90a; `kernel_resources()` gives
# the build's own, and chip_smoke.py prints both)
REGISTERS = {(4, False): 128, (4, True): 128, (8, False): 184,
             (8, True): 168}
MIN_RING, MAX_RING = 3, 6      # csrc/stage.cu takes these
STAGE_SPECIES = 3              # species per group of flux tiles
NTILES = 9                     # tiles of computed fields (csrc/stage.cu)
N3D = 9                        # slabs of the full 3-D metric
SMEM_MAX = 232448              # dynamic shared memory one H100 block may have
# the pointers of the kernel's ``ptrs`` array it copies through the ring
# (every one must be aligned to the copy width): u v rt rho w, the bases,
# the 3-D metric, the tracers and their bases
RING_PTRS = tuple(range(0, 13)) + tuple(range(14, 23)) + (29, 30, 31)


@dataclasses.dataclass(frozen=True)
class StageLaunch:
    """A launch shape of the stage kernel: a tile of ``TA`` x ``TB`` nodes
    (whole elements, one thread each), ``levels`` levels per block, a ring
    of ``ring`` stages, ``group`` species per group of flux tiles (0
    without tracers), and the dynamic shared memory in bytes of the launch
    it was sized for."""
    TA: int
    TB: int
    levels: int
    ring: int
    group: int
    smem: int

    @property
    def threads(self) -> int:
        return self.TA * self.TB


def ring_slabs(ntr: int, two_base: bool, sep: bool) -> int:
    """Slabs of one ring stage: the 5 evaluation fields, the 4 or 8 base
    fields, the 9 of the full 3-D metric (none in the separable form), and
    each species with its base or bases."""
    nbase = 8 if two_base else 4
    return 5 + nbase + (0 if sep else N3D) + ntr * (1 + nbase // 4)


def stage_smem_bytes(nz, p, TA, TB, ring, group, nslab, esize):
    """Dynamic shared memory of one block, as ``csrc/stage.cu`` lays it
    out: the ring and two buffers of tiles; 16-byte aligned, the four
    element matrices and one record of the stencil table a level; each
    slab's pointer."""
    nth = TA * TB
    vals = ring * nslab * nth + 2 * (NTILES + 2 * group) * nth
    ntab = nz * NREC + 4 * p * p
    return ((((vals * esize + 15) & ~15) + ntab * esize + 7) & ~7) \
        + nslab * 8


def resident_blocks(nbytes: int, threads: int, registers: int) -> int:
    """Blocks of ``threads`` threads, ``nbytes`` of shared memory and
    ``registers`` a thread that one H100 SM holds at once."""
    warp_regs = -(-registers * 32 // 256) * 256        # allocated per warp
    by_regs = 65536 // max(1, warp_regs * -(-threads // 32))
    return min(32, 2048 // threads, SM_SMEM // (nbytes + BLOCK_RESERVE),
               by_regs)


def _whole_elements(n, p):
    return range(p, n + 1, p)


def _tiles(A, B, p):
    """Every tile (TA, TB) of whole elements with at least min(64, A * B)
    and at most 1024 threads, most preferred first: at most MAX_THREADS
    threads; a warp on one row (32 nodes or more, or the whole row); at
    most MAX_IDLE of the last tiles idle; then nearest TARGET_THREADS; the
    least idle; the longer row."""
    least = min(64, A * B)
    out = []
    for TA in _whole_elements(A, p):
        for TB in _whole_elements(B, p):
            nth = TA * TB
            if not least <= nth <= 1024:
                continue
            idle = 1.0 - A * B / (math.ceil(A / TA) * TA
                                  * math.ceil(B / TB) * TB)
            out.append(((nth > MAX_THREADS, not (TB >= 32 or TB == B),
                         idle > MAX_IDLE, abs(math.log(nth / TARGET_THREADS)),
                         round(idle, 6), -TB), TA, TB))
    return [(TA, TB) for _, TA, TB in sorted(out)]


@functools.lru_cache(maxsize=None)
def stage_launch_shape(nz: int, A: int, B: int, p: int, ntr: int, dtype,
                       two_base: bool = True, sep: bool = False,
                       panels: int = 6, tile=None, levels=None,
                       ring=None) -> StageLaunch:
    """The stage kernel's launch shape for ``(nz, P, A, B)`` fields with
    ``p`` nodes per element edge and ``ntr`` tracer species in ``dtype``.
    The shared memory is sized for ``two_base`` and ``sep`` (by default the
    most a launch of this shape can need: two bases, the full 3-D metric);
    ``panels``: P (6 on the cubed sphere, 1 on a Cartesian grid).
    ``tile`` (TA, TB), ``levels`` and ``ring`` replace the rules' choice
    (``kernels/tune_fused.py``).  Raises ValueError where nothing fits."""
    esize = torch.empty((), dtype=dtype).element_size()
    regs = REGISTERS[esize, ntr > 0]
    nslab = ring_slabs(ntr, two_base, sep)
    group = min(ntr, STAGE_SPECIES)
    tiles = _tiles(A, B, p) if tile is None else [tuple(tile)]
    rings = [ring] if ring is not None else range(RING, MIN_RING - 1, -1)
    for TA, TB in tiles:   # the most preferred tile that fits a block
        if TA % p or TB % p or not 1 <= TA * TB <= 1024:
            raise ValueError(f"tile {TA} x {TB} is not whole elements of "
                             f"{p} nodes or has more than 1024 threads")
        fits = []          # (resident threads, ring, bytes), deepest first
        for r in rings:
            nbytes = stage_smem_bytes(nz, p, TA, TB, r, group, nslab, esize)
            if MIN_RING <= r <= MAX_RING and nbytes <= SMEM_MAX:
                fits.append((TA * TB * resident_blocks(nbytes, TA * TB, regs),
                             r, nbytes))
        if fits:
            break
    else:
        raise ValueError(f"no launch shape of the stage kernel fits nz={nz}, "
                         f"A={A}, B={B}, p={p}, ntr={ntr} in {SMEM_MAX} "
                         f"bytes of shared memory")
    # the deepest ring that leaves MIN_RESIDENT threads an SM, else the one
    # that leaves the most
    resident, r, nbytes = next((f for f in fits if f[0] >= MIN_RESIDENT),
                               max(fits, key=lambda f: f[0]))
    if levels is None:
        blocks = math.ceil(A / TA) * math.ceil(B / TB) * panels
        want = TARGET_WAVES * SMS * resident // (TA * TB)
        chunks = max(1, min(math.ceil(want / blocks), nz // MIN_LEVELS))
        lv = math.ceil(nz / chunks)
    else:
        lv = min(int(levels), nz)
    return StageLaunch(TA, TB, lv, r, group, nbytes)


def copy_width(B: int, TB: int, esize: int, ptrs) -> int:
    """Values per asynchronous copy of the ring: 16 bytes where B, the tile
    row and every pointer of ``ptrs`` (ints) allow it, else 8, else one
    value."""
    for nbytes in (16, 8, esize):
        V = nbytes // esize
        if V >= 1 and B % V == 0 and TB % V == 0 \
                and all(q % nbytes == 0 for q in ptrs):
            return V
    return 1


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _has_penalty(fg: FastGeometry) -> bool:
    return fg.penalty_left is not None and fg.nz // fg.vo > 1


def build_stage_diags(fg: FastGeometry, dtype):
    """(vd, bmeta) for the stage's vertical operators, or (None, None) if
    any is wider than 6 diagonals.  ``vd``: (n_vecs, nz+1, 1, 1) numpy
    array of ``dtype``; ``bmeta``: ``{operator: [(offset, index into
    vd)]}``."""
    nz = fg.nz
    named = {"Ii2n": fg.interp_i2n, "Dn2n": fg.diff_n2n,
             "In2i": fg.interp_n2i}
    if _has_penalty(fg):
        named.update({"Wl": fg.wscat_left, "Wr": fg.wscat_right,
                      "Pl": fg.penalty_left, "Pr": fg.penalty_right})
    vecs = []
    bmeta = {}
    for name, M in named.items():
        diags = stencils.extract_diags(_np(M))
        if diags is None:
            return None, None
        lst = []
        for o, vec in diags:
            if vec.shape[0] < nz + 1:
                vec = np.pad(vec, (0, nz + 1 - vec.shape[0]))
            lst.append((o, len(vecs)))
            vecs.append(vec)
        bmeta[name] = lst
    vd = np.stack(vecs).astype(dtype)[:, :, None, None]
    return vd, bmeta


@dataclasses.dataclass
class StageStatics:
    """What ``fused_stage`` needs beside the state, built once per
    configuration (``stage_statics``)."""
    tab: Any          # 1-D tensor: the (nz+1, NCOLS) stencil table, then
    #                 # D/delta and S/delta along a, then along b ((p, p)
    #                 # each, row-major: ``stencils.element_matrices``)
    m2d: Any          # (12, P, A, B) separable metric, or (5, P, A, B)
    use_sep: bool
    has_pen: bool
    c00: float        # interp_n2i[0, 0] and [0, 1], for the W finish
    c01: float


def _stencil_table(fg: FastGeometry):
    """The (nz+1, NCOLS) float64 table of ``LAYOUT`` plus the separable
    profiles, or None when an operator does not fit its window."""
    vd, bmeta = build_stage_diags(fg, np.float64)
    if bmeta is None:
        return None
    diags = {name: [(o, vd[i, :, 0, 0]) for o, i in bmeta.get(name, [])]
             for name, _ in LAYOUT}
    table = stencils.pack(LAYOUT, diags, fg.nz + 1)
    if table is None:
        return None
    prof = np.zeros((fg.nz + 1, 2))
    if fg.sep_ok:
        prof[:fg.nz, 0] = _np(fg.s_lev)[:, 0]
        prof[:, 1] = _np(fg.s_int)[:, 0]
    return np.concatenate([table, prof], axis=1)


def stage_supported(fg: FastGeometry) -> bool:
    """Whether the fused stage covers this configuration.  A statement
    about the configuration only.  Vertical order 1 (every vertical
    operator then fits the kernel's 2-4-point windows, which is checked),
    at most ``MAX_P`` nodes per element edge, whole elements per panel; any
    grid the engine takes (cubed sphere, Cartesian in either layout, x-z
    slice or not).  (The TPU kernel's further conditions on ``A`` and ``p``
    are about its tiles and are not carried over.)"""
    return (fg.vo == 1 and fg.nz >= 2 and fg.p <= MAX_P
            and fg.A % fg.p == 0 and fg.B % fg.p == 0
            and _stencil_table(fg) is not None)


def stage_statics(fg: FastGeometry) -> StageStatics:
    """The stage's static tensors on the device and in the dtype of ``fg``.
    Raises for a configuration outside ``stage_supported``."""
    if not stage_supported(fg):
        raise NotImplementedError(
            "configuration outside the fused stage's envelope "
            "(see stage_supported)")
    dtype, dev = fg.inv_mult.dtype, fg.inv_mult.device
    table = _stencil_table(fg)
    flat = np.concatenate([table.ravel()] + [
        m.ravel() for m in stencils.element_matrices(fg)])
    tab = torch.as_tensor(flat.astype(np_dtype(dtype)), device=dev)
    use_sep = bool(fg.sep_ok)
    fields = [fg.c2_aa, fg.c2_ab, fg.c2_ba, fg.c2_bb, fg.fj]
    if use_sep:
        fields += [fg.sep_ca, fg.sep_cb, fg.sep_e, fg.sep_f, fg.sep_da,
                   fg.sep_db, fg.sep_jacl]
    In0 = _np(fg.interp_n2i)[0]
    return StageStatics(
        tab=tab, m2d=torch.stack(fields).contiguous(), use_sep=use_sep,
        has_pen=_has_penalty(fg), c00=float(In0[0]), c01=float(In0[1]))


def _split_base(base):
    """(two_base, cb1, base1, cb2, base2); base2 is None for one base."""
    if isinstance(base, tuple):
        (cb1, base1), (cb2, base2) = base
        return True, cb1, base1, cb2, base2
    return False, 1.0, base, 0.0, None


def _w_finish(two_base, cb1, base1, cb2, base2, dt_s, dW, fg, c00, c01):
    return {"bw1": base1["W"], "bw2": base2["W"] if two_base else None,
            "cb1": cb1, "cb2": cb2, "dt_s": dt_s, "dW": dW,
            "cax0": fg.con_a_xi_int[0], "cbx0": fg.con_b_xi_int[0],
            "cxx0": fg.con_xi_xi_int[0], "c00": c00, "c01": c01}


def _base_tracers(two_base, base1, base2, ueval):
    """(btr1, btr2) as the kernel and the plain version read them: a base
    without tracers stands for the evaluation state's; btr2 is None for a
    single base."""
    btr1 = base1.get("Tracers", ueval["Tracers"])
    return btr1, (base2.get("Tracers", btr1) if two_base else None)


def _finish(out, wf, defer_w):
    if defer_w:
        return out, wf
    out["W"] = dss_cuda.w_finish_plain(out["U"], out["V"], wf)
    return out


def fused_stage_plain(base, ueval, dt_s, fg: FastGeometry, constants,
                      defer_w: bool = False):
    """Plain PyTorch version of ``fused_stage`` (same arguments and
    results): ``horizontal_tendency``, the base combination and the axpy,
    and ``tracers.horizontal_update`` where the evaluation state has
    tracers."""
    two_base, cb1, base1, cb2, base2 = _split_base(base)
    tend = horizontal_tendency(ueval, fg, constants, mask_w=False)
    out = {}
    for k in STATE4:
        bb = cb1 * base1[k] + cb2 * base2[k] if two_base else base1[k]
        out[k] = bb + dt_s * tend[k]
    if "Tracers" in ueval:
        btr1, btr2 = _base_tracers(two_base, base1, base2, ueval)
        out["Tracers"] = tracers.horizontal_update(
            ((cb1, btr1), (cb2, btr2)) if two_base else btr1, ueval, dt_s, fg)
    In0 = fg.interp_n2i[0]
    wf = _w_finish(two_base, cb1, base1, cb2, base2, dt_s, tend["W"], fg,
                   float(In0[0]), float(In0[1]))
    return _finish(out, wf, defer_w)


def _check_state(name, d, keys, ref, nz):
    for k in keys:
        f = d[k]
        rows = nz + 1 if k == "W" else nz
        if tuple(f.shape) != (rows,) + tuple(ref.shape[1:]) \
                or f.dtype != ref.dtype or f.device != ref.device \
                or not f.is_contiguous():
            raise ValueError(
                f"{name}[{k!r}] must be a contiguous ({rows}, P, A, B) "
                f"tensor of the state's dtype and device")


def _check_tracers(name, f, ref, nz, rows=None):
    if f.dim() != 4 or f.shape[0] == 0 or f.shape[0] % nz != 0 \
            or (rows is not None and f.shape[0] != rows) \
            or tuple(f.shape[1:]) != tuple(ref.shape[1:]) \
            or f.dtype != ref.dtype or f.device != ref.device \
            or not f.is_contiguous():
        raise ValueError(
            f"{name}['Tracers'] must be a contiguous (ntr * {nz}, P, A, B) "
            f"tensor of the state's dtype and device, got "
            f"{tuple(f.shape)}")


def fused_stage(base, ueval, dt_s, fg: FastGeometry, constants,
                defer_w: bool = False, statics: StageStatics = None):
    """One RK stage update ``base + dt_s * tendency(ueval)``; one kernel
    launch, then one matrix product for dW.

    ``base``: a state dict, or ``((c1, d1), (c2, d2))`` — a two-term RK
    combination evaluated inside the kernel for U, V, Rt, Rho and the
    tracers.  Returns the pre-DSS state dict with the W boundary applied, or
    with ``defer_w`` the pair ``({U, V, Rt, Rho}, w_finish)`` for
    ``dss_cuda.dss_uvw``.  With ``"Tracers"`` in ``ueval`` (flat,
    ``(ntr * nz, P, A, B)``) the result has the advected tracers too; a base
    without ``"Tracers"`` stands for the evaluation state's.
    ``statics``: ``stage_statics(fg)`` (built on the fly when absent)."""
    two_base, cb1, base1, cb2, base2 = _split_base(base)
    u = ueval["U"]
    if u.dim() != 4 or u.dtype not in (torch.float32, torch.float64):
        raise ValueError("state fields must be float32/float64 "
                         "(K, P, A, B) tensors")
    nz, P, A, B = u.shape
    if (nz, A, B) != (fg.nz, fg.A, fg.B) or P != fg.npanels:
        raise ValueError(f"state {tuple(u.shape)} does not match the "
                         f"geometry (nz={fg.nz}, P={fg.npanels}, A={fg.A}, "
                         f"B={fg.B})")
    _check_state("ueval", ueval, STATE4 + ("W",), u, nz)
    _check_state("base", base1, STATE4 + ("W",), u, nz)
    if two_base:
        _check_state("base", base2, STATE4 + ("W",), u, nz)
    if "Tracers" in ueval:
        _check_tracers("ueval", ueval["Tracers"], u, nz)
        for b in _base_tracers(two_base, base1, base2, ueval):
            if b is not None:
                _check_tracers("base", b, u, nz, ueval["Tracers"].shape[0])
    if fg.inv_mult.dtype != u.dtype or fg.inv_mult.device != u.device:
        raise ValueError("geometry and state differ in dtype or device")
    if u.device.type == "cpu":
        return fused_stage_plain(base, ueval, dt_s, fg, constants, defer_w)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    if statics is None:
        statics = stage_statics(fg)
    outs = _fused_stage_cuda(two_base, cb1, base1, cb2, base2, ueval, dt_s,
                             fg, constants, statics)
    out = dict(zip(STATE4, outs[:4]))
    if "Tracers" in ueval:
        out["Tracers"] = outs[5]
    dW = colop(fg.interp_n2i, outs[4])
    wf = _w_finish(two_base, cb1, base1, cb2, base2, dt_s, dW, fg,
                   statics.c00, statics.c01)
    return _finish(out, wf, defer_w)


def _launch_plan(two_base, base1, base2, ueval, fg, st: StageStatics,
                 launch: StageLaunch = None):
    """(tensors of the kernel's ``ptrs``, ints, launch shape, copy width)
    of one launch; the output tensors are not made yet (None)."""
    u = ueval["U"]
    nz, P, A, B = u.shape
    sep = st.use_sep
    full3d = [None] * 9 if sep else [
        fg.con_a_xi, fg.con_b_xi, fg.con_xi_xi, fg.jac3d, fg.deriv_r_a,
        fg.deriv_r_b, fg.con_a_xi_int, fg.con_b_xi_int, fg.con_xi_xi_int]
    if not all(f is None or f.is_contiguous() for f in full3d):
        raise ValueError("geometry fields must be contiguous")
    tr = ueval.get("Tracers")
    ntr = 0 if tr is None else tr.shape[0] // nz
    trs = [None] * 4
    if ntr:
        trs = [tr, *_base_tracers(two_base, base1, base2, ueval), None]
    tensors = ([ueval[k] for k in STATE4 + ("W",)]
               + [base1[k] for k in STATE4]
               + [base2[k] if two_base else None for k in STATE4]
               + [st.m2d] + full3d + [st.tab] + [None] * 5 + trs)
    if launch is None:
        launch = stage_launch_shape(nz, A, B, fg.p, ntr, u.dtype, two_base,
                                    sep, P)
    V = copy_width(B, launch.TB, u.element_size(),
                   [0 if tensors[i] is None else tensors[i].data_ptr()
                    for i in RING_PTRS])
    ints = (nz, P, A, B, fg.p, int(sep), int(st.has_pen), ntr,
            XZ_CODES[fg.xz_zero], int(fg.npanels == 1), launch.TA,
            launch.TB, launch.levels, launch.ring, launch.group, V)
    return tensors, ints, launch, V


def launch_config(base, ueval, fg: FastGeometry, statics: StageStatics = None,
                  launch: StageLaunch = None) -> dict:
    """What one launch of the kernel on these inputs would be: the tile,
    levels per block, ring depth, species per group, copy width and route,
    shared memory (for the report lines of ``chip_smoke.py``)."""
    two_base, _, base1, _, base2 = _split_base(base)
    st = statics if statics is not None else stage_statics(fg)
    _, ints, sh, V = _launch_plan(two_base, base1, base2, ueval, fg, st,
                                  launch)
    esize = ueval["U"].element_size()
    nbytes = V * esize
    nslab = ring_slabs(ints[7], two_base, st.use_sep)
    return {"tile": [sh.TA, sh.TB], "threads": sh.threads,
            "levels_per_block": sh.levels, "ring": sh.ring,
            "species_per_group": sh.group, "slabs": nslab,
            "copy_bytes": nbytes,
            "copy_route": f"cp.async.{'cg' if nbytes == 16 else 'ca'} "
                          f"{nbytes} B",
            "smem_bytes": stage_smem_bytes(
                ints[0], fg.p, sh.TA, sh.TB, sh.ring, sh.group, nslab, esize)}


_ENTRY = re.compile(r"fused_stage_kernelI([fd])Lb([01])ELb([01])E")


def kernel_resources() -> dict:
    """Registers and spill bytes of the kernel's eight instantiations as
    ``nvcc -Xptxas -v`` reported them at the build, keyed ``f32``,
    ``f32+tracers``, ``f32+cart``, ... (empty before a build)."""
    out = {}
    for name, use in build.ptxas_usage("stage").items():
        m = _ENTRY.search(name)
        if m:
            key = ("f32" if m.group(1) == "f" else "f64") \
                + ("+tracers" if m.group(2) == "1" else "") \
                + ("+cart" if m.group(3) == "1" else "")
            out[key] = use
    return out


def _fused_stage_cuda(two_base, cb1, base1, cb2, base2, ueval, dt_s, fg,
                      constants, st: StageStatics,
                      launch: StageLaunch = None):
    """Launch the kernel; returns [U, V, Rt, Rho, ucz_x] and, where the
    evaluation state has tracers, the advected tracers.  ``launch``: a
    launch shape in place of ``stage_launch_shape``'s."""
    u = ueval["U"]
    c = constants
    lib = build.library("stage")
    fn = lib.fused_stage_f32 if u.dtype == torch.float32 \
        else lib.fused_stage_f64
    tensors, ints, _, _ = _launch_plan(two_base, base1, base2, ueval, fg, st,
                                       launch)
    with torch.cuda.device(u.device):
        outs = [torch.empty_like(u) for _ in range(5)]
        tensors[24:29] = outs
        if tensors[29] is not None:
            outs.append(torch.empty_like(tensors[29]))
            tensors[32] = outs[5]
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if t is None else t.data_ptr() for t in tensors])
        scal = (ctypes.c_double * 7)(
            float(dt_s), float(cb1), float(cb2), float(c.Cp),
            float(c.Rd / (c.Cp - c.Rd)), float(c.Rd / c.P0), float(c.g))
        cints = (ctypes.c_int * len(ints))(*ints)
        err = fn(ptrs, scal, cints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_stage kernel launch failed "
                           f"(cudaGetLastError = {err})")
    launch_counts["fused_stage"] += 1
    return outs
