"""HEVI implicit Newton update in one kernel: the CUDA kernel's wrapper and
its plain version.

Counterpart of the JAX package's ``fast/pallas_implicit.py``
(``fused_implicit_update``).  Per column, one launch computes the aux
terms, the residual F of (Rt, W, Rho), the analytic banded Jacobian (exact
or reference mode) and a no-pivot banded LU solve, and returns the Newton
increment ``(d_rt, d_w, d_rho) = J^{-1} F``.  Neither the ``(n, 2q+1,
ncol)`` band tensor nor its U factor reaches device memory.

The kernel (``csrc/implicit.cu``) stages a tile of columns in shared
memory, assembles the rows of the tile level-parallel there and solves each
column there; see the note in the source for its design and its bound on
the card.  Its launch shape (columns a block, threads) comes from
``implicit_launch_shape`` and the width of its asynchronous copies from
``copy_width``; both are plain Python, so the CPU tests hold the rules.
``fused_implicit_update`` launches it for CUDA tensors — or raises — and
runs ``fused_implicit_update_plain`` only for tensors that lie on the CPU.

``PackedStatics`` / ``pack_statics`` / ``build_diag_table`` are the JAX
module's host-side packing of ``band_assembly_statics`` without its sublane
fold (which exists for the TPU's tiles); ``stencil_table`` turns them into
the fixed-window coefficient table the kernel reads.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
from typing import Any

import numpy as np
import torch

from ..kernels import build, stencils
from ..kernels.counts import launch_counts
from .stage_cuda import SMEM_MAX, SMS, resident_blocks

MATS = ("interp_n2i", "interp_i2n", "diff_n2i", "diff_i2n", "diffdiff_i2i",
        "penalty_left", "penalty_right", "wscat_left", "wscat_right")
AUX_FIELDS = ("u_n", "v_n", "con_a_xi", "con_b_xi", "con_xi_xi",
              "con_a_xi_int", "con_b_xi_int", "con_xi_xi_int", "jac",
              "jac_int", "deriv_r_int")
OFFS = (-1, 0, 1)       # the block offsets the kernel assembles (q == 4)

# Stencil windows of the kernel, per operator (``csrc/implicit.cu`` has the
# same columns as constants).  Interface rows read levels i + offset (In2i,
# Dn2i, TB_o) or interfaces i + offset (DD); level rows read interfaces
# k + offset (Ii2n, Di2n, TA_o) or levels k + offset (Pl, Pr).  Wl, Wr, Ul_o,
# Ur_o act on interior element edges, edge j lying on interface j + 1, so
# their offsets (-1, 0) are the interfaces k and k + 1.  An operator with an
# empty window must vanish.
_LEV4 = (-2, -1, 0, 1)
LAYOUT = ([("In2i", _LEV4), ("Dn2i", _LEV4)]
          + [(f"TB{o}", _LEV4) for o in OFFS]
          + [("DD", (-2, -1, 0, 1, 2)), ("Ii2n", (0, 1)), ("Di2n", (0, 1))]
          + [(f"TA{o}", (0, 1)) for o in OFFS]
          + [("Wl", (-1, 0)), ("Wr", (-1, 0)),
             ("Ul0", (-1, 0)), ("Ul1", (-1, 0)),
             ("Ur0", (-1, 0)), ("Ur1", (-1, 0)),
             ("Pl", (-1, 0, 1)), ("Pr", (-1, 0, 1)),
             ("Ul-1", ()), ("Ur-1", ())])
# then the band vectors of ``PackedStatics``, one column per block offset
BAND_COLUMNS = [("DDb", OFFS), ("Dn2i_b", OFFS), ("In2i_b", OFFS),
                ("Di2n_b", (0, 1)), ("Pl_b", OFFS), ("Pr_b", OFFS)]
NCOLS = (sum(len(o) for _, o in LAYOUT)
         + sum(len(o) for _, o in BAND_COLUMNS))

# The kernel's launch shape (``kernels/tune_fused.py implicit`` sweeps it).
# A block is a tile of C columns with all their levels in shared memory
# (``csrc/implicit.cu``), and its banded LU runs one thread a column, so the
# columns in flight on an SM (C times the blocks it holds) set how many of
# the serial solves overlap, and the blocks an SM holds how far one block's
# parallel steps hide another's solve.  Among the C of COLS whose tile fits
# a block, the rule takes the one that keeps the most SMs busy, then the
# most columns in flight an SM; among those, where every column is in
# flight at once (Schar's 1600), the smallest C (the most blocks), else the
# largest C that leaves an SM MIN_BLOCKS blocks.  On an NVIDIA H100 80GB
# HBM3 at 700 W its shape was the fastest of the 15 swept at the flagship's
# columns (f32 and f64) and at Schar's in f32, and within 4 % of it at
# Schar's in f64 (PERF.md section 6).
COLS = (4, 8, 16, 32)            # each divides THREADS
MIN_BLOCKS = 3
THREADS = 128
MAX_THREADS = 128              # csrc/implicit.cu takes at most this many
# registers a thread of the kernel takes, by value size (as `nvcc -Xptxas
# -v` reports them for sm_90a; `kernel_resources()` gives the build's own,
# and chip_smoke.py prints both)
REGISTERS = {4: 80, 8: 162}
ROW = 10                       # values of a stored W row: 2q+1 band, residual
LEVEL_ROW = 6                  # ... of a level row: 5 nonzeros, residual
NLEVEL, NINTERFACE = 11, 5     # level and interface values of the kernel
# the staged inputs: 10 level fields, 7 interface fields, c2; the
# pointers of the kernel's ``ptrs`` array they come from (rt0, w0, rho0 are
# staged with the time term only)
TIME_PTRS = (3, 4, 5)
STAGED_PTRS = tuple(range(18))


def implicit_smem_bytes(nz: int, cols: int, esize: int) -> int:
    """Dynamic shared memory of one block of ``cols`` columns, as
    ``csrc/implicit.cu`` lays it out (``smem_values``): a column's W rows
    (10 values each), its level rows (6 each) or the staged interface
    fields' share where that is more, each to twice an odd count of values,
    then the level and interface values.  (The stencil table is read
    through the read-only cache.)"""
    def pairs(n):        # twice an odd count of pairs
        return 2 * ((n + 1) // 2 | 1)

    staged = 7 * (nz + 1) + 4
    per_col = (pairs((nz + 1) * ROW) + pairs(max(2 * nz * LEVEL_ROW, staged))
               + NLEVEL * nz + NINTERFACE * (nz + 1))
    return esize * cols * per_col


@dataclasses.dataclass(frozen=True)
class ImplicitLaunch:
    """A launch shape of the implicit kernel: ``cols`` columns and
    ``threads`` threads a block, ``smem`` bytes of dynamic shared memory."""
    cols: int
    threads: int
    smem: int

    def blocks(self, ncol: int) -> int:
        return -(-ncol // self.cols)


def _esize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@functools.lru_cache(maxsize=None)
def implicit_launch_shape(nz: int, ncol: int, dtype, cols=None,
                          threads=None) -> ImplicitLaunch:
    """The implicit kernel's launch shape for ``ncol`` columns of ``nz``
    levels in ``dtype``.  ``cols`` and ``threads`` replace the rule's
    choice (``kernels/tune_fused.py``).  Raises ValueError where nothing
    fits."""
    esize = _esize(dtype)
    nth = THREADS if threads is None else int(threads)
    if not (32 <= nth <= MAX_THREADS and nth % 32 == 0):
        raise ValueError(f"{nth} threads: the kernel takes a multiple of 32 "
                         f"up to {MAX_THREADS}")
    best = None
    for C in (COLS if cols is None else (int(cols),)):
        if C < 1 or nth % C:
            raise ValueError(f"{C} columns a block: the kernel takes a "
                             f"divisor of its {nth} threads")
        nbytes = implicit_smem_bytes(nz, C, esize)
        per_sm = resident_blocks(nbytes, nth, REGISTERS[esize])
        if nbytes > SMEM_MAX or per_sm < 1:
            continue
        blocks = -(-max(ncol, 1) // C)
        inflight = min(C * min(per_sm, blocks / SMS), max(ncol, 1) / SMS)
        one_wave = blocks <= SMS * per_sm
        key = (min(blocks, SMS), round(inflight, 6), one_wave,
               -C if one_wave else (per_sm >= MIN_BLOCKS) * C)
        if best is None or key > best[0]:
            best = (key, ImplicitLaunch(C, nth, nbytes))
    if best is None:
        raise ValueError(f"no launch shape of the implicit kernel fits "
                         f"nz={nz} in {SMEM_MAX} bytes of shared memory")
    return best[1]


def copy_width(ncol: int, cols: int, esize: int, ptrs) -> int:
    """Values per asynchronous copy of the staging: 16 bytes where ncol,
    the tile's columns and every pointer of ``ptrs`` (ints) allow it, else
    8, else one value."""
    for nbytes in (16, 8):
        V = nbytes // esize
        if V >= 1 and ncol % V == 0 and cols % V == 0 \
                and all(p % nbytes == 0 for p in ptrs):
            return V
    return 1


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@dataclasses.dataclass
class PackedStatics:
    """Band-assembly statics packed into stackable arrays (host-side)."""
    q: int
    nz: int
    offs0: tuple
    offs_p1: tuple
    offs_m1: tuple
    ow: tuple
    has_penalty: bool
    TA: Any          # (n0, nz, nz+1)
    TB: Any          # (n0, nz+1, nz)
    DDb: Any         # (n0, nz+1, 1)
    Di2n_b: Any      # (nw, nz, 1)
    Dn2i_b: Any      # (nm1, nz+1, 1)
    In2i_b: Any      # (nw, nz+1, 1)
    Pl_b: Any        # (n0, nz, 1)
    Pr_b: Any        # (n0, nz, 1)
    Ul: Any          # (nw, nz, nfe-1)
    Ur: Any          # (nw, nz, nfe-1)


def pack_statics(statics, dtype=np.float32) -> PackedStatics:
    """``band_assembly_statics`` (numpy arrays or tensors) stacked per block
    offset, as numpy arrays of ``dtype``."""
    offs0 = tuple(statics["offs0"])
    offs_p1 = tuple(statics["offs_p1"])
    offs_m1 = tuple(statics["offs_m1"])
    ow = tuple(sorted(set(offs_p1) | set(offs_m1)))
    nz = statics["nz"]

    def stk(dic, offs, vec=False):
        out = np.stack([_np(dic[o]).astype(dtype) for o in offs])
        return out[..., None] if vec else out

    if statics["has_penalty"]:
        kw = dict(Pl_b=stk(statics["Pl_b"], offs0, vec=True),
                  Pr_b=stk(statics["Pr_b"], offs0, vec=True),
                  Ul=stk(statics["Ul"], ow), Ur=stk(statics["Ur"], ow))
    else:
        z_n = np.zeros((len(offs0), nz, 1), dtype)
        kw = dict(Pl_b=z_n, Pr_b=z_n,
                  Ul=np.zeros((len(ow), nz, 1), dtype),
                  Ur=np.zeros((len(ow), nz, 1), dtype))
    return PackedStatics(
        q=statics["q"], nz=nz, offs0=offs0, offs_p1=offs_p1,
        offs_m1=offs_m1, ow=ow, has_penalty=statics["has_penalty"],
        TA=stk(statics["TA"], offs0), TB=stk(statics["TB"], offs0),
        DDb=stk(statics["DDb"], offs0, vec=True),
        Di2n_b=stk(statics["Di2n_b"], ow, vec=True),
        Dn2i_b=stk(statics["Dn2i_b"], offs_m1, vec=True),
        In2i_b=stk(statics["In2i_b"], ow, vec=True),
        **kw)


def build_diag_table(ps: PackedStatics, mats, dtype):
    """``mats``: the vertical operator matrices by name (``MATS``).
    (vd, bmeta): every operator's diagonals in one (n_vecs, nz+1, 1)
    table plus ``{operator: [(offset, index into vd)]}``; (None, None) if
    any operator is wider than 6 diagonals."""
    nz = ps.nz
    # without the penalty (upwind_thermo=False, or a geometry that has
    # none) its operators are zero: the kernel's penalty terms then add
    # exact zeros
    zero = np.zeros((nz, nz))

    def pen(key):
        return mats[key] if ps.has_penalty else zero

    named = {
        "In2i": mats["interp_n2i"], "Ii2n": mats["interp_i2n"],
        "Dn2i": mats["diff_n2i"], "Di2n": mats["diff_i2n"],
        "DD": mats["diffdiff_i2i"],
        "Pl": pen("penalty_left"), "Pr": pen("penalty_right"),
        "Wl": pen("wscat_left"), "Wr": pen("wscat_right"),
    }
    i0 = {o: i for i, o in enumerate(ps.offs0)}
    iw = {o: i for i, o in enumerate(ps.ow)}
    for o in ps.offs0:
        named[f"TA{o}"] = ps.TA[i0[o]]
        named[f"TB{o}"] = ps.TB[i0[o]]
    for o in ps.ow:
        named[f"Ul{o}"] = ps.Ul[iw[o]] if ps.has_penalty else zero
        named[f"Ur{o}"] = ps.Ur[iw[o]] if ps.has_penalty else zero

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
    vd = np.stack(vecs).astype(dtype)[:, :, None]
    return vd, bmeta


def stencil_table(ps: PackedStatics, mats):
    """The (nz+1, NCOLS) float64 coefficient table of the kernel, or None
    for a configuration it does not cover: block offsets other than (-1,
    0, 1) (a half-bandwidth other than 4), or an operator with a nonzero
    outside its window.  Without penalty terms (``ps.has_penalty`` False)
    their columns are zero."""
    if not (ps.q == 4
            and ps.offs0 == ps.offs_p1 == ps.offs_m1 == ps.ow == OFFS):
        return None
    vd, bmeta = build_diag_table(ps, mats, np.float64)
    if bmeta is None:
        return None
    diags = {name: [(o, vd[i, :, 0]) for o, i in bmeta[name]]
             for name, _ in LAYOUT}
    table = stencils.pack(LAYOUT, diags, ps.nz + 1)
    if table is None:
        return None
    # the (rt, w) and (rho, w) entries at block offset -1 would read the
    # interface below the kernel's two-interface window: they must vanish
    iw = {o: i for i, o in enumerate(ps.ow)}
    if np.any(ps.Di2n_b[iw[-1]]):
        return None
    bands = []
    for name, offs in BAND_COLUMNS:
        arr = getattr(ps, name)
        for o in offs:
            vec = np.asarray(arr[OFFS.index(o)], np.float64)[:, 0]
            bands.append(np.pad(vec, (0, ps.nz + 1 - vec.shape[0])))
    return np.concatenate([table, np.stack(bands, axis=1)], axis=1)


@dataclasses.dataclass
class ImplicitStatics:
    """What ``fused_implicit_update`` needs beside the state, built once
    per configuration (``implicit_statics``)."""
    ps: PackedStatics
    tab: Any          # (nz+1, NCOLS) tensor, or None when not supported
    fg: Any           # the geometry and the device form of
    statics: Any      # ``band_assembly_statics``: the plain version's inputs


def implicit_statics(statics, fg) -> ImplicitStatics:
    """Pack ``band_assembly_statics`` (its device form, see
    ``implicit.statics_to_device``) for the kernel, on the device and in
    the dtype of ``fg``.  ``tab`` is None for a configuration outside the
    kernel's envelope (``fused_supported``)."""
    dtype, dev = fg.inv_mult.dtype, fg.inv_mult.device
    npdt = np.float32 if dtype == torch.float32 else np.float64
    ps = pack_statics(statics, dtype=np.float64)
    table = None
    if fg.vo == 1:
        table = stencil_table(ps, {k: getattr(fg, k) for k in MATS})
    tab = None if table is None else torch.as_tensor(
        np.ascontiguousarray(table, dtype=npdt), device=dev)
    return ImplicitStatics(ps=ps, tab=tab, fg=fg, statics=statics)


def fused_supported(ist: ImplicitStatics) -> bool:
    """Whether the fused update covers the configuration: vertical order 1
    (with or without the penalty terms), half-bandwidth 4, every operator
    inside the kernel's
    windows, at least 2 levels, and the smallest tile of ``COLS`` at
    ``nz`` levels in the statics' dtype fits an H100 block.  A statement
    about the configuration only."""
    if ist.tab is None or ist.ps.nz < 2:
        return False
    return implicit_smem_bytes(ist.ps.nz, min(COLS),
                               _esize(ist.tab.dtype)) <= SMEM_MAX


def fused_implicit_update_plain(x_parts, x0_parts, aux, ist, dt, constants,
                                ref_jacobian=False, newton_time_term=False):
    """Plain PyTorch version of ``fused_implicit_update`` (same arguments
    and results): the residual, the band tensor, the banded solve."""
    from . import implicit as fimp
    from ..models.vertical_banded import banded_solve_t
    fg = ist.fg
    nz = fg.nz
    if "u_i" not in aux:
        aux = dict(aux, **fimp.interface_aux(aux["u_n"], aux["v_n"], fg))
    # without the time term the residual is evaluated at x0 = x
    f = fimp.residual_lor(x_parts, x0_parts if newton_time_term else x_parts,
                          aux, fg, constants, dt,
                          penalty=ist.ps.has_penalty)
    bands = fimp.assemble_bands(x_parts, aux, fg, ist.statics, constants, dt,
                                ref_jacobian=ref_jacobian)
    dx = banded_solve_t(bands, fimp._interleave(*f, nz), ist.ps.q)
    return fimp._deinterleave(dx, nz)


def _check_cols(name, t, rows, ref):
    if tuple(t.shape) != (rows, ref.shape[1]) or t.dtype != ref.dtype \
            or t.device != ref.device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({rows}, ncol) tensor "
                         f"of the state's dtype and device")


def fused_implicit_update(x_parts, x0_parts, aux, ist: ImplicitStatics, dt,
                          constants, ref_jacobian=False,
                          newton_time_term=False):
    """Newton increment ``(d_rt, d_w, d_rho) = J^{-1} F`` for every column;
    one kernel launch.

    ``x_parts`` / ``x0_parts``: ``(rt, w, rho)`` of shapes ``(nz | nz+1,
    ncol)``; ``aux``: the column-flattened velocity and metric tensors
    (``AUX_FIELDS`` and ``c2``, as ``implicit._prep_aux`` makes them);
    ``ist``: ``implicit_statics(...)``.  ``newton_time_term`` adds
    ``(x - x0) / dt`` to the residual (Newton iterations after the
    first)."""
    rt, w, rho = x_parts
    nz = ist.ps.nz
    if rt.dim() != 2 or rt.dtype not in (torch.float32, torch.float64):
        raise ValueError("rt must be a float32/float64 (nz, ncol) tensor")
    for name, t, rows in (("rt", rt, nz), ("w", w, nz + 1), ("rho", rho, nz),
                          ("rt0", x0_parts[0], nz),
                          ("w0", x0_parts[1], nz + 1),
                          ("rho0", x0_parts[2], nz)):
        _check_cols(name, t, rows, rt)
    for k in AUX_FIELDS:
        _check_cols(k, aux[k], nz + 1 if k.endswith("_int") else nz, rt)
    _check_cols("c2", aux["c2"], 4, rt)
    if rt.device.type == "cpu":
        return fused_implicit_update_plain(
            x_parts, x0_parts, aux, ist, dt, constants, ref_jacobian,
            newton_time_term)
    if rt.device.type != "cuda":
        raise ValueError(f"unsupported device {rt.device}")
    if ist.tab is None:
        raise NotImplementedError(
            "configuration outside the fused implicit update's envelope "
            "(see fused_supported)")
    if ist.tab.dtype != rt.dtype or ist.tab.device != rt.device:
        raise ValueError("statics and state differ in dtype or device")
    return _fused_implicit_cuda(x_parts, x0_parts, aux, ist, dt, constants,
                                ref_jacobian, newton_time_term)


def _launch_plan(x_parts, x0_parts, aux, ist, newton_time_term,
                 launch: ImplicitLaunch = None):
    """(tensors of the kernel's ``ptrs`` without the outputs, launch shape,
    copy width) of one launch."""
    rt = x_parts[0]
    nz, ncol = rt.shape
    tensors = ([*x_parts, *x0_parts] + [aux[k] for k in AUX_FIELDS]
               + [aux["c2"], ist.tab])
    if launch is None:
        launch = implicit_launch_shape(nz, ncol, rt.dtype)
    staged = [tensors[i].data_ptr() for i in STAGED_PTRS
              if newton_time_term or i not in TIME_PTRS]
    V = copy_width(ncol, launch.cols, rt.element_size(), staged)
    return tensors, launch, V


def launch_config(x_parts, x0_parts, aux, ist, newton_time_term=False,
                  launch: ImplicitLaunch = None) -> dict:
    """What one launch of the kernel on these inputs would be: columns and
    threads a block, blocks, copy width and route, shared memory (for the
    report lines of ``chip_smoke.py``)."""
    _, sh, V = _launch_plan(x_parts, x0_parts, aux, ist, newton_time_term,
                            launch)
    nbytes = V * x_parts[0].element_size()
    return {"cols_per_block": sh.cols, "threads": sh.threads,
            "blocks": sh.blocks(x_parts[0].shape[1]),
            "copy_bytes": nbytes,
            "copy_route": f"cp.async.{'cg' if nbytes == 16 else 'ca'} "
                          f"{nbytes} B",
            "smem_bytes": sh.smem}


_ENTRY = re.compile(r"fused_implicit_kernelI([fd])Li(\d+)E")


def kernel_resources() -> dict:
    """Registers and spill bytes of the kernel's instantiations (one per
    value type and copy width) as ``nvcc -Xptxas -v`` reported them at the
    build, keyed ``f32/16B``, ``f32/8B``, ... (empty before a build)."""
    out = {}
    for name, use in build.ptxas_usage("implicit").items():
        m = _ENTRY.search(name)
        if m:
            esize = 4 if m.group(1) == "f" else 8
            out[f"f{8 * esize}/{int(m.group(2)) * esize}B"] = use
    return out


def _fused_implicit_cuda(x_parts, x0_parts, aux, ist, dt, constants,
                         ref_jacobian, newton_time_term,
                         launch: ImplicitLaunch = None):
    """Launch the kernel; ``launch``: a launch shape in place of
    ``implicit_launch_shape``'s."""
    rt, w, rho = x_parts
    nz, ncol = rt.shape
    c = constants
    lib = build.library("implicit")
    fn = lib.fused_implicit_f32 if rt.dtype == torch.float32 \
        else lib.fused_implicit_f64
    tensors, sh, V = _launch_plan(x_parts, x0_parts, aux, ist,
                                  newton_time_term, launch)
    with torch.cuda.device(rt.device):
        outs = (torch.empty_like(rt), torch.empty_like(w),
                torch.empty_like(rho))
        ptrs = (ctypes.c_void_p * (len(tensors) + 3))(
            *[t.data_ptr() for t in tensors + list(outs)])
        scal = (ctypes.c_double * 6)(
            1.0 / float(dt), float(c.Cp), float(c.Rd / (c.Cp - c.Rd)),
            float(c.Rd / c.P0), float(c.g), 0.5 / nz)
        ints = (ctypes.c_int * 7)(nz, int(bool(ref_jacobian)),
                                  int(bool(newton_time_term)), ist.ps.q,
                                  sh.cols, sh.threads, V)
        err = fn(ptrs, scal, ints, ncol,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_implicit_update kernel launch failed "
                           f"(cudaGetLastError = {err})")
    launch_counts["fused_implicit_update"] += 1
    return outs
