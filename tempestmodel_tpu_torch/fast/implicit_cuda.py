"""HEVI implicit Newton update in one kernel: the CUDA kernel's wrapper and
its plain version.

Counterpart of the JAX package's ``fast/pallas_implicit.py``
(``fused_implicit_update``).  Per column, one launch computes the aux
terms, the residual F of (Rt, W, Rho), the analytic banded Jacobian (exact
or reference mode) and a no-pivot banded LU solve, and returns the Newton
increment ``(d_rt, d_w, d_rho) = J^{-1} F``.  The ``(n, 2q+1, ncol)`` band
tensor of the unfused path never reaches device memory.

The kernel (``csrc/implicit.cu``) runs one thread per column and streams
the rows of the system; see the note there for its design and its bound on
the card.  ``fused_implicit_update`` launches it for CUDA tensors — or
raises — and runs ``fused_implicit_update_plain`` only for tensors that
lie on the CPU.

``PackedStatics`` / ``pack_statics`` / ``build_diag_table`` are the JAX
module's host-side packing of ``band_assembly_statics`` without its sublane
fold (which exists for the TPU's tiles); ``stencil_table`` turns them into
the fixed-window coefficient table the kernel reads.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels import build, stencils
from ..kernels.counts import launch_counts

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
    named = {
        "In2i": mats["interp_n2i"], "Ii2n": mats["interp_i2n"],
        "Dn2i": mats["diff_n2i"], "Di2n": mats["diff_i2n"],
        "DD": mats["diffdiff_i2i"],
        "Pl": mats["penalty_left"], "Pr": mats["penalty_right"],
        "Wl": mats["wscat_left"], "Wr": mats["wscat_right"],
    }
    i0 = {o: i for i, o in enumerate(ps.offs0)}
    iw = {o: i for i, o in enumerate(ps.ow)}
    for o in ps.offs0:
        named[f"TA{o}"] = ps.TA[i0[o]]
        named[f"TB{o}"] = ps.TB[i0[o]]
    if ps.has_penalty:
        for o in ps.ow:
            named[f"Ul{o}"] = ps.Ul[iw[o]]
            named[f"Ur{o}"] = ps.Ur[iw[o]]

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
    for a configuration it does not cover: no penalty terms, block offsets
    other than (-1, 0, 1) (a half-bandwidth other than 4), or an operator
    with a nonzero outside its window."""
    if not (ps.has_penalty and ps.q == 4
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
    if fg.vo == 1 and statics["has_penalty"]:
        table = stencil_table(ps, {k: getattr(fg, k) for k in MATS})
    tab = None if table is None else torch.as_tensor(
        np.ascontiguousarray(table, dtype=npdt), device=dev)
    return ImplicitStatics(ps=ps, tab=tab, fg=fg, statics=statics)


def fused_supported(ist: ImplicitStatics) -> bool:
    """Whether the fused update covers the configuration: vertical order 1
    with penalty terms, half-bandwidth 4, every operator inside the kernel's
    windows.  A statement about the configuration only."""
    return ist.tab is not None


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
                          aux, fg, constants, dt)
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


def _fused_implicit_cuda(x_parts, x0_parts, aux, ist, dt, constants,
                         ref_jacobian, newton_time_term):
    rt, w, rho = x_parts
    nz, ncol = rt.shape
    c = constants
    q = ist.ps.q
    lib = build.library("implicit")
    fn = lib.fused_implicit_f32 if rt.dtype == torch.float32 \
        else lib.fused_implicit_f64
    with torch.cuda.device(rt.device):
        d_rt, d_w, d_rho = (torch.empty_like(rt), torch.empty_like(w),
                            torch.empty_like(rho))
        # scratch of the kernel: the U-factor rows
        ufac = torch.empty((3 * nz + 1, q + 1, ncol), dtype=rt.dtype,
                           device=rt.device)
        tensors = ([rt, w, rho, *x0_parts]
                   + [aux[k] for k in AUX_FIELDS]
                   + [aux["c2"], ist.tab, d_rt, d_w, d_rho, ufac])
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[t.data_ptr() for t in tensors])
        scal = (ctypes.c_double * 6)(
            1.0 / float(dt), float(c.Cp), float(c.Rd / (c.Cp - c.Rd)),
            float(c.Rd / c.P0), float(c.g), 0.5 / nz)
        ints = (ctypes.c_int * 4)(nz, int(bool(ref_jacobian)),
                                  int(bool(newton_time_term)), q)
        err = fn(ptrs, scal, ints, ncol,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_implicit_update kernel launch failed "
                           f"(cudaGetLastError = {err})")
    launch_counts["fused_implicit_update"] += 1
    return d_rt, d_w, d_rho
