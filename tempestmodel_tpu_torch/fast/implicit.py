"""Channel-stacked HEVI vertical implicit solve.

Counterpart of the JAX package's ``fast/implicit.py``: the column
residual, the analytic banded Jacobian and the Newton update in the
leading-channel layout.  ``vertical_implicit`` has two branches, chosen by
a predicate on the configuration.  The fused one hands each Newton
iteration to the hand-written kernel of ``implicit_cuda`` (residual,
Jacobian and banded LU in one launch; the band tensor never exists).  In
the unfused one every column operator application is a clean ``(K, nz) @
(nz, ncol)`` GEMM, the Newton system interleave is a reshape (not a
gather), and the banded solve is the hand-written kernel of
``ops/cuda_banded`` — its ``(n, 2q+1, ncol)`` layout is native here.
The JAX package's other column solvers (``vertical_solver`` ``"dense"``,
``"schur"``, ``"jfnk"``) take the same exact bands: a batched dense LU,
the Schur elimination of W (``models/vertical_schur``, its reduced system
through the banded kernel), restarted GMRES with a band product for J·v
(``models/jfnk``).

The CPH, LEV and INT staggerings (Rt and W on interfaces; every field on
levels, at the LEV or the INT column operators) have residuals of their own
(``residual_cph``, ``residual_lev``) and are always solved densely, as in
the JAX package (``nonhydro.vertical_implicit`` turns every solver into
``"dense"`` for them): the exact Jacobian assembled from the column
operators (``dense_jacobian``) and a batched dense LU (``stagger_newton``).

Semantics (including the ``ref_jacobian`` reference-Jacobian mode and the
AD-subgradient sign conventions) match the JAX package's.  Where that code
writes ``x.at[0].set(0.0).at[-1].set(0.0)``, this one multiplies by a 0/1
row mask or writes in place on a fresh tensor (``_zero_ends``), never on
an argument.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.nonhydro import exner_from_rhotheta, infer_stagger, _zero_ends
from ..models.vertical_banded import banded_solve_t
from ..ops.cuda_banded import banded_solve
from . import implicit_cuda
from .engine import FastGeometry, SOLVERS


def statics_to_device(statics, dtype, device):
    """``band_assembly_statics`` with every numpy table turned ONCE into a
    tensor of ``dtype`` on ``device`` (the assembly would otherwise copy
    each small table to the device on every call)."""
    def conv(v):
        if isinstance(v, np.ndarray):
            return torch.as_tensor(v, dtype=dtype, device=device)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v
    return {k: conv(v) for k, v in statics.items()}


def static_aux(fg: FastGeometry):
    """The state-independent flattened-metric entries of the implicit
    aux dict.  Precompute ONCE per configuration (engine factories call
    this at build time); the entries are views of the geometry tensors."""
    def fl(f):
        return f.reshape(f.shape[0], -1)

    c2 = torch.stack([fg.c2_aa.reshape(-1), fg.c2_ab.reshape(-1),
                    fg.c2_ba.reshape(-1), fg.c2_bb.reshape(-1)])
    return {
        "c2": c2,
        "con_a_xi": fl(fg.con_a_xi), "con_b_xi": fl(fg.con_b_xi),
        "con_xi_xi": fl(fg.con_xi_xi),
        "con_a_xi_int": fl(fg.con_a_xi_int),
        "con_b_xi_int": fl(fg.con_b_xi_int),
        "con_xi_xi_int": fl(fg.con_xi_xi_int),
        "jac": fl(fg.jac3d), "jac_int": fl(fg.jac3d_int),
        "deriv_r_int": fl(fg.deriv_r_xi_int),
        # dz/dxi on levels (the LEV residual's gravity): the 3-D Jacobian
        # over the 2-D one in both vertical coordinates (to rounding on the
        # sphere, exactly on the plane)
        "deriv_r_n": fl(fg.jac3d / fg.jac2d[None]),
    }


def interface_aux(u_n, v_n, fg: FastGeometry):
    """Interface interpolants and derivatives of the column velocities."""
    ni = fg.interp_n2i.shape[0]
    big_u = fg.n2i_stack @ u_n        # one GEMM: [interp_n2i; diff_n2i]
    big_v = fg.n2i_stack @ v_n
    return {"u_i": big_u[:ni], "v_i": big_v[:ni],
            "du_i": big_u[ni:], "dv_i": big_v[ni:]}


def _prep_aux(d, fg: FastGeometry, saux=None, interfaces: bool = True,
              levels: bool = False):
    """Fixed per-column inputs of the implicit system, (rows, ncol).
    ``interfaces=False`` leaves out the interface interpolants of U, V
    (the fused kernel takes them itself); ``levels`` adds their vertical
    derivatives on levels (``du_n``, ``dv_n``: the LEV residual's curl)."""
    U = d["U"]
    Q = U.shape[1] * U.shape[2] * U.shape[3]

    def fl(f):
        return f.reshape(f.shape[0], Q)

    u_n = fl(U)
    v_n = fl(d["V"])
    if saux is None:
        saux = static_aux(fg)
    aux = dict(saux, u_n=u_n, v_n=v_n)
    if interfaces:
        aux.update(interface_aux(u_n, v_n, fg))
    if levels:
        aux["du_n"] = fg.diff_n2n @ u_n
        aux["dv_n"] = fg.diff_n2n @ v_n
    x_parts = (fl(d["Rt"]), fl(d["W"]), fl(d["Rho"]))
    return x_parts, aux


def residual_lor(x_parts, x0_parts, aux, fg: FastGeometry, constants, dt,
                 penalty: bool = True):
    """(f_rt, f_w, f_rho) of the HEVI column residual, batched over
    columns with the level axis leading.  Port of
    ``nonhydro._column_residual``; the time term uses x0 explicitly so
    multi-iteration Newton works (``dt = math.inf`` drops it: the explicit
    vertical tendency is minus that residual).  ``penalty=False`` leaves
    out the Rt/Rho upwind penalty (``upwind_thermo=False``; the explicit
    U/V upwinding and the W interface upwinding are other terms)."""
    nz = fg.nz
    rt, w, rho = x_parts
    rt0, w0, rho0 = x0_parts
    c = constants

    w_n = fg.interp_i2n @ w
    rho_i = fg.interp_n2i @ rho
    rt_i = fg.interp_n2i @ rt

    exner_n = exner_from_rhotheta(rt, c)
    dpi_i = fg.diff_n2i @ exner_n

    xid_n = (aux["con_a_xi"] * aux["u_n"] + aux["con_b_xi"] * aux["v_n"]
             + aux["con_xi_xi"] * w_n)
    xid_i = (aux["con_a_xi_int"] * aux["u_i"]
             + aux["con_b_xi_int"] * aux["v_i"]
             + aux["con_xi_xi_int"] * w)
    xid_i = _zero_ends(xid_i)

    mf_i = aux["jac_int"] * rho_i * xid_i
    mf_i = _zero_ends(mf_i)
    f_rho = (fg.diff_i2n @ mf_i) / aux["jac"]

    pf_i = aux["jac_int"] * rt_i * xid_i
    pf_i = _zero_ends(pf_i)
    f_rt = (fg.diff_i2n @ pf_i) / aux["jac"]

    con_ua_n = (fg.c2_aa.reshape(1, -1) * aux["u_n"]
                + fg.c2_ab.reshape(1, -1) * aux["v_n"]
                + aux["con_a_xi"] * w_n)
    con_ub_n = (fg.c2_ba.reshape(1, -1) * aux["u_n"]
                + fg.c2_bb.reshape(1, -1) * aux["v_n"]
                + aux["con_b_xi"] * w_n)
    ke_n = 0.5 * (con_ua_n * aux["u_n"] + con_ub_n * aux["v_n"]
                  + xid_n * w_n)
    dke_i = fg.diff_n2i @ ke_n

    con_ua_i = (fg.c2_aa.reshape(1, -1) * aux["u_i"]
                + fg.c2_ab.reshape(1, -1) * aux["v_i"]
                + aux["con_a_xi_int"] * w)
    con_ub_i = (fg.c2_ba.reshape(1, -1) * aux["u_i"]
                + fg.c2_bb.reshape(1, -1) * aux["v_i"]
                + aux["con_b_xi_int"] * w)
    curl = -con_ua_i * aux["du_i"] - con_ub_i * aux["dv_i"]

    pgf = dpi_i * rt_i / rho_i
    f_w = pgf + constants.g * aux["deriv_r_int"] + dke_i + curl
    f_w = _zero_ends(f_w)

    vo = fg.vo
    if penalty and fg.penalty_left is not None and nz // vo > 1:
        wb = torch.abs(xid_i[vo:nz:vo])
        wl = fg.wscat_left @ wb
        wr = fg.wscat_right @ wb
        f_rt = f_rt - (fg.penalty_left @ rt) * wl \
            - (fg.penalty_right @ rt) * wr
        f_rho = f_rho - (fg.penalty_left @ rho) * wl \
            - (fg.penalty_right @ rho) * wr
    ddw = fg.diffdiff_i2i @ w
    ddw = _zero_ends(ddw)
    upwind_coeff = 0.5 / nz
    f_w = f_w - upwind_coeff * torch.abs(xid_i) * ddw
    f_w = _zero_ends(f_w)

    inv_dt = 1.0 / dt
    return (f_rt + (rt - rt0) * inv_dt,
            f_w + (w - w0) * inv_dt,
            f_rho + (rho - rho0) * inv_dt)


def _c2(fg: FastGeometry):
    """The 2-D contravariant metric as (1, ncol) rows: aa, ab, ba, bb."""
    return tuple(m.reshape(1, -1) for m in (fg.c2_aa, fg.c2_ab, fg.c2_ba,
                                            fg.c2_bb))


def residual_cph(x_parts, x0_parts, aux, fg: FastGeometry, constants, dt,
                 penalty: bool = True):
    """(f_rt, f_w, f_rho) of the Charney-Phillips column residual: Rt and W
    on the nz + 1 interfaces, Rho on levels; batched over columns with the
    level axis leading.  Port of ``nonhydro._column_residual_cph``: the
    Exner gradient differentiated interface to interface, the RhoTheta
    flux divergence conservative on interfaces, Rt and W upwinded by the
    interface second derivative; ``penalty`` switches the Rho penalty (the
    only level field).  ``dt = math.inf`` drops the time term."""
    nz = fg.nz
    rt, w, rho = x_parts
    rt0, w0, rho0 = x0_parts
    c2aa, c2ab, c2ba, c2bb = _c2(fg)
    u_n, v_n, u_i, v_i = aux["u_n"], aux["v_n"], aux["u_i"], aux["v_i"]

    w_n = fg.interp_i2n @ w
    rho_i = fg.interp_n2i @ rho
    dpi_i = fg.diff_i2i @ exner_from_rhotheta(rt, constants)

    xid_n = (aux["con_a_xi"] * u_n + aux["con_b_xi"] * v_n
             + aux["con_xi_xi"] * w_n)
    xid_i = _zero_ends(aux["con_a_xi_int"] * u_i + aux["con_b_xi_int"] * v_i
                       + aux["con_xi_xi_int"] * w)

    mf_i = _zero_ends(aux["jac_int"] * rho_i * xid_i)
    f_rho = (fg.diff_i2n @ mf_i) / aux["jac"]
    f_rt = (fg.diff_i2i @ (aux["jac_int"] * rt * xid_i)) / aux["jac_int"]

    con_ua_n = c2aa * u_n + c2ab * v_n + aux["con_a_xi"] * w_n
    con_ub_n = c2ba * u_n + c2bb * v_n + aux["con_b_xi"] * w_n
    dke_i = fg.diff_n2i @ (0.5 * (con_ua_n * u_n + con_ub_n * v_n
                                  + xid_n * w_n))
    con_ua_i = c2aa * u_i + c2ab * v_i + aux["con_a_xi_int"] * w
    con_ub_i = c2ba * u_i + c2bb * v_i + aux["con_b_xi_int"] * w
    curl = -con_ua_i * aux["du_i"] - con_ub_i * aux["dv_i"]

    f_w = _zero_ends(dpi_i * rt / rho_i + constants.g * aux["deriv_r_int"]
                     + dke_i + curl)
    vo = fg.vo
    if penalty and fg.penalty_left is not None and nz // vo > 1:
        wb = torch.abs(xid_i[vo:nz:vo])
        f_rho = f_rho - (fg.penalty_left @ rho) * (fg.wscat_left @ wb) \
            - (fg.penalty_right @ rho) * (fg.wscat_right @ wb)
    upwind_coeff = 0.5 / nz
    ddw = _zero_ends(fg.diffdiff_i2i @ w)
    f_w = _zero_ends(f_w - upwind_coeff * torch.abs(xid_i) * ddw)
    f_rt = f_rt - upwind_coeff * torch.abs(xid_i) * (fg.diffdiff_i2i @ rt)

    inv_dt = 1.0 / dt
    return (f_rt + (rt - rt0) * inv_dt,
            f_w + (w - w0) * inv_dt,
            f_rho + (rho - rho0) * inv_dt)


def residual_lev(x_parts, x0_parts, aux, fg: FastGeometry, constants, dt,
                 penalty: bool = True):
    """(f_rt, f_w, f_rho) of the column residual with every field on the
    nz levels (LEV, and INT at its own column operators); batched over
    columns with the level axis leading.  Port of
    ``nonhydro._column_residual_lev``: mass and RhoTheta fluxes on levels,
    W's boundary levels held by zero rows; ``penalty`` switches the upwind
    penalty of all three fields (W's too: the JAX package drops the whole
    block with ``upwind_thermo=False``).  ``dt = math.inf`` drops the time
    term."""
    nz = fg.nz
    rt, w, rho = x_parts
    rt0, w0, rho0 = x0_parts
    c2aa, c2ab, c2ba, c2bb = _c2(fg)
    u_n, v_n = aux["u_n"], aux["v_n"]
    jac = aux["jac"]

    dpi_n = fg.diff_n2n @ exner_from_rhotheta(rt, constants)
    xid_n = (aux["con_a_xi"] * u_n + aux["con_b_xi"] * v_n
             + aux["con_xi_xi"] * w)
    f_rho = (fg.diff_n2n @ (jac * rho * xid_n)) / jac
    f_rt = (fg.diff_n2n @ (jac * rt * xid_n)) / jac

    con_ua_n = c2aa * u_n + c2ab * v_n + aux["con_a_xi"] * w
    con_ub_n = c2ba * u_n + c2bb * v_n + aux["con_b_xi"] * w
    dke_n = fg.diff_n2n @ (0.5 * (con_ua_n * u_n + con_ub_n * v_n
                                  + xid_n * w))
    curl = -con_ua_n * aux["du_n"] - con_ub_n * aux["dv_n"]
    f_w = _zero_ends(dpi_n * rt / rho + constants.g * aux["deriv_r_n"]
                     + dke_n + curl)

    vo = fg.vo
    if penalty and fg.penalty_left is not None and nz // vo > 1:
        xid_i = (aux["con_xi_xi_int"] * (fg.interp_n2i @ w)
                 + aux["con_a_xi_int"] * aux["u_i"]
                 + aux["con_b_xi_int"] * aux["v_i"])
        wb = torch.abs(xid_i[vo:nz:vo])
        wl = fg.wscat_left @ wb
        wr = fg.wscat_right @ wb
        f_rt = f_rt - (fg.penalty_left @ rt) * wl \
            - (fg.penalty_right @ rt) * wr
        f_rho = f_rho - (fg.penalty_left @ rho) * wl \
            - (fg.penalty_right @ rho) * wr
        f_w = _zero_ends(f_w - (fg.penalty_left @ w) * wl
                         - (fg.penalty_right @ w) * wr)

    inv_dt = 1.0 / dt
    return (f_rt + (rt - rt0) * inv_dt,
            f_w + (w - w0) * inv_dt,
            f_rho + (rho - rho0) * inv_dt)


RESIDUALS = {"LOR": residual_lor, "CPH": residual_cph, "LEV": residual_lev}


def vertical_explicit_tendency(d, fg: FastGeometry, constants, saux=None):
    """The fully explicit vertical tendencies ``{"Rt", "W", "Rho"}`` of a
    z-first state in any staggering: minus the column residual with no time
    term (the JAX package's ``nonhydro.vertical_explicit_tendency``, the
    reference's ``VerticalDynamicsFEM::StepExplicit`` with
    ``m_fFullyExplicit``).  The upwind penalty is in, whatever
    ``upwind_thermo`` says, as there.  ``saux``: precomputed
    ``static_aux(fg)``."""
    stagger = infer_stagger(d, fg.nz, axis=0)
    x, aux = _prep_aux(d, fg, saux, levels=stagger == "LEV")
    f = RESIDUALS[stagger](x, x, aux, fg, constants, math.inf)
    shp = tuple(d["U"].shape[1:])
    return {k: -v.reshape((v.shape[0],) + shp)
            for k, v in zip(("Rt", "W", "Rho"), f)}


def _shift_rows(b, o, K):
    """out[k] = b[k + o] for k in [0, K), zero out of range."""
    L = b.shape[0]
    k0, k1 = max(0, -o), min(K, L - o)
    out = b.new_zeros((K,) + tuple(b.shape[1:]))
    if k1 > k0:
        out[k0:k1] = b[k0 + o:k1 + o]
    return out


def assemble_bands(x_parts, aux, fg: FastGeometry, statics, constants, dt,
                   ref_jacobian: bool = False):
    """Banded Jacobian (n, 2q+1, ncol) of the column residual.

    Port of ``nonhydro.assemble_bands_analytic`` (same static tensors from
    ``band_assembly_statics``; same exact/reference Jacobian modes), built
    with leading-row GEMMs and finishing with reshapes instead of the
    (2, 0, 1) transposes of the trailing-column layout.
    """
    c = constants
    nz = fg.nz
    q = statics["q"]
    b = 2 * q + 1
    rt0, w0, rho0 = x_parts
    ncol = rt0.shape[1]
    dtype = rt0.dtype
    dev = rt0.device

    w_n0 = fg.interp_i2n @ w0
    rho_i0 = fg.interp_n2i @ rho0
    rt_i0 = fg.interp_n2i @ rt0
    pi_n0 = exner_from_rhotheta(rt0, c)
    dpi_drt = (c.Rd / (c.Cp - c.Rd)) * pi_n0 / rt0
    dpi_i0 = fg.diff_n2i @ pi_n0
    cXi = aux["con_xi_xi_int"]
    xid_n0 = (aux["con_a_xi"] * aux["u_n"] + aux["con_b_xi"] * aux["v_n"]
              + aux["con_xi_xi"] * w_n0)
    xid_i0 = (aux["con_a_xi_int"] * aux["u_i"]
              + aux["con_b_xi_int"] * aux["v_i"] + cXi * w0)
    mask = torch.ones((nz + 1, 1), dtype=dtype, device=dev)
    mask[0] = 0.0
    mask[-1] = 0.0
    xid_i0 = xid_i0 * mask
    jac_i = aux["jac_int"]
    inv_jac = 1.0 / aux["jac"]
    curl_coef = -(aux["con_a_xi_int"] * aux["du_i"]
                  + aux["con_b_xi_int"] * aux["dv_i"])
    ddw0 = (fg.diffdiff_i2i @ w0) * mask
    upw_c = 0.5 / nz
    if ref_jacobian:
        sgn_xid = torch.sign(xid_i0)
    else:
        sgn_xid = torch.where(xid_i0 >= 0, 1.0, -1.0).to(dtype)

    d1 = jac_i * xid_i0
    e_rt = jac_i * rt_i0 * cXi * mask
    e_rho = jac_i * rho_i0 * cXi * mask
    inv_rho_i = 1.0 / rho_i0
    r1 = rt_i0 * inv_rho_i
    r2 = dpi_i0 * inv_rho_i
    r3 = -dpi_i0 * rt_i0 * inv_rho_i * inv_rho_i

    has_pen = statics["has_penalty"]
    if has_pen:
        vo = statics["vo"]
        edge_sl = slice(vo, nz, vo)
        wb0 = torch.abs(xid_i0[edge_sl])
        wl0 = fg.wscat_left @ wb0
        wr0 = fg.wscat_right @ wb0
        lrt0 = fg.penalty_left @ rt0
        rrt0 = fg.penalty_right @ rt0
        lrho0 = fg.penalty_left @ rho0
        rrho0 = fg.penalty_right @ rho0
        if ref_jacobian:
            sgn_edge = torch.sign(xid_i0[edge_sl]) * cXi[edge_sl]
        else:
            sgn_edge = torch.where(xid_i0[edge_sl] >= 0, 1.0, -1.0).to(
                dtype) * cXi[edge_sl]

    def npa(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def col(vec):
        """(K,) static band vector -> (K, 1) broadcaster."""
        return npa(vec)[:, None]

    zrow_n = torch.zeros((nz, ncol), dtype=dtype, device=dev)
    zrow_i = torch.zeros((nz + 1, ncol), dtype=dtype, device=dev)
    rt_slots = [zrow_n] * b
    rho_slots = [zrow_n] * b
    w_slots = [zrow_i] * b

    # (rt,rt) and (rho,rho)
    for o in statics["offs0"]:
        d = q + 3 * o
        val = inv_jac * (npa(statics["TA"][o]) @ d1)
        if has_pen:
            val = val - wl0 * col(statics["Pl_b"][o]) \
                - wr0 * col(statics["Pr_b"][o])
        if o == 0:
            val = val + 1.0 / dt
        rt_slots[d] = rt_slots[d] + val
        rho_slots[d] = rho_slots[d] + val

    # (rt,w): delta = +1
    for o in statics["offs_p1"]:
        d = q + 3 * o + 1
        v_rt = inv_jac * col(statics["Di2n_b"][o]) * _shift_rows(e_rt, o, nz)
        if has_pen:
            v_rt = v_rt - lrt0 * (npa(statics["Ul"][o]) @ sgn_edge) \
                - rrt0 * (npa(statics["Ur"][o]) @ sgn_edge)
        rt_slots[d] = rt_slots[d] + v_rt

    # (rho,w): delta = -1
    for o in statics["offs_m1"]:
        d = q + 3 * o - 1
        v_rho = inv_jac * col(statics["Di2n_b"][o]) \
            * _shift_rows(e_rho, o, nz)
        if has_pen:
            v_rho = v_rho - lrho0 * (npa(statics["Ul"][o]) @ sgn_edge) \
                - rrho0 * (npa(statics["Ur"][o]) @ sgn_edge)
        rho_slots[d] = rho_slots[d] + v_rho

    # (w,rt): delta = -1
    for o in statics["offs_m1"]:
        d = q + 3 * o - 1
        v = mask * (r1 * col(statics["Dn2i_b"][o])
                    * _shift_rows(dpi_drt, o, nz + 1)
                    + r2 * col(statics["In2i_b"][o]))
        w_slots[d] = w_slots[d] + v

    # (w,rho): delta = +1
    for o in statics["offs_p1"]:
        d = q + 3 * o + 1
        v2 = mask * r3 * col(statics["In2i_b"][o])
        w_slots[d] = w_slots[d] + v2

    # (w,w)
    for o in statics["offs0"]:
        d = q + 3 * o
        val = npa(statics["TB"][o]) @ xid_n0
        val = val - upw_c * torch.abs(xid_i0) * col(statics["DDb"][o])
        if o == 0:
            val = val - upw_c * sgn_xid * ddw0 * cXi * mask
            if not ref_jacobian:
                val = val + curl_coef
        val = val * mask
        if o >= 1:
            last_col = torch.zeros((nz + 1, 1), dtype=dtype, device=dev)
            last_col[nz - o] = 1.0
            w_slots[d - 1] = w_slots[d - 1] + val * last_col
            val = val * (1.0 - last_col)
        if o == 0:
            val = val + 1.0 / dt
        w_slots[d] = w_slots[d] + val

    # interleave rows [Rt_k, W_k, Rho_k]*, W_nz — reshapes only
    rt_t = torch.stack(rt_slots, dim=1)               # (nz, b, ncol)
    rho_t = torch.stack(rho_slots, dim=1)
    w_t = torch.stack(w_slots, dim=1)                 # (nz+1, b, ncol)
    trip = torch.stack([rt_t, w_t[:nz], rho_t], dim=1)  # (nz, 3, b, ncol)
    return torch.cat(
        [trip.reshape(3 * nz, b, ncol), w_t[nz:]], dim=0)


def _interleave(f_rt, f_w, f_rho, nz):
    """(..., nz | nz+1, ncol) parts -> the interleaved ``(..., 3 nz + 1,
    ncol)`` order [Rt_0, W_0, Rho_0, ..., W_nz] (leading axes batch)."""
    trip = torch.stack([f_rt, f_w[..., :nz, :], f_rho], dim=-2)
    lead = tuple(trip.shape[:-3])
    return torch.cat([trip.reshape(lead + (3 * nz, trip.shape[-1])),
                      f_w[..., nz:, :]], dim=-2)


def _deinterleave(dx, nz):
    d_rt = dx[0:3 * nz:3]
    d_w = torch.cat([dx[1:3 * nz:3], dx[3 * nz:]], dim=0)
    d_rho = dx[2:3 * nz:3]
    return d_rt, d_w, d_rho


def band_matvec(bands, v, q: int):
    """``y = A v`` for every column: ``bands (n, 2q+1, ncol)`` with
    ``band[i, d] = A[i, i+d-q]`` (zero out of range), ``v (n, ncol)``."""
    n = bands.shape[0]
    out = torch.zeros_like(v)
    for d in range(2 * q + 1):
        s = d - q
        lo, hi = max(0, -s), min(n, n - s)
        if lo < hi:
            out[lo:hi] += bands[lo:hi, d] * v[lo + s:hi + s]
    return out


def dense_from_bands(bands, q: int):
    """The dense matrices ``(ncol, n, n)`` of ``bands (n, 2q+1, ncol)``."""
    n, b, ncol = bands.shape
    rows = torch.arange(n, device=bands.device)
    J = bands.new_zeros((n, n + 2 * q, ncol))
    for d in range(b):
        J[rows, rows + d] = bands[:, d]
    return J[:, q:q + n].permute(2, 0, 1).contiguous()


def dense_solve(bands, rhs, q: int):
    """Solve the banded systems by a batched dense LU with partial pivoting
    (``solve_batched``): ``rhs (n, ncol)`` -> ``(n, ncol)``.  The JAX
    package's dense solver calls ``jnp.linalg.solve`` the same way, outside
    any kernel."""
    return solve_batched(dense_from_bands(bands, q), rhs.T[..., None])[
        ..., 0].T


def solve_batched(A, b):
    """``torch.linalg.solve_ex(A, b)`` without an error check (nothing is
    read back to the host).  On the card the call goes to cuSOLVER / cuBLAS
    (the backend preference is set for this call and restored): measured on
    an NVIDIA H100 80GB HBM3 at 700 W (PyTorch 2.11, CUDA 12.8) at the
    flagship's 86 400 systems of 91 in float32, PyTorch's default choice
    (MAGMA) took 257 ms and cannot be captured in a CUDA graph, cuSOLVER
    27.5 ms and captures (``chip_smoke.py`` phase 3 times it)."""
    if not A.is_cuda:
        return torch.linalg.solve_ex(A, b, check_errors=False)[0]
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        x, _ = torch.linalg.solve_ex(A, b, check_errors=False)
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)
    return x


def vertical_implicit(d, fg: FastGeometry, constants, dt, q, statics,
                      newton_iters: int = 1, use_pallas: bool = True,
                      ref_jacobian: bool = False, saux=None,
                      plain: bool = False, ist=None, solver=None,
                      schur=None):
    """Batched Newton implicit update of (Rt, W, Rho).

    ``solver`` (``SOLVERS``; None: ``"pallas"`` with ``use_pallas``, else
    ``"banded"``) is the JAX package's ``vertical_solver``:

    - ``"pallas"`` (the JAX package's name) asks for the hand-written
      kernels.  ``ist``: ``implicit_cuda.implicit_statics(statics, fg)``;
      when it is given and the configuration is inside the fused kernel's
      envelope (``implicit_cuda.fused_supported``: a statement about the
      configuration only), each Newton iteration is one launch of
      ``implicit_cuda.fused_implicit_update``.  Otherwise the band tensor
      is assembled in plain tensor code and solved by the kernel of
      ``ops/cuda_banded``.  Either wrapper runs its plain version for CPU
      tensors.
    - ``"banded"``: the same banded Newton step in plain tensor code on
      whatever device the tensors lie.
    - ``"dense"``: one Newton step with the exact Jacobian (the bands of
      ``assemble_bands`` densified) and a batched dense LU per column
      (``dense_solve``).
    - ``"schur"``: W eliminated through the diagonal of the W-W block
      (``models/vertical_schur``; ``schur``: its ``schur_statics`` at
      ``q``), the reduced system solved by ``cuda_banded.banded_solve``.
    - ``"jfnk"``: restarted GMRES(48) x 2 (``models/jfnk``) with J·v a
      band product with the exact Jacobian.

    As in the JAX package the dense, Schur and JFNK steps use the exact
    Jacobian whatever ``ref_jacobian`` says.  ``statics["has_penalty"]``
    (``band_assembly_statics(upwind_thermo=)``) switches the Rt/Rho upwind
    penalty of the residual and the Jacobian.  ``plain=True`` (a check of
    the kernel path against the plain one on the same device) runs the
    kernels' plain versions.  ``saux``: precomputed ``static_aux(fg)``.

    A CPH, LEV or INT state (told by its shapes) takes ``stagger_newton``
    whatever ``solver`` says, with ``statics`` its ``stagger_statics``."""
    from ..models import jfnk as mjfnk, vertical_schur

    nz = fg.nz
    shp = d["U"].shape[1:]
    if solver is None:
        solver = "pallas" if use_pallas else "banded"
    if solver not in SOLVERS:
        raise ValueError(f"unknown vertical solver {solver!r}: expected one "
                         f"of {SOLVERS}")
    if infer_stagger(d, nz, axis=0) != "LOR":
        # the banded layout and its assembly are Lorenz's: every other
        # staggering solves densely whatever ``solver`` says, as in the JAX
        # package (``statics``: ``stagger_statics``)
        return stagger_newton(d, fg, constants, dt, statics,
                              newton_iters=newton_iters, saux=saux)
    if solver == "schur" and schur is None:
        raise ValueError("the Schur solver needs its statics (schur=)")
    pen = statics["has_penalty"]
    fused = (solver == "pallas" and ist is not None
             and implicit_cuda.fused_supported(ist))
    # the fused kernel takes the interface interpolants itself (its plain
    # version makes them when they are missing)
    x0_parts, aux = _prep_aux(d, fg, saux, interfaces=not fused)

    x_parts = x0_parts
    for it in range(newton_iters):
        if fused:
            update = (implicit_cuda.fused_implicit_update_plain if plain
                      else implicit_cuda.fused_implicit_update)
            d_rt, d_w, d_rho = update(
                x_parts, x0_parts, aux, ist, dt, constants,
                ref_jacobian=ref_jacobian, newton_time_term=(it > 0))
        else:
            f = residual_lor(x_parts, x0_parts, aux, fg, constants, dt,
                             penalty=pen)
            bands = assemble_bands(
                x_parts, aux, fg, statics, constants, dt,
                ref_jacobian=ref_jacobian and solver in ("banded", "pallas"))
            if solver == "schur":
                d_rt, d_w, d_rho = vertical_schur.schur_newton_update(
                    f, bands, schur,
                    banded_solve_t if plain else banded_solve)
            else:
                rhs = _interleave(*f, nz)
                if solver == "jfnk":
                    # J·v exact and F(x) given: no residual call is left
                    x = mjfnk.jfnk_newton_update(
                        None, _interleave(*x_parts, nz), f0=rhs,
                        jv=lambda v: band_matvec(bands, v, q))
                    x_parts = tuple(p.contiguous()
                                    for p in _deinterleave(x, nz))
                    continue
                if solver == "dense":
                    dx = dense_solve(bands, rhs, q)
                elif solver == "pallas" and not plain:
                    dx = banded_solve(bands, rhs, q)
                else:
                    dx = banded_solve_t(bands, rhs, q)
                d_rt, d_w, d_rho = _deinterleave(dx, nz)
        x_parts = (x_parts[0] - d_rt, x_parts[1] - d_w,
                   x_parts[2] - d_rho)

    rt, w, rho = x_parts
    return dict(d, Rt=rt.reshape((nz,) + shp),
                W=w.reshape((nz + 1,) + shp),
                Rho=rho.reshape((nz,) + shp))


# ---------------------------------------------------------------------------
# CPH, LEV and INT staggering: the exact dense Jacobian and the Newton step
# ---------------------------------------------------------------------------

def stagger_statics(fg: FastGeometry, upwind_thermo: bool = True):
    """What the staggered Jacobians read beside the state, built once per
    configuration on the device and in the dtype of ``fg``: the 0/1 masks
    of the boundary rows, the element-edge rows of the penalty weights,
    the static triple products ``T[k, l, m] = M1[k, m] * M2[m, l]`` of the
    two ``M1 diag(d) M2`` blocks, and whether the upwind penalty is on
    (``upwind_thermo`` and more than one vertical element)."""
    nz, vo = fg.nz, fg.vo
    dev, dt = fg.jac3d.device, fg.jac3d.dtype

    def mask(n):
        m = torch.ones((n, 1), dtype=dt, device=dev)
        m[0] = 0.0
        m[-1] = 0.0
        return m

    def triple(M1, M2):
        return (M1[:, None, :] * M2.T[None, :, :]).contiguous()

    has_pen = (upwind_thermo and fg.penalty_left is not None
               and nz // vo > 1)
    edges = torch.arange(vo, nz, vo, device=dev)
    return {
        "has_penalty": has_pen,
        "mask_i": mask(nz + 1), "mask_n": mask(nz),
        "edges": edges,
        "In2i_edges": fg.interp_n2i[edges],           # (nfe-1, nz)
        "T_w": triple(fg.diff_n2i, fg.interp_i2n),     # CPH (w, w)
        "T_rho": triple(fg.diff_i2n, fg.interp_n2i),   # CPH (rho, rho)
    }


def _dmd(a, M, b=None):
    """``diag(a) M diag(b)`` for every column, ``(K, L, ncol)``: ``a (K,
    ncol)``, ``M (K, L)`` static, ``b (L, ncol)`` or None."""
    out = a[:, None, :] * M[:, :, None]
    return out if b is None else out * b[None, :, :]


def _mdm(T, d):
    """``M1 diag(d) M2`` for every column from the static triple product
    ``T[k, l, m] = M1[k, m] * M2[m, l]``: one ``(K*L, m) @ (m, ncol)``
    product."""
    K, L, m = T.shape
    return (T.reshape(K * L, m) @ d).reshape(K, L, d.shape[1])


def _add_diag(J, r0, c0, v):
    """``J[r0 + k, c0 + k] += v[k]`` for every column (``v (K, ncol)``)."""
    k = torch.arange(v.shape[0], device=v.device)
    J[r0 + k, c0 + k] += v


def _sgn(x):
    """+1 where ``x >= 0``, else -1: the JAX package's derivative of ``|x|``
    (``lax.abs``'s JVP takes +1 at 0, where ``torch.sign`` gives 0)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _penalty_blocks(J, rows, mask, X, G, wl, wr, fg, o_w, o_x):
    """The upwind penalty's part of the rows ``rows`` (a slice) of field
    ``X`` (level rows, ``o_x`` its column offset): ``-diag(wl) Pl -
    diag(wr) Pr`` on its own columns, and the weights' dependence on W,
    ``-(diag(Pl X) Wl + diag(Pr X) Wr) G`` with ``G (nfe-1, nw, ncol)`` the
    derivative of the edge weights by W, on W's columns; ``mask`` (rows, 1)
    or None multiplies both."""
    own = -(_dmd(wl, fg.penalty_left) + _dmd(wr, fg.penalty_right))
    L = ((fg.penalty_left @ X)[:, None, :] * fg.wscat_left[:, :, None]
         + (fg.penalty_right @ X)[:, None, :] * fg.wscat_right[:, :, None])
    dw = -torch.einsum("kac,ajc->kjc", L, G)
    if mask is not None:
        own = own * mask[:, :, None]
        dw = dw * mask[:, :, None]
    n, nw = X.shape[0], G.shape[1]
    J[rows, o_x:o_x + n] += own
    J[rows, o_w:o_w + nw] += dw


def dense_jacobian(x_parts, aux, fg: FastGeometry, st, constants, dt,
                   stagger: str):
    """The exact Jacobian ``(n, n, ncol)`` of ``residual_cph`` (``stagger
    "CPH"``, n = 3 nz + 2) or ``residual_lev`` (``"LEV"``, n = 3 nz) at
    ``x_parts``, the rows and columns in the residual's order [Rt, W, Rho].

    The JAX package takes it by ``jax.jacfwd`` of the one-column residual;
    here every block is assembled from the column operators, since each
    term is a product of a static operator with per-column diagonals:
    ``diag(a) M diag(b)`` (``_dmd``), ``M1 diag(d) M2`` (``_mdm``), a
    diagonal, and the penalty weights' dependence on W at the element
    edges.  The derivative of ``|x|`` is +1 at 0, as ``jax.jacfwd`` takes
    it.  Peak memory: J itself and one block at a time."""
    c = constants
    nz = fg.nz
    rt, w, rho = x_parts
    ncol = rt.shape[1]
    dtype, dev = rt.dtype, rt.device
    n_rt, n_w = rt.shape[0], w.shape[0]
    o_w, o_rho = n_rt, n_rt + n_w
    n = o_rho + nz
    J = torch.zeros((n, n, ncol), dtype=dtype, device=dev)
    r_rt, r_w, r_rho = (slice(0, o_w), slice(o_w, o_rho),
                        slice(o_rho, n))
    u_n, v_n = aux["u_n"], aux["v_n"]
    jac, jac_i = aux["jac"], aux["jac_int"]
    exner = exner_from_rhotheta(rt, c)
    dexn = (c.Rd / (c.Cp - c.Rd)) * exner / rt
    upw = 0.5 / nz
    pen = st["has_penalty"]

    if stagger == "CPH":
        mask = st["mask_i"]
        cXi = aux["con_xi_xi_int"]
        w_n = fg.interp_i2n @ w
        rho_i = fg.interp_n2i @ rho
        dpi_i = fg.diff_i2i @ exner
        xid_n = (aux["con_a_xi"] * u_n + aux["con_b_xi"] * v_n
                 + aux["con_xi_xi"] * w_n)
        xid_i = mask * (aux["con_a_xi_int"] * aux["u_i"]
                        + aux["con_b_xi_int"] * aux["v_i"] + cXi * w)
        dxid = mask * cXi                       # d xid_i / d w, diagonal
        sgn = _sgn(xid_i)
        absx = torch.abs(xid_i)
        inv_jac_i = 1.0 / jac_i
        inv_rho_i = 1.0 / rho_i
        # Rt rows: the conservative flux divergence, the DD upwinding
        J[r_rt, r_rt] += _dmd(inv_jac_i, fg.diff_i2i, jac_i * xid_i) \
            - upw * _dmd(absx, fg.diffdiff_i2i)
        J[r_rt, r_w] += _dmd(inv_jac_i, fg.diff_i2i, jac_i * rt * dxid)
        _add_diag(J, 0, o_w, -upw * sgn * dxid * (fg.diffdiff_i2i @ rt))
        # W rows (zero at both ends)
        m3 = mask[:, :, None]
        J[r_w, r_rt] += m3 * _dmd(rt * inv_rho_i, fg.diff_i2i, dexn)
        _add_diag(J, o_w, 0, mask * dpi_i * inv_rho_i)
        J[r_w, r_w] += m3 * (_mdm(st["T_w"], xid_n)
                             - upw * _dmd(absx, fg.diffdiff_i2i))
        curl_coef = -(aux["con_a_xi_int"] * aux["du_i"]
                      + aux["con_b_xi_int"] * aux["dv_i"])
        ddw = mask * (fg.diffdiff_i2i @ w)
        _add_diag(J, o_w, o_w, mask * (curl_coef - upw * sgn * dxid * ddw))
        J[r_w, r_rho] += m3 * _dmd(-dpi_i * rt * inv_rho_i * inv_rho_i,
                                   fg.interp_n2i)
        # Rho rows: the mass flux divergence, the level penalty
        inv_jac = 1.0 / jac
        J[r_rho, r_w] += _dmd(inv_jac, fg.diff_i2n, jac_i * rho_i * dxid)
        J[r_rho, r_rho] += inv_jac[:, None, :] * _mdm(st["T_rho"],
                                                      jac_i * xid_i)
        if pen:
            e = st["edges"]
            wb = absx[e]
            G = torch.zeros((len(e), n_w, ncol), dtype=dtype, device=dev)
            G[torch.arange(len(e), device=dev), e] = sgn[e] * dxid[e]
            _penalty_blocks(J, r_rho, None, rho, G,
                            fg.wscat_left @ wb, fg.wscat_right @ wb, fg,
                            o_w, o_rho)
    elif stagger == "LEV":
        mask = st["mask_n"]
        cX = aux["con_xi_xi"]
        dpi_n = fg.diff_n2n @ exner
        xid_n = (aux["con_a_xi"] * u_n + aux["con_b_xi"] * v_n + cX * w)
        inv_jac = 1.0 / jac
        inv_rho = 1.0 / rho
        for rows, X, o_x in ((r_rt, rt, 0), (r_rho, rho, o_rho)):
            J[rows, o_x:o_x + nz] += _dmd(inv_jac, fg.diff_n2n, jac * xid_n)
            J[rows, r_w] += _dmd(inv_jac, fg.diff_n2n, jac * X * cX)
        m3 = mask[:, :, None]
        J[r_w, r_rt] += m3 * _dmd(rt * inv_rho, fg.diff_n2n, dexn)
        _add_diag(J, o_w, 0, mask * dpi_n * inv_rho)
        J[r_w, r_w] += m3 * fg.diff_n2n[:, :, None] * xid_n[None, :, :]
        curl_coef = -(aux["con_a_xi"] * aux["du_n"]
                      + aux["con_b_xi"] * aux["dv_n"])
        _add_diag(J, o_w, o_w, mask * curl_coef)
        _add_diag(J, o_w, o_rho, -mask * dpi_n * rt * inv_rho * inv_rho)
        if pen:
            e = st["edges"]
            cXi = aux["con_xi_xi_int"]
            xid_e = (cXi[e] * (st["In2i_edges"] @ w)
                     + aux["con_a_xi_int"][e] * aux["u_i"][e]
                     + aux["con_b_xi_int"][e] * aux["v_i"][e])
            wb = torch.abs(xid_e)
            wl, wr = fg.wscat_left @ wb, fg.wscat_right @ wb
            G = (_sgn(xid_e) * cXi[e])[:, None, :] \
                * st["In2i_edges"][:, :, None]
            for rows, X, o_x, m in ((r_rt, rt, 0, None),
                                    (r_rho, rho, o_rho, None),
                                    (r_w, w, o_w, mask)):
                _penalty_blocks(J, rows, m, X, G, wl, wr, fg, o_w, o_x)
    else:
        raise ValueError(f"no dense Jacobian for staggering {stagger!r}")
    _add_diag(J, 0, 0, torch.full((n, ncol), 1.0 / dt, dtype=dtype,
                                  device=dev))
    return J


def stagger_newton(d, fg: FastGeometry, constants, dt, st,
                   newton_iters: int = 1, saux=None):
    """The implicit update of (Rt, W, Rho) of a CPH, LEV or INT state (told
    by its shapes): ``newton_iters`` Newton steps, each with the exact
    dense Jacobian (``dense_jacobian``) solved by a batched dense LU
    (``solve_batched``), as the JAX package's ``vertical_implicit`` does for
    these staggerings whatever its solver.  ``st``: ``stagger_statics``."""
    stagger = infer_stagger(d, fg.nz, axis=0)
    resid = RESIDUALS[stagger]
    x0, aux = _prep_aux(d, fg, saux, levels=stagger == "LEV")
    sizes = [p.shape[0] for p in x0]
    x = x0
    for _ in range(newton_iters):
        f = torch.cat(resid(x, x0, aux, fg, constants, dt,
                            penalty=st["has_penalty"]))
        J = dense_jacobian(x, aux, fg, st, constants, dt, stagger)
        dx = solve_batched(J.permute(2, 0, 1), f.T[..., None])[..., 0].T
        x = tuple(p - q for p, q in zip(x, torch.split(dx, sizes)))
        del J
    shp = tuple(d["U"].shape[1:])
    return dict(d, **{k: p.reshape((p.shape[0],) + shp).contiguous()
                      for k, p in zip(("Rt", "W", "Rho"), x)})
