"""Channel-stacked HEVI vertical implicit solve (LOR staggering).

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

Semantics (including the ``ref_jacobian`` reference-Jacobian mode and the
AD-subgradient sign conventions) match the JAX package's.  Where that code
writes ``x.at[0].set(0.0).at[-1].set(0.0)``, this one multiplies by a 0/1
row mask or writes in place on a fresh tensor (``_zero_ends``), never on
an argument.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.nonhydro import exner_from_rhotheta, _zero_ends
from ..models.vertical_banded import banded_solve_t
from ..ops.cuda_banded import banded_solve
from . import implicit_cuda
from .engine import FastGeometry


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
    }


def interface_aux(u_n, v_n, fg: FastGeometry):
    """Interface interpolants and derivatives of the column velocities."""
    ni = fg.interp_n2i.shape[0]
    big_u = fg.n2i_stack @ u_n        # one GEMM: [interp_n2i; diff_n2i]
    big_v = fg.n2i_stack @ v_n
    return {"u_i": big_u[:ni], "v_i": big_v[:ni],
            "du_i": big_u[ni:], "dv_i": big_v[ni:]}


def _prep_aux(d, fg: FastGeometry, saux=None, interfaces: bool = True):
    """Fixed per-column inputs of the implicit system, (rows, ncol).
    ``interfaces=False`` leaves out the interface interpolants of U, V
    (the fused kernel takes them itself)."""
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
    x_parts = (fl(d["Rt"]), fl(d["W"]), fl(d["Rho"]))
    return x_parts, aux


def residual_lor(x_parts, x0_parts, aux, fg: FastGeometry, constants, dt):
    """(f_rt, f_w, f_rho) of the HEVI column residual, batched over
    columns with the level axis leading.  Port of
    ``nonhydro._column_residual``; the time term uses x0 explicitly so
    multi-iteration Newton works."""
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
    if fg.penalty_left is not None and nz // vo > 1:
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
    trip = torch.stack([f_rt, f_w[:nz], f_rho], dim=1)  # (nz, 3, ncol)
    return torch.cat(
        [trip.reshape(3 * nz, -1), f_w[nz:]], dim=0)


def _deinterleave(dx, nz):
    d_rt = dx[0:3 * nz:3]
    d_w = torch.cat([dx[1:3 * nz:3], dx[3 * nz:]], dim=0)
    d_rho = dx[2:3 * nz:3]
    return d_rt, d_w, d_rho


def vertical_implicit(d, fg: FastGeometry, constants, dt, q, statics,
                      newton_iters: int = 1, use_pallas: bool = True,
                      ref_jacobian: bool = False, saux=None,
                      plain: bool = False, ist=None):
    """Batched Newton-banded implicit update of (Rt, W, Rho).

    ``use_pallas`` (the JAX package's name, from
    ``vertical_solver="pallas"``) asks for the hand-written kernels.
    ``ist``: ``implicit_cuda.implicit_statics(statics, fg)``; when it is
    given and the configuration is inside the fused kernel's envelope
    (``implicit_cuda.fused_supported``: a statement about the configuration
    only), each Newton iteration is one launch of
    ``implicit_cuda.fused_implicit_update``.  Otherwise the band tensor is
    assembled in plain tensor code and solved by the kernel of
    ``ops/cuda_banded``.  Either wrapper runs its plain version for CPU
    tensors.  Without ``use_pallas``, and with ``plain=True`` (a check of
    the kernel path against the plain one on the same device), the plain
    versions run on whatever device the tensors lie.
    ``saux``: precomputed ``static_aux(fg)``."""
    nz = fg.nz
    shp = d["U"].shape[1:]
    fused = (use_pallas and ist is not None
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
            f_rt, f_w, f_rho = residual_lor(
                x_parts, x0_parts, aux, fg, constants, dt)
            f = _interleave(f_rt, f_w, f_rho, nz)
            bands = assemble_bands(x_parts, aux, fg, statics, constants, dt,
                                   ref_jacobian=ref_jacobian)
            if use_pallas and not plain:
                dx = banded_solve(bands, f, q)
            else:
                dx = banded_solve_t(bands, f, q)
            d_rt, d_w, d_rho = _deinterleave(dx, nz)
        x_parts = (x_parts[0] - d_rt, x_parts[1] - d_w,
                   x_parts[2] - d_rho)

    rt, w, rho = x_parts
    return dict(d, Rt=rt.reshape((nz,) + shp),
                W=w.reshape((nz + 1,) + shp),
                Rho=rho.reshape((nz,) + shp))
