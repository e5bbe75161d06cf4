"""Nonhydrostatic pieces the z-first engine needs.

Counterpart of the JAX package's ``models/nonhydro.py``, reduced to what
the z-first engine calls: the Exner function, the Lorenz one-column
residual and its fixed inputs (used once, host-side, to find the Jacobian
bandwidth), the static tensors of the analytic banded-Jacobian assembly,
and the staggering of a state (``infer_stagger``, ``convert_stagger``:
LOR, CPH, LEV; INT states have LEV's shapes).  The reference-layout
tendencies and column residuals of that module are not ported: the port
runs the z-first engine (``fast/engine``, ``fast/implicit``), which has
its own, batched over columns, for every staggering.
"""

from __future__ import annotations

import numpy as np
import torch


def exner_from_rhotheta(rt, constants):
    """Exner pressure from rho*theta (PhysicalConstants.h:404-411)."""
    c = constants
    return c.Cp * torch.exp(
        c.Rd / (c.Cp - c.Rd) * torch.log(c.Rd / c.P0 * rt))


def infer_stagger(state, nz: int, axis: int = -1) -> str:
    """Staggering from the shapes of a state whose level axis is ``axis``
    (-1: the reference layout; 0: the z-first engine's): ``"LEV"`` where W
    has ``nz`` levels (LEV and INT), ``"CPH"`` where Rt has ``nz + 1`` (Rt
    and W on interfaces), else ``"LOR"``."""
    if state["W"].shape[axis] == nz:
        return "LEV"
    if state["Rt"].shape[axis] == nz + 1:
        return "CPH"
    return "LOR"


def convert_stagger(state, geom, stagger: str):
    """A Lorenz-form reference-layout state in another staggering (a new
    dict; the fields it does not move are the same tensors).

    For test cases without a ``stagger`` parameter on ``initial_state``:
    their level fields were already evaluated at the staggering's level
    positions (``geom.z_lev`` is staggering-aware), so only shapes move --
    W to levels (LEV, INT) by interface interpolation, Rt to interfaces
    (CPH) by level interpolation."""
    if stagger == "LOR":
        return state
    out = dict(state)
    key, M = {"LEV": ("W", geom.interp_i2n), "INT": ("W", geom.interp_i2n),
              "CPH": ("Rt", geom.interp_n2i)}.get(stagger, (None, None))
    if key is None:
        raise ValueError(stagger)
    f = state[key]
    out[key] = torch.einsum(
        "KL,...L->...K",
        torch.as_tensor(np.asarray(M, np.float64), device=f.device).to(
            f.dtype), f)
    return out


def _zero_ends(f):
    """Copy of ``f`` with its first and last rows set to zero (a fresh
    tensor written in place; the argument is left alone)."""
    out = f.clone()
    out[0] = 0.0
    out[-1] = 0.0
    return out


# ---------------------------------------------------------------------------
# Vertical implicit solve: one-column residual (bandwidth estimate only)
# ---------------------------------------------------------------------------

def _column_residual(x, aux, geom_mats, constants, dt, nz):
    """Residual F of the HEVI column system for one column.

    ``x``: flat vector [Rt (nz), W (nz+1), Rho (nz)].
    ``aux``: dict of fixed per-column tensors (U/V on levels+interfaces,
    metric columns, initial state x0).
    Reference: ``VerticalDynamicsFEM::PrepareColumn`` + ``BuildF``.
    """
    g = geom_mats
    rt = x[:nz]
    w = x[nz:2 * nz + 1]
    rho = x[2 * nz + 1:]

    u_n, v_n = aux["u_n"], aux["v_n"]
    u_i, v_i = aux["u_i"], aux["v_i"]

    w_n = g["interp_i2n"] @ w
    rho_i = g["interp_n2i"] @ rho
    rt_i = g["interp_n2i"] @ rt

    exner_n = exner_from_rhotheta(rt, constants)
    dpi_i = g["diff_n2i"] @ exner_n

    xid_n = (aux["con_a_xi"] * u_n + aux["con_b_xi"] * v_n
             + aux["con_xi_xi"] * w_n)
    xid_i = (aux["con_a_xi_int"] * u_i + aux["con_b_xi_int"] * v_i
             + aux["con_xi_xi_int"] * w)
    xid_i = _zero_ends(xid_i)

    # mass and rhotheta fluxes on interfaces -> flux divergence on levels
    mf_i = _zero_ends(aux["jac_int"] * rho_i * xid_i)
    f_rho = (g["diff_i2n"] @ mf_i) / aux["jac"]

    pf_i = _zero_ends(aux["jac_int"] * rt_i * xid_i)
    f_rt = (g["diff_i2n"] @ pf_i) / aux["jac"]

    # W equation (Clark form, implicit): KE gradient + curl + PGF + gravity
    con_ua_n = (aux["con2d_aa"] * u_n + aux["con2d_ab"] * v_n
                + aux["con_a_xi"] * w_n)
    con_ub_n = (aux["con2d_ab"] * u_n + aux["con2d_bb"] * v_n
                + aux["con_b_xi"] * w_n)
    ke_n = 0.5 * (con_ua_n * u_n + con_ub_n * v_n + xid_n * w_n)
    dke_i = g["diff_n2i"] @ ke_n

    con_ua_i = (aux["con2d_aa"] * u_i + aux["con2d_ab"] * v_i
                + aux["con_a_xi_int"] * w)
    con_ub_i = (aux["con2d_ab"] * u_i + aux["con2d_bb"] * v_i
                + aux["con_b_xi_int"] * w)
    curl = -con_ua_i * aux["du_i"] - con_ub_i * aux["dv_i"]

    pgf = dpi_i * rt_i / rho_i
    f_w = pgf + constants.g * aux["deriv_r_int"] + dke_i + curl
    f_w = _zero_ends(f_w)

    # upwinding (only at interior element edges, so nfe == 1 has none)
    if g["penalty_left"] is not None and nz // g["vo"] > 1:
        wb = torch.abs(xid_i[g["vo"]:nz:g["vo"]])
        wl = g["wscat_left"] @ wb
        wr = g["wscat_right"] @ wb
        f_rt = f_rt - (g["penalty_left"] @ rt) * wl \
                    - (g["penalty_right"] @ rt) * wr
        f_rho = f_rho - (g["penalty_left"] @ rho) * wl \
                      - (g["penalty_right"] @ rho) * wr
    # W upwinding: 2nd-derivative damping with |u^xi| coefficient
    ddw = _zero_ends(g["diffdiff_i2i"] @ w)
    upwind_coeff = 0.5 / nz
    f_w = f_w - upwind_coeff * torch.abs(xid_i) * ddw
    f_w = _zero_ends(f_w)

    f = torch.cat([f_rt, f_w, f_rho])
    return f + (x - aux["x0"]) / dt


def _implicit_aux(state, geom, col):
    """Fixed inputs + initial vector of ONE column for the solve.

    ``state``: dict of per-level numpy profiles (the same in every column);
    ``col``: (panel, i, j) of the column whose metric terms are taken.
    Everything is a float64 CPU tensor: this feeds the bandwidth estimate,
    not the step."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    In2i, Dn2i = t(geom.interp_n2i), t(geom.diff_n2i)
    u, v = t(state["U"]), t(state["V"])
    c2 = np.asarray(geom.con2d, np.float64)[col]
    aux = {
        "u_n": u, "v_n": v,
        "u_i": In2i @ u, "v_i": In2i @ v,
        "du_i": Dn2i @ u, "dv_i": Dn2i @ v,
        "con_a_xi": t(geom.con_a_xi[col]), "con_b_xi": t(geom.con_b_xi[col]),
        "con_xi_xi": t(geom.con_xi_xi[col]),
        "con_a_xi_int": t(geom.con_a_xi_int[col]),
        "con_b_xi_int": t(geom.con_b_xi_int[col]),
        "con_xi_xi_int": t(geom.con_xi_xi_int[col]),
        "jac": t(geom.jac3d[col]), "jac_int": t(geom.jac3d_int[col]),
        "deriv_r_int": t(geom.deriv_r_int[col][..., 2]),
        "con2d_aa": float(c2[0, 0]), "con2d_ab": float(c2[0, 1]),
        "con2d_bb": float(c2[1, 1]),
    }
    x0 = torch.cat([t(state["Rt"]), t(state["W"]), t(state["Rho"])])
    aux["x0"] = x0

    def opt(a):
        return None if a is None else t(a)

    gmats = {
        "interp_n2i": In2i, "interp_i2n": t(geom.interp_i2n),
        "diff_n2i": Dn2i, "diff_i2n": t(geom.diff_i2n),
        "diffdiff_i2i": t(geom.diffdiff_i2i),
        "penalty_left": opt(geom.penalty_left),
        "penalty_right": opt(geom.penalty_right),
        "wscat_left": opt(geom.wscat_left),
        "wscat_right": opt(geom.wscat_right),
        "vo": geom.vo,
    }
    return x0, aux, gmats


def estimate_bandwidth(geom, constants) -> int:
    """Half-bandwidth of the interleaved column Jacobian (host-side, once).

    The analog of the reference's hand-maintained bandwidth table
    (``VerticalDynamicsFEM.cpp:165-200``), derived numerically from the
    autograd Jacobian of one synthetic column instead (float64, CPU).
    """
    from . import vertical_banded as vb
    nz = geom.nz
    P, A, B = geom.jac3d.shape[:3]
    rng = np.random.default_rng(0)
    lev = 1.0 + 0.3 * rng.random(nz)
    state = {
        "U": 10.0 * lev, "V": 5.0 * lev,
        "Rt": 300.0 * lev,
        "W": 0.1 * (1.0 + rng.random(nz + 1)),
        "Rho": lev,
    }
    col = np.unravel_index(P * A * B // 2, (P, A, B))
    x0, aux_one, gmats = _implicit_aux(state, geom, tuple(int(c) for c in col))

    def resid_one(x):
        return _column_residual(x, aux_one, gmats, constants, 100.0, nz)

    return vb.compute_bandwidth(resid_one, x0)


def band_assembly_statics(geom, q: int, upwind_thermo: bool = True):
    """Host-side static tensors for the analytic banded-Jacobian assembly.

    Every Jacobian block of the HEVI column system has the form
    ``diag(a) . M . diag(b)`` or ``diag(a) . M1 . diag(d) . M2`` with M
    static (the column operators): its band at block offset ``o`` is an
    elementwise scaling of the static band ``M[k, k+o]``, or a tiny
    static matmul ``T_o @ d`` with ``T_o[k, m] = M1[k, m] * M2[m, k+o]``.
    The assembly is then a handful of small matmuls — the analytic analog of
    the reference's hand-coded ``BuildJacobianF``
    (``VerticalDynamicsFEM.cpp:3191``).

    Call once per model build.
    """
    Di2n = np.asarray(geom.diff_i2n)        # (nz, nz+1)
    In2i = np.asarray(geom.interp_n2i)      # (nz+1, nz)
    Dn2i = np.asarray(geom.diff_n2i)        # (nz+1, nz)
    Ii2n = np.asarray(geom.interp_i2n)      # (nz, nz+1)
    DD = np.asarray(geom.diffdiff_i2i)      # (nz+1, nz+1)
    nz = Di2n.shape[0]
    vo = geom.vo
    nfe = nz // vo

    def offs(delta):
        import math
        lo = math.ceil((-q - delta) / 3)
        hi = math.floor((q - delta) / 3)
        return list(range(lo, hi + 1))

    def sband(M, o):
        """Static band M[k, k+o] as a (rows,) vector, zero out of range."""
        K, L = M.shape
        out = np.zeros(K, dtype=M.dtype)
        k0, k1 = max(0, -o), min(K, L - o)
        if k1 > k0:
            out[k0:k1] = M[np.arange(k0, k1), np.arange(k0, k1) + o]
        return out

    def tprod(M1, M2, o):
        """T_o[k, m] = M1[k, m] * M2[m, k+o] (zero where k+o out of range)."""
        K, Mm = M1.shape
        L = M2.shape[1]
        T = np.zeros((K, Mm), dtype=M1.dtype)
        for k in range(K):
            j = k + o
            if 0 <= j < L:
                T[k] = M1[k] * M2[:, j]
        return T

    # Interleaved column indices: Rt_k -> 3k, W_k -> 3k+1, Rho_k -> 3k+2
    # (k < nz), W_nz -> 3nz.  A block coupling at level offset o lands at
    # band slot q + 3o + delta with delta = col_shift - row_shift; note
    # delta differs per ROW type: (rt,w) has delta=+1 but (rho,w) has
    # delta=-1, and the special last column W_nz sits at delta-1.
    ow = sorted(set(offs(1)) | set(offs(-1)))
    st = {"q": q, "nz": nz, "vo": vo, "offs0": offs(0),
          "offs_p1": offs(1), "offs_m1": offs(-1)}
    # (rt,rt)/(rho,rho): inv_jac . [Di2n diag(d1) In2i] - penalties + I/dt
    st["TA"] = {o: tprod(Di2n, In2i, o) for o in offs(0)}
    # (w,w): Dn2i diag(xid_n0) Ii2n + diag terms - upw |xid| DD
    st["TB"] = {o: tprod(Dn2i, Ii2n, o) for o in offs(0)}
    st["DDb"] = {o: sband(DD, o) for o in offs(0)}
    # (rt,w) [delta +1] and (rho,w) [delta -1]: inv_jac . Di2n diag(e)
    st["Di2n_b"] = {o: sband(Di2n, o) for o in ow}
    # (w,rt): diag(r) Dn2i diag(dpi_drt), diag(r) In2i [delta -1]
    st["Dn2i_b"] = {o: sband(Dn2i, o) for o in offs(-1)}
    st["In2i_b"] = {o: sband(In2i, o) for o in ow}
    if geom.penalty_left is not None and nfe > 1 and upwind_thermo:
        Pl = np.asarray(geom.penalty_left)
        Pr = np.asarray(geom.penalty_right)
        Wl = np.asarray(geom.wscat_left)    # (nz, nfe-1)
        Wr = np.asarray(geom.wscat_right)
        st["Pl_b"] = {o: sband(Pl, o) for o in offs(0)}
        st["Pr_b"] = {o: sband(Pr, o) for o in offs(0)}
        # U_o[k, a] = W[k, a] * [(a+1)*vo - k == o]  (weight-derivative
        # coupling of the penalty to W at the element edges; rt rows use
        # offs(1), rho rows offs(-1))
        edges = (np.arange(nfe - 1) + 1) * vo
        Ul, Ur = {}, {}
        for o in ow:
            m = (edges[None, :] - np.arange(nz)[:, None]) == o
            Ul[o] = Wl * m
            Ur[o] = Wr * m
        st["Ul"], st["Ur"] = Ul, Ur
        st["has_penalty"] = True
    else:
        st["has_penalty"] = False
    return st
