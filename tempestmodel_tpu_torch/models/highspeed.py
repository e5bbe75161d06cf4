"""HighSpeedDynamics (``--hmethod HS``) on the z-first engine: the
momentum-form SE-horizontal / FD-vertical dynamical core.

Counterpart of the JAX package's ``models/highspeed.py`` (the reference's
``HighSpeedDynamics`` under ``PROGNOSTIC_CONTRAVARIANT_MOMENTA`` with the
fused-combine ARS343b driver).  The prognostic variables are contravariant
momenta: MU = rho u^a, MV = rho u^b and Rt, Rho on levels, MW = rho w (the
physical vertical momentum) on interfaces; the vertical is second-order
finite differences in physical z, so the implicit acoustic step is one
tridiagonal solve per column.  One step is the ARS343b stage sequence (four
explicit stages, three implicit solves, the stage states recombined
linearly), then the velocity-form nu4 / Rayleigh tail of the z-first engine
(``engine.step_after_subcycle``).

On the card:

- the tridiagonal systems ``(nz+1, 3, ncol)`` go to the hand-written banded
  kernel at q = 1 (``ops/cuda_banded.banded_solve``, its template form);
- the momentum DSS is the band DSS kernel's state mode
  (``dss_cuda.dss_state``) with a second rotation table: contravariant
  components cross a panel edge with the inverse transpose of the covariant
  edge matrices (``contravariant_edge_rotations``); on a Cartesian grid it
  is the per-field wrap-sum, MU (MV) zeroed at no-flux walls along a (b);
- the tail's DSS and nu4 passes are the Strang step's.

What the 3-D metric gives beyond ``FastGeometry`` (the covariant 2-D metric,
the Coriolis parameter, the z-derivatives of the level surfaces on
interfaces, the physical heights) is held in ``HSStatics``.  A Cartesian
grid runs in its natural (a, b) layout.  Tracers are not advected by this
scheme; as in the JAX package the step's state comes back without them.
The step carries nothing: ``step(d, carry)`` ignores ``carry`` and returns
``{}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import np_dtype
from ..config import ModelConfig
from ..fast import dss_cuda, engine
from ..fast.engine import FastGeometry, hderiv_a, hderiv_b, hweak_div
from ..grid.geometry import CubedSphereGeometry
from ..ops.cuda_banded import banded_solve
from .split_explicit import check_supported
from .vertical_banded import banded_solve_t

MOMENTA = ("MU", "MV", "Rt", "Rho", "MW")
# the momentum state's fields as the DSS kernels' state mode names them
_AS_STATE = {"MU": "U", "MV": "V", "Rt": "Rt", "Rho": "Rho", "MW": "W"}


@dataclasses.dataclass
class HSStatics:
    """The metric terms of the momentum form that ``FastGeometry`` lacks,
    z-first on its device and in its dtype."""
    cv_aa: Any          # (P, A, B) covariant 2-D metric g_ij
    cv_ab: Any
    cv_ba: Any
    cv_bb: Any
    coriolis: Any       # (P, A, B)
    dr_a_int: Any       # (nz+1, P, A, B): dz/da of the interface surfaces
    dr_b_int: Any       # dz/db
    z_lev: Any          # (nz, P, A, B): physical height of the levels
    z_int: Any          # (nz+1, P, A, B): of the interfaces
    rot: Any            # (4, nlinks, A): the contravariant edge table


def contravariant_edge_rotations(geom) -> np.ndarray:
    """The band DSS kernel's rotation table for contravariant components:
    ``dss_cuda.edge_rotations``'s layout (float64 ``(4, n_links, A)``) of
    the inverse transpose of each covariant edge matrix."""
    cov = np.asarray(geom.edge_mats, np.float64)      # (6, 4, A, 2, 2)
    mats = np.swapaxes(np.linalg.inv(cov), -1, -2)
    A = mats.shape[2]
    rot = np.zeros((4, len(geom.edge_meta), A), np.float64)
    for i, (pa, e, qa, qe, flip) in enumerate(geom.edge_meta):
        rot[:, i] = mats[pa, e].reshape(A, 4).T
    return rot


def hs_statics(geom, fg: FastGeometry) -> HSStatics:
    """``HSStatics`` of a geometry (host numpy) on ``fg``'s device."""
    if fg.ab_swapped:
        raise ValueError("the HS step runs a Cartesian grid in its natural "
                         "layout")
    dtype, dev = fg.inv_mult.dtype, fg.inv_mult.device
    f64 = np.float64

    def c(a):
        return torch.as_tensor(np.ascontiguousarray(a, np_dtype(dtype)),
                               device=dev)

    def zf(a):
        return c(np.moveaxis(np.asarray(a, f64), -1, 0))

    cov = np.asarray(geom.cov2d, f64)
    dri = np.asarray(geom.deriv_r_int, f64)
    rot = (contravariant_edge_rotations(geom)
           if isinstance(geom, CubedSphereGeometry) else np.zeros((4, 1,
                                                                   fg.A)))
    return HSStatics(
        cv_aa=c(cov[..., 0, 0]), cv_ab=c(cov[..., 0, 1]),
        cv_ba=c(cov[..., 1, 0]), cv_bb=c(cov[..., 1, 1]),
        coriolis=c(np.asarray(geom.coriolis, f64)),
        dr_a_int=zf(dri[..., 0]), dr_b_int=zf(dri[..., 1]),
        z_lev=zf(geom.z_lev), z_int=zf(geom.z_int), rot=c(rot))


# ---------------------------------------------------------------------------
# state conversion: velocity form (U, V covariant, W = u_xi) <-> momenta
# ---------------------------------------------------------------------------

def _w_nodes(w_e):
    """0.5-average an interface field to levels."""
    return 0.5 * (w_e[:-1] + w_e[1:])


def _edge_avg(f_n):
    """0.5-average a level field to the interior interfaces."""
    return 0.5 * (f_n[:-1] + f_n[1:])


def _pad_interfaces(f_int):
    """An interior-interface field (nz-1 rows) with zero boundary rows."""
    z = torch.zeros_like(f_int[:1])
    return torch.cat([z, f_int, z], dim=0)


def _rho_edges(rho):
    rho_e = _pad_interfaces(_edge_avg(rho))
    rho_e[0] = rho[0]                   # a fresh tensor
    rho_e[-1] = rho[-1]
    return rho_e


def to_momentum(d, fg: FastGeometry, hs: HSStatics):
    """Velocity-form z-first state -> momenta {MU, MV, Rt, Rho, MW}: w =
    W / (dz/dxi) on interfaces, the horizontal contravariant components
    from u^i = h^ij (u_j - z_j w)."""
    rho = d["Rho"]
    w_e = d["W"] / fg.deriv_r_xi_int
    w_n = _w_nodes(w_e)
    ua_eff = d["U"] - fg.deriv_r_a * w_n
    ub_eff = d["V"] - fg.deriv_r_b * w_n
    con_ua = fg.c2_aa[None] * ua_eff + fg.c2_ab[None] * ub_eff
    con_ub = fg.c2_ba[None] * ua_eff + fg.c2_bb[None] * ub_eff
    return {"MU": rho * con_ua, "MV": rho * con_ub, "Rt": d["Rt"],
            "Rho": rho, "MW": _rho_edges(rho) * w_e}


def from_momentum(m, fg: FastGeometry, hs: HSStatics):
    """Momenta -> velocity-form z-first state (the exact inverse)."""
    rho = m["Rho"]
    con_ua = m["MU"] / rho
    con_ub = m["MV"] / rho
    w_e = m["MW"] / _rho_edges(rho)
    w_n = _w_nodes(w_e)
    u_cov = (hs.cv_aa[None] * con_ua + hs.cv_ab[None] * con_ub
             + fg.deriv_r_a * w_n)
    v_cov = (hs.cv_ba[None] * con_ua + hs.cv_bb[None] * con_ub
             + fg.deriv_r_b * w_n)
    return {"U": u_cov, "V": v_cov, "Rt": m["Rt"],
            "Rho": rho, "W": fg.deriv_r_xi_int * w_e}


# ---------------------------------------------------------------------------
# explicit tendencies (StepExplicitCombine)
# ---------------------------------------------------------------------------

def hs_explicit_tendency(m, fg: FastGeometry, hs: HSStatics, constants):
    """Time tendencies of the momenta (no dt, no DSS): the flux-form SE
    horizontal dynamics, the pressure and kinetic-energy gradients along z
    surfaces, the vector-invariant vorticity force, the vertical momentum
    fluxes in finite differences."""
    mu, mv = m["MU"], m["MV"]
    rt, rho, mw = m["Rt"], m["Rho"], m["MW"]
    c = constants
    z_n, z_i = hs.z_lev, hs.z_int
    dz_lev = z_i[1:] - z_i[:-1]
    dz_hat = z_n[1:] - z_n[:-1]
    za, zb = fg.deriv_r_a, fg.deriv_r_b

    # interface auxiliaries (interior interfaces, zero-padded)
    inv_rho_e = 1.0 / _edge_avg(rho)
    mu_e = _edge_avg(mu)
    mv_e = _edge_avg(mv)
    mw_int = mw[1:-1]
    sdot = (mw_int - mu_e * hs.dr_a_int[1:-1]
            - mv_e * hs.dr_b_int[1:-1]) * inv_rho_e
    sdot_ua = _pad_interfaces(sdot * mu_e)
    sdot_ub = _pad_interfaces(sdot * mv_e)
    jac_i = fg.jac3d_int
    vmflux_base = jac_i[1:-1] * mw_int * inv_rho_e
    vmflux_a = _pad_interfaces(vmflux_base * mu_e)
    vmflux_b = _pad_interfaces(vmflux_base * mv_e)

    # level auxiliaries
    inv_rho = 1.0 / rho
    con_ua = mu * inv_rho
    con_ub = mv * inv_rho
    cov_ua = hs.cv_aa[None] * con_ua + hs.cv_ab[None] * con_ub
    cov_ub = hs.cv_ba[None] * con_ua + hs.cv_bb[None] * con_ub
    jac = fg.jac3d
    mflux_a = jac * mu
    mflux_b = jac * mv
    theta = rt * inv_rho
    pflux_a = mflux_a * theta
    pflux_b = mflux_b * theta
    ke = 0.5 * (cov_ua * con_ua + cov_ub * con_ub)
    sdot_w_n = _w_nodes(mw) - za * mu - zb * mv
    pres = c.pressure_from_rhotheta(rt)

    # horizontal derivatives
    div_mass = hweak_div(mflux_a, mflux_b, fg)
    div_pres = hweak_div(pflux_a, pflux_b, fg)
    dp_a, dp_b = hderiv_a(pres, fg), hderiv_b(pres, fg)
    dke_a, dke_b = hderiv_a(ke, fg), hderiv_b(ke, fg)
    dcovub_a = hderiv_a(cov_ub, fg)
    dcovua_b = hderiv_b(cov_ua, fg)

    # the pressure gradient along z surfaces: the slope term removed with
    # a centred z-derivative (one-sided at the bottom and top)
    dzp_int = (pres[1:] - pres[:-1]) / dz_hat
    dzp = torch.cat([dzp_int[:1],
                     (pres[2:] - pres[:-2]) / (z_n[2:] - z_n[:-2]),
                     dzp_int[-1:]], dim=0)
    dp_a = dp_a - za * dzp
    dp_b = dp_b - zb * dzp

    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    con_dp_a = c_aa * dp_a + c_ab * dp_b
    con_dp_b = c_ba * dp_a + c_bb * dp_b
    con_dke_a = c_aa * dke_a + c_ab * dke_b
    con_dke_b = c_ba * dke_a + c_bb * dke_b

    inv_j2d = (1.0 / fg.jac2d)[None]
    abs_vort = hs.coriolis[None] + inv_j2d * (dcovub_a - dcovua_b)
    vort_a = -abs_vort * inv_j2d * cov_ub
    vort_b = abs_vort * inv_j2d * cov_ua

    inv_jac = 1.0 / jac
    flux_div = inv_jac * div_mass
    dz_mom_a = (sdot_ua[1:] - sdot_ua[:-1]) / dz_lev
    dz_mom_b = (sdot_ub[1:] - sdot_ub[:-1]) / dz_lev

    d_mu = (-con_dp_a - rho * (con_dke_a + vort_a)
            - flux_div * con_ua - dz_mom_a)
    if fg.is_xz:
        d_mv = torch.zeros_like(mv)
    else:
        d_mv = (-con_dp_b - rho * (con_dke_b + vort_b)
                - flux_div * con_ub - dz_mom_b)

    # MW on the interior interfaces
    div_w = hweak_div(vmflux_a, vmflux_b, fg)
    dz_wflux = (sdot_w_n[1:] - sdot_w_n[:-1]) / dz_hat
    d_mw = _pad_interfaces(-(div_w[1:-1] / jac_i[1:-1] + dz_wflux))
    return {"MU": d_mu, "MV": d_mv, "Rt": -inv_jac * div_pres,
            "Rho": -flux_div, "MW": d_mw}


# ---------------------------------------------------------------------------
# the implicit acoustic solve (StepImplicitCombine)
# ---------------------------------------------------------------------------

def hs_tridiagonal(m, hs: HSStatics, constants, dt):
    """The implicit step's tridiagonal systems in MW over every column:
    ``(bands, rhs)`` with ``bands`` ``(nz+1, 3, ncol)`` (band ``[i, d]`` =
    A[i, i + d - 1]: the ``cuda_banded`` layout at q 1) and ``rhs``
    ``(nz+1, ncol)``; the bottom and top rows are W = 0."""
    c = constants
    rt, rho, mw = m["Rt"], m["Rho"], m["MW"]
    z_n, z_i = hs.z_lev, hs.z_int
    pres = c.pressure_from_rhotheta(rt)
    dpdtheta = c.gamma * pres / rt

    rho_e = _edge_avg(rho)
    theta_e = _edge_avg(rt) / rho_e
    inv_dz_lev = 1.0 / (z_i[1:] - z_i[:-1])
    inv_dz_hat = 1.0 / (z_n[1:] - z_n[:-1])
    inv_dz_k = inv_dz_lev[1:]
    inv_dz_km = inv_dz_lev[:-1]
    dpdt_k = dpdtheta[1:]
    dpdt_km = dpdtheta[:-1]
    theta_pad = _pad_interfaces(theta_e)
    th_km = theta_pad[:-2]
    th_kp = theta_pad[2:]

    dt2 = dt * dt
    g = c.g
    a_int = -dt2 * inv_dz_km * (inv_dz_hat * dpdt_km * th_km - 0.5 * g)
    b_int = 1.0 + dt2 * (
        inv_dz_hat * theta_e * (dpdt_k * inv_dz_k + dpdt_km * inv_dz_km)
        + 0.5 * g * (inv_dz_k - inv_dz_km))
    c_int = -dt2 * inv_dz_k * (inv_dz_hat * dpdt_k * th_kp + 0.5 * g)
    d_int = mw[1:-1] - dt * (
        inv_dz_hat * (pres[1:] - pres[:-1]) + g * rho_e)

    one = torch.ones_like(a_int[:1])
    zero = torch.zeros_like(one)
    dl = torch.cat([zero, a_int, zero], dim=0)
    dd = torch.cat([one, b_int, one], dim=0)
    du = torch.cat([zero, c_int, zero], dim=0)
    n = dl.shape[0]
    Q = dl[0].numel()
    bands = torch.stack([dl, dd, du], dim=1).reshape(n, 3, Q)
    rhs = torch.cat([zero, d_int, zero], dim=0).reshape(n, Q)
    return bands, rhs, theta_e, inv_dz_lev


def hs_implicit_update(m, hs: HSStatics, constants, dt, solve=banded_solve):
    """One implicit acoustic solve: the tridiagonal in MW (``solve(bands,
    rhs, 1)``; the hand-written banded kernel by default, its plain version
    for CPU tensors), then the implicit vertical mass and rho theta flux
    updates.  MU and MV pass through."""
    rt, rho = m["Rt"], m["Rho"]
    bands, rhs, theta_e, inv_dz_lev = hs_tridiagonal(m, hs, constants, dt)
    w_new = solve(bands, rhs, 1).reshape(m["MW"].shape)
    dz_mass = (w_new[1:] - w_new[:-1]) * inv_dz_lev
    w_theta = w_new * _pad_interfaces(theta_e)
    dz_ptheta = (w_theta[1:] - w_theta[:-1]) * inv_dz_lev
    w_new[0] = 0.0                      # a fresh tensor
    return {"MU": m["MU"], "MV": m["MV"], "Rt": rt - dt * dz_ptheta,
            "Rho": rho - dt * dz_mass, "MW": w_new}


# ---------------------------------------------------------------------------
# DSS of the momenta
# ---------------------------------------------------------------------------

def make_momentum_dss(fg: FastGeometry, hs: HSStatics, plain: bool = False):
    """``dss(m) -> m``: the DSS of {MU, MV, Rt, Rho, MW} in one launch of
    the band DSS kernel's state mode with the contravariant rotation table
    (its plain version for CPU tensors or with ``plain=True``); on a
    Cartesian grid the per-field wrap-sum, MU (MV) zeroed at the no-flux
    walls along a (b)."""
    walls_a, walls_b = fg.noflux

    def dss(m):
        d = {_AS_STATE[k]: m[k] for k in MOMENTA}
        if plain:
            out = dss_cuda.dss_state_plain(d, fg.inv_mult, hs.rot,
                                           fg.dss_links, fg.p, wrap=fg.wrap)
        else:
            out = dss_cuda.dss_state(d, fg.inv_mult, hs.rot, fg.dss_links,
                                     fg.p, wrap=fg.wrap, table=fg.dss_table)
        res = {k: out[_AS_STATE[k]] for k in MOMENTA}
        if walls_a:
            res["MU"][:, :, 0] = 0.0        # fresh tensors from the DSS
            res["MU"][:, :, -1] = 0.0
        if walls_b:
            res["MV"][..., 0] = 0.0
            res["MV"][..., -1] = 0.0
        return res

    return dss


# ---------------------------------------------------------------------------
# the ARS343b fused-combine driver
# ---------------------------------------------------------------------------

def ars343b_combos():
    """The stage-combination coefficients of the fused ARS(3,4,3) driver
    (``TimestepSchemeARS343b.cpp:52-172``): (diag_exp, diag_imp, u2f, u3f,
    u4f)."""
    g = 0.4358665215084590
    b1 = -1.5 * g * g + 4.0 * g - 0.25
    b2 = 1.5 * g * g - 5.0 * g + 1.25
    a42 = a43 = 0.5529291480359398
    a31 = ((1.0 - 4.5 * g + 1.5 * g * g) * a42
           + (2.75 - 10.5 * g + 3.75 * g * g) * a43
           - 3.5 + 13.0 * g - 4.5 * g * g)
    a32 = ((-1.0 + 4.5 * g - 1.5 * g * g) * a42
           + (-2.75 + 10.5 * g - 3.75 * g * g) * a43
           + 4.0 - 12.5 * g + 4.5 * g * g)
    a41 = 1.0 - a42 - a43

    imp = [[g, 0.0, 0.0, 0.0],
           [0.5 * (1.0 - g), g, 0.0, 0.0],
           [b1, b2, g, 0.0],
           [b1, b2, g, 0.0]]
    exp_ = [[g, 0.0, 0.0, 0.0],
            [a31, a32, 0.0, 0.0],
            [a41, a42, a43, 0.0],
            [0.0, b1, b2, g]]

    diag_exp = [exp_[s][s] for s in range(4)]
    diag_imp = [imp[s][s] for s in range(4)]

    u2f = [1.0 - exp_[1][0] / exp_[0][0],
           exp_[1][0] / exp_[0][0] - imp[1][0] / imp[0][0],
           imp[1][0] / imp[0][0]]

    u3f = [1.0 - exp_[2][0] / exp_[0][0],
           exp_[2][0] / exp_[0][0] - imp[2][0] / imp[0][0],
           imp[2][0] / imp[0][0],
           exp_[2][1] / exp_[1][1] - imp[2][1] / imp[1][1],
           imp[2][1] / imp[1][1]]
    u3f7 = -exp_[2][1] / exp_[1][1]
    for i in range(3):
        u3f[i] += u3f7 * u2f[i]

    u4f = [1.0 - exp_[3][0] / exp_[0][0],
           exp_[3][0] / exp_[0][0] - imp[3][0] / imp[0][0],
           imp[3][0] / imp[0][0],
           exp_[3][1] / exp_[1][1] - imp[3][1] / imp[1][1],
           imp[3][1] / imp[1][1],
           exp_[3][2] / exp_[2][2] - imp[3][2] / imp[2][2],
           imp[3][2] / imp[2][2]]
    u4f7 = -exp_[3][1] / exp_[1][1]
    u4f8 = -exp_[3][2] / exp_[2][2]
    for i in range(3):
        u4f[i] += u4f7 * u2f[i] + u4f8 * u3f[i]
    u4f[3] += u4f8 * u3f[3]
    u4f[4] += u4f8 * u3f[4]

    return diag_exp, diag_imp, u2f, u3f, u4f


def combine(insts, coeffs):
    """The linear combination of momentum states, summed in order."""
    out = {k: coeffs[0] * v for k, v in insts[0].items()}
    for s in range(1, len(insts)):
        out = {k: out[k] + coeffs[s] * insts[s][k] for k in out}
    return out


def make_hs_step(cfg: ModelConfig, geom, ref_state=None, device=None,
                 plain: bool = False):
    """(step, fg) of HS on z-first states (``engine.pack_state``'s layout;
    tensors on ``device``, default ``cuda``, raising when absent):
    ``step(d[, carry]) -> (d, {})``, self-starting, so it is its own first
    step, the carry unused (the JAX package's ``make_hs_step`` returns
    0.0).  ``plain=True`` runs every kernel's plain version."""
    check_supported(cfg, geom, "HS")
    s = engine._setup(cfg, geom, ref_state, device, plain, None, None,
                      False)
    fg, constants, dt = s.fg, cfg.constants, cfg.dt
    hs = hs_statics(geom, fg)
    diag_exp, diag_imp, u2f, u3f, u4f = ars343b_combos()
    dss_m = make_momentum_dss(fg, hs, plain)
    solve = banded_solve_t if plain else banded_solve

    def explicit(insts, coeffs, arg, dts):
        tend = hs_explicit_tendency(arg, fg, hs, constants)
        out = combine(insts, coeffs)
        out = {k: out[k] + (dts * dt) * tend[k] for k in MOMENTA}
        return dss_m(out)

    def implicit(arg, dts):
        return dss_m(hs_implicit_update(arg, hs, constants, dts * dt, solve))

    def step_fn(d, carry=None):
        u0 = to_momentum(d, fg, hs)
        uf1 = explicit([u0], [1.0], u0, diag_exp[0])
        u1 = implicit(uf1, diag_imp[0])
        uf2 = explicit([u0, uf1, u1], u2f, u1, diag_exp[1])
        u2 = implicit(uf2, diag_imp[1])
        uf3 = explicit([u0, uf1, u1, uf2, u2], u3f, u2, diag_exp[2])
        u3 = implicit(uf3, diag_imp[2])
        uf4 = explicit([u0, uf1, u1, uf2, u2, uf3, u3], u4f, u3,
                       diag_exp[3])
        out = engine.step_after_subcycle(
            from_momentum(uf4, fg, hs), dt, cfg, fg, rayleigh=s.rayleigh,
            dss_fn=s.dss_fn, use_fused_hyper=s.hyper_fns is not None,
            hyper_fns=s.hyper_fns)
        return out, {}

    return step_fn, fg

