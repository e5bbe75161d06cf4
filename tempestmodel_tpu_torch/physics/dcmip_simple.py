"""Reed-Jablonowski (2012) DCMIP "simple physics" package.

Counterpart of the JAX package's ``physics/dcmip_simple.py``, a port of
``test/dcmip2016/interface/simple_physics_v6.f90`` (wrapped by
``test/dcmip2016/DCMIPPhysics.cpp``): large-scale condensation, Smith-Vogl
surface fluxes (implicit), and Ekman boundary-layer diffusion solved with
the Thomas algorithm — all batched over every column.  The Thomas sweeps
are loops over the levels, each iteration one set of tensor operations
over all columns.

Level ordering here is the model's (k=0 surface .. k=nz-1 top); the
reference Fortran orders top-down, so its k+1 recurrences become k-1 here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import WorkflowProcess

# constants (simple_physics_v6.f90:230-270)
GRAVIT = 9.80616
RAIR = 287.0
CPAIR = 1.0045e3
LATVAP = 2.5e6
RH2O = 461.5
EPSILO = RAIR / RH2O
ZVIR = (RH2O / RAIR) - 1.0
C_DRAG = 0.0011
SST_TC = 302.15
T0C = 273.16
E0 = 610.78
RHOW = 1000.0
CD0 = 0.0007
CD1 = 0.000065
CM = 0.002
V20 = 20.0
P0 = 100000.0
PBLTOP = 85000.0
PBLCONST = 10000.0


def _qsat(p, t):
    return EPSILO * E0 / p * torch.exp(-LATVAP / RH2O * (1.0 / t - 1.0 / T0C))


def simple_physics_update(u, v, t, q, pmid, pint, ps, tsurf, dt,
                          rj2012_precip: bool = True, wind_speed=None):
    """One physics step on (..., nz) column tensors, k=0 at the surface.

    Returns (u, v, t, q, precl).  ``pint``: (..., nz+1) interface pressures
    with pint[..., 0] = ps.  ``u``/``v`` may be any fixed pointwise linear
    combination of the physical wind components (e.g. covariant) since the
    PBL/drag operator is a per-column scalar linear operator; pass
    ``wind_speed`` = |v|(surface) explicitly in that case.
    """
    nz = t.shape[-1]
    pdel = pint[..., :-1] - pint[..., 1:]            # > 0
    rpdel = 1.0 / pdel

    precl = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)

    # ---- large-scale condensation (RJ2012) ----
    if rj2012_precip:
        qsat = _qsat(pmid, t)
        cond = (q - qsat) / (1.0 + (LATVAP / CPAIR)
                             * (EPSILO * LATVAP * qsat / (RAIR * t * t)))
        cond = torch.where(q > qsat, cond, torch.zeros_like(cond))
        t = t + LATVAP / CPAIR * cond
        q = q - cond
        precl = precl + torch.sum(cond * pdel, dim=-1) / (dt * GRAVIT * RHOW)

    # ---- surface fluxes (implicit, lowest level) ----
    za = (RAIR / GRAVIT * t[..., 0] * (1.0 + ZVIR * q[..., 0]) * 0.5
          * (torch.log(ps) - torch.log(pint[..., 1])))
    if wind_speed is None:
        wind = torch.sqrt(u[..., 0] ** 2 + v[..., 0] ** 2)
    else:
        wind = wind_speed
    cd = torch.where(wind < V20, CD0 + CD1 * wind, torch.full_like(wind, CM))
    qsats = _qsat(ps, tsurf)
    mfac = 1.0 / (1.0 + cd * wind * dt / za)
    tfac = 1.0 / (1.0 + C_DRAG * wind * dt / za)
    u = u.clone()
    v = v.clone()
    t = t.clone()
    q = q.clone()
    u[..., 0] = u[..., 0] * mfac
    v[..., 0] = v[..., 0] * mfac
    t[..., 0] = (t[..., 0] + C_DRAG * wind * tsurf * dt / za) * tfac
    q[..., 0] = (q[..., 0] + C_DRAG * wind * qsats * dt / za) * tfac

    # ---- boundary-layer diffusivities (RJ2012 configuration) ----
    # Km/Ke at interfaces (index k = interface below level k)
    pint_decay = torch.exp(-((PBLTOP - pint) / PBLCONST) ** 2)
    kfac = torch.where(pint >= PBLTOP, torch.ones_like(pint), pint_decay)
    km_i = cd[..., None] * wind[..., None] * za[..., None] * kfac
    ke_i = C_DRAG * wind[..., None] * za[..., None] * kfac

    # tridiagonal coefficients: CA couples level k to k+1 (above),
    # CC couples level k to k-1 (below); interface k+1 sits between them.
    rho_i = (pint[..., 1:-1]
             / (RAIR * 0.5 * (t[..., 1:] * (1.0 + ZVIR * q[..., 1:])
                              + t[..., :-1] * (1.0 + ZVIR * q[..., :-1]))))
    dpm = pmid[..., :-1] - pmid[..., 1:]             # > 0
    diff_m = dt * GRAVIT * GRAVIT * km_i[..., 1:-1] * rho_i * rho_i / dpm
    diff_e = dt * GRAVIT * GRAVIT * ke_i[..., 1:-1] * rho_i * rho_i / dpm

    zeros = torch.zeros(t.shape[:-1] + (1,), dtype=t.dtype, device=t.device)
    cam = torch.cat([rpdel[..., :-1] * diff_m, zeros], dim=-1)
    ccm = torch.cat([zeros, rpdel[..., 1:] * diff_m], dim=-1)
    ca = torch.cat([rpdel[..., :-1] * diff_e, zeros], dim=-1)
    cc = torch.cat([zeros, rpdel[..., 1:] * diff_e], dim=-1)

    # Thomas sweep from the surface upward (reference k=pver..1): one
    # iteration a level, every column at once
    theta = t * (P0 / pmid) ** (RAIR / CPAIR)
    z0 = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    ce_m_p = ce_e_p = fu_p = fv_p = ft_p = fq_p = z0
    sweep = []
    for k in range(nz):
        dm = 1.0 + cam[..., k] + ccm[..., k] - ccm[..., k] * ce_m_p
        de = 1.0 + ca[..., k] + cc[..., k] - cc[..., k] * ce_e_p
        ce_m_p = cam[..., k] / dm
        ce_e_p = ca[..., k] / de
        fu_p = (u[..., k] + ccm[..., k] * fu_p) / dm
        fv_p = (v[..., k] + ccm[..., k] * fv_p) / dm
        ft_p = (theta[..., k] + cc[..., k] * ft_p) / de
        fq_p = (q[..., k] + cc[..., k] * fq_p) / de
        sweep.append((ce_m_p, ce_e_p, fu_p, fv_p, ft_p, fq_p))

    # back substitution from the top downward
    u_n = v_n = th_n = q_n = z0
    back = [None] * nz
    for k in range(nz - 1, -1, -1):
        ce_m, ce_e, fu, fv, ft, fq = sweep[k]
        u_n = ce_m * u_n + fu
        v_n = ce_m * v_n + fv
        th_n = ce_e * th_n + ft
        q_n = ce_e * q_n + fq
        back[k] = (u_n, v_n, th_n, q_n)
    u2, v2, th2, q2 = (torch.stack(f, dim=-1) for f in zip(*back))

    t2 = th2 * (pmid / P0) ** (RAIR / CPAIR)
    return u2, v2, t2, q2, precl


def moist_baro_tsurf(lat):
    """Latitude-dependent Tsurf for the moist baroclinic wave test (numpy,
    host-side)."""
    a = 6371220.0
    omega = 7.29212e-5
    pi = np.pi
    u0 = 35.0
    t00 = 288.0
    latw = 2.0 * pi / 9.0
    eta0 = 0.252
    etav = (1.0 - eta0) * 0.5 * pi
    q0 = 0.021
    ts = (t00 + pi * u0 / RAIR * 1.5 * np.sin(etav)
          * np.cos(etav) ** 0.5
          * ((-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0)
              + 10.0 / 63.0) * u0 * np.cos(etav) ** 1.5
             + (8.0 / 5.0 * np.cos(lat) ** 3
                * (np.sin(lat) ** 2 + 2.0 / 3.0) - pi / 4.0)
             * a * omega * 0.5))
    return ts / (1.0 + ZVIR * q0 * np.exp(-((lat / latw) ** 4)))


class DCMIPSimplePhysics(WorkflowProcess):
    """Simple physics on the model state (tracer 0 = rho*qv).

    ``test``: "tropical_cyclone" (constant SST) or "moist_baroclinic"
    (latitude-dependent Tsurf).
    """

    def __init__(self, interval: float = 0.0,
                 test: str = "tropical_cyclone",
                 rj2012_precip: bool = True):
        super().__init__(interval)
        self.test = test
        self.rj2012_precip = rj2012_precip
        self._tsurf = None
        self.precl = None

    def perform(self, model, t_now):
        g = model.geom_dev
        c = model.cfg.constants
        dt = self.interval if self.interval > 0 else model.cfg.dt
        if self._tsurf is None:
            lat = np.asarray(model.geom.lat)
            tsurf = (np.full(lat.shape, SST_TC)
                     if self.test == "tropical_cyclone"
                     else moist_baro_tsurf(lat))
            self._tsurf = torch.as_tensor(
                tsurf, dtype=model.cfg.dtype, device=model.device)
        state = model.state
        rho = state["Rho"]
        rt = state["Rt"]
        q = state["Tracers"][0] / rho
        pmid = c.pressure_from_rhotheta(rt)
        rt_i = torch.einsum("KL,...L->...K", g.interp_n2i, rt)
        pint = c.pressure_from_rhotheta(rt_i)
        ps = pint[..., 0]
        tv = pmid / (rho * c.Rd)
        temp = tv / (1.0 + 0.61 * q)
        # surface wind speed from the metric: |u|^2 = u_a u^a + u_b u^b
        con = g.con2d
        ua_con = (con[..., 0, 0, None] * state["U"]
                  + con[..., 0, 1, None] * state["V"])
        ub_con = (con[..., 1, 0, None] * state["U"]
                  + con[..., 1, 1, None] * state["V"])
        speed = torch.sqrt(torch.clamp(
            ua_con[..., 0] * state["U"][..., 0]
            + ub_con[..., 0] * state["V"][..., 0], min=0.0))
        # the PBL operator is per-column scalar-linear: apply it to the
        # covariant components directly (exact)
        u2, v2, t2, q2, precl = simple_physics_update(
            state["U"], state["V"], temp, q, pmid, pint, ps,
            torch.broadcast_to(self._tsurf, ps.shape), dt,
            rj2012_precip=self.rj2012_precip, wind_speed=speed)
        tv2 = t2 * (1.0 + 0.61 * q2)
        rt2 = rho * tv2 * (c.P0 / pmid) ** (c.Rd / c.Cp)
        tr = state["Tracers"].clone()
        tr[0] = q2 * rho
        self.precl = precl
        return dict(state, U=u2, V=v2, Rt=rt2, Tracers=tr)
