"""Kessler (1969) warm-rain microphysics, batched over all columns.

Counterpart of the JAX package's ``physics/kessler.py``, a port of the
DCMIP2016 Kessler kernel (reference ``test/dcmip2016/interface/kessler.f90``,
wrapped by ``test/dcmip2016/KesslerPhysics.cpp``): autoconversion/accretion,
saturation adjustment, rain evaporation, and subcycled upstream rain
sedimentation.  The per-column Fortran loop becomes one tensor update over
every column at once; the CFL-limited subcycle count is the global maximum.
"""

from __future__ import annotations

import math

import torch

from ..model import WorkflowProcess

F2X = 17.27
F5 = 237.3 * F2X * 2500000.0 / 1003.0
XK = 0.2875
PSL = 1000.0          # sea-level pressure (mb)
RHO_WATER = 1000.0    # liquid water density (kg/m^3)


def kessler_column_update(theta, qv, qc, qr, rho, pk, z, dt):
    """One Kessler physics step.

    All inputs (..., nz) tensors with level index increasing upward
    (``z`` may be a host array); ``pk`` is the Exner function (p/p0)^(R/cp);
    returns (theta', qv', qc', qr', precl) with precl (...,) in m/s.
    """
    z = torch.as_tensor(z, device=theta.device)
    r = 0.001 * rho
    rhalf = torch.sqrt(rho[..., 0:1] / rho)
    pc = 3.8 / (pk ** (1.0 / XK) * PSL)
    dz = z[..., 1:] - z[..., :-1]

    def velqr_of(qr_):
        return 36.34 * (torch.clamp(qr_ * r, min=0.0) ** 0.1364) * rhalf

    velqr = velqr_of(qr)
    # global CFL-limited subcycle count
    vel_low = velqr[..., :-1]
    dt_max = torch.min(torch.where(
        vel_low != 0.0, 0.8 * dz / torch.clamp(vel_low, min=1e-30),
        torch.full_like(vel_low, dt)))
    dt_max = torch.clamp(dt_max, max=dt)
    # The JAX package keeps the subcycle count on the device as the trip
    # count of a while loop.  Here it is one host read a firing (the one
    # device-to-host sync of the physics), then a Python loop of tensor
    # operations.
    rainsplit = math.ceil(float(dt / dt_max.item()))
    dt0 = dt / rainsplit

    precl = torch.zeros(theta.shape[:-1], dtype=theta.dtype,
                        device=theta.device)
    for _ in range(rainsplit):
        precl = precl + rho[..., 0] * qr[..., 0] * velqr[..., 0] / RHO_WATER

        # upstream sedimentation
        flux = r * qr * velqr
        sed_low = dt0 * (flux[..., 1:] - flux[..., :-1]) / (r[..., :-1] * dz)
        sed_top = -dt0 * qr[..., -1] * velqr[..., -1] / (
            0.5 * (z[..., -1] - z[..., -2]))
        sed = torch.cat([sed_low, sed_top[..., None]], dim=-1)

        # autoconversion + accretion (KW 2.13)
        qrprod = qc - (qc - dt0 * torch.clamp(0.001 * (qc - 0.001), min=0.0)) \
            / (1.0 + dt0 * 2.2 * torch.clamp(qr, min=0.0) ** 0.875)
        qc = torch.clamp(qc - qrprod, min=0.0)
        qr = torch.clamp(qr + qrprod + sed, min=0.0)

        # saturation vapor mixing ratio (KW 2.11)
        tpk = pk * theta
        qvs = pc * torch.exp(F2X * (tpk - 273.0) / (tpk - 36.0))
        prod = (qv - qvs) / (1.0 + qvs * F5 / (tpk - 36.0) ** 2)

        # rain evaporation (KW 2.14)
        rqr = torch.clamp(r * qr, min=0.0)
        ern = dt0 * ((1.6 + 124.9 * rqr ** 0.2046) * rqr ** 0.525) \
            / (2550000.0 * pc / (3.8 * qvs) + 540000.0) \
            * torch.clamp(qvs - qv, min=0.0) / (r * qvs)
        ern = torch.minimum(ern, torch.clamp(-prod - qc, min=0.0))
        ern = torch.minimum(ern, qr)

        # saturation adjustment (KW 3.10)
        dcond = torch.maximum(prod, -qc)
        theta = theta + 2500000.0 / (1003.0 * pk) * (dcond - ern)
        qv = torch.clamp(qv - dcond + ern, min=0.0)
        qc = qc + dcond
        qr = qr - ern

        velqr = velqr_of(qr)
    return theta, qv, qc, qr, precl / rainsplit


class KesslerPhysics(WorkflowProcess):
    """Kessler microphysics on the model state.

    Expects tracers [rho*qv, rho*qc, rho*qr] (moisture densities); updates
    Rt (via theta) and the tracers; keeps the precipitation rate in
    ``self.precl`` and in ``model.user_data["PRECL"]`` (reference
    ``KesslerPhysics.cpp``).
    """

    def __init__(self, interval: float = 0.0):
        super().__init__(interval)
        self.precl = None

    def perform(self, model, t):
        state = model.state
        if state["Tracers"].shape[0] < 3:
            raise ValueError(
                "KesslerPhysics requires tracers [rho*qv, rho*qc, rho*qr]")
        constants = model.cfg.constants
        dt = self.interval if self.interval > 0 else model.cfg.dt
        rho = state["Rho"]
        theta = state["Rt"] / rho
        pk = constants.exner_from_rhotheta(state["Rt"]) / constants.Cp
        qv = state["Tracers"][0] / rho
        qc = state["Tracers"][1] / rho
        qr = state["Tracers"][2] / rho
        th2, qv2, qc2, qr2, precl = kessler_column_update(
            theta, qv, qc, qr, rho, pk, model.geom_dev.z_lev, dt)
        tr = torch.stack([qv2 * rho, qc2 * rho, qr2 * rho], dim=0)
        if state["Tracers"].shape[0] > 3:
            tr = torch.cat([tr, state["Tracers"][3:]], dim=0)
        self.precl = precl
        model.user_data["PRECL"] = precl     # large-scale precip (m/s)
        return dict(state, Rt=th2 * rho, Tracers=tr)
