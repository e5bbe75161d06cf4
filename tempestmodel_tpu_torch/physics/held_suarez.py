"""Held-Suarez (1994) idealized physics as a WorkflowProcess.

Counterpart of the JAX package's ``physics/held_suarez.py``, a port of the
reference ``HeldSuarezPhysics`` (``src/atm/HeldSuarezPhysics.{h,cpp}``):
backward-Euler boundary-layer Rayleigh friction on the horizontal velocity
and Newtonian relaxation of temperature to the radiative-equilibrium
profile, applied to the RhoTheta prognostic via the Ullrich update
(``HeldSuarezPhysics.cpp:200-212``).  The column update is elementwise
tensor code over the whole grid on the state's device.
"""

from __future__ import annotations

import torch

from ..model import WorkflowProcess

# Reference parameter values (HeldSuarezPhysics.h:26-47)
BOUNDARY_SIGMA = 0.7
K_FRICTION = 1.0 / 86400.0
K_A = (1.0 / 40.0) / 86400.0
K_S = (1.0 / 4.0) / 86400.0
DELTA_T_Y = 60.0
DELTA_THETA_Z = 10.0
T_MIN = 200.0
T_MAX = 315.0


def held_suarez_update(state, geom, constants, dt):
    """Apply one Held-Suarez physics step of length dt to a reference-layout
    state of tensors (a new dict; the inputs are not changed).  ``geom``: a
    geometry or its ``_device.OnDevice`` view."""
    c = constants
    rt = state["Rt"]
    rho = state["Rho"]
    lat = torch.as_tensor(geom.lat, device=rt.device)[..., None]
    row = torch.as_tensor(geom.interp_n2i, device=rt.device)[0]

    # surface pressure from the bottom-interface rho*theta (interpolated)
    rt_i0 = torch.einsum("L,...L->...", row, rt)
    psurf = c.pressure_from_rhotheta(rt_i0)[..., None]

    pres = c.pressure_from_rhotheta(rt)
    sigma = pres / psurf
    bscale = torch.clamp(
        (sigma - BOUNDARY_SIGMA) / (1.0 - BOUNDARY_SIGMA), min=0.0)

    # boundary-layer friction (backward Euler)
    fric = 1.0 / (1.0 + K_FRICTION * bscale * dt)
    u = state["U"] * fric
    v = state["V"] * fric

    # temperature relaxation
    temp = pres / (rho * c.Rd)
    sl, cl = torch.sin(lat), torch.cos(lat)
    kt = K_A + (K_S - K_A) * bscale * cl ** 4
    teq = (T_MAX - DELTA_T_Y * sl * sl
           - DELTA_THETA_Z * torch.log(pres / c.P0) * cl * cl)
    teq = teq * (pres / c.P0) ** c.kappa
    teq = torch.clamp(teq, min=T_MIN)

    # Ullrich RhoTheta update (reference :200-212)
    gam = c.gamma
    ddh = -kt / gam * (1.0 + (gam - 1.0) * teq / temp)
    h = -kt / gam * (1.0 - teq / temp)
    rt_new = rt * (1.0 + dt / (1.0 - dt * ddh) * h)

    return dict(state, U=u, V=v, Rt=rt_new)


class HeldSuarezPhysics(WorkflowProcess):
    """Held-Suarez forcing fired every ``interval`` model seconds."""

    def __init__(self, interval: float):
        super().__init__(interval)

    def perform(self, model, t):
        dt = self.interval if self.interval > 0 else model.cfg.dt
        return held_suarez_update(model.state, model.geom_dev,
                                  model.cfg.constants, dt)
