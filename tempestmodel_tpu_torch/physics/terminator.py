"""'Terminator' toy chemistry (DCMIP2016 test 3).

Counterpart of the JAX package's ``physics/terminator.py``, a port of the
reference Fortran kernel (``test/dcmip2016/interface/Terminator.f90``,
wrapped by ``test/dcmip2016/TerminatorPhysics.cpp``): Cl/Cl2 photolytic toy
chemistry with an exact local solution; Cly = Cl + 2*Cl2 is conserved
exactly, which makes it a sharp tracer-transport correctness diagnostic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import WorkflowProcess

CLY_CONSTANT = 4.0e-6
K1_LAT_CENTER = np.deg2rad(20.0)
K1_LON_CENTER = np.deg2rad(300.0)


def k_vals(lat, lon):
    """(k1, k2) photolysis and recombination rates at tensors (lat, lon)."""
    k1 = torch.clamp(
        torch.sin(lat) * np.sin(K1_LAT_CENTER)
        + torch.cos(lat) * np.cos(K1_LAT_CENTER)
        * torch.cos(lon - K1_LON_CENTER), min=0.0)
    return k1, 1.0


def terminator_tendency(lat, lon, cl, cl2, dt):
    """(dcl/dt, dcl2/dt) via the exact local solution (tensors)."""
    k1, k2 = k_vals(lat, lon)
    r = k1 / (4.0 * k2)
    cly = cl + 2.0 * cl2
    det = torch.sqrt(r * r + 2.0 * r * cly)
    expdt = torch.exp(-4.0 * k2 * det * dt)
    el = torch.where(torch.abs(det * k2 * dt) > 1e-16,
                     (1.0 - expdt) / torch.clamp(det, min=1e-300) / dt,
                     torch.full_like(det, 4.0 * k2))
    cl_f = (-el * (cl - det + r) * (cl + det + r)
            / (1.0 + expdt + dt * el * (cl + r)))
    return cl_f, -cl_f / 2.0


def terminator_initial(lat, lon):
    """Equilibrium (cl, cl2) initial condition (numpy, host-side)."""
    k1 = np.maximum(
        0.0, np.sin(lat) * np.sin(K1_LAT_CENTER)
        + np.cos(lat) * np.cos(K1_LAT_CENTER) * np.cos(lon - K1_LON_CENTER))
    k2 = 1.0
    r = k1 / (4.0 * k2)
    det = np.sqrt(r * r + 2.0 * CLY_CONSTANT * r)
    cl = det - r
    cl2 = CLY_CONSTANT / 2.0 - (det - r) / 2.0
    return cl, cl2


class TerminatorPhysics(WorkflowProcess):
    """Applies the chemistry to tracers [cl*rho, cl2*rho] at ``cl_index``
    and the one after it."""

    def __init__(self, interval: float = 0.0, cl_index: int = 0):
        super().__init__(interval)
        self.cl_index = cl_index

    def perform(self, model, t):
        g = model.geom_dev
        dt = self.interval if self.interval > 0 else model.cfg.dt
        i0 = self.cl_index
        state = model.state
        rho = state["Rho"]
        cl = state["Tracers"][i0] / rho
        cl2 = state["Tracers"][i0 + 1] / rho
        clf, cl2f = terminator_tendency(g.lat[..., None], g.lon[..., None],
                                        cl, cl2, dt)
        tr = state["Tracers"].clone()
        tr[i0] = (cl + dt * clf) * rho
        tr[i0 + 1] = (cl2 + dt * cl2f) * rho
        return dict(state, Tracers=tr)
