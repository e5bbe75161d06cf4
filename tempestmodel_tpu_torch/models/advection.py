"""Advection equation set: passive tracer transport in a prescribed wind.

Counterpart of the JAX package's ``models/advection.py``, the analog of the
reference ``EquationSet::AdvectionEquations``
(``src/atm/EquationSet.cpp:30-45``: zero prognostic components, tracers
only).  The wind is supplied by the test case as covariant (U, V) fields
(optionally a callable of time); tracers advance with the same variational
flux divergence + DSS as the shallow-water model.  The DSS of all species
is one ``dss_scalar`` launch at ``K = ntracers`` (``fast/dss_cuda``).
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from .._device import resolve_device
from ..config import ModelConfig
from ..ops import sem
from ..timestep.explicit import erk_substep
from . import sw_model


def advection_tendency(tracers, u_cov, v_cov, geom):
    """d(rho q)/dt = -(1/J) div(J u^i q) for each tracer (2-D);
    ``tracers``: (ntr, 6, A, B)."""
    nea, neb, p = geom.nea, geom.neb, geom.p
    da, db = geom.delta_a, geom.delta_b
    con = torch.as_tensor(geom.con2d, device=tracers.device)
    jac2d = torch.as_tensor(geom.jac2d, device=tracers.device)
    con_u = con[..., 0, 0] * u_cov + con[..., 0, 1] * v_cov
    con_v = con[..., 1, 0] * u_cov + con[..., 1, 1] * v_cov
    base_a = jac2d * con_u
    base_b = jac2d * con_v
    tr = torch.movedim(tracers, 0, -1)             # (P, A, B, ntr)
    div = sem.weak_div(base_a[..., None] * tr, base_b[..., None] * tr,
                       geom.stiff, nea, neb, p, da, db)
    return torch.movedim(-div / jac2d[..., None], -1, 0)


def make_advection_step(cfg: ModelConfig, geom,
                        wind: Union[tuple, Callable], device=None,
                        plain: bool = False):
    """``step(tracers, t) -> tracers``: one explicit RK step of the
    ``(ntr, 6, A, B)`` tracers on ``device`` (default ``cuda``; raises when
    absent).

    ``wind``: (U_cov, V_cov) tensors, or a callable of ``t`` returning
    them.  ``t`` is a 0-d tensor on the device (a float is taken too), so
    that a captured CUDA graph can replay the step with the time its input
    buffer holds.  ``plain``: the DSS kernel's plain version.
    """
    dev = resolve_device(device)
    st = sw_model.sw_statics(geom, dev)
    dt = cfg.dt
    dss = sw_model.make_scalar_dss(st, plain)

    def get_wind(t):
        if callable(wind):
            return wind(t)
        return wind

    def step(tracers, t):
        if not torch.is_tensor(t):
            t = torch.tensor(float(t), dtype=tracers.dtype, device=dev)
        u, v = get_wind(t)

        def stage(base, ueval, dt_s):
            tend = advection_tendency(ueval, u, v, st)
            return dss(base + dt_s * tend)

        return erk_substep(cfg.explicit_scheme, tracers, dt, stage)

    return step
