"""The port's shallow-water step in every explicit scheme and with a
tracer against the JAX package's, float64 on the CPU: ``make_sw_step``
with FE, RK4, SSPRK3, KGU35 and SSPRK53 on Williamson 5 at ne2 and with
one tracer species at ne3 (3 steps, 1e-11 relative per field).  Each JAX
step is compiled once.  (``Model`` is in ``test_torch_sw_driver.py``.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tempestmodel_tpu.models import advection as j_adv
from tempestmodel_tpu.models import hyperdiff as j_hd
from tempestmodel_tpu.models import shallow_water as j_sw
from tempestmodel_tpu.models import sw_model as j_swm
from tempestmodel_tpu.parallel import dss as j_dss
from tempestmodel_tpu.timestep.explicit import erk_substep as j_erk
from tempestmodel_tpu_torch.models import sw_model as t_swm

from torch_port_common import CPU
from test_torch_sw_driver import NSTEPS, assert_close, w5_pair


@pytest.mark.parametrize("scheme", ["fe", "rk4", "ssprk3", "kgu35",
                                    "ssprk53"])
def test_every_explicit_scheme_matches_jax(scheme):
    jc, tc, jg, tg, js, ts = w5_pair(2, scheme=scheme)
    jstep = j_swm.make_sw_step(jc, jg)
    tstep = t_swm.make_sw_step(tc, tg, device=CPU)
    for _ in range(NSTEPS):
        js, ts = jstep(js), tstep(ts)
    assert_close(ts, js)


def jax_step_with_tracers(cfg, geom):
    """JAX ``make_sw_step`` with the tracers' flux-form tendency of
    ``advection_tendency`` at the stage's wind.  The JAX package's
    ``sw_tendency`` states the same tendency but its contraction over the
    species axis cannot take a (ntr, 6, A, B) stack (it raises), so the
    reference step is assembled from the package's own pieces: the same
    stages, DSS and tail as ``make_sw_step``."""
    def dss_state(s):
        u, v = j_dss.apply_dss_vector(s["U"], s["V"], geom)
        return {"U": u, "V": v, "H": j_dss.apply_dss_scalar(s["H"], geom),
                "Tracers": j_dss.apply_dss_scalar(
                    s["Tracers"].transpose(1, 2, 3, 0), geom)
                .transpose(3, 0, 1, 2)}

    def stage(base, ueval, dt_s):
        tend = j_sw.sw_tendency({k: ueval[k] for k in ("U", "V", "H")},
                                geom, cfg.constants)
        tend["Tracers"] = j_adv.advection_tendency(
            ueval["Tracers"], ueval["U"], ueval["V"], geom)
        return dss_state({k: base[k] + dt_s * tend[k] for k in base})

    @jax.jit
    def step(state):
        u1 = j_erk(cfg.explicit_scheme, state, cfg.dt, stage)
        return j_hd.step_after_subcycle_sw(u1, cfg.dt, cfg, geom, dss_state)

    return step


def test_a_tracer_matches_jax():
    """Williamson 5 at ne3 with one species, order-4 hyperviscosity."""
    jc, tc, jg, tg, js, ts = w5_pair(3)
    lon, lat = np.asarray(tg.lon), np.asarray(tg.lat)
    q = (1.0 + np.cos(lat) * np.cos(lon - 1.5 * np.pi))[None]
    js = dict(js, Tracers=jnp.asarray(q))
    ts = dict(ts, Tracers=torch.from_numpy(q.copy()))
    jstep = jax_step_with_tracers(jc, jg)
    tstep = t_swm.make_sw_step(tc, tg, device=CPU)
    for _ in range(NSTEPS):
        js, ts = jstep(js), tstep(ts)
    assert ts["Tracers"].shape == (1, 6, 12, 12)
    assert_close(ts, js)
