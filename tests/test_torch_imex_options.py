"""What the JAX package's IMEX ignores, and ``Model(fuse_pallas=False)``,
against the JAX package, float64 on the CPU: UMJS at ne2 p4 nz6, dt 100 s,
3 steps, 1e-11 relative per field (``torch_imex_wide``).

JAX's reference-layout ``make_nh_imex_step`` reads neither
``upwind_thermo`` (its implicit Rt/Rho penalty is always on), nor
``explicit_vertical`` (the implicit solve runs), nor the uniform (nu2)
diffusion (only its Strang step adds it).  So one JAX run of the plain
ARS343 configuration is the reference of the port run with each of the
three set, as it is of the plain port run.

``Model(fuse_pallas=False)`` runs the engine's unfused path, where JAX's
``Model`` runs its reference-layout engine: under ARS343 against the same
JAX run (JAX's ``Model`` sends that configuration to
``make_nh_imex_step``), and under Strang-HEVI against JAX's own
``Model(fuse_pallas=False)``."""

import numpy as np
import pytest

from tempestmodel_tpu import model as j_model
from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.fast import engine as t_engine

from torch_port_common import CPU, FIELDS, JaxUMJS, TorchUMJS
from torch_imex_wide import (assert_imex_matches, jax_imex, port_imex,
                             sphere_configs, sphere_start)

VARIANTS = {"plain": {}, "upwind_thermo_off": dict(upwind_thermo=False),
            "explicit_vertical": dict(explicit_vertical=True),
            "nu2": dict(nu_uniform_scalar=1e5, nu_uniform_vector=1e5)}


@pytest.fixture(scope="module")
def plain():
    """(jcfg, tcfg, tgeom, jgeom, start, JAX's 3 ARS343 steps)."""
    jcfg, tcfg, jgeom, tgeom = sphere_configs("ars343")
    start = sphere_start(jcfg, jgeom)
    return jcfg, tcfg, tgeom, jgeom, start, jax_imex(jcfg, jgeom, start)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_what_jax_imex_ignores_leaves_the_step_alone(plain, variant):
    _, tcfg, tgeom, _, start, want = plain
    cfg = tcfg.with_(**VARIANTS[variant])
    # outside the z-first envelope, but for the plain run
    assert t_engine.fast_imex_supported(cfg, geom=tgeom) == (
        variant == "plain")
    assert t_engine.imex_supported(cfg, geom=tgeom)
    assert_imex_matches(port_imex(cfg, tgeom, start), want, start)


def test_model_imex_unfused_matches_jax(plain):
    """``Model(fuse_pallas=False)`` under ARS343 (UMJS, the port's own
    start) equals the JAX run."""
    _, tcfg, _, _, start, want = plain
    m = t_model.Model(tcfg.with_(fuse_pallas=False), TorchUMJS(pert="exp"),
                      device=CPU)
    m.go(nsteps=3)
    assert m.step_count == 3 and m.carry is None
    assert_imex_matches({k: v.numpy() for k, v in m.state.items()}, want,
                        start)


def test_model_strang_unfused_matches_jax_model():
    """``Model(fuse_pallas=False)`` under Strang-HEVI equals JAX's own
    ``Model(fuse_pallas=False)`` (its reference-layout engine) over 3
    steps, each from its package's UMJS start."""
    jcfg, tcfg, _, _ = sphere_configs("strang")
    jm = j_model.Model(jcfg.with_(fuse_pallas=False), JaxUMJS(pert="exp"))
    start = {k: np.asarray(v) for k, v in jm.state.items()}
    jm.go(nsteps=3)
    assert not jm._fast
    m = t_model.Model(tcfg.with_(fuse_pallas=False), TorchUMJS(pert="exp"),
                      device=CPU)
    m.go(nsteps=3)
    assert m.step_count == 3 and set(m.carry) == {"Rt", "W", "Rho"}
    got = {k: v.numpy() for k, v in m.state.items()}
    assert_imex_matches(got, {k: np.asarray(jm.state[k]) for k in FIELDS},
                        start)
