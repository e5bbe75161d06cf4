"""IMEX-ARK on periodic Cartesian grids in the port vs the JAX package,
float64 on the CPU: 2 steps of ``fast.make_fast_imex_step`` for the Schar
mountain waves (x-z slice with its Rayleigh sponge toward the reference
state, ARS343) in both layouts of the engine and both vertical solvers
against one JAX compile (its default layout, swapped), and for the 3-D
thermal bubble (GARK2, the nu4 passes on the plane); 1e-11 relative per
field.  The configurations are ``tests/test_torch_cartesian.py``'s; V of
the x-z slice is roundoff, so U and V are measured against their common
scale, every other field against its own."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.fast import engine as j_engine
from tempestmodel_tpu_torch import fast as t_fast

from test_torch_cartesian import CASES, _configs
from torch_port_common import CPU, FIELDS

SCHEMES = {"schar": "ars343", "bubble3d": "gark2"}


def _compare(got, want, start, tol):
    """Worst relative error per field (U and V against their common
    scale), and the steps moved every field but the x-z slice's V."""
    vel = max(np.abs(want["U"]).max(), np.abs(want["V"]).max())
    errs = {}
    for k in FIELDS:
        a, b = want[k], got[k].numpy()
        assert b.shape == a.shape and np.isfinite(b).all(), k
        scale = vel if k in ("U", "V") else np.abs(a).max()
        errs[k] = float(np.abs(a - b).max() / (scale + 1e-300))
    assert max(errs.values()) < tol, errs
    assert np.abs(want["W"] - start["W"]).max() > 0.0
    assert np.abs(want["Rt"] - start["Rt"]).max() > 1e-12 * np.abs(
        start["Rt"]).max()
    return errs


@pytest.fixture(scope="module")
def runs():
    """2 IMEX steps of JAX (one compile per case) and of the port per
    (case, solver, layout); computed at first use."""
    cache = {}

    def setup(name):
        if ("setup", name) not in cache:
            jtc, _, jcfg, tcfg, jgeom, tgeom = _configs(name)
            scheme = SCHEMES[name]
            jcfg = jcfg.with_(timescheme=tj.TimestepSchemeType(scheme))
            tcfg = tcfg.with_(timescheme=tt.TimestepSchemeType(scheme))
            js = jtc.initial_state(jgeom, jcfg.constants, dtype=jnp.float64)
            ref = jtc.reference_state(jgeom, jcfg.constants,
                                      dtype=jnp.float64) \
                if CASES[name]["rayleigh"] else None
            cache["setup", name] = (jcfg, tcfg, jgeom, tgeom,
                                    {k: np.asarray(v) for k, v in js.items()},
                                    None if ref is None else {
                                        k: np.array(v)
                                        for k, v in ref.items()})
        return cache["setup", name]

    def jax_run(name):
        if ("jax", name) not in cache:
            jcfg, _, jgeom, _, start, ref = setup(name)
            step = j_engine.make_fast_imex_step(
                jcfg, jgeom, ref_state=None if ref is None else {
                    k: jnp.asarray(v) for k, v in ref.items()})
            s = {k: jnp.asarray(v) for k, v in start.items()}
            for _ in range(2):
                s = step(s)
            cache["jax", name] = {k: np.asarray(v) for k, v in s.items()}
        return cache["jax", name]

    def torch_run(name, solver, swap):
        key = (name, solver, swap)
        if key not in cache:
            _, tcfg, _, tgeom, start, ref = setup(name)
            step = t_fast.make_fast_imex_step(
                tcfg.with_(vertical_solver=solver), tgeom, ref_state=ref,
                device=CPU, swap_ab=swap)
            s = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
            for _ in range(2):
                s = step(s)
            cache[key] = s
        return cache[key]

    return setup, jax_run, torch_run


CARTESIAN = ([("schar", s, w) for s in ("pallas", "banded")
              for w in (True, False)]
             + [("bubble3d", s, None) for s in ("pallas", "banded")])


@pytest.mark.parametrize("name,solver,swap", CARTESIAN, ids=[
    f"{n}-{SCHEMES[n]}-{s}" + ("" if w is None else
                               ("-swapped" if w else "-natural"))
    for n, s, w in CARTESIAN])
def test_two_imex_steps_match_jax(runs, name, solver, swap):
    setup, jax_run, torch_run = runs
    start = setup(name)[4]
    _compare(torch_run(name, solver, swap), jax_run(name), start, 1e-11)


def test_the_rayleigh_sponge_reaches_the_imex_step(runs):
    """Schar's sponge is on: the step with the reference state differs from
    the step without it (the tail's finish is not skipped)."""
    setup, _, torch_run = runs
    _, tcfg, _, tgeom, start, _ = setup("schar")
    step = t_fast.make_fast_imex_step(tcfg, tgeom, device=CPU)
    s = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    for _ in range(2):
        s = step(s)
    damped = torch_run("schar", "banded", True)
    assert not torch.equal(s["U"], damped["U"])
