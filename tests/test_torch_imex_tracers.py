"""The port's IMEX with tracers against the JAX package's reference-layout
``make_nh_imex_step``, float64 on the CPU: UMJS at ne2 p4 nz6, dt 100 s,
two seeded species (a tenth of their values negative), 3 steps, 1e-11
relative per field and per species (``torch_imex_wide``).

JAX's IMEX advances the tracers in each stage's tendency and updates them
in each implicit solve (``update_column_tracers``) with no column
positivity filter: that filter is Strang's alone.  The start carries
negative values so that a filter there would show, and a test shows that
it would.  Then ``Model`` on the DCMIP2016 moist wave under ARS343, 2
steps, against ``make_nh_imex_step`` from the Model's own start."""

from unittest import mock

import numpy as np
import pytest
import torch

from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch.testcases import dcmip2016 as t_dcmip

from torch_port_common import CPU, FIELDS, rel_err
from torch_imex_wide import (NTR, assert_imex_matches, jax_imex, port_imex,
                             sphere_configs, sphere_start)

# name: (scheme, configuration changes)
CASES = {"ars343": ("ars343", {}), "gark2": ("gark2", {}),
         "dense": ("ars343", dict(vertical_solver="dense"))}


@pytest.fixture(scope="module")
def runs():
    """``get(name)``: (tcfg, tgeom, start, JAX's 3 steps), at first use."""
    cache = {}

    def get(name):
        if name not in cache:
            scheme, over = CASES[name]
            jcfg, tcfg, jgeom, tgeom = sphere_configs(scheme, **over)
            start = sphere_start(jcfg, jgeom, ntr=NTR)
            cache[name] = tcfg, tgeom, start, jax_imex(jcfg, jgeom, start)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_moist_imex_matches_make_nh_imex_step(runs, name):
    tcfg, tgeom, start, want = runs(name)
    assert (start["Tracers"] < 0).any()
    assert_imex_matches(port_imex(tcfg, tgeom, start), want, start)


def test_moist_imex_unfused_matches_make_nh_imex_step(runs):
    """The unfused path (``fused=False``: the banded kernel's solve, the nu4
    tail as tensor code, separate DSS launches) gives the same step."""
    tcfg, tgeom, start, want = runs("ars343")
    assert_imex_matches(port_imex(tcfg, tgeom, start, fused=False), want,
                        start)


def test_a_column_filter_would_show(runs):
    """With Strang's column positivity filter after each tracer solve the
    port would leave JAX's IMEX by far more than the bar, so the match
    above says the filter is not there."""
    tcfg, tgeom, start, want = runs("ars343")
    setup = t_engine._setup

    def with_filter(*a, **kw):
        return setup(*a, **dict(kw, column_filter=True))

    with mock.patch.object(t_engine, "_setup", with_filter):
        got = port_imex(tcfg, tgeom, start)
    err = max(rel_err(got["Tracers"][i], want["Tracers"][i])
              for i in range(NTR))
    assert err > 1e-6
    for k in FIELDS:
        assert rel_err(got[k], want[k]) < 1e-11, k


def test_model_runs_the_moist_wave_under_ars343():
    """``Model`` on the moist baroclinic wave (three species, two of them
    zero) under ARS343, where the parent raised: 2 steps equal JAX
    ``make_nh_imex_step``'s from the Model's own start."""
    jcfg, tcfg, jgeom, _ = sphere_configs("ars343")
    m = t_model.Model(tcfg, t_dcmip.MoistBaroclinicWave(), device=CPU)
    start = {k: v.numpy().copy() for k, v in m.state.items()}
    assert start["Tracers"].shape[0] == 3 and start["Tracers"][0].any()
    m.go(nsteps=2)
    assert m.step_count == 2 and m.carry is None
    got = {k: v.numpy() for k, v in m.state.items()}
    assert_imex_matches(got, jax_imex(jcfg, jgeom, start, steps=2), start)
