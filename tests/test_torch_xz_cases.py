"""The periodic x-z cases over terrain and the thermal bubble, the port vs
the JAX package, float64 on the CPU: 3 Strang-HEVI steps of the shear jet
over the Schar-profile mountain (tropopause profile, the lateral and top
sponge) and of the hydrostatic mountain waves (Agnesi profile, the
reference's inverted left sponge) at nex 8 nz 8 against JAX
``make_fast_step``, 1e-11 relative per field, in both layouts of the port's
engine, fused and unfused.  Each JAX step is compiled once, at first use.
The sponges and the thermal bubble through the driver and the CLI are in
``test_torch_xz_bubble.py``.

V of an x-z slice carries roundoff only, so U and V are measured against
their common scale, as ``tests/test_torch_cartesian.py`` does."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases import nonhydro_xz as j_xz
from tempestmodel_tpu_torch import fast as t_fast, convert
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz

from torch_port_common import CPU, FIELDS

TOL = 1e-11
CASES = {
    "shear_jet": dict(cls="ShearJetMountainWave", dt=1.0, nu=1e7),
    "hydrostatic": dict(cls="HydrostaticMountain", dt=1.0, nu=1e7),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(got, want, tol):
    """Worst relative error per field; U and V against their common scale
    (V of an x-z slice is roundoff)."""
    vel = max(np.abs(_np(want["U"])).max(), np.abs(_np(want["V"])).max())
    errs = {}
    for k in FIELDS:
        a, b = _np(want[k]), _np(got[k])
        assert a.shape == b.shape and np.isfinite(b).all(), k
        scale = vel if k in ("U", "V") else np.abs(a).max()
        errs[k] = float(np.abs(a - b).max() / (scale + 1e-300))
    assert max(errs.values()) < tol, errs
    return errs


def _configs(name):
    c = CASES[name]
    jtc, ttc = getattr(j_xz, c["cls"])(), getattr(t_xz, c["cls"])()
    kw = dict(nex=8, ney=1, order=4, nz=8, x_extent=jtc.x_extent,
              y_extent=jtc.y_extent, ztop=jtc.ztop, dt=c["dt"],
              hyperdiffusion=True, nu_scalar=c["nu"], nu_div=c["nu"],
              nu_vort=c["nu"], rayleigh_damping=True)
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CARTESIAN_XZ,
                          vertical_solver="banded", dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ,
                          vertical_solver="pallas", dtype=torch.float64, **kw)
    jgeom = j_nh.build_nh_cartesian_geometry(
        jcfg, ztop=jtc.ztop, topography=jtc.topography,
        rayleigh=jtc.rayleigh_strength)
    tgeom = t_nh.build_nh_cartesian_geometry(
        tcfg, ztop=ttc.ztop, topography=ttc.topography,
        rayleigh=ttc.rayleigh_strength)
    start = {k: np.asarray(v) for k, v in jtc.initial_state(
        jgeom, jcfg.constants, dtype=jnp.float64).items()}
    ref = {k: np.asarray(v) for k, v in jtc.reference_state(
        jgeom, jcfg.constants, dtype=jnp.float64).items()}
    return jcfg, tcfg, jgeom, tgeom, start, ref


@pytest.fixture(scope="module")
def runs():
    """3 steps of JAX ``make_fast_step`` per case (its default layout), and
    of the port per (case, path, layout); computed at first use."""
    cache = {}

    def configs(name):
        if ("cfg", name) not in cache:
            cache["cfg", name] = _configs(name)
        return cache["cfg", name]

    def jax_run(name):
        if ("jax", name) not in cache:
            jcfg, _, jgeom, _, start, ref = configs(name)
            first, step = j_fast.make_fast_step(
                jcfg, jgeom, ref_state={k: jnp.asarray(v)
                                        for k, v in ref.items()})
            X, c = first(j_fast.pack_state({k: jnp.asarray(v)
                                            for k, v in start.items()}))
            for _ in range(2):
                X, c = step(X, c)
            cache["jax", name] = {k: np.asarray(v) for k, v in
                                  j_fast.unpack_state(X, jcfg.nz).items()}
        return cache["jax", name]

    def torch_run(name, fused, swap):
        key = (name, fused, swap)
        if key not in cache:
            _, tcfg, _, tgeom, start, ref = configs(name)
            first, step = t_fast.make_fast_step(
                tcfg, tgeom, ref_state=ref, device=CPU, fused=fused,
                swap_ab=swap)
            X, c = first(convert.state_from_numpy(start, device=CPU))
            for _ in range(2):
                X, c = step(X, c)
            cache[key] = t_fast.unpack_state(X)
        return cache[key]

    return configs, jax_run, torch_run


SLICE = [(n, f, w) for n in CASES for f in (None, False) for w in (True,
                                                                   False)]


@pytest.mark.parametrize("name,fused,swap", SLICE, ids=[
    f"{n}-{'fused' if f is None else 'unfused'}-"
    f"{'swapped' if w else 'natural'}" for n, f, w in SLICE])
def test_three_steps_over_the_mountain_match_jax(runs, name, fused, swap):
    configs, jax_run, torch_run = runs
    start = configs(name)[4]
    want = jax_run(name)
    _compare(torch_run(name, fused, swap), want, TOL)
    # the steps moved the state: W from rest, and the sponge or the
    # mountain changed U
    assert np.abs(want["W"]).max() > 0.0
    assert np.abs(want["U"] - start["U"]).max() > 1e-9 * np.abs(
        start["U"]).max()
