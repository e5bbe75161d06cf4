"""Terrain on the cubed sphere, the port vs the JAX package, float64 on the
CPU: 3 Strang-HEVI steps of ``make_fast_step`` at ne2 p4 nz6 from JAX's own
initial state against JAX ``make_fast_step``, 1e-11 relative per field, on
the fused path (the separable terrain metric in the stage and the nu4
passes with a non-zero metric) and the unfused one (the terrain terms in
tensor code), for the mountain-induced Rossby wave (2 km Gaussian mountain,
Rayleigh layer, nu4; both vertical solvers), the Schar mountain on the
X=500 planet (Rayleigh layer, no hyperdiffusion, dt 0.4 s) and the
perturbed Jablonowski-Williamson wave (its surface geopotential, nu4).
Also which wrappers one step reaches over the mountain, and
``make_fast_multistep`` bit for bit against the eager steps.  Each JAX step
is compiled once, at first use (its Pallas kernels run in interpret mode:
about a minute a case).

The Schar and JW cases start from JAX's initial state with a seeded vertical
velocity (W of 1e4 in covariant units: about 1 m/s under JW's 10 km top,
0.3 m/s under Schar's 30 km) instead of rest.  At rest, where the wind runs
along the terrain (everywhere in JW, whose terrain depends on latitude
only; along the Schar ridges), the contravariant vertical velocity at the
interfaces is roundoff, and the Newton Jacobian of the implicit solve takes
its sign for the upwind terms: one Newton iterate then depends on roundoff,
in the JAX package as in the port.  Measured on the CPU by
``tests/torch_terrain_roundoff.py``: a start perturbed by 1e-15 relative
moves JAX's own 3-step result by 5e-5 (Schar, W) and 1e-1 (JW, W), and the
port's by as much.  JW's W is also small against the roundoff of the
hydrostatic residual it comes from: the same perturbation moves it by
1.3e-11 to 1.5e-11 of its largest value with a seeded W of 100 and by
5e-12 to 7e-12 with 1e4.  The Rossby case has neither and starts at rest."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu.constants import PhysicalConstants as JConstants
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases import nonhydro_sphere as j_sph
from tempestmodel_tpu_torch import fast as t_fast, convert
from tempestmodel_tpu_torch.constants import PhysicalConstants as TConstants
from tempestmodel_tpu_torch.fast import (engine as t_engine, dss_cuda,
                                         hyper_cuda, stage_cuda)
from tempestmodel_tpu_torch.kernels.counts import launch_counts
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases import nonhydro_sphere as t_sph

from torch_port_common import CPU, FIELDS, rel_err

TOL = 1e-11
NU = 1e15
W_SEEDED = 1.0e4          # amplitude of the seeded W (covariant)
CASES = {
    "rossby": dict(cls="MountainRossby3D", kw={}, dt=200.0, rayleigh=True,
                   hyper=True, w=0.0),
    "schar": dict(cls="ScharMountainSphere", kw={}, dt=0.4, rayleigh=True,
                  hyper=False, w=W_SEEDED),
    "jw": dict(cls="BaroclinicWaveJW", kw={"pert": "exp"}, dt=200.0,
               rayleigh=False, hyper=True, w=W_SEEDED),
}


def seeded_w(start, amplitude, seed=7):
    """``start`` with W replaced by seeded noise of ``amplitude``, zero on
    the bottom and top interfaces (numpy, reference layout)."""
    out = dict(start)
    if amplitude:
        w = amplitude * np.random.default_rng(seed).standard_normal(
            start["W"].shape)
        w[..., 0] = w[..., -1] = 0.0
        out["W"] = w
    return out


def _configs(name):
    c = CASES[name]
    jtc = getattr(j_sph, c["cls"])(**c["kw"])
    ttc = getattr(t_sph, c["cls"])(**c["kw"])
    jc, tc_ = JConstants(), TConstants()
    if hasattr(jtc, "constants"):
        jc, tc_ = jtc.constants(jc), ttc.constants(tc_)
    kw = dict(ne=2, order=4, nz=6, ztop=jtc.ztop, dt=c["dt"],
              rayleigh_damping=c["rayleigh"], hyperdiffusion=c["hyper"],
              nu_scalar=NU, nu_div=NU, nu_vort=NU)
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE, constants=jc,
                          vertical_solver="banded", dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, constants=tc_,
                          vertical_solver="pallas", dtype=torch.float64, **kw)
    jgeom = j_nh.build_nh_sphere_geometry(
        jcfg, ztop=jtc.ztop,
        topography=lambda lon, lat: jtc.topography(lon, lat, jc),
        rayleigh=jtc.rayleigh_strength if c["rayleigh"] else None)
    tgeom = t_nh.build_nh_sphere_geometry(
        tcfg, ztop=ttc.ztop,
        topography=lambda lon, lat: ttc.topography(lon, lat, tc_),
        rayleigh=ttc.rayleigh_strength if c["rayleigh"] else None)
    js = jtc.initial_state(jgeom, jc, dtype=jnp.float64)
    start = seeded_w({k: np.asarray(v) for k, v in js.items()}, c["w"])
    ref = None
    if c["rayleigh"]:
        jref = jtc.reference_state(jgeom, jc, dtype=jnp.float64)
        ref = {k: np.asarray(v) for k, v in jref.items()}
    return jcfg, tcfg, jgeom, tgeom, start, ref


def make_runs():
    """3 steps of JAX ``make_fast_step`` per case and of the port per
    (case, solver, path); computed at first use and cached."""
    cache = {}

    def configs(name):
        if ("cfg", name) not in cache:
            cache["cfg", name] = _configs(name)
        return cache["cfg", name]

    def jax_run(name):
        if ("jax", name) not in cache:
            jcfg, _, jgeom, _, start, ref = configs(name)
            first, step = j_fast.make_fast_step(
                jcfg, jgeom, ref_state=None if ref is None else {
                    k: jnp.asarray(v) for k, v in ref.items()})
            X, c = first(j_fast.pack_state(
                {k: jnp.asarray(v) for k, v in start.items()}))
            for _ in range(2):
                X, c = step(X, c)
            cache["jax", name] = {k: np.asarray(v) for k, v in
                                  j_fast.unpack_state(X, jcfg.nz).items()}
        return cache["jax", name]

    def torch_run(name, solver, fused):
        key = (name, solver, fused)
        if key not in cache:
            _, tcfg, _, tgeom, start, ref = configs(name)
            first, step = t_fast.make_fast_step(
                tcfg.with_(vertical_solver=solver), tgeom, ref_state=ref,
                device=CPU, fused=fused)
            X, c = first(convert.state_from_numpy(start, device=CPU))
            for _ in range(2):
                X, c = step(X, c)
            cache[key] = {k: v.numpy() for k, v in
                          t_fast.unpack_state(X).items()}
        return cache[key]

    return configs, jax_run, torch_run


@pytest.fixture(scope="module")
def runs():
    return make_runs()


def three_steps_match_jax(runs, name, solver, fused):
    configs, jax_run, torch_run = runs
    start = configs(name)[4]
    want, got = jax_run(name), torch_run(name, solver, fused)
    errs = {}
    for k in FIELDS:
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k
        errs[k] = rel_err(got[k], want[k])
        # the steps moved every field (W starts at rest)
        assert np.abs(want[k] - start[k]).max() > 1e-9 * (
            np.abs(start[k]).max() + 1e-30), k
    assert max(errs.values()) < TOL, errs


# the Rossby case's steps are held in tests/test_torch_terrain_rossby.py
# and JW's in tests/test_torch_terrain_jw.py (JAX compiles of their own, run
# beside this file)
STEPS = [("schar", "pallas", f) for f in (None, False)]


@pytest.mark.parametrize("name,solver,fused", STEPS, ids=[
    f"{n}-{s}-{'fused' if f is None else 'unfused'}" for n, s, f in STEPS])
def test_three_steps_over_a_mountain_match_jax(runs, name, solver, fused):
    three_steps_match_jax(runs, name, solver, fused)


@pytest.mark.parametrize("name", list(CASES))
def test_the_fast_geometry_carries_the_mountain(runs, name):
    """The path the comparisons run: the separable metric over a real
    mountain (non-zero terrain terms), the fused stage, and the nu4 kernels
    where the case has hyperdiffusion."""
    configs, *_ = runs
    _, tcfg, _, tgeom, _, _ = configs(name)
    fg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64, device=CPU)
    assert fg.sep_ok and stage_cuda.stage_supported(fg)
    assert hyper_cuda.supported(fg, tcfg)
    for k in ("sep_ca", "sep_cb", "sep_f", "sep_da", "sep_db", "s_int"):
        assert float(getattr(fg, k).abs().max()) > 0.0, k


def test_a_step_over_the_mountain_goes_through_the_wrappers(runs,
                                                            monkeypatch):
    """Calls of the kernels' wrappers in one fused ``step`` of the Rossby
    case (on the CPU each runs its plain version, and no launch is
    counted): the dry path with its nu4 kernels, the tail's DSS through
    ``dss_state`` with the Rayleigh finish."""
    from tempestmodel_tpu_torch.fast import implicit, implicit_cuda
    configs, *_ = runs
    _, tcfg, _, tgeom, start, ref = configs("rossby")
    want = {"stage": 5, "uvw": 5, "update": 1, "banded": 0, "pass1": 1,
            "pass2": 1, "scalar": 16, "vector": 2, "state": 0, "scalar2": 0}
    if "state" in t_engine.DSS_MERGE_DEFAULT:
        want.update(state=2, vector=0, scalar=want["scalar"] - 6)
    if "scalar2" in t_engine.DSS_MERGE_DEFAULT:
        pairs = 5 if "state" in t_engine.DSS_MERGE_DEFAULT else 7
        want.update(scalar2=pairs, scalar=want["scalar"] - 2 * pairs)
    calls = dict.fromkeys(want, 0)
    finishes = []

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            if key == "state":
                finishes.append(kw.get("rayleigh") is not None)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(stage_cuda, "fused_stage",
                        counting("stage", stage_cuda.fused_stage))
    monkeypatch.setattr(implicit_cuda, "fused_implicit_update", counting(
        "update", implicit_cuda.fused_implicit_update))
    monkeypatch.setattr(implicit, "banded_solve",
                        counting("banded", implicit.banded_solve))
    for key, fname in (("pass1", "nu4_pass1"), ("pass2", "nu4_pass2")):
        monkeypatch.setattr(hyper_cuda, fname,
                            counting(key, getattr(hyper_cuda, fname)))
    for key in ("uvw", "scalar", "vector", "state", "scalar2"):
        monkeypatch.setattr(dss_cuda, f"dss_{key}",
                            counting(key, getattr(dss_cuda, f"dss_{key}")))
    first, step = t_fast.make_fast_step(tcfg, tgeom, ref_state=ref,
                                        device=CPU)
    X, c = first(convert.state_from_numpy(start, device=CPU))
    calls.update(dict.fromkeys(calls, 0))
    finishes.clear()
    before = dict(launch_counts)
    step(X, c)
    assert calls == want
    assert dict(launch_counts) == before          # CPU tensors: no launch
    if want["state"]:
        assert any(finishes)                      # the Rayleigh finish


def test_multistep_over_the_mountain_equals_the_eager_steps(runs):
    """``make_fast_multistep(3)`` (a plain loop on the CPU) against
    ``first_step`` and 3 eager steps of the Rossby case: the same bits."""
    configs, *_ = runs
    _, tcfg, _, tgeom, start, ref = configs("rossby")
    X0 = convert.state_from_numpy(start, device=CPU)
    first, multi = t_fast.make_fast_multistep(tcfg, tgeom, 3, ref_state=ref,
                                              device=CPU)
    X, c = multi(*first(X0))
    first, step = t_fast.make_fast_step(tcfg, tgeom, ref_state=ref,
                                        device=CPU)
    E, ce = first(X0)
    for _ in range(3):
        E, ce = step(E, ce)
    for k in FIELDS:
        assert torch.equal(X[k], E[k]), k
    for k in ce:
        assert torch.equal(c[k], ce[k]), k

