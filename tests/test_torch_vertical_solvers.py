"""The port's dense and Schur column solvers against the JAX package's,
float64 on the CPU.

Dense (``vertical_solver="dense"``): 3 steps of the port's
``make_fast_step``, fused and unfused, against 3 steps of JAX
``nh_model.make_nh_step`` with the same solver (its reference-layout
engine; JAX's z-first engine refuses this solver), 1e-11 relative per
field, on UMJS at ne2 p4 nz6, on the thermal bubble of
``tests/test_jfnk.py``'s fixture (nex 8, nz 16, dt 0.05 s, no
hyperdiffusion; from a seeded W, see ``W_BUBBLE``), and with 2 Newton
iterations under ``jacobian_mode="reference"`` (JAX's dense step uses the
exact AD Jacobian in every mode, and so must the port) and 3 seeded tracer
species.  Each JAX step compiles once, at first use (about 25 s a case).

Schur (``vertical_solver="schur"``; ``test_torch_vertical_schur.py``):
JAX's ``make_strang_step`` hands its
Schur solve a half-bandwidth q = 0 (only ``"banded"`` and ``"pallas"`` get
``estimate_bandwidth``), and with q = 0 its band extraction seeds one
colouring, so the "bands" are the Jacobian's row sums on the diagonal and
every W coupling of the Schur system is lost.  The port does not copy that:
its Schur solve takes the exact bands at the estimated q.  So the solve is
held against JAX's ``nonhydro.vertical_implicit(solver="schur",
q=estimate_bandwidth(...))`` called directly (1e-11), and the port's Schur
solve against its own dense one within ``tests/test_jfnk.py``'s bar; and
the step reaches the banded kernel's wrapper with the reduced system's
half-bandwidth 4 vo + 5 = 9.

U and V of an x-z slice: V carries roundoff only, so both are measured
against their common scale."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases import nonhydro_xz as j_xz
from tempestmodel_tpu.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as JaxUMJS)
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.kernels import synthetic
from tempestmodel_tpu_torch.models import nh_model as t_nh

from torch_port_common import CPU, FIELDS

TOL = 1e-11
STEPS = 3
NTR = 3
NU = 1e15
# the bubble's seeded W (covariant; 0.1 m/s under its 1 km top): from rest
# the atmosphere around the bubble keeps a roundoff W, whose sign picks the
# upwind terms of the Newton Jacobian (ROADMAP's caveat "roundoff-decided
# upwind signs"); 3 steps of the port against JAX ``make_nh_step`` from rest
# then differ by 2.5e-10 of W's scale with "banded" as with "dense", and by
# 7.7e-13 from this W (measured on the CPU)
W_BUBBLE = 100.0

CASES = {
    "umjs": dict(grid="sphere", kw={}),
    "bubble": dict(grid="bubble", kw={}, w=W_BUBBLE),
    # 2 Newton iterations, the reference Jacobian mode and 3 species in
    # one case: one JAX compile less a solver
    "umjs_newton2_reference_species": dict(
        grid="sphere", kw=dict(newton_iterations=2,
                               jacobian_mode="reference"), ntr=NTR),
}


def _configs(name, solver):
    """(jcfg, tcfg, jgeom, tgeom, start): both packages' configuration of
    case ``name`` and JAX's initial state (numpy, reference layout)."""
    c = CASES[name]
    if c["grid"] == "sphere":
        jtc = JaxUMJS(pert="exp")
        kw = dict(ne=2, order=4, nz=6, ztop=jtc.ztop, dt=200.0,
                  hyperdiffusion=True, nu_scalar=NU, nu_div=NU, nu_vort=NU,
                  vertical_solver=solver, **c["kw"])
        jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE,
                              dtype=jnp.float64, **kw)
        tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE,
                              dtype=torch.float64, **kw)
        jgeom = j_nh.build_nh_sphere_geometry(jcfg, ztop=jtc.ztop)
        tgeom = t_nh.build_nh_sphere_geometry(tcfg, ztop=jtc.ztop)
    else:
        jtc = j_xz.ThermalBubble()
        kw = dict(nex=8, ney=1, order=4, nz=16, ztop=jtc.ztop,
                  x_extent=jtc.x_extent, y_extent=jtc.y_extent, dt=0.05,
                  hyperdiffusion=False, vertical_solver=solver, **c["kw"])
        jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CARTESIAN_XZ,
                              dtype=jnp.float64, **kw)
        tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ,
                              dtype=torch.float64, **kw)
        jgeom = j_nh.build_nh_cartesian_geometry(jcfg)
        tgeom = t_nh.build_nh_cartesian_geometry(tcfg)
    js = jtc.initial_state(jgeom, jcfg.constants)
    start = {k: np.asarray(v, np.float64) for k, v in js.items()}
    if c.get("w"):
        w = c["w"] * np.random.default_rng(7).standard_normal(
            start["W"].shape)
        w[..., 0] = w[..., -1] = 0.0
        start["W"] = w
    if c.get("ntr"):
        P, A, B, nz = start["Rt"].shape
        t = synthetic.random_tracers_numpy(nz, P, A, B, c["ntr"], 4, seed=5)
        start["Tracers"] = np.ascontiguousarray(np.moveaxis(
            t.reshape(c["ntr"], nz, P, A, B), 1, -1))
    return jcfg, tcfg, jgeom, tgeom, start


def make_runs(solver):
    """3 steps of JAX ``make_nh_step`` per case and of the port per (case,
    path), with ``solver``; computed at first use and cached."""
    cache = {}

    def configs(name):
        if name not in cache:
            cache[name] = _configs(name, solver)
        return cache[name]

    def jax_run(name):
        if ("jax", name) not in cache:
            jcfg, _, jgeom, _, start, = configs(name)
            first, step = j_nh.make_nh_step(jcfg, jgeom)
            s, c = first({k: jnp.asarray(v) for k, v in start.items()})
            for _ in range(STEPS - 1):
                s, c = step(s, c)
            cache["jax", name] = {k: np.asarray(v) for k, v in s.items()}
        return cache["jax", name]

    def torch_run(name, fused):
        _, tcfg, _, tgeom, start = configs(name)
        first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU,
                                            fused=fused)
        d, c = first(t_fast.pack_state(
            {k: torch.from_numpy(v.copy()) for k, v in start.items()},
            device=CPU))
        for _ in range(STEPS - 1):
            d, c = step(d, c)
        return {k: v.numpy() for k, v in t_fast.unpack_state(d).items()}

    return configs, jax_run, torch_run


def assert_steps_close(got, want, start, tol=TOL):
    """Per field: relative error against JAX's scale (U and V against
    their common one) below ``tol``, every value finite, and the steps moved
    the field."""
    uv = max(np.abs(want["U"]).max(), np.abs(want["V"]).max())
    errs = {}
    for k in want:
        g = got[k]
        assert g.shape == want[k].shape and np.isfinite(g).all(), k
        scale = uv if k in ("U", "V") else np.abs(want[k]).max()
        errs[k] = float(np.abs(g - want[k]).max() / max(scale, 1e-300))
        moved = np.abs(want[k] - start[k]).max()
        assert moved > 1e-9 * (np.abs(start[k]).max() + 1e-30) or \
            k == "V", k
    assert max(errs.values()) < tol, errs
    return errs


@pytest.fixture(scope="module")
def dense_runs():
    return make_runs("dense")


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", list(CASES))
def test_dense_steps_match_make_nh_step(dense_runs, name, fused):
    configs, jax_run, torch_run = dense_runs
    assert_steps_close(torch_run(name, fused), jax_run(name),
                       configs(name)[4])


def test_dense_uses_the_exact_jacobian_in_reference_mode(dense_runs):
    """The reference-mode bands solved densely would be another step: the
    port's dense step under ``jacobian_mode="reference"`` equals its step
    under ``"exact"`` (one code path), and both equal JAX's."""
    configs, jax_run, torch_run = dense_runs
    _, tcfg, _, tgeom, start = configs("umjs_newton2_reference_species")
    outs = []
    for mode in ("reference", "exact"):
        first, step = t_fast.make_fast_step(
            tcfg.with_(jacobian_mode=mode), tgeom, device=CPU)
        d, c = first(t_fast.pack_state(
            {k: torch.from_numpy(v.copy()) for k, v in start.items()},
            device=CPU))
        outs.append(d)
    for k in FIELDS:
        assert torch.equal(outs[0][k], outs[1][k]), k
