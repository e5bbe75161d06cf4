"""Shared by the ``test_torch_imex_*`` files that hold the port's IMEX
outside the z-first envelope against the JAX package's reference-layout
``nh_model.make_nh_imex_step``: the configurations in both packages, one
numpy start handed to both, 3 steps of each and the comparison, float64 on
the CPU.

The JAX package's ``Model`` sends an IMEX scheme to ``make_nh_imex_step``
wherever its ``fast_imex_supported`` refuses it; the port runs the same
configurations on its z-first IMEX body (``models/nh_model.
make_nh_imex_step``).  Each JAX step compiles once per module, at first use
(about 20-30 s on the sphere, 5 s on an x-z slice)."""

import numpy as np
import jax.numpy as jnp
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as JaxUMJS)
from tempestmodel_tpu_torch.kernels import synthetic
from tempestmodel_tpu_torch.models import nh_model as t_nh

from torch_port_common import CPU, FIELDS, rel_err
from test_torch_vertical_solvers import assert_steps_close

STEPS = 3
TOL = 1e-11
NTR = 2
# UMJS at test scale: the re-anchor's probe of JAX's IMEX (ARS343, finite)
SPHERE = dict(ne=2, order=4, nz=6, dt=100.0, hyperdiffusion=True,
              nu_scalar=1e15, nu_div=1e15, nu_vort=1e15)


def sphere_configs(scheme="ars343", **over):
    """(jcfg, tcfg, jgeom, tgeom) of UMJS at ne2 p4 nz6, dt 100 s: JAX with
    ``"banded"``, the port with ``"pallas"`` unless ``over`` names a
    solver (the pairing of ``torch_port_common``)."""
    jtc = JaxUMJS(pert="exp")
    kw = dict(SPHERE, ztop=jtc.ztop, **over)
    jsolver = kw.pop("vertical_solver", "banded")
    tsolver = "pallas" if jsolver == "banded" else jsolver
    jcfg = tj.ModelConfig(equation_set=tj.EquationSet.PRIMITIVE_NONHYDRO,
                          grid_kind=tj.GridKind.CUBED_SPHERE,
                          timescheme=tj.TimestepSchemeType(scheme),
                          vertical_solver=jsolver, dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(equation_set=tt.EquationSet.PRIMITIVE_NONHYDRO,
                          grid_kind=tt.GridKind.CUBED_SPHERE,
                          timescheme=tt.TimestepSchemeType(scheme),
                          vertical_solver=tsolver, dtype=torch.float64, **kw)
    jgeom = j_nh.build_nh_sphere_geometry(jcfg, ztop=jtc.ztop)
    tgeom = t_nh.build_nh_sphere_geometry(tcfg, ztop=jtc.ztop)
    return jcfg, tcfg, jgeom, tgeom


def seeded_tracers(P, A, B, nz, ntr=NTR, seed=5):
    """``synthetic.random_tracers_numpy`` in the reference layout (ntr, P,
    A, B, nz): positive with a tenth of the values NEGATIVE, and per species
    one whole non-positive column and one zero element."""
    t = synthetic.random_tracers_numpy(nz, P, A, B, ntr, 4, seed=seed)
    return np.ascontiguousarray(np.moveaxis(t.reshape(ntr, nz, P, A, B), 1,
                                            -1))


def sphere_start(jcfg, jgeom, ntr=0):
    """JAX's UMJS start (``pert="exp"``) as numpy arrays, with ``ntr``
    seeded species."""
    s = JaxUMJS(pert="exp").initial_state(jgeom, jcfg.constants,
                                          dtype=jnp.float64)
    start = {k: np.asarray(v) for k, v in s.items()}
    if ntr:
        P, A, B, nz = start["Rho"].shape
        start["Tracers"] = seeded_tracers(P, A, B, nz, ntr)
    return start


def jax_run(step, start, steps=STEPS):
    """``steps`` calls of a JAX step from the numpy ``start`` (numpy
    out)."""
    s = {k: jnp.asarray(v) for k, v in start.items()}
    for _ in range(steps):
        s = step(s)
    return {k: np.asarray(v) for k, v in s.items()}


def jax_imex(jcfg, jgeom, start, ref=None, steps=STEPS):
    """``steps`` steps of JAX ``make_nh_imex_step`` (numpy out)."""
    return jax_run(j_nh.make_nh_imex_step(
        jcfg, jgeom, ref_state=None if ref is None else
        {k: jnp.asarray(v) for k, v in ref.items()}), start, steps)


def port_imex(tcfg, tgeom, start, ref=None, steps=STEPS, **kw):
    """``steps`` steps of the port's ``make_nh_imex_step`` (numpy out); the
    input is left alone."""
    step = t_nh.make_nh_imex_step(
        tcfg, tgeom, device=CPU, ref_state=None if ref is None else
        {k: torch.from_numpy(v.copy()) for k, v in ref.items()}, **kw)
    s0 = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    s = s0
    for _ in range(steps):
        s = step(s)
    for k, v in s0.items():
        np.testing.assert_array_equal(v.numpy(), start[k])
    return {k: v.numpy() for k, v in s.items()}


def assert_imex_matches(got, want, start, tol=TOL):
    """The five fields as ``assert_steps_close`` holds them (U and V
    against their common scale), and each tracer species against its own
    scale; every value finite, every species moved (one that starts at
    zero everywhere must stay there)."""
    errs = assert_steps_close({k: got[k] for k in FIELDS},
                              {k: want[k] for k in FIELDS}, start, tol)
    if "Tracers" in want:
        g, w = got["Tracers"], want["Tracers"]
        assert g.shape == w.shape and np.isfinite(g).all()
        for i in range(w.shape[0]):
            errs[f"Tracers[{i}]"] = rel_err(g[i], w[i])
            assert np.abs(w[i] - start["Tracers"][i]).max() > 0.0 \
                or not (start["Tracers"][i].any() or w[i].any()), i
        assert max(errs.values()) < tol, errs
    return errs
