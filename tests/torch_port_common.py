"""Shared set-up of the ``test_torch_*`` files: the same configuration
built by the JAX package (the reference) and by the PyTorch port, on the
CPU in float64.  Data crosses between the two as numpy arrays only."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import nh_model as j_nh_model
from tempestmodel_tpu.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as JaxUMJS)
from tempestmodel_tpu_torch import convert
from tempestmodel_tpu_torch.kernels import synthetic
from tempestmodel_tpu_torch.models import nh_model as t_nh_model
from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as TorchUMJS)

# the shapes here are tiny and the suite runs several worker processes: one
# intra-op thread each keeps the workers from oversubscribing the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELDS = ("U", "V", "Rt", "Rho", "W")

# the configuration of tests/test_fast_engine.py
BASE = dict(ne=4, order=4, nz=8, ztop=30000.0, dt=200.0,
            hyperdiffusion=True, nu_scalar=1e15, nu_div=1e15, nu_vort=1e15)


def jax_config(**kw):
    return tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE,
                          vertical_solver="banded", dtype=jnp.float64,
                          **{**BASE, **kw})


def torch_config(**kw):
    return tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE,
                          vertical_solver="pallas", dtype=torch.float64,
                          **{**BASE, **kw})


def build_pair(**kw):
    """(jcfg, jgeom, tcfg, tgeom) for one configuration."""
    jcfg, tcfg = jax_config(**kw), torch_config(**kw)
    jgeom = j_nh_model.build_nh_sphere_geometry(jcfg, ztop=jcfg.ztop)
    tgeom = t_nh_model.build_nh_sphere_geometry(tcfg, ztop=tcfg.ztop)
    return jcfg, jgeom, tcfg, tgeom


def initial_states(jcfg, jgeom, tcfg, tgeom):
    js = JaxUMJS(pert="exp").initial_state(jgeom, jcfg.constants,
                                           dtype=jnp.float64)
    ts = TorchUMJS(pert="exp").initial_state(tgeom, tcfg.constants,
                                             dtype=torch.float64, device=CPU)
    return js, ts


def fast_geometry_fields_numpy(jfg):
    """The fields of a JAX ``FastGeometry`` as numpy arrays / scalars."""
    out = {}
    for f in dataclasses.fields(jfg):
        v = getattr(jfg, f.name)
        if v is None or isinstance(v, (int, float, bool, str, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def terrain_like_pair(jfg, seed=0, vary_jac=False):
    """(jfg_t, tfg_t): the JAX ``FastGeometry`` ``jfg`` and its port
    counterpart, both with the same seeded terrain-like separable metric
    (the UMJS terrain is flat, so its terrain terms all vanish).
    ``vary_jac``: also a z-constant 3-D Jacobian that is no multiple of the
    2-D one."""
    fields = synthetic.terrain_fields(
        jfg.nz, 6, jfg.A, jfg.B, np.asarray(jfg.sep_e), seed=seed,
        jacl=np.asarray(jfg.sep_jacl) if vary_jac else None)
    jfg_t = dataclasses.replace(
        jfg, **{k: jnp.asarray(v) for k, v in fields.items()})
    tfg_t = convert.fast_geometry_from_numpy(
        fast_geometry_fields_numpy(jfg_t), device=CPU, dtype=torch.float64)
    return jfg_t, tfg_t


def state_pair(nz, A, seed):
    """The same seeded random z-first state as JAX arrays and as tensors."""
    d = synthetic.random_state_numpy(nz, 6, A, A, seed)
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v.copy()) for k, v in d.items()})


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-300)


def random_fast_state(nz, A, seed=0):
    """Seeded z-first state with positive Rt/Rho, as numpy arrays."""
    rng = np.random.default_rng(seed)
    d = {k: rng.standard_normal((nz + (1 if k == "W" else 0), 6, A, A))
         for k in FIELDS}
    d["Rho"] = 1.0 + 0.1 * np.abs(d["Rho"])
    d["Rt"] = 300.0 * d["Rho"] * (1.0 + 0.01 * d["Rt"])
    d["W"] = 0.01 * d["W"]        # keeps a second Newton iterate physical
    return d


def perturbed_umjs_state(jcfg, jgeom, seed=0):
    """The balanced UMJS start in z-first layout with small seeded noise
    (numpy): near enough to balance for a Newton solve with a long step."""
    rng = np.random.default_rng(seed)
    js = JaxUMJS(pert="exp").initial_state(jgeom, jcfg.constants,
                                           dtype=jnp.float64)
    d = {k: np.ascontiguousarray(np.moveaxis(np.asarray(js[k]), -1, 0))
         for k in FIELDS}
    for k in ("U", "V", "Rt", "Rho"):
        d[k] = d[k] * (1.0 + 1e-3 * rng.standard_normal(d[k].shape))
    d["W"] = 0.01 * rng.standard_normal(d["W"].shape)
    return d


class ImexRuns:
    """Steps of the JAX package's ``make_fast_imex_step`` and of the port's
    from one UMJS start (``pert="exp"``, JAX's own initial state) on one
    sphere configuration built once (default ne2 p4 nz6: one JAX compile of
    an IMEX step takes 20-30 s on the CPU even there).  Each JAX step is
    compiled once, at first use; results are cached per (scheme, solver,
    merge)."""

    def __init__(self, ne=2, nz=6, nsteps=2):
        self.jcfg, self.jgeom, self.tcfg, self.tgeom = build_pair(ne=ne,
                                                                  nz=nz)
        js = JaxUMJS(pert="exp").initial_state(
            self.jgeom, self.jcfg.constants, dtype=jnp.float64)
        self.start = {k: np.asarray(js[k]) for k in FIELDS}
        self.nsteps = nsteps
        self.cache = {}

    def configs(self, scheme):
        return (self.jcfg.with_(timescheme=tj.TimestepSchemeType(scheme)),
                self.tcfg.with_(timescheme=tt.TimestepSchemeType(scheme)))

    def jax(self, scheme):
        if ("jax", scheme) not in self.cache:
            from tempestmodel_tpu.fast import engine as j_engine
            step = j_engine.make_fast_imex_step(self.configs(scheme)[0],
                                                self.jgeom)
            s = {k: jnp.asarray(v) for k, v in self.start.items()}
            for _ in range(self.nsteps):
                s = step(s)
            self.cache["jax", scheme] = {k: np.asarray(v)
                                         for k, v in s.items()}
        return self.cache["jax", scheme]

    def torch(self, scheme, solver="pallas", dss_merge=None):
        key = ("torch", scheme, solver, dss_merge)
        if key not in self.cache:
            from tempestmodel_tpu_torch import fast as t_fast
            cfg = self.configs(scheme)[1].with_(vertical_solver=solver)
            step = t_fast.make_fast_imex_step(cfg, self.tgeom, device=CPU,
                                              dss_merge=dss_merge)
            s = {k: torch.from_numpy(v.copy()) for k, v in self.start.items()}
            for _ in range(self.nsteps):
                s = step(s)
            self.cache[key] = s
        return self.cache[key]


def assert_imex_close(got, want, start, tol=1e-11):
    """Per field: relative error against JAX's scale below ``tol`` (the bar
    of ``tests/test_fast_engine.py``), every value finite, and the steps
    moved the field (so the comparison is not of two starts)."""
    errs = {}
    for k in FIELDS:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k])
        assert g.shape == want[k].shape and np.isfinite(g).all(), k
        errs[k] = rel_err(g, want[k])
        moved = np.abs(want[k] - start[k]).max()
        assert moved > 1e-9 * (np.abs(start[k]).max() + 1e-30), k
    assert max(errs.values()) < tol, errs
    return errs
