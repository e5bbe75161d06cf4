"""Shared set-up of the ``test_torch_*`` files: the same configuration
built by the JAX package (the reference) and by the PyTorch port, on the
CPU in float64.  Data crosses between the two as numpy arrays only."""

import dataclasses
import functools
import os

import numpy as np
import jax
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


def _structure(v):
    """A hashable description of a ``pallas_call`` parameter that holds all
    of it: dataclasses field by field (the reprs of Pallas's grid and block
    mappings leave out the index maps), jaxprs as their text with their
    constants, arrays whole (a repr elides a long one)."""
    from jax._src import core as jax_core
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, _structure(getattr(v, f.name)))
            for f in dataclasses.fields(v))
    if isinstance(v, jax_core.ClosedJaxpr):
        return (str(v.jaxpr), _structure(v.consts))
    if isinstance(v, jax_core.Jaxpr):
        return str(v)
    if isinstance(v, (np.ndarray, jax.Array)):
        a = np.asarray(v)
        return (a.shape, str(a.dtype), a.tobytes())
    if isinstance(v, (tuple, list)):
        return tuple(_structure(x) for x in v)
    if hasattr(v, "items"):
        return tuple(sorted((repr(k), _structure(x)) for k, x in v.items()))
    return repr(v)


def _trace_pallas_once():
    """Trace each distinct Pallas kernel of the JAX reference once per
    worker process while a ``test_torch_*`` test runs.

    On the CPU the JAX package's Pallas kernels run in interpret mode, and
    lowering a JAX step retraces every ``pallas_call`` of it into an XLA
    loop: a step of the z-first engine makes 37 calls of 10 distinct
    kernels, and this retracing is two thirds of lowering it.  Here the
    traced loop of each distinct call (the kernel's jaxpr, every other
    parameter of the call and the operands' types) is kept and evaluated
    again instead: the same XLA program, so the same bits (checked on the
    moist step of ``torch_tracer_steps``: lowering its ``first_step`` took
    21 s instead of 43 s on the CPU, its ``step`` then 14 s instead of 44).
    The JAX package's own tests (any test outside a ``test_torch_*`` file,
    told by pytest's ``PYTEST_CURRENT_TEST``) take the original path."""
    try:
        from jax._src import core as jax_core
        from jax._src.pallas import hlo_interpreter
        original = hlo_interpreter.pallas_call_hlo_interpret
    except (ImportError, AttributeError):    # another JAX: the plain path
        return
    traced = {}

    def interpret(*args, **params):
        if "test_torch_" not in os.environ.get("PYTEST_CURRENT_TEST", ""):
            return original(*args, **params)
        avals = [jax_core.get_aval(a) for a in args]
        key = (_structure(params),
               tuple((a.shape, str(a.dtype), a.weak_type) for a in avals))
        if key not in traced:
            traced[key] = jax.make_jaxpr(functools.partial(original,
                                                           **params))(
                *[jax.ShapeDtypeStruct(a.shape, a.dtype, weak_type=a.weak_type)
                  for a in avals])
        closed = traced[key]
        return jax_core.eval_jaxpr(closed.jaxpr, closed.consts, *args)

    hlo_interpreter.pallas_call_hlo_interpret = interpret


_trace_pallas_once()

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


class RayleighUMJS:
    """The UMJS case with its Rayleigh layer and reference state and the
    off-centred implicit combination (0.1) at ne4 p4 nz8 in both packages,
    from JAX's initial state: 3 steps of the JAX package's ``make_fast_step``
    (``first_step`` and, with ``inner``, its ``make_fast_multistep`` of
    ``inner`` steps, else two ``step`` calls; computed at first use) and of
    the port's per (fused, DSS grouping), the port's inputs checked to be
    left alone.  ``kw`` sets the rest (the Jacobian mode)."""

    def __init__(self, inner=None, **kw):
        from tempestmodel_tpu.models import nh_model as j_nh
        from tempestmodel_tpu_torch.models import nh_model as t_nh
        kw = dict(rayleigh_damping=True, off_centering=0.1, **kw)
        jcfg, _, tcfg, _ = build_pair()
        self.jcfg, self.tcfg = jcfg.with_(**kw), tcfg.with_(**kw)
        tc = TorchUMJS(pert="exp", rayleigh=True)
        jtc = JaxUMJS(pert="exp", rayleigh=True)
        self.tgeom = t_nh.build_nh_sphere_geometry(
            self.tcfg, ztop=tc.ztop, rayleigh=tc.rayleigh_strength)
        self.jgeom = j_nh.build_nh_sphere_geometry(
            self.jcfg, ztop=jtc.ztop, rayleigh=jtc.rayleigh_strength)
        self.js = jtc.initial_state(self.jgeom, self.jcfg.constants,
                                    dtype=jnp.float64)
        self.jref = jtc.reference_state(self.jgeom, self.jcfg.constants,
                                        dtype=jnp.float64)
        self.ref = {k: np.array(v) for k, v in self.jref.items()}
        self.state = {k: np.asarray(v) for k, v in self.js.items()}
        self.inner = inner
        self.cache = {}

    def jax(self):
        """(3-step state in the reference layout, z-first state, carry)."""
        if "jax" not in self.cache:
            from tempestmodel_tpu import fast as j_fast
            from tempestmodel_tpu.fast import engine as j_engine
            if self.inner is None:
                first, step = j_fast.make_fast_step(self.jcfg, self.jgeom,
                                                    ref_state=self.jref)
                J, cj = first(j_fast.pack_state(self.js))
                for _ in range(2):
                    J, cj = step(J, cj)
            else:
                first, multi = j_engine.make_fast_multistep(
                    self.jcfg, self.jgeom, self.inner, ref_state=self.jref)
                J, cj = multi(*first(j_fast.pack_state(self.js)))
            self.cache["jax"] = (
                {k: np.asarray(v) for k, v in
                 j_fast.unpack_state(J, self.jcfg.nz).items()},
                {k: np.asarray(v) for k, v in J.items()}, cj)
        return self.cache["jax"]

    def port(self, fused=None, merge=None):
        """The port's 3 steps (z-first tensors) per (fused, DSS grouping)."""
        if (fused, merge) not in self.cache:
            from tempestmodel_tpu_torch import fast as t_fast
            first, step = t_fast.make_fast_step(
                self.tcfg, self.tgeom, ref_state=self.ref, device=CPU,
                fused=fused, dss_merge=merge)
            X0 = convert.state_from_numpy(self.state, device=CPU)
            keep = {k: v.clone() for k, v in X0.items()}
            X, c = first(X0)
            for k in X0:                          # the input is left alone
                assert torch.equal(X0[k], keep[k]), k
            for _ in range(2):
                X, c = step(X, c)
            self.cache[fused, merge] = X
        return self.cache[fused, merge]

    def check_rayleigh(self):
        """The damping leaves Rho alone, the separate DSS launches with the
        plain Rayleigh finish match JAX to 1e-11, and the Rayleigh finish
        inside the one-launch DSS gives the same bits."""
        from tempestmodel_tpu_torch.fast import engine as t_engine
        fg = t_engine.build_fast_geometry(self.tgeom, dtype=torch.float64,
                                          device=CPU)
        fac, ref_term = t_engine._rayleigh_terms(self.tcfg, self.tgeom,
                                                 self.ref, fg)
        assert torch.equal(fac["Rho"], torch.ones_like(fac["Rho"]))
        assert float(fac["U"].min()) < 1.0
        assert float(ref_term["Rho"].abs().max()) == 0.0
        J = self.jax()[1]
        separate = self.port(merge=())
        merged = self.port(merge=("state", "scalar2"))
        for k in FIELDS:
            assert bool(torch.isfinite(separate[k]).all()), k
            assert rel_err(separate[k].numpy(), J[k]) < 1e-11, k
            assert torch.equal(separate[k], merged[k]), k
