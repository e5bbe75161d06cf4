"""The port's z-first engine vs the JAX package's: the horizontal
tendency, the hyperdiffusion tail, the full-state DSS (with and without the
folded W finish), and the slice as a whole (3 steps of ``make_fast_step``
on the fused path -- fused nu4 tail included -- and on the unfused path,
both Jacobian modes; ``make_fast_multistep``), float64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu.fast import engine as j_engine
from tempestmodel_tpu_torch import fast as t_fast, convert
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch.kernels.counts import launch_counts
import tempestmodel_tpu_torch as tt

from torch_port_common import (build_pair, initial_states, CPU, FIELDS,
                               fast_geometry_fields_numpy, random_fast_state,
                               rel_err)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def fgs(pair):
    jcfg, jgeom, tcfg, tgeom = pair
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    tfg = convert.fast_geometry_from_numpy(
        fast_geometry_fields_numpy(jfg), device=CPU, dtype=torch.float64)
    d = random_fast_state(jfg.nz, jfg.A, seed=11)
    # a smooth-ish state keeps the comparison away from cancellation noise
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    return jfg, tfg, jd, td, d


def test_horizontal_tendency(pair, fgs):
    jcfg, _, tcfg, _ = pair
    jfg, tfg, jd, td, d = fgs
    jt = jax.jit(lambda x: j_engine.horizontal_tendency(
        x, jfg, jcfg.constants))(jd)
    ttend = t_engine.horizontal_tendency(td, tfg, tcfg.constants)
    for k in FIELDS:
        assert ttend[k].is_contiguous(), k
        assert rel_err(ttend[k].numpy(), jt[k]) < 1e-12, k
    for k, v in td.items():
        np.testing.assert_array_equal(v.numpy(), d[k])


def test_apply_w_boundary(fgs):
    jfg, tfg, jd, td, _ = fgs
    jw = j_engine.apply_w_boundary(jd, jfg)["W"]
    tw = t_engine.apply_w_boundary(
        {k: v.clone() for k, v in td.items()}, tfg)["W"]
    assert rel_err(tw.numpy(), jw) < 1e-13


def test_apply_dss_full_state(fgs):
    jfg, tfg, jd, td, _ = fgs
    jo = j_engine.apply_dss(jd, jfg)
    before = dict(launch_counts)
    to = t_engine.apply_dss(td, tfg)
    tp = t_engine.apply_dss(td, tfg, plain=True)
    assert dict(launch_counts) == before     # CPU tensors: no launch
    for k in FIELDS:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=0,
                                   atol=1e-13 * float(np.abs(jo[k]).max()))
        assert torch.equal(to[k], tp[k])


def test_apply_dss_with_the_w_finish_folded_in(pair, fgs):
    """``apply_dss(w_finish=...)`` after a deferred fused stage, against the
    JAX package's (its stage and DSS kernels in interpret mode)."""
    from tempestmodel_tpu.fast import stage_pallas
    from tempestmodel_tpu_torch.fast import stage_cuda
    jcfg, _, tcfg, _ = pair
    jfg, tfg, jd, td, _ = fgs
    jupd, jwf = stage_pallas.fused_stage(jd, jd, 25.0, jfg, jcfg.constants,
                                         interpret=True, defer_w=True)
    jo = j_engine.apply_dss(jupd, jfg, w_finish=jwf)
    tupd, twf = stage_cuda.fused_stage(td, td, 25.0, tfg, tcfg.constants,
                                       defer_w=True)
    assert "W" not in tupd
    to = t_engine.apply_dss(tupd, tfg, w_finish=twf)
    tp = t_engine.apply_dss(tupd, tfg, w_finish=twf, plain=True)
    for k in FIELDS:
        assert rel_err(to[k].numpy(), jo[k]) < 1e-12, k
        assert torch.equal(to[k], tp[k])
    # the same state through the undeferred stage and the four-launch DSS
    full = t_engine.apply_dss(
        stage_cuda.fused_stage(td, td, 25.0, tfg, tcfg.constants), tfg)
    for k in FIELDS:
        assert rel_err(full[k].numpy(), to[k].numpy()) < 1e-13, k


@pytest.mark.parametrize("order", [4, 2])
def test_step_after_subcycle(pair, fgs, order):
    jcfg, _, tcfg, _ = pair
    jfg, tfg, jd, td, _ = fgs
    jc = jcfg.with_(hypervis_order=order)
    tc = tcfg.with_(hypervis_order=order)
    jo = jax.jit(lambda x: j_engine.step_after_subcycle(
        x, jc.dt, jc, jfg))(jd)
    to = t_engine.step_after_subcycle(td, tc.dt, tc, tfg)
    for k in FIELDS:
        assert rel_err(to[k].numpy(), jo[k]) < 1e-12, k


def test_fast_engine_supported_predicate(pair):
    _, _, tcfg, _ = pair
    assert t_engine.fast_engine_supported(tcfg)
    assert not t_engine.fast_engine_supported(
        tcfg.with_(grid_kind=tt.GridKind.CARTESIAN_XZ))
    # upwind_thermo=False runs on this engine since the vertical options
    # were ported, the other staggerings since they were; those not with
    # tracers
    assert t_engine.fast_engine_supported(tcfg.with_(upwind_thermo=False))
    cph = tcfg.with_(
        vertical_staggering=tt.VerticalStaggering.CHARNEY_PHILLIPS)
    assert t_engine.fast_engine_supported(cph)
    assert not t_engine.fast_engine_supported(cph, has_tracers=True)
    assert t_engine.fast_engine_supported(tcfg, has_tracers=True)
    assert not t_engine.fast_engine_supported(tcfg, mesh=object())


def _run_jax(jcfg, jgeom, js, nsteps, firsts=None):
    """``nsteps`` steps of JAX ``make_fast_step``; ``firsts`` (a dict), when
    given, keeps the state and carry after ``first_step`` under "X1"."""
    first, step = j_fast.make_fast_step(jcfg, jgeom)
    X, c = first(j_fast.pack_state(js))
    if firsts is not None:
        firsts["X1"] = (X, c)
    for _ in range(nsteps - 1):
        X, c = step(X, c)
    return j_fast.unpack_state(X, jcfg.nz)


def _run_torch(tcfg, tgeom, state_np, nsteps, **kw):
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU, **kw)
    X0 = convert.state_from_numpy(state_np, device=CPU, dtype=torch.float64)
    keep = {k: v.clone() for k, v in X0.items()}
    X, c = first(X0)
    for k in X0:                                  # the input is left alone
        assert torch.equal(X0[k], keep[k]), k
    for _ in range(nsteps - 1):
        X, c = step(X, c)
    return t_fast.unpack_state(X)


@pytest.fixture(scope="module")
def three_steps(pair):
    """3 steps of JAX ``make_fast_step`` per Jacobian mode (computed at
    first use, kept for the module), and of the port per (mode, path)."""
    jcfg, jgeom, tcfg, tgeom = pair
    js, _ = initial_states(jcfg, jgeom, tcfg, tgeom)
    state_np = {k: np.asarray(v) for k, v in js.items()}
    cache = {}

    def jax_run(mode, firsts=None):
        """``firsts``: see ``_run_jax`` (kept at the mode's first run)."""
        if ("jax", mode) not in cache:
            cache["firsts", mode] = {}
            cache["jax", mode] = _run_jax(
                jcfg.with_(jacobian_mode=mode), jgeom, js, 3,
                cache["firsts", mode])
        if firsts is not None:
            firsts.update(cache["firsts", mode])
        return cache["jax", mode]

    def torch_run(mode, fused):
        if (mode, fused) not in cache:
            cache[mode, fused] = _run_torch(
                tcfg.with_(jacobian_mode=mode), tgeom, state_np, 3,
                fused=fused)
        return cache[mode, fused]

    return jax_run, torch_run


@pytest.mark.parametrize("mode", ["exact", "reference"])
def test_three_steps_match_jax(three_steps, mode):
    """The slice as a whole on the path the predicates choose (the fused
    one): bit-identical initial state (JAX's, carried across as numpy), 3
    Strang-HEVI steps, 1e-11 relative per field."""
    jax_run, torch_run = three_steps
    want, got = jax_run(mode), torch_run(mode, None)
    for k in FIELDS:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k


@pytest.mark.parametrize("mode", ["exact", "reference"])
def test_three_steps_unfused_match_jax(three_steps, mode):
    jax_run, torch_run = three_steps
    want, got = jax_run(mode), torch_run(mode, False)
    for k in FIELDS:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k


@pytest.mark.parametrize("mode", ["exact", "reference"])
def test_fused_path_matches_unfused_path(three_steps, mode):
    _, torch_run = three_steps
    a, b = torch_run(mode, None), torch_run(mode, False)
    for k in FIELDS:
        assert rel_err(a[k].numpy(), b[k].numpy()) < 1e-11, k


@pytest.mark.parametrize("kw,want", [
    ({}, {"stage": 5, "uvw": 5, "update": 1, "banded": 0, "pass1": 1,
          "pass2": 1, "scalar": 16, "vector": 2, "state": 0, "scalar2": 0}),
    ({"fused": False},
     {"stage": 0, "uvw": 0, "update": 0, "banded": 1, "pass1": 0, "pass2": 0,
      "scalar": 21, "vector": 7, "state": 0, "scalar2": 0}),
    ({"dss_merge": ("state", "scalar2")},
     {"stage": 5, "uvw": 5, "update": 1, "banded": 0, "pass1": 1, "pass2": 1,
      "scalar": 0, "vector": 0, "state": 2, "scalar2": 5})],
    ids=["predicates", "forced_unfused", "one_launch_dss"])
def test_make_fast_step_takes_the_path_the_predicates_choose(
        pair, monkeypatch, kw, want):
    """Calls of the kernels' wrappers in one ``step`` (on the CPU each runs
    its plain version).  The fused path takes the fused nu4 tail."""
    from tempestmodel_tpu_torch.fast import (dss_cuda, hyper_cuda, implicit,
                                             implicit_cuda, stage_cuda)
    _, _, tcfg, tgeom = pair
    calls = dict.fromkeys(want, 0)
    if not kw:
        # the default DSS grouping is whatever was measured faster
        for name in t_engine.DSS_MERGE_DEFAULT:
            assert name in ("state", "scalar2")
        if "state" in t_engine.DSS_MERGE_DEFAULT:
            want = dict(want, state=2, vector=0, scalar=want["scalar"] - 6)
        if "scalar2" in t_engine.DSS_MERGE_DEFAULT:
            pairs = 5 if "state" in t_engine.DSS_MERGE_DEFAULT else 7
            want = dict(want, scalar2=pairs,
                        scalar=want["scalar"] - 2 * pairs)

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(stage_cuda, "fused_stage",
                        counting("stage", stage_cuda.fused_stage))
    monkeypatch.setattr(dss_cuda, "dss_uvw",
                        counting("uvw", dss_cuda.dss_uvw))
    monkeypatch.setattr(implicit_cuda, "fused_implicit_update", counting(
        "update", implicit_cuda.fused_implicit_update))
    monkeypatch.setattr(implicit, "banded_solve",
                        counting("banded", implicit.banded_solve))
    for key, name in (("pass1", "nu4_pass1"), ("pass2", "nu4_pass2")):
        monkeypatch.setattr(hyper_cuda, name,
                            counting(key, getattr(hyper_cuda, name)))
    for key in ("scalar", "vector", "state", "scalar2"):
        monkeypatch.setattr(dss_cuda, f"dss_{key}",
                            counting(key, getattr(dss_cuda, f"dss_{key}")))
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU, **kw)
    d = random_fast_state(tcfg.nz, tcfg.ne * tcfg.order, seed=2)
    X = {k: torch.from_numpy(v) for k, v in d.items()}
    carry = {k: torch.zeros_like(X[k]) for k in ("Rt", "W", "Rho")}
    step(X, carry)
    assert calls == want


def test_make_fast_step_refuses_an_unknown_dss_group(pair):
    _, _, tcfg, tgeom = pair
    with pytest.raises(ValueError, match="dss_merge"):
        t_fast.make_fast_step(tcfg, tgeom, device=CPU, dss_merge=("uvw",))
    with pytest.raises(ValueError, match="inner_steps"):
        t_fast.make_fast_multistep(tcfg, tgeom, 0, device=CPU)


@pytest.fixture(scope="module")
def multistep(pair, three_steps):
    """``first_step`` then one ``multi`` of 3 steps: the port's, the port's
    eager loop, and the JAX package's ``make_fast_multistep``.  JAX's
    ``first_step`` there is its ``make_fast_step``'s: its result is the one
    ``three_steps`` computed (the exact mode, this configuration's), so it
    is not compiled twice."""
    jcfg, jgeom, tcfg, tgeom = pair
    js, _ = initial_states(jcfg, jgeom, tcfg, tgeom)
    state_np = {k: np.asarray(v) for k, v in js.items()}
    X0 = convert.state_from_numpy(state_np, device=CPU, dtype=torch.float64)
    first, multi = t_fast.make_fast_multistep(tcfg, tgeom, 3, device=CPU)
    X, c = multi(*first(X0))
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU)
    E, ce = first(X0)
    for _ in range(3):
        E, ce = step(E, ce)
    assert jcfg.jacobian_mode == "exact"
    firsts = {}
    three_steps[0]("exact", firsts)
    _, jmulti = j_engine.make_fast_multistep(jcfg, jgeom, 3)
    J, cj = jmulti(*firsts["X1"])
    return (X, c), (E, ce), (J, cj)


def test_multistep_equals_the_eager_steps(multistep):
    (X, c), (E, ce), _ = multistep
    for k in FIELDS:
        assert torch.equal(X[k], E[k]), k
    for k in c:
        assert torch.equal(c[k], ce[k]), k


def test_multistep_matches_jax_multistep(multistep):
    (X, c), _, (J, cj) = multistep
    for k in FIELDS:
        assert rel_err(X[k].numpy(), J[k]) < 1e-11, k
    assert set(c) == set(cj)


def test_rayleigh_and_off_centering(pair):
    """Rayleigh damping and the off-centred implicit combination (0.1): 3
    steps at ne4 p4 nz8 against JAX ``make_fast_step`` from the same state,
    1e-11 relative per field; the damping leaves Rho alone, and the Rayleigh
    finish inside the one-launch DSS gives the same bits."""
    jcfg, _, tcfg, _ = pair
    from tempestmodel_tpu.models import nh_model as j_nh_model
    from tempestmodel_tpu.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS as JaxUMJS)
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    tc = BaroclinicWaveUMJS(pert="exp", rayleigh=True)
    jtc = JaxUMJS(pert="exp", rayleigh=True)
    kw = dict(rayleigh_damping=True, off_centering=0.1)
    cfg, jc = tcfg.with_(**kw), jcfg.with_(**kw)
    geom = nh_model.build_nh_sphere_geometry(
        cfg, ztop=tc.ztop, rayleigh=tc.rayleigh_strength)
    jgeom = j_nh_model.build_nh_sphere_geometry(
        jc, ztop=jtc.ztop, rayleigh=jtc.rayleigh_strength)
    js = jtc.initial_state(jgeom, jc.constants, dtype=jnp.float64)
    jref = jtc.reference_state(jgeom, jc.constants, dtype=jnp.float64)
    ref = {k: np.array(v) for k, v in jref.items()}
    state = {k: np.asarray(v) for k, v in js.items()}
    fg = t_engine.build_fast_geometry(geom, dtype=torch.float64, device=CPU)
    fac, ref_term = t_engine._rayleigh_terms(cfg, geom, ref, fg)
    assert torch.equal(fac["Rho"], torch.ones_like(fac["Rho"]))
    assert float(fac["U"].min()) < 1.0
    assert float(ref_term["Rho"].abs().max()) == 0.0

    first, step = j_fast.make_fast_step(jc, jgeom, ref_state=jref)
    J, cj = first(j_fast.pack_state(js))
    for _ in range(2):
        J, cj = step(J, cj)
    outs = []
    for merge in ((), ("state", "scalar2")):
        first, step = t_fast.make_fast_step(cfg, geom, ref_state=ref,
                                            device=CPU, dss_merge=merge)
        X, c = first(convert.state_from_numpy(state, device=CPU))
        for _ in range(2):
            X, c = step(X, c)
        outs.append(X)
    for k in FIELDS:
        assert bool(torch.isfinite(outs[0][k]).all()), k
        assert rel_err(outs[0][k].numpy(), J[k]) < 1e-11, k
        # the Rayleigh finish inside the one-launch DSS: the same bits
        assert torch.equal(outs[0][k], outs[1][k]), k


@pytest.mark.gpu
def test_kernel_path_matches_plain_path_on_the_card(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    _, _, tcfg, tgeom = pair
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    state = BaroclinicWaveUMJS(pert="exp").initial_state(
        tgeom, tcfg.constants, device="cuda")
    outs = []
    for kw in ({}, {"fused": False}, {"plain": True}):
        first, step = t_fast.make_fast_step(tcfg, tgeom, device="cuda", **kw)
        X, c = first(t_fast.pack_state(state, device="cuda"))
        X, c = step(X, c)
        outs.append(X)
    for other in outs[1:]:
        for k in FIELDS:
            assert rel_err(outs[0][k].cpu().numpy(),
                           other[k].cpu().numpy()) < 1e-11, k
    # one graph replay of one step: the eager step's result
    first, multi = t_fast.make_fast_multistep(tcfg, tgeom, 1, device="cuda")
    X, c = multi(*first(t_fast.pack_state(state, device="cuda")))
    for k in FIELDS:
        assert rel_err(X[k].cpu().numpy(), outs[0][k].cpu().numpy()) < 1e-13
