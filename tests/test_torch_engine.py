"""The port's z-first engine vs the JAX package's: the horizontal
tendency, the bottom W boundary, the path predicates and the kernels a step
goes through, float64 (the full-state DSS with and without the folded W
finish and the hyperdiffusion tail: ``test_torch_engine_tail.py``).  The slice as a whole (3 steps against JAX ``make_fast_step``) is
in ``test_torch_engine_steps.py`` (the exact Jacobian, ``make_fast_multistep``)
and ``test_torch_engine_rayleigh.py`` (the reference Jacobian with the
Rayleigh layer and off-centring)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.fast import engine as j_engine
from tempestmodel_tpu_torch import fast as t_fast, convert
from tempestmodel_tpu_torch.fast import engine as t_engine
import tempestmodel_tpu_torch as tt

from torch_port_common import (build_pair, CPU, FIELDS,
                               fast_geometry_fields_numpy, random_fast_state,
                               rel_err)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def make_fgs(pair):
    jcfg, jgeom, tcfg, tgeom = pair
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    tfg = convert.fast_geometry_from_numpy(
        fast_geometry_fields_numpy(jfg), device=CPU, dtype=torch.float64)
    d = random_fast_state(jfg.nz, jfg.A, seed=11)
    # a smooth-ish state keeps the comparison away from cancellation noise
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    return jfg, tfg, jd, td, d


@pytest.fixture(scope="module")
def fgs(pair):
    return make_fgs(pair)


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
