"""The full-state DSS (every grouping, and with the W finish of a deferred
fused stage) and the hyperdiffusion tail (nu4, nu2, none) with three seeded
tracer species in the state, the port against the JAX package's (its
Pallas kernels in interpret mode), float64 on the CPU, on
``test_torch_tracers``'s terrain-like geometry and seeded moist states."""

import numpy as np
import jax
import pytest
import torch

from tempestmodel_tpu.fast import engine as j_engine
from tempestmodel_tpu_torch.fast import engine as t_engine

from torch_port_common import build_pair, rel_err
from test_torch_tracers import ALL, TOL, species_err
import test_torch_tracers


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def fgs(pair):
    return test_torch_tracers.make_fgs(pair)


@pytest.fixture(scope="module")
def jax_dss(fgs):
    jfg, _, (jd, _), _ = fgs
    return j_engine.apply_dss(jd, jfg)


@pytest.mark.parametrize("merge", [(), ("state",), ("scalar2",),
                                   ("state", "scalar2")],
                         ids=["separate", "state", "scalar2", "both"])
def test_apply_dss_with_tracers(fgs, jax_dss, merge):
    _, tfg, (_, td), _ = fgs
    want = jax_dss
    got = t_engine.apply_dss(td, tfg, merge=merge)
    plain = t_engine.apply_dss(td, tfg, merge=merge, plain=True)
    assert set(got) == set(want) == set(ALL)
    for k in ALL:
        assert got[k].is_contiguous(), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-13 * float(
                                       np.abs(want[k]).max()))
        assert torch.equal(got[k], plain[k]), k


def test_apply_dss_with_tracers_and_the_w_finish(pair, fgs):
    """After a deferred fused stage with tracers: (U, V, W) in one launch,
    the tracers beside it, against the JAX package's kernels in interpret
    mode."""
    from tempestmodel_tpu.fast import stage_pallas
    from tempestmodel_tpu_torch.fast import stage_cuda
    jcfg, _, tcfg, _ = pair
    jfg, tfg, (jd, td), _ = fgs
    jupd, jwf = stage_pallas.fused_stage(jd, jd, 25.0, jfg, jcfg.constants,
                                         interpret=True, defer_w=True)
    want = j_engine.apply_dss(jupd, jfg, w_finish=jwf)
    tupd, twf = stage_cuda.fused_stage(td, td, 25.0, tfg, tcfg.constants,
                                       defer_w=True)
    for merge in ((), ("scalar2",)):
        got = t_engine.apply_dss(tupd, tfg, w_finish=twf, merge=merge)
        assert set(got) == set(ALL)
        for k in ALL:
            assert rel_err(got[k].numpy(), want[k]) < TOL, k


@pytest.mark.parametrize("order", [4, 2, 0], ids=["nu4", "nu2", "none"])
def test_step_after_subcycle_with_tracers(pair, fgs, order):
    """The tail with tracers: their Laplacian beside the five fields', and
    the per-element positivity filter before the last DSS -- also when
    there is no hyperdiffusion at all."""
    jcfg, _, tcfg, _ = pair
    jfg, tfg, (jd, td), _ = fgs
    kw = dict(hypervis_order=order) if order else dict(hyperdiffusion=False)
    jc, tc = jcfg.with_(**kw), tcfg.with_(**kw)
    want = jax.jit(lambda x: j_engine.step_after_subcycle(
        x, jc.dt, jc, jfg))(jd)
    got = t_engine.step_after_subcycle(td, tc.dt, tc, tfg)
    assert set(got) == set(want) == set(ALL)
    for k in ALL:
        assert rel_err(got[k].numpy(), want[k]) < TOL, k
    assert species_err(got["Tracers"].numpy(), want["Tracers"],
                       tfg.nz) < TOL
    assert rel_err(got["Tracers"].numpy(), td["Tracers"].numpy()) > 1e-3
    if order == 4:
        # the two nu4 kernels' wrappers (their plain versions here) around
        # the same tracer code
        fused = t_engine.step_after_subcycle(td, tc.dt, tc, tfg,
                                             use_fused_hyper=True)
        for k in ALL:
            assert rel_err(fused[k].numpy(), got[k].numpy()) < TOL, k
