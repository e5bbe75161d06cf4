"""The port's z-first engine vs the JAX package's (its Pallas kernels in
interpret mode), float64 on the CPU, on ``test_torch_engine``'s seeded
state: the full-state DSS (with and without the W finish of a deferred
fused stage folded in) and the hyperdiffusion tail (order 4 and 2)."""

import numpy as np
import jax
import pytest
import torch

from tempestmodel_tpu.fast import engine as j_engine
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch.kernels.counts import launch_counts

from torch_port_common import build_pair, FIELDS, rel_err
import test_torch_engine


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def fgs(pair):
    return test_torch_engine.make_fgs(pair)


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
