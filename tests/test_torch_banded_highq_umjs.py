"""UMJS at vertical order 2 with the ``"pallas"`` solver (the unfused
path: the banded kernel's wide route, q 10) against the JAX package's
``make_fast_step`` (its banded solver), 3 steps, float64, 1e-11 relative per
field.  The orders 3, the finite-volume order 2 and a stretched grid are
``slow``.  (``test_torch_banded_highq.py`` has the solves themselves.)"""

import numpy as np
import pytest

from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu_torch import fast as t_fast, convert
from tempestmodel_tpu_torch.models import nonhydro as t_nonhydro

from torch_port_common import build_pair, initial_states, CPU, FIELDS, rel_err
from test_torch_banded_highq import F64


# ---------------------------------------------------------------------------
# the step at vertical order 2 and up ("pallas": the unfused path's banded
# kernel where the fused implicit kernel does not take the order)
# ---------------------------------------------------------------------------

UMJS = dict(ne=2, order=4, nz=6)


def _three_steps(jcfg, jgeom, tcfg, tgeom):
    """3 steps of both packages' ``make_fast_step`` from the JAX initial
    state; returns the worst relative error of a field and the port's
    half-bandwidth."""
    js, _ = initial_states(jcfg, jgeom, tcfg, tgeom)
    jfirst, jstep = j_fast.make_fast_step(jcfg, jgeom)
    jX, jc = jfirst(j_fast.pack_state(js))
    for _ in range(2):
        jX, jc = jstep(jX, jc)
    want = j_fast.unpack_state(jX, jcfg.nz)
    tfirst, tstep = t_fast.make_fast_step(tcfg, tgeom, device=CPU)
    tX, tc = tfirst(convert.state_from_numpy(
        {k: np.asarray(v) for k, v in js.items()}, device=CPU, dtype=F64))
    for _ in range(2):
        tX, tc = tstep(tX, tc)
    got = t_fast.unpack_state(tX)
    errs = {k: rel_err(got[k].numpy(), want[k]) for k in FIELDS}
    q = t_nonhydro.estimate_bandwidth(tgeom, tcfg.constants)
    return max(errs.values()), q


def _pair(**kw):
    """The port with ``"pallas"`` (the solver that raised), the JAX package
    with ``"banded"``: the same elimination as its Pallas kernel, which on
    the CPU runs in interpret mode and takes minutes to compile at q 10."""
    return build_pair(**{**UMJS, **kw})


def test_umjs_vertical_order_2_pallas_matches_jax():
    """q = 10 raised in the port before the repair; the unfused path now
    takes the wide form of ``banded_solve`` and the step equals JAX's."""
    jcfg, jgeom, tcfg, tgeom = _pair(vertical_order=2)
    err, q = _three_steps(jcfg, jgeom, tcfg, tgeom)
    assert q == 10
    assert err < 1e-11, err


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["order3", "fv_order2", "stretched"])
def test_umjs_wider_bands_match_jax(variant):
    kw = {"order3": dict(vertical_order=3),
          "fv_order2": dict(vertical_order=2, vertical_discretization="FV"),
          "stretched": dict(vertical_order=2,
                            vertical_stretch="cubic")}[variant]
    jcfg, jgeom, tcfg, tgeom = _pair(**kw)
    err, q = _three_steps(jcfg, jgeom, tcfg, tgeom)
    # the finite-volume column of order 2 is banded like order 1 (q 4)
    assert q == (4 if variant == "fv_order2" else 16 if variant == "order3"
                 else 10)
    assert err < 1e-11, (variant, err)
