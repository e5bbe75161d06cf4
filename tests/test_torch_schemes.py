"""Two of the four explicit sub-schemes beside KGU(3,5), forward Euler and
RK4 (``test_torch_schemes_ssp.py`` has SSPRK3 and SSPRK53): one
``first_step`` of the port's ``make_fast_step`` vs the JAX package's,
float64, from JAX's initial state carried across as numpy.  (Files of
their own: each scheme costs one compile of the JAX step.)"""

import numpy as np
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu_torch import fast as t_fast, convert

from torch_port_common import (build_pair, initial_states, CPU, FIELDS,
                               rel_err)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.mark.parametrize("scheme", ["fe", "rk4"])
def test_other_explicit_schemes_one_step(pair, scheme):
    check_one_step(pair, scheme)


def check_one_step(pair, scheme):
    jcfg, jgeom, tcfg, tgeom = pair
    js, _ = initial_states(jcfg, jgeom, tcfg, tgeom)
    jc = jcfg.with_(explicit_scheme=tj.ExplicitSubScheme(scheme))
    tc = tcfg.with_(explicit_scheme=tt.ExplicitSubScheme(scheme))

    first, _ = j_fast.make_fast_step(jc, jgeom)
    jX, _ = first(j_fast.pack_state(js))
    want = j_fast.unpack_state(jX, jc.nz)

    tfirst, _ = t_fast.make_fast_step(tc, tgeom, device=CPU)
    tX, _ = tfirst(convert.state_from_numpy(
        {k: np.asarray(v) for k, v in js.items()}, device=CPU,
        dtype=torch.float64))
    got = t_fast.unpack_state(tX)
    for k in FIELDS:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k
