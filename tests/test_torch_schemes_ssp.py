"""Two of the four explicit sub-schemes beside KGU(3,5), SSPRK3 and
SSPRK53 (``test_torch_schemes.py`` has forward Euler and RK4): one
``first_step`` of the port's ``make_fast_step`` vs the JAX package's,
float64, 1e-11 relative per field."""

import pytest

from torch_port_common import build_pair
from test_torch_schemes import check_one_step


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.mark.parametrize("scheme", ["ssprk3", "ssprk53"])
def test_other_explicit_schemes_one_step(pair, scheme):
    check_one_step(pair, scheme)
