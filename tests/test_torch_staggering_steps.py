"""The CPH, LEV and INT staggerings as a whole against the JAX package's
``make_nh_step`` on the inertia-gravity wave x-z slice
(``test_torch_staggering.CASES``): 3 steps of ``make_fast_step``, the fused
choice and ``fused=False``, 1e-11 relative per field, under CPH, LEV, INT
and CPH with nu4; that nu4 moves the step by far more than the
tolerance."""

import numpy as np
import pytest

from test_torch_staggering import case_runs, check_steps

NAMES = ["cph", "lev", "int", "cph_nu4"]


@pytest.fixture(scope="module")
def runs():
    return case_runs()


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", NAMES)
def test_staggered_steps_match_make_nh_step(runs, name, fused):
    check_steps(runs, name, fused)


def test_nu4_moves_the_staggered_step(runs):
    """The x-z slice's nu4 is strong enough for the comparisons above to
    see it: with it the state differs from the one without by far more
    than the tolerance."""
    without = runs("cph")[1]
    with_nu4 = runs("cph_nu4")[1]
    d = max(np.abs(with_nu4[k] - without[k]).max() / np.abs(without[k]).max()
            for k in ("Rt", "W", "Rho"))
    assert d > 1e-8
