"""The CPH, LEV and INT staggerings with the vertical options against the
JAX package's ``make_nh_step`` on the inertia-gravity wave x-z slice
(``test_torch_staggering.CASES``): 3 steps of ``make_fast_step``, the fused
choice and ``fused=False``, 1e-11 relative per field, under CPH with
``upwind_thermo=False``, the explicit vertical path under CPH and LEV, and
INT with nu4 (JAX's tail assembled by rows: ``jax_tail_by_rows``);
``vertical_solver="pallas"`` under CPH is the dense step."""

import numpy as np
import pytest

from test_torch_staggering import case_runs, check_steps, port_steps
from test_torch_vertical_solvers import assert_steps_close
from torch_port_common import FIELDS

NAMES = ["cph_upwind_off", "cph_explicit", "lev_explicit", "int_nu4"]


@pytest.fixture(scope="module")
def runs():
    return case_runs()


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", NAMES)
def test_staggered_steps_match_make_nh_step(runs, name, fused):
    check_steps(runs, name, fused)


def test_pallas_solver_is_the_dense_step(runs):
    """``vertical_solver="pallas"`` solves a staggered state densely, as
    the JAX package does: the same bits as ``"dense"``."""
    (jcfg, tcfg, jgeom, tgeom, start, ref), want = runs("cph")
    dense = port_steps(tcfg, tgeom, start, ref)
    pallas = port_steps(tcfg.with_(vertical_solver="pallas"), tgeom, start,
                        ref)
    for k in FIELDS:
        np.testing.assert_array_equal(pallas[k], dense[k], k)
    assert_steps_close(pallas, want, start)
