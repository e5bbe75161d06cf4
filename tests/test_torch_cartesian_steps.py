"""Periodic Cartesian grids in the port vs the JAX package, float64 on the
CPU, the slice as a whole: 3 steps of ``make_fast_step`` for the Schar
mountain waves (``test_torch_cartesian.CASES``), fused and unfused, both
vertical solvers, in both layouts, against one JAX run; the two layouts
against each other.  U and V are measured against their common scale (V of
an x-z slice is roundoff)."""

import pytest

from test_torch_cartesian import _compare, _configs, slice_runs


@pytest.fixture(scope="module")
def runs():
    return slice_runs({name: _configs(name) for name in ("schar",)})


SLICE = [("schar", s, f, w) for s in ("pallas", "banded")
         for f in (None, False) for w in (True, False)]


@pytest.mark.parametrize("name,solver,fused,swap", SLICE, ids=[
    f"{n}-{s}-{'fused' if f is None else 'unfused'}"
    + ("" if w is None else ("-swapped" if w else "-natural"))
    for n, s, f, w in SLICE])
def test_three_steps_match_jax(runs, name, solver, fused, swap):
    """3 Strang-HEVI steps from JAX's own initial state, 1e-11 relative per
    field against JAX ``make_fast_step`` (whose layout is its default:
    swapped for all three cases)."""
    jax_run, torch_run = runs
    _compare(torch_run(name, solver, fused, swap), jax_run(name), 1e-11)


def test_the_two_layouts_agree(runs):
    """The swap is an exact relabeling: both layouts give one trajectory
    (to rounding: the sums run in another order)."""
    _, torch_run = runs
    a = torch_run("schar", "pallas", None, True)
    b = torch_run("schar", "pallas", None, False)
    _compare(a, b, 1e-12)
