"""Periodic Cartesian grids in the port vs the JAX package, float64 on the
CPU, the slice as a whole: 3 steps of ``make_fast_step`` for the
inertia-gravity waves and the 3-D thermal bubble
(``test_torch_cartesian.CASES``; the bubble swapped, with hyperdiffusion:
the nu4 passes on a plane), fused and unfused, both vertical solvers, each
against one JAX run.  U and V are measured against their common scale."""

import pytest

from test_torch_cartesian import _compare, _configs, slice_runs


@pytest.fixture(scope="module")
def runs():
    return slice_runs({name: _configs(name) for name in ("igw", "bubble3d")})


SLICE = [(n, s, f, None) for n in ("igw", "bubble3d")
         for s in ("pallas", "banded") for f in (None, False)]


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
