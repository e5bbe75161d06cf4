"""Rossby-Haurwitz flow over the mountain on the cubed sphere
(``MountainRossby3D``), the port vs the JAX package, float64 on the CPU: 3
Strang-HEVI steps of ``make_fast_step`` at ne2 p4 nz6 from JAX's initial
state with a seeded W (``tests/test_torch_terrain_sphere.py``, whose set-up
this file shares) against JAX ``make_fast_step``, 1e-11 relative per
field, with both vertical solvers on the fused and the unfused path.  A
file of its own so that its JAX compile runs beside the other terrain
cases'."""

import pytest

import test_torch_terrain_sphere as base

STEPS = [("rossby", s, f) for s in ("pallas", "banded")
         for f in (None, False)]


@pytest.fixture(scope="module")
def runs():
    return base.make_runs()


@pytest.mark.parametrize("name,solver,fused", STEPS, ids=[
    f"{n}-{s}-{'fused' if f is None else 'unfused'}" for n, s, f in STEPS])
def test_three_steps_over_a_mountain_match_jax(runs, name, solver, fused):
    base.three_steps_match_jax(runs, name, solver, fused)
