"""The perturbed Jablonowski-Williamson wave on the cubed sphere, the port vs
the JAX package, float64 on the CPU: 3 Strang-HEVI steps of
``make_fast_step`` at ne2 p4 nz6 (its surface geopotential as the terrain,
nu4) from JAX's initial state with the seeded W of
``tests/test_torch_terrain_sphere.py`` (whose set-up this file shares),
against JAX ``make_fast_step``, 1e-11 relative per field, on the fused and
the unfused path.  A file of its own so that its JAX compile (about a
minute and a half) runs beside the other terrain cases'."""

import pytest

import test_torch_terrain_sphere as base


@pytest.fixture(scope="module")
def runs():
    return base.make_runs()


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
def test_three_steps_of_jw_match_jax(runs, fused):
    base.three_steps_match_jax(runs, "jw", "pallas", fused)

