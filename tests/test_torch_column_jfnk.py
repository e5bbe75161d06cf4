"""The port's JFNK column solver (``vertical_solver="jfnk"``: restarted
GMRES(48) x 2 with Givens rotations, ``models/jfnk.py``) against the JAX
package's, float64 on the CPU: 3 steps of ``make_fast_step``, fused and
unfused, against 3 steps of JAX ``nh_model.make_nh_step`` with the same
solver, on the cases of ``tests/test_torch_vertical_solvers.py`` (UMJS
ne2 p4 nz6, the thermal bubble from a seeded W, and 2 Newton iterations under
``jacobian_mode="reference"`` with 3 seeded species), 1e-11 relative per field.

JAX's J·v is its analytic fused JVP of the column residual, the port's a
band product with the analytic exact Jacobian: the two agree to roundoff,
and GMRES carries that roundoff on (past n = 3 nz + 1 Krylov vectors the
basis is amplified roundoff in either package).  Measured on the CPU: the
port's steps stay within 2.4e-13 of JAX's (W) on UMJS, so the 1e-11 bar
holds for JFNK too.  ``gmres_batched`` against JAX's on random well-posed
systems, the finite-difference probe and the band product are in
``test_torch_column_jfnk_pieces.py``."""

import pytest

import test_torch_vertical_solvers as base


@pytest.fixture(scope="module")
def jfnk_runs():
    return base.make_runs("jfnk")


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", list(base.CASES))
def test_jfnk_steps_match_make_nh_step(jfnk_runs, name, fused):
    configs, jax_run, torch_run = jfnk_runs
    base.assert_steps_close(torch_run(name, fused), jax_run(name),
                            configs(name)[4])
