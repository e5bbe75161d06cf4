"""IMEX-ARK on the port's z-first engine against the JAX package, float64 on
the CPU: ``fast.make_fast_imex_step`` for ARS222 and ARS232, 2 steps from
the UMJS start at ne2 p4 nz6, with both vertical solvers (the fused implicit
kernel's plain version and the banded solve), 1e-11 relative per field.
JAX's step runs ``vertical_solver="banded"``, as JAX's own test does, and
is compiled once for the module; the other schemes are in the other
``test_torch_imex_*.py`` files, so that their JAX compiles run on other
workers."""

import pytest

from torch_port_common import ImexRuns, assert_imex_close

SCHEMES = ("ars222", "ars232")


@pytest.fixture(scope="module")
def runs():
    return ImexRuns()


@pytest.mark.parametrize("solver", ["pallas", "banded"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_two_imex_steps_match_jax(runs, scheme, solver):
    assert_imex_close(runs.torch(scheme, solver), runs.jax(scheme),
                      runs.start)
