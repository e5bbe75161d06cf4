"""The port's z-first engine as a whole against the JAX package's, the
reference Jacobian, with the UMJS case's Rayleigh layer and the off-centred
implicit combination (0.1): 3 steps of ``make_fast_step`` at ne4 p4 nz8
(``tests/test_fast_engine.py``'s configuration) on the fused path, on the
unfused path and with every DSS grouping, from the same state, float64,
1e-11 relative per field.  One JAX run (its ``first_step`` and two of its
``step``) is the reference of every test here; the exact Jacobian's is
``test_torch_engine_steps.py``'s."""

import pytest

from torch_port_common import RayleighUMJS, FIELDS, rel_err

MODES = ["reference"]


@pytest.fixture(scope="module")
def case():
    return RayleighUMJS(jacobian_mode="reference")


@pytest.mark.parametrize("mode", MODES)
def test_three_steps_match_jax(case, mode):
    """The path the predicates choose (the fused one, the default DSS
    grouping: the Rayleigh finish inside ``dss_state``)."""
    J, got = case.jax()[1], case.port()
    for k in FIELDS:
        assert rel_err(got[k].numpy(), J[k]) < 1e-11, k


@pytest.mark.parametrize("mode", MODES)
def test_three_steps_unfused_match_jax(case, mode):
    J, got = case.jax()[1], case.port(fused=False)
    for k in FIELDS:
        assert rel_err(got[k].numpy(), J[k]) < 1e-11, k


@pytest.mark.parametrize("mode", MODES)
def test_fused_path_matches_unfused_path(case, mode):
    a, b = case.port(), case.port(fused=False)
    for k in FIELDS:
        assert rel_err(a[k].numpy(), b[k].numpy()) < 1e-11, k


@pytest.mark.parametrize("mode", MODES)
def test_rayleigh_and_off_centering(case, mode):
    """The damping leaves Rho alone, the separate DSS launches with the
    plain Rayleigh finish match JAX to 1e-11, and the Rayleigh finish
    inside the one-launch DSS gives the same bits."""
    case.check_rayleigh()
