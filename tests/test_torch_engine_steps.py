"""The port's z-first engine as a whole against the JAX package's, the
exact Jacobian (the configuration's default), with the UMJS case's Rayleigh
layer and the off-centred implicit combination (0.1): 3 steps of
``make_fast_step`` on the fused path (the fused nu4 tail included) and on
the unfused path, every DSS grouping, and ``make_fast_multistep``, from the
same UMJS start (ne4 p4 nz8, ``tests/test_fast_engine.py``'s
configuration), float64, 1e-11 relative per field.

The JAX package's reference is its ``first_step`` followed by its
``make_fast_multistep`` of 2 steps (a scan of its ``step``): the 3-step
state every port path here is held to, from two JAX compiles (the
reference Jacobian's is ``test_torch_engine_rayleigh.py``'s)."""

import pytest
import torch

from tempestmodel_tpu_torch import fast as t_fast, convert

from torch_port_common import RayleighUMJS, CPU, FIELDS, rel_err

MODES = ["exact"]
INNER = 2       # the steps of the multistep graph after first_step


@pytest.fixture(scope="module")
def case():
    return RayleighUMJS(inner=INNER, jacobian_mode="exact")


@pytest.mark.parametrize("mode", MODES)
def test_three_steps_match_jax(case, mode):
    """The slice as a whole on the path the predicates choose (the fused
    one): bit-identical initial state (JAX's, carried across as numpy), 3
    Strang-HEVI steps, 1e-11 relative per field."""
    want, got = case.jax()[0], t_fast.unpack_state(case.port())
    for k in FIELDS:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k


@pytest.mark.parametrize("mode", MODES)
def test_three_steps_unfused_match_jax(case, mode):
    want = case.jax()[0]
    got = t_fast.unpack_state(case.port(fused=False))
    for k in FIELDS:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k


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


@pytest.fixture(scope="module")
def multistep(case):
    """``first_step`` then one ``multi`` of ``INNER`` steps: the port's,
    the port's eager loop, and the JAX package's ``make_fast_multistep``
    (the run ``case`` holds)."""
    X0 = convert.state_from_numpy(case.state, device=CPU,
                                  dtype=torch.float64)
    first, multi = t_fast.make_fast_multistep(
        case.tcfg, case.tgeom, INNER, ref_state=case.ref, device=CPU)
    X, c = multi(*first(X0))
    first, step = t_fast.make_fast_step(case.tcfg, case.tgeom,
                                        ref_state=case.ref, device=CPU)
    E, ce = first(X0)
    for _ in range(INNER):
        E, ce = step(E, ce)
    assert case.jcfg.jacobian_mode == "exact"
    _, J, cj = case.jax()
    return (X, c), (E, ce), (J, cj)


def test_multistep_equals_the_eager_steps(multistep):
    (X, c), (E, ce), _ = multistep
    for k in FIELDS:
        assert torch.equal(X[k], E[k]), k
    for k in c:
        assert torch.equal(c[k], ce[k]), k


def test_multistep_matches_jax_multistep(multistep):
    (X, c), _, (J, cj) = multistep
    for k in FIELDS:
        assert rel_err(X[k].numpy(), J[k]) < 1e-11, k
    assert set(c) == set(cj)
