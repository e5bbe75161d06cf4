"""The moist slice as a whole against the JAX package's, the reference
Jacobian: 3 steps of ``make_fast_step`` with three seeded tracer species,
fused and unfused (``torch_tracer_steps``; the exact Jacobian is
``test_torch_tracers_steps.py``'s)."""

import pytest

import torch_tracer_steps
from torch_port_common import build_pair

MODES = ["reference"]


@pytest.fixture(scope="module")
def three_steps():
    return torch_tracer_steps.three_steps(build_pair())


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("mode", MODES)
def test_three_moist_steps_match_jax(three_steps, mode, fused):
    torch_tracer_steps.check_three_moist_steps(three_steps, mode, fused)
