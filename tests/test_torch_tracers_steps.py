"""The moist slice as a whole against the JAX package's, the exact
Jacobian: 3 steps of ``make_fast_step`` with three seeded tracer species,
fused and unfused, the two paths against each other, and
``make_fast_multistep`` against the eager steps (``torch_tracer_steps``;
the reference Jacobian is ``test_torch_tracers_reference.py``'s)."""

import pytest
import torch

from tempestmodel_tpu_torch import fast as t_fast

import torch_tracer_steps
from torch_port_common import build_pair, CPU, rel_err
from test_torch_tracers import ALL

MODES = ["exact"]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def three_steps(pair):
    return torch_tracer_steps.three_steps(pair)


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("mode", MODES)
def test_three_moist_steps_match_jax(three_steps, mode, fused):
    torch_tracer_steps.check_three_moist_steps(three_steps, mode, fused)


def test_moist_fused_path_matches_unfused_path(three_steps):
    _, torch_run, _ = three_steps
    (a, _), (b, _) = torch_run("exact", None), torch_run("exact", False)
    for k in ALL:
        assert rel_err(a[k].numpy(), b[k].numpy()) < 1e-11, k


def test_moist_multistep_equals_the_eager_steps(pair, three_steps):
    """``make_fast_multistep(3)`` after ``first_step``: the bits of 3 eager
    steps, the tracers and their carry included."""
    _, _, tcfg, tgeom = pair
    _, _, d = three_steps
    X0 = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    first, multi = t_fast.make_fast_multistep(tcfg, tgeom, 3, device=CPU)
    X, c = multi(*first(X0))
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU)
    E, ce = first(X0)
    for _ in range(3):
        E, ce = step(E, ce)
    assert set(X) == set(ALL) and set(c) == {"Rt", "W", "Rho", "Tracers"}
    for k in ALL:
        assert torch.equal(X[k], E[k]), k
    for k in c:
        assert torch.equal(c[k], ce[k]), k
