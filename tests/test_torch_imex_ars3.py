"""IMEX-ARK on the port's z-first engine against the JAX package, float64 on
the CPU: ``fast.make_fast_imex_step`` for the four-stage schemes ARS343,
ARS343b, ARS443 and SSP3332 (whose first stage is explicit-free: its DSS
takes the step's start itself), 2 steps from the UMJS start at ne2 p4 nz6,
with both vertical solvers, 1e-11 relative per field.  A file apart from
``tests/test_torch_imex.py`` so that the two files' JAX compiles run on two
workers.  Each JAX step is compiled once for the module."""

import pytest

from torch_port_common import ImexRuns, assert_imex_close

SCHEMES = ("ars343", "ars343b", "ars443", "ssp3332")


@pytest.fixture(scope="module")
def runs():
    return ImexRuns()


@pytest.mark.parametrize("solver", ["pallas", "banded"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_two_imex_steps_match_jax(runs, scheme, solver):
    assert_imex_close(runs.torch(scheme, solver), runs.jax(scheme),
                      runs.start)


@pytest.mark.parametrize("scheme", ["ars343", "ssp3332"])
def test_the_step_leaves_its_input_alone(runs, scheme):
    """The bottom W boundary writes in place; SSP3332's first stage DSSes
    the step's start itself, which must stay as it was."""
    import numpy as np
    import torch
    from tempestmodel_tpu_torch import fast as t_fast
    from torch_port_common import CPU, FIELDS
    step = t_fast.make_fast_imex_step(runs.configs(scheme)[1], runs.tgeom,
                                      device=CPU)
    s = {k: torch.from_numpy(v.copy()) for k, v in runs.start.items()}
    step(s)
    for k in FIELDS:
        assert np.array_equal(s[k].numpy(), runs.start[k]), k
