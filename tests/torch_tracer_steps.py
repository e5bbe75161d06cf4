"""Shared by ``test_torch_tracers_steps.py`` and
``test_torch_tracers_reference.py``: the moist slice as a whole, 3 steps of
``make_fast_step`` with three seeded tracer species in both packages from
the same perturbed start (``test_torch_tracers.moist_state_numpy``), one
Jacobian mode a file, so that each file compiles its JAX steps once."""

import numpy as np
import jax.numpy as jnp
import torch

from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu_torch import fast as t_fast

from torch_port_common import CPU, rel_err
from test_torch_tracers import ALL, moist_state_numpy, species_err


def _run_torch(tcfg, tgeom, d, nsteps, **kw):
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU, **kw)
    X0 = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    X, c = first(X0)
    for k in X0:                                  # the input is left alone
        np.testing.assert_array_equal(X0[k].numpy(), d[k])
    for _ in range(nsteps - 1):
        X, c = step(X, c)
    return X, c


def three_steps(pair):
    """(jax_run(mode), torch_run(mode, fused), start): 3 moist steps of JAX
    ``make_fast_step`` per Jacobian mode (computed at first use, kept by the
    caller's module fixture), and of the port per (mode, path)."""
    jcfg, jgeom, tcfg, tgeom = pair
    d = moist_state_numpy(jcfg, jgeom, seed=21)
    cache = {}

    def jax_run(mode):
        if ("jax", mode) not in cache:
            first, step = j_fast.make_fast_step(
                jcfg.with_(jacobian_mode=mode), jgeom)
            X, c = first({k: jnp.asarray(v) for k, v in d.items()})
            for _ in range(2):
                X, c = step(X, c)
            cache["jax", mode] = ({k: np.asarray(v) for k, v in X.items()},
                                  set(c))
        return cache["jax", mode]

    def torch_run(mode, fused):
        if (mode, fused) not in cache:
            cache[mode, fused] = _run_torch(
                tcfg.with_(jacobian_mode=mode), tgeom, d, 3, fused=fused)
        return cache[mode, fused]

    return jax_run, torch_run, d


def check_three_moist_steps(three_steps, mode, fused):
    """The same perturbed moist state through 3 Strang-HEVI steps of both
    packages: 1e-11 relative on the five fields and on every species."""
    jax_run, torch_run, d = three_steps
    (want, wcarry), (got, carry) = jax_run(mode), torch_run(mode, fused)
    assert set(got) == set(want) == set(ALL)
    assert set(carry) == wcarry == {"Rt", "W", "Rho", "Tracers"}
    for k in ALL:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k
    assert species_err(got["Tracers"].numpy(), want["Tracers"],
                       d["Rt"].shape[0]) < 1e-11
    assert float(got["Tracers"].min()) >= 0.0
    assert rel_err(got["Tracers"].numpy(), d["Tracers"]) > 1e-3
