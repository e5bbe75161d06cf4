"""The port's CLI with the vertical options of this slice against the JAX
package's CLI, float64 on the CPU: ``--vmethod DENSE`` and ``JFNK`` (dt
200 s), ``--vmethod NONE`` and ``--explicitvertical`` (the explicit
vertical path, dt 10 s) on ``umjs_pert`` at resolution 2 with 6 levels for
3 steps, compared through each CLI's final checkpoint (1e-11 relative per
field; U and V against their common scale).  Each JAX configuration
compiles one JAX step: ``NONE`` and ``--explicitvertical`` share one."""

import glob
import os

import numpy as np
import pytest
import torch

from tempestmodel_tpu import cli as j_cli
from tempestmodel_tpu_torch import cli as t_cli
from tempestmodel_tpu_torch.io import output as t_output

from torch_port_common import CPU, FIELDS

TOL = 1e-11
NSTEPS = 3


def final_checkpoint(root, dt):
    files = sorted(glob.glob(os.path.join(root, "restart.*")))
    assert files, f"no checkpoint in {root}"
    state, _, t, step = t_output.CompositeCheckpoint.load(files[-1],
                                                          device=CPU)
    assert step == NSTEPS and abs(t - NSTEPS * dt) < 1e-9
    return state


def _args(flags, dt):
    return ["--case", "umjs_pert", "--resolution", "2", "--levels", "6",
            "--dt", f"{dt:g}s", "--nsteps", str(NSTEPS),
            "--output_restart_dt", f"{NSTEPS * dt:g}s", "--norefstate"] \
        + flags


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX CLI's final checkpoint per configuration, run at first use
    (``--vmethod NONE`` and ``--explicitvertical`` are one configuration
    in both CLIs: one JAX run serves both)."""
    cache = {}

    def get(flags, dt):
        key = tuple(flags), dt
        if key not in cache:
            jdir = str(tmp_path_factory.mktemp("jax"))
            assert j_cli.main(_args(flags, dt) + ["--output_dir", jdir]) == 0
            cache[key] = final_checkpoint(jdir, dt)
        return cache[key]
    return get


@pytest.mark.parametrize("flags,jax_flags,dt", [
    (["--vmethod", "DENSE"], ["--vmethod", "DENSE"], 200.0),
    (["--vmethod", "JFNK"], ["--vmethod", "JFNK"], 200.0),
    (["--vmethod", "NONE"], ["--explicitvertical"], 10.0),
    (["--explicitvertical"], ["--explicitvertical"], 10.0)],
    ids=["dense", "jfnk", "none", "explicitvertical"])
def test_cli_vertical_options_match_the_jax_cli(tmp_path, jax_runs, flags,
                                                 jax_flags, dt):
    tdir = str(tmp_path / "port")
    assert t_cli.main(_args(flags, dt) + ["--output_dir", tdir,
                                          "--device", "cpu"]) == 0
    got, want = final_checkpoint(tdir, dt), jax_runs(jax_flags, dt)
    assert set(FIELDS) <= set(want) and set(got) == set(want)
    uv = max(float(torch.as_tensor(want[k]).abs().max()) for k in "UV")
    for k in want:
        g, w = got[k].numpy(), np.asarray(torch.as_tensor(want[k]))
        assert np.isfinite(g).all(), k
        scale = uv if k in "UV" else np.abs(w).max()
        assert np.abs(g - w).max() < TOL * scale, k


def test_cli_runs_schur(tmp_path):
    """``--vmethod SCHUR`` runs (the JAX CLI's Schur step takes q = 0, see
    ``tests/test_torch_vertical_solvers.py``, so there is no JAX run to
    hold it to): 3 finite steps that moved the state."""
    tdir = str(tmp_path / "port")
    assert t_cli.main(_args(["--vmethod", "SCHUR"], 200.0) + [
        "--output_dir", tdir, "--device", "cpu"]) == 0
    got = final_checkpoint(tdir, 200.0)
    for k in FIELDS:
        assert torch.isfinite(got[k]).all(), k
    assert float(got["W"].abs().max()) > 0.0
