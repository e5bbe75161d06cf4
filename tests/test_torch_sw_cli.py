"""The port's CLI on the shallow-water cases against the JAX package's
CLI, float64 on the CPU: ``sw_tc2``, ``sw_tc5``, ``sw_rh4`` and
``sw_galewsky`` at resolution 4 with the CLI's defaults for 3 steps,
compared through each CLI's final checkpoint (1e-11 relative per field).
Each case compiles one JAX step."""

import glob
import os

import pytest
import torch

from tempestmodel_tpu import cli as j_cli
from tempestmodel_tpu_torch import cli as t_cli
from tempestmodel_tpu_torch.io import output as t_output

from torch_port_common import CPU, rel_err

TOL = 1e-11
NSTEPS = 3


CLI_ARGS = ["--resolution", "4", "--nsteps", str(NSTEPS),
            "--output_restart_dt", "300s", "--norefstate"]


def final_checkpoint(root):
    files = sorted(glob.glob(os.path.join(root, "restart.*")))
    assert files, f"no checkpoint in {root}"
    state, _, t, step = t_output.CompositeCheckpoint.load(files[-1],
                                                          device=CPU)
    assert step == NSTEPS and t == NSTEPS * 100.0
    return state


@pytest.mark.parametrize("case", ["sw_tc2", "sw_tc5", "sw_rh4",
                                  "sw_galewsky"])
def test_cli_sw_cases_match_the_jax_cli(tmp_path, case):
    """The CLI's defaults (dt 100 s, KGU35, nu 1e15 of order 4, float64)
    at resolution 4 for 3 steps, compared through each CLI's final
    checkpoint."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert j_cli.main(["--case", case, "--output_dir", jdir]
                      + CLI_ARGS) == 0
    assert t_cli.main(["--case", case, "--output_dir", tdir,
                       "--device", "cpu"] + CLI_ARGS) == 0
    got, want = final_checkpoint(tdir), final_checkpoint(jdir)
    assert set(got) == set(want) == {"U", "V", "H"}
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        assert rel_err(got[k], want[k]) < TOL, k
