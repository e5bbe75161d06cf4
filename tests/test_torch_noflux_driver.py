"""The density current through the port's driver and CLI, float64 on the
CPU: ``cli.main(["--case", "density_current", ...])`` (nex 4, nz 8, 3 steps
of 0.1 s, Rayleigh sponges, no hyperdiffusion) against the JAX package's
``Model.go`` at the same flags (checksum records and the final state to
1e-11), and a no-flux ``Model`` that restarts bit for bit from its own
``.npz`` and ``.tarena`` checkpoints (the carry holds the walls' halo)."""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
from tempestmodel_tpu import model as j_model
from tempestmodel_tpu.io import output as j_output
from tempestmodel_tpu.testcases import nonhydro_xz as j_xz
from tempestmodel_tpu_torch import cli as t_cli
from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.io import arena as t_arena
from tempestmodel_tpu_torch.io import output as t_output
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz

from torch_port_common import CPU, FIELDS

TOL = 1e-11
DT = 0.1
STEPS = 3
ARGV = ["--case", "density_current", "--resolution", "4", "--levels", "8",
        "--dt", "0.1s", "--nsteps", str(STEPS), "--nohypervis",
        "--checksum_dt", "0.1s"]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX ``Model`` of the CLI's density current, checksums every
    step."""
    tc = j_xz.DensityCurrent()
    assert tc.bc_x == "noflux"
    cfg = tj.ModelConfig(
        equation_set=tj.EquationSet.PRIMITIVE_NONHYDRO,
        grid_kind=tj.GridKind.CARTESIAN_XZ, x_extent=tc.x_extent,
        y_extent=tc.y_extent, ztop=tc.ztop, nex=4, nz=8, order=4, dt=DT,
        hyperdiffusion=False, rayleigh_damping=True, dtype=jnp.float64)
    cks = j_output.ChecksumOutput(DT)
    m = j_model.Model(cfg, tc, output_managers=[cks])
    m.go(nsteps=STEPS)
    return {"state": {k: np.asarray(v) for k, v in m.state.items()},
            "checksums": cks.records}


def _close(a, b):
    return abs(a - b) <= TOL * max(abs(b), 1e-300) or abs(b) < 1e-15


def test_cli_density_current_matches_jax_model(jax_run, capsys):
    rc = t_cli.main(ARGV + ["--vmethod", "V2", "--device", "cpu"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "..Checksums" in l]
    assert len(lines) == STEPS + 1
    want = jax_run["checksums"]
    for line, w in zip(lines, want):
        t = float(re.search(r"t=([0-9.e+-]+)s", line).group(1))
        assert abs(t - round(w["time"], 1)) < 1e-12
        got = {k: float(v) for k, v in
               re.findall(r"(\w+): ([-0-9.e+]+)", line)}
        for k in FIELDS:
            assert _close(got[k], w[k]), (k, got[k], w[k])
    # the same flags through the driver: the final state
    args = t_cli.make_parser().parse_args(ARGV + ["--vmethod", "V2"])
    tc, cfg, wps = t_cli.configure(args)
    assert isinstance(tc, t_xz.DensityCurrent) and not wps
    m = t_model.Model(cfg, tc, device=CPU)
    assert m.geom.bc_x == "noflux"
    m.go(nsteps=STEPS)
    vel = max(np.abs(jax_run["state"]["U"]).max(),
              np.abs(jax_run["state"]["V"]).max())
    for k in FIELDS:
        want_k = jax_run["state"][k]
        scale = vel if k in ("U", "V") else np.abs(want_k).max()
        err = np.abs(m.state[k].numpy() - want_k).max() / scale
        assert err < TOL, (k, err)


@pytest.mark.parametrize("fmt", ["npz", "arena"])
def test_a_noflux_model_restarts_bit_for_bit(tmp_path, fmt):
    """4 steps straight against 2 steps, a checkpoint, and 2 more steps of
    a new ``Model`` restarted from it; the carry's halo goes through the
    file."""
    if fmt == "arena" and not t_arena.available():
        pytest.skip("no C++ toolchain: the arena library cannot be built")
    args = t_cli.make_parser().parse_args(ARGV + ["--vmethod", "V2"])
    tc, cfg, _ = t_cli.configure(args)
    ck = t_output.CompositeCheckpoint(2 * DT, str(tmp_path), fmt=fmt)
    m = t_model.Model(cfg, tc, output_managers=[ck], device=CPU)
    m.go(nsteps=4)
    assert {"halo_" + k for k in FIELDS} <= set(m.carry)
    first = sorted(os.listdir(tmp_path))[0]
    r = t_model.Model(cfg, t_xz.DensityCurrent(), device=CPU)
    r.restart_from(str(tmp_path / first))
    assert r.step_count == 2
    assert {"halo_" + k for k in FIELDS} <= set(r.carry)
    r.go(nsteps=2)
    for k in FIELDS:
        assert torch.equal(r.state[k], m.state[k]), k
    for k in m.carry:
        assert torch.equal(r.carry[k], m.carry[k]), k
