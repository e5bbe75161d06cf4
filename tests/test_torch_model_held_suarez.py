"""The port's model driver against the JAX package's, float64 on the CPU:
``Model.go`` with Held-Suarez every step and the checksum and energy
streams (UMJS ne2 p4 nz6, 3 steps, fields and records to 1e-11 relative),
restarts from the JAX run's checkpoints in both formats, the port's own
checkpoints read by the JAX package and continued bit for bit, the error
norms against the reference state.  One JAX ``Model`` is built and its
step compiled once, for the module."""

import numpy as np
import pytest
import torch

from tempestmodel_tpu import model as j_model
from tempestmodel_tpu.io import output as j_output
from tempestmodel_tpu.physics import held_suarez as j_hs
from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.io import output as t_output
from tempestmodel_tpu_torch.physics import held_suarez as t_hs

from torch_port_common import CPU, FIELDS, JaxUMJS, TorchUMJS
from test_torch_model import (CONFIG, NSTEPS, TOL, _assert_fields_close,
                              _step_file, arena_or_skip, jax_cfg, torch_cfg)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``Model``: UMJS (exp perturbation), Held-Suarez every step,
    checksums and invariants every step, and a checkpoint every step in
    each format; 3 steps.  Returns the final state, the records and the
    checkpoint directories."""
    arena_or_skip()
    root = tmp_path_factory.mktemp("jax_run")
    cks = j_output.ChecksumOutput(CONFIG["dt"])
    en = j_output.EnergyOutput(CONFIG["dt"])
    oms = [cks, en,
           j_output.CompositeCheckpoint(CONFIG["dt"], str(root / "npz"),
                                        fmt="npz"),
           j_output.CompositeCheckpoint(CONFIG["dt"], str(root / "arena"),
                                        fmt="arena")]
    m = j_model.Model(jax_cfg(), JaxUMJS(pert="exp"), output_managers=oms,
                      workflow_processes=[j_hs.HeldSuarezPhysics(0.0)])
    m.go(nsteps=NSTEPS)
    return {"state": {k: np.asarray(v) for k, v in m.state.items()},
            "checksums": cks.records, "energy": en.records, "root": root}


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The same run on the port, on the CPU, with a checkpoint every step
    in each format."""
    arena_or_skip()
    root = tmp_path_factory.mktemp("port_run")
    cks = t_output.ChecksumOutput(CONFIG["dt"])
    en = t_output.EnergyOutput(CONFIG["dt"])
    oms = [cks, en,
           t_output.CompositeCheckpoint(CONFIG["dt"], str(root / "npz"),
                                        fmt="npz"),
           t_output.CompositeCheckpoint(CONFIG["dt"], str(root / "arena"))]
    m = t_model.Model(torch_cfg(), TorchUMJS(pert="exp"),
                      output_managers=oms,
                      workflow_processes=[t_hs.HeldSuarezPhysics(0.0)],
                      device=CPU)
    m.go(nsteps=NSTEPS)
    return {"model": m, "checksums": cks.records, "energy": en.records,
            "root": root}


def test_model_go_with_held_suarez_matches_jax(jax_run, port_run):
    m = port_run["model"]
    assert m.step_count == NSTEPS and m.time == NSTEPS * CONFIG["dt"]
    _assert_fields_close(m.state, jax_run["state"])


@pytest.mark.parametrize("stream", ["checksums", "energy"])
def test_the_records_match_jax(jax_run, port_run, stream):
    got, want = port_run[stream], jax_run[stream]
    assert [r["time"] for r in got] == [r["time"] for r in want]
    assert len(got) == NSTEPS + 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= TOL * abs(w[k]), (k, g[k], w[k])


@pytest.mark.parametrize("fmt", ["npz", "arena"])
def test_a_restart_from_a_jax_checkpoint_matches_jax(jax_run, fmt):
    m = t_model.Model(torch_cfg(), TorchUMJS(pert="exp"),
                      workflow_processes=[t_hs.HeldSuarezPhysics(0.0)],
                      device=CPU)
    m.restart_from(_step_file(jax_run["root"], fmt, 1))
    assert m.step_count == 1 and m.time == CONFIG["dt"]
    assert set(m.carry) == {"Rt", "W", "Rho"}        # the z-first carry
    assert m.carry["W"].shape == (CONFIG["nz"] + 1, 6, 8, 8)
    m.go(nsteps=NSTEPS - 1)
    _assert_fields_close(m.state, jax_run["state"])


@pytest.mark.parametrize("fmt", ["npz", "arena"])
def test_a_port_checkpoint_reads_in_jax_and_restarts_bit_for_bit(
        port_run, fmt):
    path = _step_file(port_run["root"], fmt, 1)
    state, carry, t, step = t_output.CompositeCheckpoint.load(path,
                                                              device=CPU)
    jstate, jcarry, jt, jstep = j_output.CompositeCheckpoint.load(path)
    assert (t, step) == (jt, jstep) == (CONFIG["dt"], 1)
    for mine, theirs in ((state, jstate), (carry, jcarry)):
        assert set(mine) == set(theirs)
        for k in mine:
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(theirs[k]))
    m = t_model.Model(torch_cfg(), TorchUMJS(pert="exp"),
                      workflow_processes=[t_hs.HeldSuarezPhysics(0.0)],
                      device=CPU)
    m.restart_from(path)
    m.go(nsteps=NSTEPS - 1)
    for k, v in port_run["model"].state.items():
        assert torch.equal(m.state[k], v), k


def test_compute_error_norms_and_the_reference(port_run):
    m = port_run["model"]
    norms = m.compute_error_norms()
    assert set(norms) == set(FIELDS)
    assert 0.0 < float(norms["U"]["l2_rel"]) < 1.0
