"""The port's model driver against the JAX package's, float64 on the CPU:
``Model.go`` with Held-Suarez every step and the checksum and energy
streams (UMJS ne2 p4 nz6, 3 steps, fields and records to 1e-11 relative),
restarts from the JAX run's checkpoints in both formats, the port's own
checkpoints read by the JAX package and continued bit for bit, the driver
bitwise equal to the engine's own step loops (Strang and ARS343), the hook
rules (a replaced or mutated key is seen by the next step; steps between
firings run as one call), ``--perturb_restart``, the CLI, and the
configurations that are not ported.  The port runs
``vertical_solver="pallas"`` (the kernels' plain versions on the CPU), JAX
``"banded"``, as ``tests/torch_port_common.py`` pairs them.  One JAX
``Model`` is built and its step compiled once, for the module."""

import os

import numpy as np
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu import model as j_model
from tempestmodel_tpu.io import output as j_output
from tempestmodel_tpu.physics import held_suarez as j_hs
from tempestmodel_tpu_torch import cli as t_cli
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.io import arena as t_arena
from tempestmodel_tpu_torch.io import output as t_output
from tempestmodel_tpu_torch.physics import held_suarez as t_hs

from torch_port_common import (CPU, FIELDS, JaxUMJS, TorchUMJS, jax_config,
                               rel_err, torch_config)

CONFIG = dict(ne=2, nz=6, dt=300.0)
NSTEPS = 3
TOL = 1e-11


def jax_cfg(**kw):
    return jax_config(equation_set=tj.EquationSet.PRIMITIVE_NONHYDRO,
                      **{**CONFIG, **kw})


def torch_cfg(**kw):
    return torch_config(equation_set=tt.EquationSet.PRIMITIVE_NONHYDRO,
                        **{**CONFIG, **kw})


def arena_or_skip():
    if not t_arena.available():
        pytest.skip("no C++ toolchain: the arena library cannot be built")


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


def _step_file(root, fmt, step):
    ext = {"npz": ".npz", "arena": ".tarena"}[fmt]
    t = step * CONFIG["dt"]
    return str(root / fmt / f"restart.{t:012.2f}{ext}")


def _assert_fields_close(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.shape == want[k].shape and np.isfinite(g).all(), k
        assert rel_err(g, want[k]) < tol, (k, rel_err(g, want[k]))


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


def test_the_driver_is_the_engine_step_loop_bit_for_bit():
    cfg = torch_cfg()
    m = t_model.Model(cfg, TorchUMJS(pert="exp"), device=CPU)
    start = {k: v.clone() for k, v in m.state.items()}
    m.go(nsteps=NSTEPS)
    first, step = t_fast.make_fast_step(cfg, m.geom, device=CPU)
    X, c = first(t_fast.pack_state(start, device=CPU))
    for _ in range(NSTEPS - 1):
        X, c = step(X, c)
    want = t_fast.unpack_state(X)
    for k in FIELDS:
        assert torch.equal(m.state[k], want[k]), k
    for k in c:
        assert torch.equal(m.carry[k], c[k]), k
    # the steps ran as one call of the runner: three "Step" entries
    assert m.timers.groups["Step"].count == NSTEPS


def test_the_imex_driver_is_make_fast_imex_step_bit_for_bit():
    cfg = torch_cfg(timescheme=tt.TimestepSchemeType.ARS343)
    m = t_model.Model(cfg, TorchUMJS(pert="exp"), device=CPU)
    s = {k: v.clone() for k, v in m.state.items()}
    m.go(nsteps=2)
    step = t_fast.make_fast_imex_step(cfg, m.geom, device=CPU)
    for _ in range(2):
        s = step(s)
    for k in FIELDS:
        assert torch.equal(m.state[k], s[k]), k
    assert m.carry is None and m.step_count == 2


class _ScaleRho(t_model.WorkflowProcess):
    """Multiplies Rho by 1.001 in the state dict it is given: by a new
    tensor under the same key, or in place."""

    def __init__(self, in_place):
        super().__init__(0.0)
        self.in_place = in_place

    def perform(self, model, t):
        s = model.state
        if self.in_place:
            s["Rho"].mul_(1.001)
        else:
            s["Rho"] = s["Rho"] * 1.001
        return s


@pytest.mark.parametrize("in_place", [False, True])
def test_a_hook_that_changes_one_key_is_seen_by_the_next_step(in_place):
    cfg = torch_cfg()
    m = t_model.Model(cfg, TorchUMJS(pert="exp"),
                      workflow_processes=[_ScaleRho(in_place)], device=CPU)
    start = {k: v.clone() for k, v in m.state.items()}
    m.go(nsteps=2)
    first, step = t_fast.make_fast_step(cfg, m.geom, device=CPU)
    X, c = first(t_fast.pack_state(start, device=CPU))
    s = t_fast.unpack_state(X)
    s["Rho"] = s["Rho"] * 1.001
    X, c = step(t_fast.pack_state(s, device=CPU), c)
    s = t_fast.unpack_state(X)
    s["Rho"] = s["Rho"] * 1.001
    for k in FIELDS:
        assert torch.equal(m.state[k], s[k]), k


class _Log(t_model.WorkflowProcess):
    def __init__(self, interval):
        super().__init__(interval)
        self.fired = []

    def perform(self, model, t):
        self.fired.append((t, model.step_count))
        return model.state


def test_hooks_fire_on_the_jax_schedule_and_runs_fill_the_gaps():
    """A workflow process every 2 steps (armed at the first step), a
    checksum stream every 3 steps (from step 0), over 7 steps: the firings
    are those of the JAX package's step-by-step loop, and the steps
    between them run as one call each."""
    dt = CONFIG["dt"]
    log = _Log(2 * dt)
    cks = t_output.ChecksumOutput(3 * dt)
    m = t_model.Model(torch_cfg(), TorchUMJS(pert="exp"),
                      output_managers=[cks], workflow_processes=[log],
                      device=CPU)
    calls = []
    advance = m._advance
    m._advance = lambda n: (calls.append(n), advance(n))
    m.go(nsteps=7)
    # the JAX package's hooks asked after every step
    jwp = j_model.WorkflowProcess(2 * dt)
    jom = j_output.ChecksumOutput(3 * dt)
    want_wp, want_om, t = [], [0.0], 0.0
    assert jom.is_output_needed(0.0)         # the initial output
    jom._last = 0.0
    for step in range(1, 8):
        t += dt
        if jwp.is_ready(t):
            jwp._last = t
            want_wp.append((t, step))
        if jom.is_output_needed(t):
            jom._last = t
            want_om.append(t)
    assert log.fired == want_wp == [(3 * dt, 3), (5 * dt, 5), (7 * dt, 7)]
    assert [r["time"] for r in cks.records] == want_om
    assert calls == [3, 2, 1, 1] and sum(calls) == 7
    assert m.timers.groups["Step"].count == 7


def test_perturb_restart_changes_u_and_keeps_rho(tmp_path):
    # ne4: a grid fine enough for nodes inside the perturbation's radius
    cfg = torch_cfg(ne=4)
    ck = t_output.CompositeCheckpoint(CONFIG["dt"], str(tmp_path), fmt="npz")
    m0 = t_model.Model(cfg, TorchUMJS(pert="none"), output_managers=[ck],
                       device=CPU)
    m0.go(nsteps=1)
    path = str(tmp_path / os.listdir(tmp_path)[0])
    ms = []
    for perturb in (True, False):
        m = t_model.Model(cfg, TorchUMJS(pert="exp"), device=CPU)
        m.restart_from(path, perturb=perturb)
        ms.append(m)
    assert ms[0].carry is None and ms[1].carry is not None
    du = (ms[0].state["U"] - ms[1].state["U"]).abs().max()
    assert float(du) > 1e-8
    assert torch.equal(ms[0].state["Rho"], ms[1].state["Rho"])
    ms[0].go(nsteps=1)
    assert bool(torch.isfinite(ms[0].state["U"]).all())


def test_compute_error_norms_and_the_reference(port_run):
    m = port_run["model"]
    norms = m.compute_error_norms()
    assert set(norms) == set(FIELDS)
    assert 0.0 < float(norms["U"]["l2_rel"]) < 1.0


def test_cli_runs_the_baroclinic_wave_with_every_output(tmp_path, capsys):
    rc = t_cli.main(["--case", "umjs_pert", "--resolution", "2",
                     "--levels", "6", "--order", "4", "--dt", "300s",
                     "--nsteps", "4", "--vmethod", "V2",
                     "--checksum_dt", "600s", "--output_dir", str(tmp_path),
                     "--output_dt", "600s", "--output_format", "nc",
                     "--output_vort", "--output_div", "--output_ps",
                     "--output_Ri", "--output_x", "12", "--output_y", "7",
                     "--output_restart_dt", "600s", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("..Checksums") == 3 and out.count("..Invariants") == 3
    assert "Error norms vs reference state" in out and "Loop" in out
    files = sorted(os.listdir(tmp_path))
    assert [f for f in files if f.endswith(".nc")] == [
        "out.000000.nc", "out.000001.nc", "out.000002.nc"]
    restarts = [f for f in files if f.startswith("restart.")]
    assert len(restarts) == 2
    from tempestmodel_tpu.io.netcdf import read_netcdf
    d = read_netcdf(str(tmp_path / "out.000002.nc"))
    for name in ("U", "V", "T", "P", "Rho", "Theta", "Vorticity",
                 "Divergence", "Ri"):
        assert d[name].shape == (1, 6, 7, 12), name
    assert d["W"].shape == (1, 7, 7, 12) and d["PS"].shape == (1, 7, 12)
    assert 150.0 < d["T"].min() and d["T"].max() < 350.0
    # a restart from the CLI's last checkpoint, with the perturbation
    rc = t_cli.main(["--case", "umjs_pert", "--resolution", "2",
                     "--levels", "6", "--dt", "300s", "--nsteps", "1",
                     "--vmethod", "V2", "--norefstate",
                     "--restart_file", str(tmp_path / sorted(restarts)[-1]),
                     "--perturb_restart", "--device", "cpu"])
    assert rc == 0


def test_cli_runs_the_schar_mountain_waves(capsys):
    rc = t_cli.main(["--case", "schar", "--resolution", "8", "--levels",
                     "8", "--dt", "0.5s", "--nsteps", "2", "--vmethod", "V2",
                     "--checksum_dt", "1s", "--nu", "1e7", "--nud", "1e7",
                     "--nuv", "1e7", "--device", "cpu"])
    assert rc == 0
    assert capsys.readouterr().out.count("..Checksums") == 2


def test_cli_runs_the_thermal_bubble(capsys):
    """The thermal bubble's grid is periodic (its test case sets no
    ``bc_x``), so it runs on the z-first engine, as in the JAX package."""
    rc = t_cli.main(["--case", "thermal_bubble", "--resolution", "4",
                     "--levels", "8", "--dt", "0.05s", "--nsteps", "2",
                     "--vmethod", "V2", "--nohypervis", "--checksum_dt",
                     "0.05s", "--device", "cpu"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "..Checksums" in l]
    assert len(lines) == 3 and all("nan" not in l for l in lines)


@pytest.mark.parametrize("case", ["sw_tc2", "sw_galewsky", "density_current"])
def test_cli_cases_that_need_unported_engines_raise(case):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        t_cli.main(["--case", case, "--nsteps", "1", "--device", "cpu"])


@pytest.mark.parametrize("what", ["shallow_water", "mesh", "cph", "erk",
                                  "imex_tracers", "no_fuse"])
def test_unported_configurations_raise(what):
    from tempestmodel_tpu_torch.testcases.dcmip2016 import (
        MoistBaroclinicWave)
    tc = TorchUMJS(pert="exp")
    kw, cfg = {}, torch_cfg()
    if what == "shallow_water":
        cfg = cfg.with_(equation_set=tt.EquationSet.SHALLOW_WATER, nz=1)
    elif what == "mesh":
        kw["mesh"] = object()
    elif what == "cph":
        cfg = cfg.with_(
            vertical_staggering=tt.VerticalStaggering.CHARNEY_PHILLIPS)
    elif what == "erk":
        cfg = cfg.with_(timescheme=tt.TimestepSchemeType.ERK)
    elif what == "imex_tracers":
        cfg = cfg.with_(timescheme=tt.TimestepSchemeType.ARS343)
        tc = MoistBaroclinicWave()
    else:
        cfg = cfg.with_(fuse_pallas=False)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        t_model.Model(cfg, tc, device=CPU, **kw)


def test_profile_phases_is_not_ported():
    m = t_model.Model(torch_cfg(), TorchUMJS(pert="exp"), device=CPU)
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        m.profile_phases()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["npz", "arena"])
def test_restarts_continue_bit_for_bit_on_the_card(tmp_path, fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    arena_or_skip()
    cfg = torch_cfg()
    ck = t_output.CompositeCheckpoint(CONFIG["dt"], str(tmp_path), fmt=fmt)
    m = t_model.Model(cfg, TorchUMJS(pert="exp"), output_managers=[ck],
                      workflow_processes=[t_hs.HeldSuarezPhysics(0.0)],
                      device="cuda")
    m.go(nsteps=NSTEPS)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == NSTEPS
    m2 = t_model.Model(cfg, TorchUMJS(pert="exp"),
                       workflow_processes=[t_hs.HeldSuarezPhysics(0.0)],
                       device="cuda")
    m2.restart_from(str(tmp_path / files[0]))
    m2.go(nsteps=NSTEPS - 1)
    for k, v in m.state.items():
        assert torch.equal(m2.state[k], v), k
