"""The port's model driver, float64 on the CPU: the driver bitwise equal
to the engine's own step loops (Strang and ARS343), the hook rules (a
replaced or mutated key is seen by the next step; steps between firings
run as one call), ``--perturb_restart``, the CLI, and the configurations
that are not ported.  ``Model.go`` against the JAX package's (Held-Suarez,
the records, the checkpoints both ways) is in
``test_torch_model_held_suarez.py``.  The port runs
``vertical_solver="pallas"`` (the kernels' plain versions on the CPU), JAX
``"banded"``, as ``tests/torch_port_common.py`` pairs them."""

import os

import numpy as np
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu import model as j_model
from tempestmodel_tpu.io import output as j_output
from tempestmodel_tpu_torch import cli as t_cli
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.io import arena as t_arena
from tempestmodel_tpu_torch.io import output as t_output
from tempestmodel_tpu_torch.physics import held_suarez as t_hs

from torch_port_common import (CPU, FIELDS, TorchUMJS, jax_config, rel_err,
                               torch_config)

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


@pytest.mark.parametrize("case", ["sw_tc2", "sw_galewsky"])
def test_cli_cases_that_need_unported_engines_raise(case, capsys):
    """The shallow-water cases, which raised before their engine was
    ported, run through the CLI (2 steps at its default resolution) and
    give finite states."""
    rc = t_cli.main(["--case", case, "--nsteps", "2", "--checksum_dt",
                     "200s", "--device", "cpu"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "..Checksums" in l or "..Invariants" in l]
    assert len(lines) == 4
    assert all("nan" not in l and "inf" not in l for l in lines)


@pytest.mark.parametrize("what", ["shallow_water", "mesh", "cph", "erk",
                                  "imex_tracers", "no_fuse"])
def test_unported_configurations_raise(what):
    from tempestmodel_tpu_torch.testcases.dcmip2016 import (
        MoistBaroclinicWave)
    tc = TorchUMJS(pert="exp")
    kw, cfg = {}, torch_cfg()
    if what == "shallow_water":
        # ported: Model builds the shallow-water set and steps it
        from tempestmodel_tpu_torch.testcases.shallow_water import (
            Williamson2)
        m = t_model.Model(cfg.with_(equation_set=tt.EquationSet.SHALLOW_WATER,
                                    nz=1), Williamson2(), device=CPU)
        m.go(nsteps=1)
        assert set(m.state) == {"U", "V", "H"}
        assert all(bool(torch.isfinite(v).all()) for v in m.state.values())
        return
    if what == "mesh":
        kw["mesh"] = object()
    elif what == "cph":
        # ported: Model builds the converted Charney-Phillips start and
        # steps it; with tracers it raises (the roadmap's)
        cph = cfg.with_(
            vertical_staggering=tt.VerticalStaggering.CHARNEY_PHILLIPS,
            dt=50.0)
        m = t_model.Model(cph, tc, device=CPU)
        assert m.state["Rt"].shape[-1] == cph.nz + 1
        m.go(nsteps=2)
        assert all(bool(torch.isfinite(v).all()) for v in m.state.values())
        cfg, tc = cph, MoistBaroclinicWave()
    elif what == "erk":
        # ported: the explicit vertical path runs (at a vertically stable
        # dt) with an empty carry
        m = t_model.Model(cfg.with_(timescheme=tt.TimestepSchemeType.ERK,
                                    dt=10.0), tc, device=CPU)
        m.go(nsteps=2)
        assert m.carry == {}
        assert all(bool(torch.isfinite(v).all()) for v in m.state.values())
        # its empty carry goes back in as it came out
        m.set_state(dict(m.state), m.carry, m.time, m.step_count)
        m.go(nsteps=1)
        assert m.step_count == 3 and m.carry == {}
        return
    elif what == "imex_tracers":
        # ported: the moist wave under ARS343 runs on the IMEX body (no
        # carry), its species kept
        m = t_model.Model(cfg.with_(timescheme=tt.TimestepSchemeType.ARS343),
                          MoistBaroclinicWave(), device=CPU)
        m.go(nsteps=2)
        assert m.carry is None and m.state["Tracers"].shape[0] == 3
        assert all(bool(torch.isfinite(v).all()) for v in m.state.values())
        return
    elif what == "no_fuse":
        # ported: fuse_pallas=False runs Strang-HEVI and IMEX on the
        # engine's unfused path, and SPEX and HS on their one path
        for ts, dt in (("strang", 300.0), ("ars343", 300.0),
                       ("spex", 100.0), ("hs", 100.0)):
            m = t_model.Model(cfg.with_(
                fuse_pallas=False, timescheme=tt.TimestepSchemeType(ts),
                dt=dt), tc, device=CPU)
            m.go(nsteps=2)
            assert m.step_count == 2, ts
            assert all(bool(torch.isfinite(v).all())
                       for v in m.state.values()), ts
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        t_model.Model(cfg, tc, device=CPU, **kw)


def test_profile_phases_is_not_ported():
    """It is ported: the JAX package's five phases, each a positive time in
    ms, over the model's state, which stays as it was."""
    m = t_model.Model(torch_cfg(), TorchUMJS(pert="exp"), device=CPU)
    before = {k: v.clone() for k, v in m.state.items()}
    out = m.profile_phases(reps=1)
    assert tuple(out) == ("HorizontalStep", "VerticalStepExplicit",
                          "VerticalStepImplicit", "Communicate",
                          "StepAfterSubCycle")
    assert all(v > 0 for v in out.values())
    for k, v in m.state.items():
        assert torch.equal(v, before[k]), k


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
