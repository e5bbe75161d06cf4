"""The driver on a device mesh and the pieces around it, float64 on the CPU
(no JAX step): ``Model(mesh=ShardMesh(2, 4))`` against the port's
single-device ``Model`` (JAX ``test_model_driver_mesh``), a configuration
outside the mesh envelope, ``Model.profile_phases`` on one device and on a
mesh, the shallow-water set's ``ValueError``, ``scaling.measure`` at a tiny
size, the shard geometry, the lockstep driver's failures, and the exchange
report."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import tempestmodel_tpu_torch as tt
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.fast import engine as t_engine, mesh_engine
from tempestmodel_tpu_torch.model import Model
from tempestmodel_tpu_torch.models import nh_model
from tempestmodel_tpu_torch.parallel import analyze, mesh as pmesh, scaling
from tempestmodel_tpu_torch.parallel.mesh import ShardMesh
from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS)
from tempestmodel_tpu_torch.testcases.shallow_water import Williamson2

torch.set_num_threads(1)

CPU = torch.device("cpu")
PHASES = ("HorizontalStep", "VerticalStepExplicit", "VerticalStepImplicit",
          "Communicate", "StepAfterSubCycle")
# the keys of the JAX package's ``parallel.scaling.measure``
MEASURE_KEYS = {"n_devices", "mesh", "ne", "nz", "engine", "gridpoints",
                "sec_per_step", "gps_total", "gps_per_device"}


def _cfg(**kw):
    tc = BaroclinicWaveUMJS(pert="exp")
    base = dict(grid_kind=tt.GridKind.CUBED_SPHERE,
                equation_set=tt.EquationSet.PRIMITIVE_NONHYDRO, ne=4,
                order=4, nz=6, ztop=tc.ztop, dt=100.0, hyperdiffusion=True,
                nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                vertical_solver="pallas", dtype=torch.float64)
    return tt.ModelConfig(**dict(base, **kw)), tc


def _rel(a, b):
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max())
               for k in b)


@pytest.fixture(scope="module")
def models():
    """A single-device and a 2 x 4 mesh ``Model`` after 2 steps."""
    cfg, tc = _cfg()
    one = Model(cfg, tc, device=CPU)
    one.go(nsteps=2)
    sharded = Model(cfg, tc, device=CPU, mesh=ShardMesh(2, 4, device=CPU))
    sharded.go(nsteps=2)
    return one, sharded


def test_model_on_mesh_matches_single_device(models):
    """``go`` runs the sharded step, ``state`` and ``carry`` gather: 1e-11
    relative per field."""
    one, sharded = models
    assert isinstance(sharded._d, list) and len(sharded._d) == 8
    assert tuple(sharded._d[0]["U"].shape) == (6, 6, 8, 4)
    s1, s2 = one.state, sharded.state
    assert set(s1) == set(s2)
    assert _rel(s2, s1) < 1e-11
    assert set(sharded.carry) == {"Rt", "W", "Rho"}
    assert _rel(sharded.carry, one.carry) < 1e-9


def test_model_on_mesh_restarts_from_a_gathered_carry(models):
    """A state and carry set from outside (a restart) are packed and
    sharded: one more step equals the single-device model's."""
    one, sharded = models
    cfg, tc = _cfg()
    again = Model(cfg, tc, device=CPU, mesh=ShardMesh(1, 2, device=CPU))
    again.set_state({k: v.clone() for k, v in one.state.items()},
                    {k: v.clone() for k, v in one.carry.items()},
                    one.time, one.step_count)
    again.go(nsteps=1)
    one2 = Model(cfg, tc, device=CPU)
    one2.set_state({k: v.clone() for k, v in one.state.items()},
                   {k: v.clone() for k, v in one.carry.items()},
                   one.time, one.step_count)
    one2.go(nsteps=1)
    assert _rel(again.state, one2.state) < 1e-11


@pytest.mark.parametrize("kw", [
    {"vertical_solver": "dense"}, {"timescheme": tt.TimestepSchemeType.ARS343},
    {"timescheme": tt.TimestepSchemeType.SPEX}, {"explicit_vertical": True},
    {"nu_uniform_scalar": 1.0e5}, {"upwind_thermo": False},
    {"vertical_staggering": tt.VerticalStaggering.CHARNEY_PHILLIPS}],
    ids=lambda kw: next(iter(kw)))
def test_model_outside_the_mesh_envelope_raises(kw):
    cfg, tc = _cfg(ne=2, **kw)
    with pytest.raises(NotImplementedError,
                       match="mesh outside the z-first envelope"):
        Model(cfg, tc, device=CPU, mesh=ShardMesh(2, 2, device=CPU))


def test_model_mesh_that_splits_elements_raises():
    cfg, tc = _cfg(ne=4)
    with pytest.raises(NotImplementedError, match="mesh outside"):
        Model(cfg, tc, device=CPU, mesh=ShardMesh(1, 8, device=CPU))
    with pytest.raises(NotImplementedError, match="mesh outside"):
        Model(tt.ModelConfig(ne=2, order=4, dt=600.0), Williamson2(),
              device=CPU, mesh=ShardMesh(2, 2, device=CPU))


@pytest.mark.parametrize("on_mesh", [False, True], ids=["one", "mesh"])
def test_profile_phases(models, on_mesh):
    """The five keys of the JAX package, finite positive times, the state
    (and the resident z-first state) left as they were."""
    model = models[1] if on_mesh else models[0]
    before = {k: v.clone() for k, v in model.state.items()}
    resident = model._d
    out = model.profile_phases(reps=1)
    assert tuple(out) == PHASES
    assert all(np.isfinite(v) and v > 0 for v in out.values()), out
    for k, v in model.state.items():
        assert torch.equal(v, before[k]), k
    assert model._d is resident


def test_profile_phases_before_the_first_step():
    cfg, tc = _cfg(ne=2)
    model = Model(cfg, tc, device=CPU)
    assert tuple(model.profile_phases(reps=1)) == PHASES


def test_profile_phases_shallow_water_raises():
    model = Model(tt.ModelConfig(ne=2, order=4, dt=600.0), Williamson2(),
                  device=CPU)
    with pytest.raises(ValueError, match="nonhydro"):
        model.profile_phases()


def test_scaling_measure_keys():
    out = scaling.measure(4, 2, nz=4, steps=1, reps=1, device=CPU)
    assert set(out) == MEASURE_KEYS
    assert out["mesh"] == [2, 2] and out["engine"] == "fast"
    assert out["gridpoints"] == 6 * 8 * 8 * 4 and out["sec_per_step"] > 0
    one = scaling.measure(1, 2, nz=4, steps=1, reps=1, device=CPU)
    assert set(one) == MEASURE_KEYS and one["mesh"] == [1, 1]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scaling.measure(1, 2, engine="reference", device=CPU)


def test_local_geometry_slices_every_horizontal_field():
    """Every ``FastGeometry`` field with a horizontal extent ``(..., A, B)``
    is in ``HORIZONTAL`` and is sliced to the shard's block; the horizontal
    operators are the block's; the edge tables stay the whole grid's."""
    cfg, tc = _cfg(ne=4, rayleigh_damping=True)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    fg = t_engine.build_fast_geometry(geom, dtype=torch.float64, device=CPU)
    A, B = fg.A, fg.B
    operators = {"DA", "Sd", "DA_b", "Sd_b"}      # (A, A), (B, B): rebuilt
    horizontal = set()
    for f in dataclasses.fields(fg):
        v = getattr(fg, f.name)
        if isinstance(v, torch.Tensor) and v.dim() >= 2 \
                and tuple(v.shape[-2:]) == (A, B) and f.name not in operators:
            horizontal.add(f.name)
    assert horizontal <= set(mesh_engine.HORIZONTAL)
    assert {"area3d", "rayleigh_lev", "inv_mult", "sep_e"} <= horizontal
    loc = mesh_engine.local_geometry(fg, 2, 4, 1, 2, CPU)
    assert (loc.A, loc.B) == (8, 4)
    for k in horizontal:
        got = getattr(loc, k)
        assert torch.equal(got, getattr(fg, k)[..., 8:16, 8:12]), k
        assert got.is_contiguous(), k
    assert torch.equal(loc.e_rot, fg.e_rot)
    assert loc.dss_links == fg.dss_links
    assert torch.equal(loc.DA, fg.DA[:8, :8]) and \
        torch.equal(loc.Sd_b, fg.Sd_b[:4, :4])


def test_shardmesh_lockstep_failures():
    """A failing shard stops the others and its error reaches the caller;
    shards that run different numbers of exchanges raise."""
    mesh = ShardMesh(2, 2, device=CPU)

    def fails(r, x):
        if r == 2:
            raise KeyError("shard two")
        return pmesh.ppermute(x, "x", [(0, 1)]).wait()

    xs = [torch.full((3,), float(r)) for r in range(4)]
    with pytest.raises(KeyError, match="shard two"):
        mesh.run(fails, xs)

    def uneven(r, x):
        if r != 1:
            pmesh.ppermute(x, "y", [(0, 1)]).wait()
        return x

    with pytest.raises(RuntimeError, match="different numbers"):
        mesh.run(uneven, xs)
    got = mesh.run(lambda r, x: pmesh.ppermute(x, "x", [(1, 0)]).wait(), xs)
    assert [float(g[0]) for g in got] == [2.0, 3.0, 0.0, 0.0]
    coords = mesh.run(lambda r, x: mesh.coords(pmesh.current()[1]), xs)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_shardmesh_lockstep_stress():
    """16 shards (more than the cores) and 30 exchanges each under a short
    switch interval: every shard receives exactly what its source sent
    (a lost or reordered exchange would break the running sums), within a
    time bound."""
    n, rounds = 16, 30
    mesh = ShardMesh(4, 4, device=CPU)
    ring = [(j, (j + 1) % n) for j in range(n)]

    def fn(r, x):
        acc = x
        for _ in range(rounds):
            acc = acc + pmesh.ppermute(acc, ("x", "y"), ring).wait()
        return acc

    want = np.arange(n, dtype=np.float64)
    for _ in range(rounds):
        want = want + np.roll(want, 1)
    got = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: got.update(out=mesh.run(
            fn, [torch.full((2,), float(r), dtype=torch.float64)
                 for r in range(n)])))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        mesh.close()
    assert [float(g[0]) for g in got["out"]] == list(want)
    assert mesh.tally.counts == {"collective-permute": rounds}


def test_graph_runner_takes_a_sharded_state_on_the_cpu():
    """On CPU tensors the runner of a sharded step is its plain loop."""
    calls = []

    def step(d, c):
        calls.append(1)
        return [{"U": x["U"] + 1.0} for x in d], c

    run = t_engine.graph_runner(step, 3)
    d, c = run([{"U": torch.zeros(2)}, {"U": torch.ones(2)}], [{}, {}])
    assert len(calls) == 3 and float(d[1]["U"][0]) == 4.0 and c == [{}, {}]


def test_format_report():
    mesh = ShardMesh(2, 1, device=CPU)
    xs = [torch.zeros(4, dtype=torch.float64) for _ in range(2)]
    rep = analyze.collective_report(
        lambda s: mesh.run(lambda r, x: pmesh.ppermute(
            x, "x", [(0, 1)]).wait(), s), (xs,), mesh)
    assert rep.counts == {"collective-permute": 1}
    assert rep.bytes_ == {"collective-permute": 32} and rep.moved == 32
    text = analyze.format_report(rep, "two shards")
    assert "collective-permute" in text and "moved between shards: 32" in text
