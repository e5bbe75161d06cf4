"""The port's mesh engine (``make_fast_step(mesh=)`` on a ``ShardMesh``)
against the JAX package's single-device ``make_fast_step``, float64 on the
CPU: UMJS ne4 p4 nz6 (``tests/test_fast_mesh.py``'s configuration), 3
Strang-HEVI steps from JAX's own initial state at (2, 2), (1, 4) and
(1, 1), the port's ``"banded"`` and ``"pallas"`` paths, 1e-11 relative per
field (the bar of ``tests/test_fast_engine.py:61-73``); one JAX run shared
by every case.  Also the exchange tally of one step (exactly 7 DSS calls of
``expected_exchange_bytes``, point-to-point only: JAX's
``test_mesh_fast_engine_collective_bytes``), the mesh predicate against
JAX's ``fast_engine_supported(mesh=)`` over a sweep, and the sharded
multistep against its eager steps."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu.fast import engine as j_engine
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.fast import engine as t_engine, mesh_dss
from tempestmodel_tpu_torch.parallel.analyze import (collective_report,
                                                     format_report)
from tempestmodel_tpu_torch.parallel.mesh import ShardMesh

from torch_port_common import build_pair, CPU, FIELDS, rel_err, JaxUMJS

NSTEPS = 3
KW = dict(nz=6, dt=100.0)


@pytest.fixture(scope="module")
def case():
    """(tcfg, tgeom, start z-first numpy, JAX's 3-step state)."""
    jcfg, jgeom, tcfg, tgeom = build_pair(**KW)
    js = JaxUMJS(pert="exp").initial_state(jgeom, jcfg.constants,
                                           dtype=jnp.float64)
    X0 = j_fast.pack_state(js)
    first, step = j_fast.make_fast_step(jcfg, jgeom)
    X, c = first(X0)
    for _ in range(NSTEPS - 1):
        X, c = step(X, c)
    start = {k: np.asarray(v) for k, v in X0.items()}
    return tcfg, tgeom, start, {k: np.asarray(v) for k, v in X.items()}


def _torch_start(start):
    return {k: torch.from_numpy(v.copy()) for k, v in start.items()}


def _mesh_steps(tcfg, tgeom, start, mesh, nsteps=NSTEPS, **kw):
    first, step = t_fast.make_fast_step(tcfg, tgeom, mesh=mesh, **kw)
    X, c = first(mesh.shard(_torch_start(start)))
    for _ in range(nsteps - 1):
        X, c = step(X, c)
    return X, c


@pytest.mark.parametrize("solver", ["pallas", "banded"])
@pytest.mark.parametrize("mx,my", [(2, 2), (1, 4), (1, 1)])
def test_mesh_step_matches_jax(case, mx, my, solver):
    tcfg, tgeom, start, want = case
    mesh = ShardMesh(mx, my, device=CPU)
    X, c = _mesh_steps(tcfg.with_(vertical_solver=solver), tgeom, start,
                       mesh)
    assert len(X) == mx * my
    for r, d in enumerate(X):
        assert tuple(d["U"].shape) == (KW["nz"], 6, 16 // mx, 16 // my), r
        assert set(c[r]) == {"Rt", "W", "Rho"}
    got = mesh.gather(X)
    for k in FIELDS:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, (k, mx, my)


def test_collective_report_is_exact_routing(case):
    """One ``first_step`` (the implicit half step and a whole Strang step:
    5 stage DSS and the tail's 2) issues only point-to-point exchanges, of
    exactly 7 x ``expected_exchange_bytes`` at ktot = 5 nz + 1, float64."""
    tcfg, tgeom, start, _ = case
    A, nz = tcfg.ne * tcfg.order, tcfg.nz
    for mx, my in ((2, 4), (2, 2), (1, 4)):
        mesh = ShardMesh(mx, my, device=CPU)
        first, _ = t_fast.make_fast_step(tcfg, tgeom, mesh=mesh)
        rep = collective_report(first, (mesh.shard(_torch_start(start)),),
                                mesh)
        assert set(rep.counts) == {"collective-permute"}, rep.counts
        assert "all-reduce" not in rep.counts
        assert "all-gather" not in rep.counts
        per_call = mesh_dss.expected_exchange_bytes(
            tgeom.edge_meta, mx, my, A, 5 * nz + 1, itemsize=8)
        assert sum(rep.bytes_.values()) == 7 * per_call, format_report(rep)
        nrounds = mesh_dss.routing_stats(tgeom.edge_meta, mx, my, A)[0]
        assert rep.counts["collective-permute"] == 7 * (
            2 * (mx > 1) + 2 * (my > 1) + nrounds)
        assert rep.input_bytes == sum(v.nbytes for v in start.values())
        assert 0 < rep.moved
    mesh = ShardMesh(1, 1, device=CPU)
    first, _ = t_fast.make_fast_step(tcfg, tgeom, mesh=mesh)
    rep = collective_report(first, (mesh.shard(_torch_start(start)),), mesh)
    assert rep.counts == {} and rep.moved == 0


class _Shape:
    """Anything with ``shape`` is a mesh to both predicates."""

    def __init__(self, mx, my):
        self.shape = {"x": mx, "y": my}


def test_mesh_predicate_matches_jax():
    base = dict(grid_kind="CUBED_SPHERE", ne=4, order=4, nz=6)
    variants = [
        {}, {"ne": 3}, {"ne": 6}, {"order": 3, "ne": 4},
        {"vertical_solver": "pallas"}, {"vertical_solver": "dense"},
        {"vertical_solver": "schur"}, {"vertical_solver": "jfnk"},
        {"timescheme": "ERK"}, {"timescheme": "ARS343"},
        {"timescheme": "SPEX"}, {"explicit_vertical": True},
        {"nu_uniform_scalar": 1.0}, {"nu_uniform_vector": 1.0},
        {"upwind_thermo": False}, {"vertical_staggering": "CHARNEY_PHILLIPS"},
        {"vertical_staggering": "LEVELS"}, {"grid_kind": "CARTESIAN_XZ"},
        {"rayleigh_damping": True}, {"hyperdiffusion": False},
    ]
    shapes = [(1, 1), (2, 2), (1, 4), (2, 4), (4, 1), (1, 8), (3, 1),
              (2, 3), (4, 4)]
    seen = {True: 0, False: 0}
    for var in variants:
        kw = dict(base, **var)
        jkw, tkw = dict(kw), dict(kw)
        for pkg, d in ((tj, jkw), (tt, tkw)):
            d["grid_kind"] = pkg.GridKind[kw["grid_kind"]]
            if "timescheme" in kw:
                d["timescheme"] = pkg.TimestepSchemeType[kw["timescheme"]]
            if "vertical_staggering" in kw:
                d["vertical_staggering"] = pkg.VerticalStaggering[
                    kw["vertical_staggering"]]
        jcfg = tj.ModelConfig(dtype=jnp.float64, **jkw)
        tcfg = tt.ModelConfig(dtype=torch.float64, **tkw)
        for mx, my in shapes:
            for tr in (False, True):
                want = j_engine.fast_engine_supported(
                    jcfg, has_tracers=tr, mesh=_Shape(mx, my))
                got = t_engine.fast_engine_supported(
                    tcfg, has_tracers=tr, mesh=_Shape(mx, my))
                assert got == want, (var, mx, my, tr)
                seen[got] += 1
        assert not t_engine.fast_engine_supported(tcfg, mesh=object())
    assert seen[True] > 20 and seen[False] > 100


def test_mesh_multistep_equals_eager_steps(case):
    """``make_fast_multistep(mesh=)`` (a loop on the CPU; one CUDA graph of
    every shard's steps on a card) after ``first_step``: the bits of the
    eager sharded steps, state and carry."""
    tcfg, tgeom, start, _ = case
    mesh = ShardMesh(2, 2, device=CPU)
    first, multi = t_fast.make_fast_multistep(tcfg, tgeom, 2, mesh=mesh)
    X, c = multi(*first(mesh.shard(_torch_start(start))))
    E, ce = _mesh_steps(tcfg, tgeom, start, mesh)
    for r in range(4):
        for k in X[r]:
            assert torch.equal(X[r][k], E[r][k]), (r, k)
        for k in c[r]:
            assert torch.equal(c[r][k], ce[r][k]), (r, k)
