"""The mesh engine with tracers, the Rayleigh layer and terrain, against the
JAX package, float64 on the CPU: the mountain-induced Rossby wave (2 km
Gaussian mountain, Rayleigh layer, nu4; ne2 p4 nz6, from rest, as
``test_torch_terrain_sphere.py`` runs it) with three seeded tracer species,
3 Strang-HEVI steps of the port's ``make_fast_step(mesh=ShardMesh(2, 2))``
against JAX's single-device ``make_fast_step``, 1e-11 relative per field
and per species, both column solvers.  The tracers ride in the exchange's
payload after W and are never Rayleigh-damped.  The ``slow`` test holds the
same run to JAX's own mesh engine (``make_fast_step(mesh=)`` under
``shard_map`` on four virtual CPU devices)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.kernels import synthetic
from tempestmodel_tpu_torch.parallel.mesh import ShardMesh

from torch_port_common import CPU, FIELDS, rel_err
from test_torch_terrain_sphere import _configs

NSTEPS = 3
NTR = 3
ALL = FIELDS + ("Tracers",)


@pytest.fixture(scope="module")
def case():
    """(jcfg, tcfg, jgeom, tgeom, start (z-first numpy, with tracers), ref
    (reference layout numpy), JAX's 3 single-device steps)."""
    jcfg, tcfg, jgeom, tgeom, start, ref = _configs("rossby")
    ref = {k: np.array(v) for k, v in ref.items()}      # writable copies
    X0 = {k: np.asarray(v) for k, v in j_fast.pack_state(
        {k: jnp.asarray(v) for k, v in start.items()}).items()}
    A = jcfg.ne * jcfg.order
    X0["Tracers"] = synthetic.random_tracers_numpy(jcfg.nz, 6, A, A, NTR,
                                                   jcfg.order, seed=11)
    first, step = j_fast.make_fast_step(jcfg, jgeom, ref_state={
        k: jnp.asarray(v) for k, v in ref.items()})
    X, c = first({k: jnp.asarray(v) for k, v in X0.items()})
    for _ in range(NSTEPS - 1):
        X, c = step(X, c)
    return (jcfg, tcfg, jgeom, tgeom, X0, ref,
            {k: np.asarray(v) for k, v in X.items()})


def _port_mesh(tcfg, tgeom, X0, ref, mx, my, **kw):
    mesh = ShardMesh(mx, my, device=CPU)
    first, step = t_fast.make_fast_step(tcfg, tgeom, ref_state=ref,
                                        mesh=mesh, ntracers=NTR, **kw)
    X, c = first(mesh.shard({k: torch.from_numpy(v.copy())
                             for k, v in X0.items()}))
    for _ in range(NSTEPS - 1):
        X, c = step(X, c)
    return mesh.gather(X), c


def _check(got, want, nz):
    assert set(got) == set(want) == set(ALL)
    for k in ALL:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k
    for i in range(NTR):
        sl = slice(i * nz, (i + 1) * nz)
        assert rel_err(got["Tracers"][sl].numpy(),
                       want["Tracers"][sl]) < 1e-11, i


@pytest.mark.parametrize("solver", ["pallas", "banded"])
def test_mesh_tracers_rayleigh_terrain_match_jax(case, solver):
    _, tcfg, _, tgeom, X0, ref, want = case
    got, carry = _port_mesh(tcfg.with_(vertical_solver=solver), tgeom, X0,
                            ref, 2, 2)
    _check(got, want, tcfg.nz)
    assert all(set(c) == {"Rt", "W", "Rho", "Tracers"} for c in carry)
    assert float(got["Tracers"].min()) >= 0.0
    assert rel_err(got["Tracers"].numpy(), X0["Tracers"]) > 1e-3


def test_mesh_step_checks_the_species_count(case):
    """``ntracers`` is read under a mesh: a state with another number of
    species raises."""
    _, tcfg, _, tgeom, X0, ref, _ = case
    mesh = ShardMesh(2, 2, device=CPU)
    first, _ = t_fast.make_fast_step(tcfg, tgeom, ref_state=ref, mesh=mesh)
    with pytest.raises(ValueError, match="ntracers"):
        first(mesh.shard({k: torch.from_numpy(v.copy())
                          for k, v in X0.items()}))


@pytest.mark.slow
def test_mesh_tracers_match_jax_mesh_engine(case):
    """The port's sharded run against JAX's ``make_fast_step(mesh=2x2,
    ntracers=3)``: 1e-11 per field and species."""
    jcfg, tcfg, jgeom, tgeom, X0, ref, _ = case
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    first, step = j_fast.make_fast_step(
        jcfg, jgeom, ref_state={k: jnp.asarray(v) for k, v in ref.items()},
        mesh=mesh, ntracers=NTR)
    spec = NamedSharding(mesh, P(None, None, "x", "y"))
    X = {k: jax.device_put(jnp.asarray(v), spec) for k, v in X0.items()}
    with mesh:
        X, c = first(X)
        for _ in range(NSTEPS - 1):
            X, c = step(X, c)
    want = {k: np.asarray(v) for k, v in X.items()}
    got, _ = _port_mesh(tcfg, tgeom, X0, ref, 2, 2)
    _check(got, want, tcfg.nz)
