"""The port's mesh DSS (``fast/mesh_dss.py``) against the JAX package's,
float64 on the CPU at ne4 p4 nz6: the static routing and both byte helpers
message for message and round for round at (2, 4), (2, 2), (1, 4) and
(1, 1); the exchange on a ``ShardMesh``, inline and overlap, with and
without a flat tracer block in the payload, against JAX's
``make_state_dss_mesh`` under ``shard_map`` (the conftest's virtual CPU
devices) to 1e-13; and against the port's single-device DSS, which it
equals bit for bit (the port sums every pair along a before any along b on
a mesh as on one device; the JAX package's mesh DSS rounds differently
from its single-device one where a shard boundary meets an element
boundary).  The overlap schedule equals the inline one bit for bit."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from tempestmodel_tpu.fast import engine as j_engine, mesh_dss as j_mesh_dss
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch.fast import mesh_dss as t_mesh_dss
from tempestmodel_tpu_torch.kernels import synthetic
from tempestmodel_tpu_torch.parallel.mesh import ShardMesh

from torch_port_common import (build_pair, CPU, FIELDS, rel_err,
                               random_fast_state)

NZ = 6
NTR = 3


@pytest.fixture(scope="module")
def grids():
    jcfg, jgeom, tcfg, tgeom = build_pair(nz=NZ)
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    tfg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64,
                                       device=CPU)
    return jgeom, jfg, tfg


def _state(A, tracers, seed=0):
    d = random_fast_state(NZ, A, seed=seed)
    if tracers:
        d["Tracers"] = synthetic.random_tracers_numpy(NZ, 6, A, A, NTR, 4,
                                                      seed=seed + 1)
    return d


def _port_dss(tfg, d, mx, my, overlap):
    """The port's mesh DSS of the numpy z-first dict ``d`` on a
    ``ShardMesh`` of the CPU, gathered."""
    mesh = ShardMesh(mx, my, device=CPU)
    fn = t_mesh_dss.make_state_dss_mesh(
        tfg.dss_links, tfg.e_rot.numpy(), mx, my, tfg.A, tfg.p, NZ,
        overlap=overlap)
    ds = mesh.shard({k: torch.from_numpy(v.copy()) for k, v in d.items()})
    ims = mesh.shard({"m": tfg.inv_mult[None]})
    out = mesh.run(lambda r, x, w: fn(x, w["m"][0]), ds, ims)
    return mesh.gather(out)


def _jax_dss(jfg, d, mx, my, overlap):
    mesh = Mesh(np.array(jax.devices()[:mx * my]).reshape(mx, my),
                ("x", "y"))
    fn = j_mesh_dss.make_state_dss_mesh(
        jfg.dss_links, np.asarray(jfg.e_rot), mx, my, jfg.A, jfg.p, NZ,
        overlap=overlap)
    sspec = {k: P(None, None, "x", "y") for k in d}
    f = jax.jit(jax.shard_map(lambda s, w: fn(s, w), mesh=mesh,
                              in_specs=(sspec, P(None, "x", "y")),
                              out_specs=sspec))
    sh = {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P(None, None, "x", "y"))) for k, v in d.items()}
    w = jax.device_put(jfg.inv_mult, NamedSharding(mesh, P(None, "x", "y")))
    with mesh:
        out = f(sh, w)
    return {k: np.asarray(v) for k, v in out.items()}


def _single(tfg, d):
    """The port's single-device DSS (the kernels' plain versions)."""
    return t_engine.apply_dss({k: torch.from_numpy(v.copy())
                               for k, v in d.items()}, tfg, plain=True)


@pytest.mark.parametrize("mx,my", [(2, 4), (2, 2), (1, 4), (1, 1)])
def test_routing_and_bytes_equal_jax(grids, mx, my):
    """The same local messages and the same rounds, message for message
    (every field of each ``Msg``), and the same byte and routing counts."""
    jgeom, jfg, tfg = grids
    A = tfg.A
    jl, jr = j_mesh_dss.build_edge_routing(jgeom.edge_meta, mx, my, A)
    tl, tr = t_mesh_dss.build_edge_routing(tfg.dss_links, mx, my, A)

    def rows(msgs):
        return [dataclasses.astuple(m) for m in msgs]

    assert rows(tl) == rows(jl)
    assert len(tr) == len(jr)
    for trd, jrd in zip(tr, jr):
        assert [(k, rows(ms)) for k, ms in trd] == \
            [(k, rows(ms)) for k, ms in jrd]
        srcs = [k[0] for k, _ in trd]
        dsts = [k[1] for k, _ in trd]
        assert len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts)
    for ktot, item in ((5 * NZ + 1, 8), (5 * NZ + 1 + NTR * NZ, 4)):
        assert t_mesh_dss.expected_exchange_bytes(
            tfg.dss_links, mx, my, A, ktot, item) == \
            j_mesh_dss.expected_exchange_bytes(jgeom.edge_meta, mx, my, A,
                                               ktot, item)
    assert t_mesh_dss.routing_stats(tfg.dss_links, mx, my, A) == \
        j_mesh_dss.routing_stats(jgeom.edge_meta, mx, my, A)


@pytest.mark.parametrize("tracers", [False, True], ids=["dry", "tracers"])
@pytest.mark.parametrize("mx,my", [(2, 2), (1, 4)])
def test_mesh_dss_matches_jax_and_single_device(grids, mx, my, tracers):
    """Both schedules against JAX's mesh DSS under ``shard_map`` (1e-13 per
    field) and against the port's single-device DSS (bit for bit; the
    tracers take no rotation)."""
    _, jfg, tfg = grids
    d = _state(tfg.A, tracers, seed=3)
    single = _single(tfg, d)
    for overlap in (False, True):
        want = _jax_dss(jfg, d, mx, my, overlap)
        got = _port_dss(tfg, d, mx, my, overlap)
        assert set(got) == set(want) == set(d)
        for k in d:
            assert rel_err(got[k].numpy(), want[k]) < 1e-13, (k, overlap)
            assert rel_err(got[k].numpy(), single[k].numpy()) < 1e-13, k
            assert torch.equal(got[k], single[k]), (k, overlap)


def test_overlap_schedule_bit_equal(grids):
    """The overlap schedule posts every exchange before the interior pair
    sums and gives the inline schedule's bits, with a tracer block too."""
    _, _, tfg = grids
    d = _state(tfg.A, True, seed=5)
    for mx, my in ((2, 4), (1, 4), (2, 2)):
        a = _port_dss(tfg, d, mx, my, False)
        b = _port_dss(tfg, d, mx, my, True)
        for k in d:
            assert torch.equal(a[k], b[k]), (mx, my, k)
    assert set(FIELDS) < set(d)
