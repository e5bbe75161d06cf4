"""``DistMesh`` over gloo against ``ShardMesh``, float64 on the CPU: four
processes from ``torch.multiprocessing.spawn`` (a ``file://`` rendezvous)
each run one shard of a 2 x 2 mesh, UMJS ne4 p4 nz6, two Strang-HEVI steps
(``tests/torch_mesh_worker.py``; no JAX runs in the children).  Each rank's
shard and carry equal the ``ShardMesh`` run's bit for bit, under the inline
and the overlap schedule, and so do the tallies: the same ops and per-shard
payload bytes on every rank, and the bytes the ranks sent sum to what
crossed between the ``ShardMesh``'s shards."""

import os
import time

import pytest
import torch
import torch.multiprocessing as mp

from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.parallel.mesh import ShardMesh

import torch_mesh_worker as worker


@pytest.fixture(scope="module")
def reference():
    """The ``ShardMesh`` runs of the children's configuration."""
    torch.set_num_threads(1)
    cfg, geom, X0 = worker.config()
    out = {}
    for overlap in (False, True):
        mesh = ShardMesh(*worker.MESH, device="cpu")
        first, step = t_fast.make_fast_step(
            cfg.with_(halo_overlap=overlap), geom, mesh=mesh)
        mesh.tally.reset()
        X, c = worker.run_steps(first, step, mesh.shard(X0))
        out[overlap] = (X, c, mesh.gather(X), mesh.tally)
    return out


@pytest.mark.parametrize("overlap", [False, True], ids=["inline", "overlap"])
def test_distmesh_gloo_equals_shardmesh(reference, overlap, tmp_path):
    world = worker.MESH[0] * worker.MESH[1]
    ctx = mp.spawn(worker.rank_main,
                   args=(world, str(tmp_path / "rendezvous"), str(tmp_path),
                         overlap),
                   nprocs=world, join=False)
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            pytest.fail("the ranks did not finish in 180 s")
    X, c, gathered, tally = reference[overlap]
    moved = 0
    for r in range(world):
        got = torch.load(os.path.join(tmp_path, f"rank{r}.pt"))
        assert set(got["X"]) == set(X[r])
        for k in X[r]:
            assert torch.equal(got["X"][k], X[r][k]), (r, k)
        for k in c[r]:
            assert torch.equal(got["carry"][k], c[r][k]), (r, k)
        for k in gathered:
            assert torch.equal(got["gathered"][k], gathered[k]), (r, k)
        assert got["counts"] == tally.counts
        assert got["bytes"] == tally.bytes_
        assert got["wrong_world"]
        moved += got["moved"]
    assert moved == tally.moved > 0
