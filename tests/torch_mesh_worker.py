"""The child processes of ``tests/test_torch_mesh_dist.py``: one rank of a
gloo group each, a shard of a ``DistMesh``.  It imports torch and the port
only (no JAX runs in a child)."""

import os

import torch
import torch.distributed as dist

MESH = (2, 2)
STEPS = 2        # first_step, then this many - 1 steps


def config():
    """The UMJS configuration of the mesh tests (ne4 p4 nz6, float64) and
    its initial z-first state on the CPU."""
    import tempestmodel_tpu_torch as tt
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, ne=4, order=4,
                         nz=6, ztop=tc.ztop, dt=100.0, hyperdiffusion=True,
                         nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                         vertical_solver="pallas", dtype=torch.float64)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    state = tc.initial_state(geom, cfg.constants, dtype=torch.float64,
                             device="cpu")
    return cfg, geom, fast.pack_state(state, device="cpu")


def run_steps(first, step, X):
    X, c = first(X)
    for _ in range(STEPS - 1):
        X, c = step(X, c)
    return X, c


def rank_main(rank, world, init_file, out_dir, overlap):
    """One rank: ``STEPS`` steps of the mesh engine on a ``DistMesh`` over
    gloo; its shard, carry and exchange tally saved to ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from tempestmodel_tpu_torch import fast
        from tempestmodel_tpu_torch.parallel.mesh import DistMesh
        cfg, geom, X0 = config()
        try:
            DistMesh(1, 2)            # a mesh of another size than the group
            wrong_world = False
        except ValueError:
            wrong_world = True
        mesh = DistMesh(*MESH)
        first, step = fast.make_fast_step(cfg.with_(halo_overlap=overlap),
                                          geom, mesh=mesh, device="cpu")
        mesh.tally.reset()
        X, c = run_steps(first, step, mesh.shard(X0))
        gathered = mesh.gather(X)
        t = mesh.tally
        torch.save({"X": X, "carry": c, "gathered": gathered,
                    "counts": t.counts, "bytes": t.bytes_, "moved": t.moved,
                    "wrong_world": wrong_world},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
