"""Weak/strong scaling harness of the z-first engine over a device mesh.

Counterpart of the JAX package's ``parallel/scaling.py``.  The reference's
only scaling axis is the 2-D horizontal domain decomposition
(``GridCSGLL.cpp:92-148``, one patch per MPI rank).  This harness runs the
flagship nonhydrostatic Strang-HEVI step (UMJS, order 4) over meshes of 1,
2, 4 and 8 shards and reports both:

- **strong scaling**: fixed global problem, growing mesh;
- **weak scaling**: the per-shard block held ~constant (A scales with
  sqrt(n_shards); exact at n in {1, 4} on the cubed sphere since A = B).

The mesh is a ``parallel.mesh.ShardMesh``: every shard on one device (the
card, by default), the sharded step replayed as one CUDA graph.  On one
card the numbers measure what splitting costs (smaller kernels, more
launches, the exchange's copies), as the JAX harness says of its virtual
CPU devices, not multi-card throughput.  Only ``engine="fast"`` (the
z-first engine) runs; the JAX package's reference-layout mesh engine is not
ported (``engine="reference"`` raises).

Run: ``python -m tempestmodel_tpu_torch.parallel.scaling [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

_REFERENCE = ("the reference-layout mesh engine is not ported (ROADMAP "
              "queue 1 item 1: mesh outside the z-first envelope); use "
              "engine='fast'")


def _mesh_shape(n: int):
    mx = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            mx = cand
            break
    return mx, n // mx


def _build(ne: int, nz: int, dtype, device):
    from ..config import ModelConfig, GridKind
    from ..models import nh_model
    from ..testcases.nonhydro_sphere import BaroclinicWaveUMJS
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=ne, order=4,
                      nz=nz, ztop=tc.ztop, dt=100.0, hyperdiffusion=True,
                      nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                      vertical_solver="pallas", dtype=dtype)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    state = tc.initial_state(geom, cfg.constants, dtype=dtype, device=device)
    return cfg, geom, state


def _elapsed_s(fn, dev):
    """Seconds of one call of ``fn``: CUDA events on the card,
    ``time.perf_counter`` on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) * 1e-3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure(n_devices: int, ne: int, nz: int = 10, steps: int = 5,
            dtype=None, reps: int = 3, explicit: bool = True,
            engine: str = "fast", device=None) -> dict:
    """Gridpoint-steps/s of the flagship step on a mesh of ``n_devices``
    shards (one device without a mesh for 1), the JAX package's keys.

    ``engine``: ``"fast"``, the z-first engine (the overlap-scheduled mesh
    DSS on a mesh, as the JAX harness ships it); ``"reference"`` raises.
    ``explicit`` is accepted for the JAX package's signature (it picks a
    DSS layer of the reference-layout engine) and not read.  ``device``:
    where every shard lives (default ``cuda``; raises when absent)."""
    from .._device import resolve_device
    from ..fast import engine as feng
    from .mesh import ShardMesh
    if engine != "fast":
        raise NotImplementedError(_REFERENCE)
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float32
    cfg, geom, state = _build(ne, nz, dtype, dev)
    mx, my = _mesh_shape(n_devices)
    mesh = ShardMesh(mx, my, device=dev) if n_devices > 1 else None
    if mesh is not None:
        cfg = cfg.with_(halo_overlap=True)
    first_step, multi = feng.make_fast_multistep(cfg, geom, steps,
                                                 mesh=mesh, device=dev)
    X = feng.pack_state(state, device=dev)
    if mesh is not None:
        X = mesh.shard(X)
    X, carry = first_step(X)
    multi(X, carry)                      # build, capture
    best = min(_elapsed_s(lambda: multi(X, carry), dev) / steps
               for _ in range(reps))
    npts = 6 * (ne * 4) ** 2 * nz
    return {"n_devices": n_devices, "mesh": [mx, my], "ne": ne, "nz": nz,
            "engine": engine,
            "gridpoints": npts, "sec_per_step": best,
            "gps_total": npts / best,
            "gps_per_device": npts / best / n_devices}


def scaling_report(device_counts=(1, 2, 4, 8), ne_strong: int = 8,
                   weak_pairs=((1, 6), (4, 12)), nz: int = 10,
                   steps: int = 5, device=None) -> dict:
    """Strong sweep at fixed ne + weak pairs with the per-shard work fixed,
    for the z-first engine (the JAX package's ``strong_fast`` and
    ``weak_fast``; its ``strong`` and ``weak`` of the reference-layout
    engine stay empty)."""
    from .._device import resolve_device
    dev = resolve_device(device)
    out = {"strong": [], "weak": [], "reference": _REFERENCE,
           "platform": dev.type}
    out["strong_fast"] = [measure(n, ne_strong, nz, steps, device=dev)
                          for n in device_counts]
    out["weak_fast"] = [measure(n, ne, nz, steps, device=dev)
                        for n, ne in weak_pairs]
    for key in ("strong_fast", "weak_fast"):
        if out[key]:
            s0 = out[key][0]["gps_per_device"]
            for r in out[key]:
                r["efficiency"] = r["gps_per_device"] / s0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the shards live (default cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(scaling_report(device=args.device), indent=1))


if __name__ == "__main__":
    main()
