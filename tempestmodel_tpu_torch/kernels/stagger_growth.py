#!/usr/bin/env python3
"""Where the staggered runs grow: max |W| every 5 eager steps of UMJS with
its perturbation (no Rayleigh layer, nu4 1e15, dt 100 s, 30 levels, f32
unless named) under LEV, INT (vertical order 2), CPH and LOR, on the
kernel path and the plain path, in float32 and float64, at ne30, ne16 and
ne8, and LEV without nu4 and with nu 1e16.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 tempestmodel_tpu_torch/kernels/stagger_growth.py [--steps N]

Prints one JSON line a run (its configuration, max |W| after steps 5, 10,
..., N, seconds) and the card's name and power limit.  ``chip_smoke.py``
phase 5k times the same configurations through ``Model.go``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# (staggering, ne, dtype, configuration changes, make_fast_step keywords)
RUNS = [("LEV", 30, "f32", {}, {}), ("LEV", 30, "f32", {}, {"plain": True}),
        ("LEV", 30, "f64", {}, {}), ("LEV", 16, "f32", {}, {}),
        ("LEV", 8, "f32", {}, {}),
        ("LEV", 30, "f32", {"nu_scalar": 1e16, "nu_div": 1e16,
                            "nu_vort": 1e16}, {}),
        ("LEV", 30, "f32", {"hyperdiffusion": False}, {}),
        ("INT", 30, "f32", {}, {"plain": True}),
        ("LOR", 30, "f32", {}, {}), ("CPH", 30, "f32", {}, {})]


def run(stag, ne, dtype_name, over, kw, nsteps, dev):
    import torch
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    dtype = torch.float32 if dtype_name == "f32" else torch.float64
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = tm.ModelConfig(
        equation_set=tm.EquationSet.PRIMITIVE_NONHYDRO,
        grid_kind=tm.GridKind.CUBED_SPHERE, ne=ne, order=4, nz=30,
        vertical_order=2 if stag == "INT" else 1,
        vertical_staggering=tm.VerticalStaggering(stag), ztop=tc.ztop,
        dt=100.0, hyperdiffusion=True, nu_scalar=1e15, nu_div=1e15,
        nu_vort=1e15, vertical_solver="pallas", dtype=dtype).with_(**over)
    m = Model(cfg, tc, device=dev)
    first, step = fast.make_fast_step(cfg, m.geom, device=dev, **kw)
    X, carry = first(fast.pack_state(m.state, device=dev))
    w = []
    t0 = time.perf_counter()
    for i in range(nsteps):
        if i:
            X, carry = step(X, carry)
        if i % 5 == 4:
            w.append(float(X["W"].abs().max()))
    torch.cuda.synchronize()
    return {"staggering": stag, "ne": ne, "dtype": dtype_name,
            "changes": over, "step_keywords": kw,
            "max_abs_W_every_5_steps": w,
            "seconds": time.perf_counter() - t0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("stagger_growth: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for stag, ne, dt, over, kw in RUNS:
        print(json.dumps(run(stag, ne, dt, over, kw, args.steps, dev)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
