#!/usr/bin/env python3
"""Time the implicit kernel (``fused_implicit_update``) of a checkout on a
GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 tempestmodel_tpu_torch/kernels/bench_implicit.py [--root DIR]

``DIR`` (default: the repository this file lies in) is the checkout whose
package is imported, built and timed: an unpacked earlier commit (``git
archive``) under a git-ignored directory can be timed against the working
tree in one call, in turns (parent, change, change, parent).  Run as a file,
not with ``-m``, so that the package is imported from ``DIR``.

Prints one JSON line per case, float32 and float64: the flagship columns
(UMJS ne30 p4 L30, 86 400 columns, terrain-like metric, the balanced state
with per-mille noise), without and with the time term, and the Schar x-z
slice of ``chip_smoke.py`` (nex 100, 40 levels, 1600 columns, swapped
layout).  Each time is the mean of 10 (Schar: 50) launches queued behind a
busy device, as ``chip_smoke.py`` times them (the flagship's inputs exceed
the 50 MB L2; Schar's stay in it); three repeats are printed, with the
device memory one launch allocates at its peak beyond its inputs.  The
first line holds the card's name and power limit.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys

REPEATS = 3


def main():
    here = pathlib.Path(__file__).resolve()
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(here.parents[2]))
    args = ap.parse_args()
    root = str(pathlib.Path(args.root).resolve())
    if sys.path and pathlib.Path(sys.path[0]).resolve() == here.parent:
        sys.path.pop(0)          # not this directory: the checkout's package
    sys.path.insert(0, root)
    os.chdir(root)

    import torch
    if not torch.cuda.is_available():
        print("bench_implicit: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import implicit_cuda, implicit as fimp
    from tempestmodel_tpu_torch.kernels import build, synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nh_model, nonhydro
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "nvidia_smi": smi,
                      "build_s": build.build_all()["seconds"]}), flush=True)
    dev = torch.device("cuda")

    def inputs(geom, fg, d, consts, seed):
        q = nonhydro.estimate_bandwidth(geom, consts)
        ist = implicit_cuda.implicit_statics(fimp.statics_to_device(
            nonhydro.band_assembly_statics(geom, q), fg.inv_mult.dtype, dev),
            fg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for k in ("U", "V", "Rt", "Rho"):
            d[k] = d[k] * (1.0 + 1e-3 * torch.randn(
                d[k].shape, dtype=d[k].dtype, device=dev, generator=gen))
        d["W"] = 0.01 * torch.randn(d["W"].shape, dtype=d["W"].dtype,
                                    device=dev, generator=gen)
        x0, aux = fimp._prep_aux(d, fg, None, interfaces=False)
        return ist, x0, aux

    def time_case(label, ist, x0, aux, consts, dt, reps):
        x1 = tuple((p * 1.001).contiguous() for p in x0)
        for time_term in (False, True):
            xs = x1 if time_term else x0

            def run():
                return implicit_cuda.fused_implicit_update(
                    xs, x0, aux, ist, dt, consts,
                    newton_time_term=time_term)

            run()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            ms = [time_cuda(run, [()], reps, queued=True)
                  for _ in range(REPEATS)]
            row = {"case": label + ("_time_term" if time_term else ""),
                   "dtype": str(x0[0].dtype)[6:],
                   "shape": list(x0[0].shape), "ms": ms,
                   "launch_alloc_mb": extra / 2**20}
            if hasattr(implicit_cuda, "launch_config"):
                row["launch"] = implicit_cuda.launch_config(
                    xs, x0, aux, ist, time_term)
            print(json.dumps(row), flush=True)

    tc = BaroclinicWaveUMJS(pert="exp")
    for dtype in (torch.float32, torch.float64):
        cfg = tm.ModelConfig(
            grid_kind=tm.GridKind.CUBED_SPHERE, ne=30, order=4, nz=30,
            ztop=tc.ztop, dt=100.0, vertical_solver="pallas", dtype=dtype)
        consts = cfg.constants
        geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
        fg = synthetic.terrain_like(
            fast.build_fast_geometry(geom, dtype=dtype, device=dev), seed=0)
        d = fast.pack_state(tc.initial_state(geom, consts, dtype=dtype,
                                             device=dev), device=dev)
        ist, x0, aux = inputs(geom, fg, d, consts, 0)
        time_case("flagship", ist, x0, aux, consts, 50.0, 10)
        del ist, x0, aux, fg, d
        _, scfg, sgeom, state, _ = chip_smoke.cartesian_setup(
            "schar", dtype, chip_smoke.SCHAR_NEX, 1, chip_smoke.SCHAR_NZ,
            dev)
        fg = fast.build_fast_geometry_cartesian(sgeom, dtype=dtype,
                                                device=dev, swap_ab=True)
        d = fast.engine._swap_ab_state(fast.pack_state(state, device=dev))
        ist, x0, aux = inputs(sgeom, fg, d, scfg.constants, 12)
        time_case("schar_swapped", ist, x0, aux, scfg.constants,
                  0.5 * chip_smoke.SCHAR_DT, 50)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
