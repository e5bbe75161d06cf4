#!/usr/bin/env python3
"""Time the stage kernel (``fused_stage``) of a checkout on a GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 tempestmodel_tpu_torch/kernels/bench_stage.py [--root DIR]

``DIR`` (default: the repository this file lies in) is the checkout whose
package is imported, built and timed: an unpacked earlier commit (``git
archive``) under a git-ignored directory can be timed against the working
tree in one call, in turns (parent, change, change, parent).  Run as a file,
not with ``-m``, so that the package is imported from ``DIR``.

Prints one JSON line per case, float32 and float64: the flagship shapes
(ne30 p4 L30, terrain-like metric with a z-constant 3-D Jacobian) with one
base and two, without tracers and with three seeded species, and the Schar
x-z slice of ``chip_smoke.py`` (nex 100, 40 levels, full 3-D metric) in both
layouts.  Each time is the mean of 20 (Schar: 50) launches queued behind a
busy device, as ``chip_smoke.py`` times them (the flagship's inputs exceed
the 50 MB L2; Schar's stay in it); three repeats are printed.  The first
line holds the card's name and power limit.
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
        print("bench_stage: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import stage_cuda
    from tempestmodel_tpu_torch.kernels import build, synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "nvidia_smi": smi,
                      "build_s": build.build_all()["seconds"]}), flush=True)
    dev = torch.device("cuda")

    def time_stage(label, fg, sets, reps):
        """sets: [(base, ueval)]; the same launch on each in turn."""
        st = stage_cuda.stage_statics(fg)
        split = [(stage_cuda._split_base(b), ue) for b, ue in sets]

        def run(i):
            (tb, c1, x1, c2, x2), ue = split[i]
            return stage_cuda._fused_stage_cuda(tb, c1, x1, c2, x2, ue,
                                                12.5, fg, consts, st)

        ms = [time_cuda(run, [(i,) for i in range(len(sets))], reps,
                        queued=True) for _ in range(REPEATS)]
        row = {"case": label, "dtype": str(fg.inv_mult.dtype)[6:],
               "ms": ms, "shape": list(sets[0][1]["U"].shape)}
        if hasattr(stage_cuda, "launch_config"):
            row["launch"] = stage_cuda.launch_config(sets[0][0], sets[0][1],
                                                     fg, st)
        print(json.dumps(row), flush=True)

    tc = BaroclinicWaveUMJS(pert="exp")
    for dtype in (torch.float32, torch.float64):
        cfg = tm.ModelConfig(
            grid_kind=tm.GridKind.CUBED_SPHERE, ne=30, order=4, nz=30,
            ztop=tc.ztop, dt=100.0, vertical_solver="pallas", dtype=dtype)
        consts = cfg.constants
        geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
        fg = synthetic.terrain_like(
            fast.build_fast_geometry(geom, dtype=dtype, device=dev),
            vary_jac=True)
        ue, b1, b2 = (synthetic.random_state(fg, s) for s in (1, 2, 3))
        time_stage("flagship_one_base", fg, [(b1, ue)], 20)
        time_stage("flagship_two_base", fg, [(((0.3, b1), (0.7, b2)), ue)],
                   20)
        ue, b1, b2 = (dict(d, Tracers=synthetic.random_tracers(fg, 3, s))
                      for s, d in enumerate((ue, b1, b2), 7))
        time_stage("flagship_one_base_3species", fg, [(b1, ue)], 20)
        time_stage("flagship_two_base_3species", fg,
                   [(((0.3, b1), (0.7, b2)), ue)], 20)
        del ue, b1, b2, fg
        _, scfg, sgeom = chip_smoke.cartesian_setup(
            "schar", dtype, chip_smoke.SCHAR_NEX, 1, chip_smoke.SCHAR_NZ)
        consts = scfg.constants
        for layout in ("swapped", "natural"):
            fg = fast.build_fast_geometry_cartesian(
                sgeom, dtype=dtype, device=dev,
                swap_ab=(layout == "swapped"))
            # one argument set, as chip_smoke.py times it: the slice's
            # fields (0.25 MB each) stay in the L2, as inside its step
            ue, b1, b2 = (synthetic.random_state(fg, s) for s in (1, 2, 3))
            time_stage(f"schar_{layout}_one_base", fg, [(b1, ue)], 50)
            time_stage(f"schar_{layout}_two_base", fg,
                       [(((0.3, b1), (0.7, b2)), ue)], 50)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
