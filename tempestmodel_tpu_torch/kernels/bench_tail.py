#!/usr/bin/env python3
"""Time the nu4 tail's kernels ``nu4_pass1`` and ``nu4_pass2`` of a
checkout on a GPU, beside the practical floor of the bytes they move.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 tempestmodel_tpu_torch/kernels/bench_tail.py [--root DIR]

``DIR`` (default: the repository this file lies in) is the checkout whose
package is imported, built and timed: an unpacked earlier commit (``git
archive``) under a git-ignored directory can be timed against the working
tree in one call, in turns (parent, change, change, parent).  Run as a file,
not with ``-m``, so that the package is imported from ``DIR``.

Prints one JSON line per case, float32 and float64: both passes at the
flagship (ne30 p4: (30 | 31, 6, 120, 120), two input sets of 2 x 104 MB in
float32 that cycle through more than the 50 MB L2), on the 3-D bubble's
plane (40 | 41, 1, 128, 128) and on its rectangular plane (..., 128, 64),
whose inputs stay in the L2 as inside their steps.  The metric is
terrain-like with a 3-D Jacobian that is no multiple of the 2-D one; the
viscosities make pass 2's increment as large as the state.  Then the floor:
PyTorch elementwise passes that read and write the same bytes (pass 1:
``x * 2`` on each of the five fields; pass 2: ``base + work`` on each).
Each time is the mean of 20 (planes: 100) launches queued behind a busy
device, as ``chip_smoke.py`` times them; three repeats are printed.  Last,
the 3-D thermal bubble on that plane (32 x 32 elements, p 4, 40 levels,
float32, the nu4 tail on the kernels) through ``make_fast_multistep``: ms
a step by CUDA events over four replays of a 10-step graph, and device ms
and launches a step from torch.profiler over two replays.  It steps at dt
0.01 s with nu 1e3: the test case's dt 0.1 s and nu 1e6 suit
``chip_smoke.py``'s 4 x 2-element grid and give non-finite fields on this
one within the 70 steps; the step's launches do not depend on either.
The first line holds the card's name and power limit.
"""
BUBBLE_DT, BUBBLE_NU = 0.01, 1.0e3

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
        print("bench_tail: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import hyper_cuda
    from tempestmodel_tpu_torch.kernels import build, synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nh_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "nvidia_smi": smi,
                      "build_s": build.build_all()["seconds"]}), flush=True)
    dev = torch.device("cuda")
    fields = ("U", "V", "Rt", "Rho", "W")

    def emit(label, what, fn, sets, reps, fg, pass2=None):
        ms = [time_cuda(fn, sets, reps, queued=True) for _ in range(REPEATS)]
        shape = list(sets[0][0]["U"].shape)
        row = {"case": label, "what": what,
               "dtype": str(fg.inv_mult.dtype)[6:], "shape": shape,
               "ms": ms}
        if pass2 is not None and hasattr(hyper_cuda, "hyper_launch_shape"):
            row["launch"] = hyper_cuda.hyper_launch_shape(
                *shape, fg.p, fg.inv_mult.dtype, pass2)._asdict()
        print(json.dumps(row), flush=True)

    def bench(label, fg, reps):
        hst = hyper_cuda.hyper_statics(fg)
        sets = [(synthetic.random_state(fg, seed=s),
                 synthetic.random_state(fg, seed=s + 10)) for s in (1, 2)]
        d, w = sets[0]
        unit = hyper_cuda.nu4_pass1_plain(w, fg, hst)
        nu_s = float(d["Rho"].abs().max() / unit["Rho"].abs().max())
        nu_v = float(d["U"].abs().max() / unit["U"].abs().max())
        nu = (nu_s, nu_v, 0.7 * nu_v, 1.0)
        del unit
        emit(f"nu4_pass1_{label}", "kernel",
             lambda x, y: hyper_cuda.nu4_pass1(x, fg, hst), sets, reps, fg,
             False)
        emit(f"nu4_pass1_{label}", "floor",
             lambda x, y: [x[k] * 2.0 for k in fields], sets, reps, fg)
        emit(f"nu4_pass2_{label}", "kernel",
             lambda x, y: hyper_cuda.nu4_pass2(x, y, *nu, fg, hst), sets,
             reps, fg, True)
        emit(f"nu4_pass2_{label}", "floor",
             lambda x, y: [x[k] + y[k] for k in fields], sets, reps, fg)

    for dtype in (torch.float32, torch.float64):
        cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=30,
                             order=4, nz=30, ztop=30000.0, dtype=dtype)
        geom = nh_model.build_nh_sphere_geometry(cfg)
        fg = synthetic.terrain_like(
            fast.build_fast_geometry(geom, dtype=dtype, device=dev),
            seed=chip_smoke.SEED, vary_jac=True)
        bench("flagship", fg, 20)
        del fg
        for tag, ney in (("plane", chip_smoke.PLANE_NE),
                         ("plane_rectangular", chip_smoke.PLANE_NE // 2)):
            _, _, pgeom = chip_smoke.cartesian_setup(
                "bubble3d", dtype, chip_smoke.PLANE_NE, ney,
                chip_smoke.SCHAR_NZ)
            fg = fast.build_fast_geometry_cartesian(pgeom, dtype=dtype,
                                                    device=dev)
            bench(tag, fg, 100)
        torch.cuda.empty_cache()
    bubble_line(chip_smoke, fast, dev)
    return 0


def bubble_line(chip_smoke, fast, dev):
    """The 3-D bubble on the plane under graph replay (prints one line)."""
    import torch
    from tempestmodel_tpu_torch.kernels import counts
    _, cfg, geom, state, _ = chip_smoke.cartesian_setup(
        "bubble3d", torch.float32, chip_smoke.PLANE_NE, chip_smoke.PLANE_NE,
        chip_smoke.SCHAR_NZ, dev)
    cfg = cfg.with_(dt=BUBBLE_DT, nu_scalar=BUBBLE_NU, nu_div=BUBBLE_NU,
                    nu_vort=BUBBLE_NU)
    inner = chip_smoke.INNER_STEPS
    first_step, multi = fast.make_fast_multistep(cfg, geom, inner,
                                                 device=dev)
    counts.reset_launch_counts()
    X, carry = multi(*first_step(fast.pack_state(state, device=dev)))
    launches = {k: v for k, v in counts.launch_counts.items() if v}
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(4):
        ev0.record()
        X, carry = multi(X, carry)
        ev1.record()
        torch.cuda.synchronize()
        ms.append(ev0.elapsed_time(ev1) / inner)
    prof = chip_smoke.profile_steps(multi, X, carry, 2, "bubble_multistep",
                                    inner)
    if not all(bool(torch.isfinite(v).all()) for v in X.values()):
        raise RuntimeError("bubble: non-finite fields")
    print(json.dumps({
        "case": "bubble3d_multistep", "shape": list(X["U"].shape),
        "dt": BUBBLE_DT, "nu": BUBBLE_NU,
        "ms_per_step_each_replay": ms,
        "device_ms_per_step": prof["device_ms_per_step"],
        "device_launches_per_step": prof["device_launches_per_step"],
        "kernel_launches_at_capture": launches,
        "top": [(r["name"][:40], r["device_ms_per_step"])
                for r in prof["top"][:12]]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
