#!/usr/bin/env python3
"""Time ``banded_solve_multi`` of a checkout on a GPU, beside the practical
floor of the bytes it moves.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 tempestmodel_tpu_torch/kernels/bench_banded.py [--root DIR]

``DIR`` (default: the repository this file lies in) is the checkout whose
package is imported, built and timed: an unpacked earlier commit (``git
archive``) under a git-ignored directory can be timed against the working
tree in one call, in turns (parent, change, change, parent).  Run as a file,
not with ``-m``, so that the package is imported from ``DIR``.

Prints one JSON line per case, float32 and float64: the moist wave's tracer
systems (n 30, q 1, R 3) and n 30, q 4, R 5, both at the flagship's 86 400
columns (two input sets that together exceed the 50 MB L2), with the device
memory one launch allocates beyond the inputs (its output and any scratch)
and, where the checkout's kernel takes a launch shape, the shape and the
stream form's time too; then the floor: ``rhs * bands.sum(1, keepdim=True)``
(a PyTorch reduction and an elementwise pass that read the bands and the
right-hand sides once and write the solution's bytes).  Each time is the
mean of 20 launches queued behind a busy device, as ``chip_smoke.py`` times
them; three repeats are printed.  The first line holds the card's name and
power limit.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys

REPEATS = 3
NCOL = 6 * 120 * 120         # the flagship's columns (ne30 p4)
N = 30                       # levels: the tracer systems' rows


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

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_banded: no CUDA device", file=sys.stderr)
        return 1
    from tempestmodel_tpu_torch.kernels import build
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.ops import cuda_banded

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "nvidia_smi": smi,
                      "build_s": build.build_all()["seconds"]}), flush=True)
    dev = torch.device("cuda")
    shaped = hasattr(cuda_banded, "banded_multi_launch_shape")

    def systems(q, R, dtype, seed):
        rng = np.random.default_rng(seed)
        b = 2 * q + 1
        bands = rng.standard_normal((N, b, NCOL))
        bands[:, q] += 2.0 * b
        rows = np.arange(N)
        for d in range(b):
            col = rows + d - q
            bands[(col < 0) | (col >= N), d] = 0.0
        rhs = rng.standard_normal((N, R, NCOL))
        return (torch.as_tensor(bands, dtype=dtype, device=dev),
                torch.as_tensor(rhs, dtype=dtype, device=dev))

    for dtype in (torch.float32, torch.float64):
        for q, R in ((1, 3), (4, 5)):
            sets = [systems(q, R, dtype, s) for s in range(2)]
            bands, rhs = sets[0]
            row = {"case": f"n{N}_q{q}_r{R}", "dtype": str(dtype)[6:],
                   "shape": [N, 2 * q + 1, R, NCOL]}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            x = cuda_banded.banded_solve_multi(bands, rhs, q)
            torch.cuda.synchronize()
            row["launch_allocates_MB"] = (torch.cuda.max_memory_allocated()
                                          - base) / 1e6
            del x
            row["ms"] = [time_cuda(lambda b, r: cuda_banded.banded_solve_multi(
                b, r, q), sets, 20, queued=True) for _ in range(REPEATS)]
            if shaped:
                row["launch"] = cuda_banded.launch_config(bands, rhs, q)
                stream = cuda_banded.banded_multi_launch_shape(
                    N, q, R, NCOL, dtype, form="stream")
                row["ms_stream_form"] = [time_cuda(
                    lambda b, r: cuda_banded._banded_solve_multi_cuda(
                        b, r, q, stream), sets, 20, queued=True)
                    for _ in range(REPEATS)]
            row["floor_ms"] = [time_cuda(
                lambda b, r: r * b.sum(1, keepdim=True), sets, 20,
                queued=True) for _ in range(REPEATS)]
            print(json.dumps(row), flush=True)
            del sets, bands, rhs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
