#!/usr/bin/env python3
"""Time ``banded_solve`` and ``banded_solve_multi`` of a checkout on a GPU,
beside the practical floor of the bytes they move.

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

Then ``banded_solve`` at the flagship's unfused Newton systems (n 91, q 4,
86 400 columns, two input sets), float32 and float64: the rule's launch, the
memory one launch allocates, each form the checkout's launch rule can take
(``banded_solve_launch_shape``), ``banded_solve_multi`` on the same systems
with ``rhs.view(n, 1, ncol)`` (its rule's form, its tile form where a tile
fits and its stream form forced), and the floor ``rhs * bands.sum(1)``.
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
N_SOLVE, Q_SOLVE = 91, 4     # the unfused Newton systems: 3 nz + 1 rows


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

    def systems(q, R, dtype, seed, n=N):
        rng = np.random.default_rng(seed)
        b = 2 * q + 1
        bands = rng.standard_normal((n, b, NCOL))
        bands[:, q] += 2.0 * b
        rows = np.arange(n)
        for d in range(b):
            col = rows + d - q
            bands[(col < 0) | (col >= n), d] = 0.0
        rhs = rng.standard_normal((n, R, NCOL))
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
    for dtype in (torch.float32, torch.float64):
        bench_solve(cuda_banded, systems, dtype, time_cuda)
    return 0


def bench_solve(cuda_banded, systems, dtype, time_cuda):
    """``banded_solve`` at n 91, q 4 (one line), ``banded_solve_multi`` at
    R = 1 on the same systems (one line), and their floor (one line)."""
    import torch
    n, q = N_SOLVE, Q_SOLVE
    sets = []
    for s in range(2):
        b, r = systems(q, 1, dtype, 10 + s, n)
        sets.append((b, r[:, 0].contiguous()))
        del b, r
    bands, rhs = sets[0]
    tag = str(dtype)[6:]
    row = {"case": f"solve_n{n}_q{q}", "dtype": tag, "kernel": "banded_solve",
           "shape": [n, 2 * q + 1, NCOL]}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    x = cuda_banded.banded_solve(bands, rhs, q)
    torch.cuda.synchronize()
    row["launch_allocates_MB"] = (torch.cuda.max_memory_allocated()
                                  - base) / 1e6
    want = cuda_banded.banded_solve_plain(bands, rhs, q)
    row["max_rel_err"] = float((x - want).abs().max() / want.abs().max())
    del x
    row["ms"] = [time_cuda(lambda b, r: cuda_banded.banded_solve(b, r, q),
                           sets, 20, queued=True) for _ in range(REPEATS)]
    rule = getattr(cuda_banded, "banded_solve_launch_shape", None)
    if rule is not None:
        row["launch"] = cuda_banded.launch_config(bands, rhs, q)
        for form in cuda_banded.SOLVE_FORMS:
            try:
                sh = rule(n, q, NCOL, dtype, form=form)
            except ValueError:
                continue
            row[f"ms_{form}_form"] = [time_cuda(
                lambda b, r: cuda_banded._banded_solve_cuda(b, r, q, sh),
                sets, 20, queued=True) for _ in range(REPEATS)]
            row[f"launch_{form}_form"] = sh._asdict()
    print(json.dumps(row), flush=True)

    multi = [(b, r.view(n, 1, NCOL)) for b, r in sets]
    row = {"case": f"solve_n{n}_q{q}", "dtype": tag,
           "kernel": "banded_solve_multi R=1"}
    row["ms"] = [time_cuda(lambda b, r: cuda_banded.banded_solve_multi(
        b, r, q), multi, 20, queued=True) for _ in range(REPEATS)]
    row["launch"] = cuda_banded.launch_config(*multi[0], q)
    for form in ("tile", "stream"):
        try:
            sh = cuda_banded.banded_multi_launch_shape(n, q, 1, NCOL, dtype,
                                                       form=form)
        except ValueError as e:
            row[f"{form}_form"] = f"not taken: {e}"
            continue
        row[f"ms_{form}_form"] = [time_cuda(
            lambda b, r: cuda_banded._banded_solve_multi_cuda(b, r, q, sh),
            multi, 20, queued=True) for _ in range(REPEATS)]
        row[f"launch_{form}_form"] = sh._asdict()
    print(json.dumps(row), flush=True)
    row = {"case": f"solve_n{n}_q{q}", "dtype": tag, "kernel": "floor",
           "what": "rhs * bands.sum(1)",
           "ms": [time_cuda(lambda b, r: r * b.sum(1), sets, 20, queued=True)
                  for _ in range(REPEATS)]}
    print(json.dumps(row), flush=True)
    del sets, multi, bands, rhs, want
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
