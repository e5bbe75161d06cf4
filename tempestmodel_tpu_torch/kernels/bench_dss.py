#!/usr/bin/env python3
"""Time the DSS kernels ``dss_scalar``, ``dss_vector`` and ``dss_uvw`` of a
checkout on a GPU, beside the practical floor of the bytes they move.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 tempestmodel_tpu_torch/kernels/bench_dss.py [--root DIR]

``DIR`` (default: the repository this file lies in) is the checkout whose
package is imported, built and timed: an unpacked earlier commit (``git
archive``) under a git-ignored directory can be timed against the working
tree in one call, in turns (parent, change, change, parent).  Run as a file,
not with ``-m``, so that the package is imported from ``DIR``.

Prints one JSON line per case, float32 and float64: ``dss_scalar`` on a
level field of the flagship (ne30 p4: (30, 6, 120, 120), eight input copies
that cycle through more than the 50 MB L2) and on the moist wave's flat
tracer field (K = 90); ``dss_vector`` at the flagship (four input pairs);
``dss_uvw`` at the flagship with two bases and one; the three kernels at
the Schar slice of ``chip_smoke.py`` (40 levels, swapped (K, 1, 4, 400) and
natural (K, 1, 400, 4)) and on the 3-D bubble's plane (40, 1, 128, 128),
whose inputs stay in the L2 as inside their steps.  Then the floor:
PyTorch elementwise passes that read and write the same bytes (``x *
imult`` for a scalar; ``u * imult`` and ``v * imult`` for the pair; for
``dss_uvw`` those and ``addcmul`` of bw1, bw2 and dW).  A kernel line gives
the launch shape where the checkout's kernel takes one.  Each time is the
mean of 40 (small shapes: 100) launches queued behind a busy device, as
``chip_smoke.py`` times them; three repeats are printed.  The first line holds the card's
name and power limit.
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
        print("bench_dss: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import dss_cuda
    from tempestmodel_tpu_torch.kernels import build
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nh_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "nvidia_smi": smi,
                      "build_s": build.build_all()["seconds"]}), flush=True)
    dev = torch.device("cuda")

    def emit(label, fn, sets, reps, fg, shape, nfields=None):
        """``nfields``: the fields the kernel stages a level (None: the
        floor's elementwise passes)."""
        ms = [time_cuda(fn, sets, reps, queued=True) for _ in range(REPEATS)]
        row = {"case": label, "what": "floor" if nfields is None
               else "kernel", "dtype": str(fg.inv_mult.dtype)[6:],
               "shape": list(shape), "ms": ms}
        band = {1, 5} | set(getattr(dss_cuda, "NFIELDS", {}).values())
        if hasattr(dss_cuda, "dss_launch_shape") and nfields in band:
            row["launch"] = dss_cuda.dss_launch_shape(
                *shape, fg.p, fg.inv_mult.dtype, nfields)._asdict()
        print(json.dumps(row), flush=True)

    def bench(label, fg, K, ncopies, reps):
        dtype = fg.inv_mult.dtype
        P, A, B = fg.inv_mult.shape
        links, im, rot, table = fg.dss_links, fg.inv_mult, fg.e_rot, \
            fg.dss_table
        gen = torch.Generator(device=dev).manual_seed(0)

        def rnd(*shape):
            return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

        kw = dict(wrap=fg.wrap, table=table)
        xs = [(rnd(K, P, A, B),) for _ in range(ncopies)]
        emit(f"scalar_{label}", lambda x: dss_cuda.dss_scalar(
            x, im, links, fg.p, **kw), xs, reps, fg, (K, P, A, B), 1)
        emit(f"scalar_{label}", lambda x: x * im[None], xs, reps, fg,
             (K, P, A, B))
        if label.startswith("k90"):
            return
        pairs = [(rnd(K, P, A, B), rnd(K, P, A, B))
                 for _ in range(max(1, ncopies // 2))]
        emit(f"vector_{label}", lambda u, v: dss_cuda.dss_vector(
            u, v, im, rot, links, fg.p, **kw), pairs, reps, fg,
            (K, P, A, B), 2)
        emit(f"vector_{label}", lambda u, v: (u * im[None], v * im[None]),
             pairs, reps, fg, (K, P, A, B))
        del pairs
        n = max(1, ncopies // 4)
        sets = []
        for _ in range(n):
            wf = {"bw1": rnd(K + 1, P, A, B), "bw2": rnd(K + 1, P, A, B),
                  "dW": rnd(K + 1, P, A, B), "cax0": rnd(P, A, B),
                  "cbx0": rnd(P, A, B),
                  "cxx0": 1.0 + rnd(P, A, B).abs(), "cb1": 0.3, "cb2": 0.7,
                  "dt_s": 12.5, "c00": 0.6, "c01": 0.4}
            sets.append((rnd(K, P, A, B), rnd(K, P, A, B), wf))
        for tag, drop in (("two_base", False), ("one_base", True)):
            args = [(u, v, dict(w, bw2=None) if drop else w)
                    for u, v, w in sets]
            emit(f"uvw_{label}_{tag}", lambda u, v, w: dss_cuda.dss_uvw(
                u, v, im, rot, links, fg.p, w, **kw), args, reps, fg,
                (K, P, A, B), 5)
        emit(f"uvw_{label}", lambda u, v, w: (
            u * im[None], v * im[None],
            torch.addcmul(w["bw1"], w["bw2"], w["dW"])), sets, reps, fg,
            (K, P, A, B))

    for dtype in (torch.float32, torch.float64):
        cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=30,
                             order=4, nz=30, ztop=30000.0, dtype=dtype)
        geom = nh_model.build_nh_sphere_geometry(cfg)
        fg = fast.build_fast_geometry(geom, dtype=dtype, device=dev)
        bench("flagship", fg, 30, 8, 40)
        bench("k90", fg, 90, 3, 40)
        del fg
        _, _, sgeom = chip_smoke.cartesian_setup(
            "schar", dtype, chip_smoke.SCHAR_NEX, 1, chip_smoke.SCHAR_NZ)
        for layout in ("swapped", "natural"):
            fg = fast.build_fast_geometry_cartesian(
                sgeom, dtype=dtype, device=dev,
                swap_ab=(layout == "swapped"))
            bench(f"schar_{layout}", fg, chip_smoke.SCHAR_NZ, 1, 100)
        _, _, pgeom = chip_smoke.cartesian_setup(
            "bubble3d", dtype, chip_smoke.PLANE_NE, chip_smoke.PLANE_NE,
            chip_smoke.SCHAR_NZ)
        fg = fast.build_fast_geometry_cartesian(pgeom, dtype=dtype,
                                                device=dev)
        bench("plane", fg, chip_smoke.SCHAR_NZ, 1, 100)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
