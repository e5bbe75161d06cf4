#!/usr/bin/env python3
"""Time the DSS kernels ``dss_scalar``, ``dss_vector``, ``dss_uvw``,
``dss_scalar2`` and ``dss_state`` of a checkout on a GPU, beside the
practical floor of the bytes they move.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 tempestmodel_tpu_torch/kernels/bench_dss.py [--root DIR]
        [--modes scalar,vector,scalar2,uvw,state]

``DIR`` (default: the repository this file lies in) is the checkout whose
package is imported, built and timed: an unpacked earlier commit (``git
archive``) under a git-ignored directory can be timed against the working
tree in one call, in turns (parent, change, change, parent).  Run as a file,
not with ``-m``, so that the package is imported from ``DIR``.

Prints one JSON line per case, float32 and float64: ``dss_scalar`` on a
level field of the flagship (ne30 p4: (30, 6, 120, 120), eight input copies
that cycle through more than the 50 MB L2) and on the moist wave's flat
tracer field (K = 90); ``dss_vector`` at the flagship (four input pairs);
``dss_uvw`` at the flagship with two bases and one; ``dss_scalar2`` (Rt and
Rho in one launch) beside two ``dss_scalar`` launches on the same fields and,
at the flagship, one ``torch.sparse.mm`` of the scalar operator on the two
fields side by side (``kernels/dss_operator.py``); ``dss_state`` (the five
fields of a state, W with one level more) without and with the Rayleigh
finish, beside the separate launches it merges (``dss_vector``,
``dss_scalar`` on W, ``dss_scalar2`` on Rt and Rho, and with the finish
``engine.apply_rayleigh`` after them); the kernels at
the Schar slice of ``chip_smoke.py`` (40 levels, swapped (K, 1, 4, 400) and
natural (K, 1, 400, 4)) and on the 3-D bubble's plane (40, 1, 128, 128),
whose inputs stay in the L2 as inside their steps.  Then the floor:
PyTorch elementwise passes that read and write the same bytes (``x *
imult`` for a scalar; ``u * imult`` and ``v * imult`` for the pair and for
``dss_scalar2``; for
``dss_uvw`` those and ``addcmul`` of bw1, bw2 and dW; for ``dss_state`` each
field times imult, with the finish ``addcmul`` of ref, fac and the field).
``--modes`` keeps the named cases only (``scalar`` also names the K = 90
line).  A kernel line gives
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
    ap.add_argument("--modes", default="scalar,vector,scalar2,uvw,state")
    args = ap.parse_args()
    modes = set(args.modes.split(","))
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
    from tempestmodel_tpu_torch.kernels import build, dss_operator
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nh_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "nvidia_smi": smi,
                      "build_s": build.build_all()["seconds"]}), flush=True)
    dev = torch.device("cuda")

    def launch_of(shape, fg, mode):
        """The band kernel's launch shape in ``mode`` where the checkout's
        kernel runs that mode (its rule takes the mode's name, or in
        checkouts before ``dss_scalar2`` joined the band kernel its field
        count), else None."""
        modes = getattr(dss_cuda, "MODES", ())
        if mode not in modes:
            return None
        arg = mode if "scalar2" in modes else dss_cuda.NFIELDS[mode]
        return dss_cuda.dss_launch_shape(*shape, fg.p, fg.inv_mult.dtype,
                                         arg)._asdict()

    def emit(label, fn, sets, reps, fg, shape, mode=None, what="kernel"):
        """``mode``: the band kernel's mode that ``fn`` runs, if any;
        ``what``: "kernel", "floor" or another yardstick."""
        ms = [time_cuda(fn, sets, reps, queued=True) for _ in range(REPEATS)]
        row = {"case": label, "what": what,
               "dtype": str(fg.inv_mult.dtype)[6:], "shape": list(shape),
               "ms": ms}
        launch = launch_of(shape, fg, mode) if mode else None
        if launch is not None:
            row["launch"] = launch
        print(json.dumps(row), flush=True)

    def bench_state(label, fg, K, ncopies, reps, rnd, kw):
        """``dss_state`` without and with the Rayleigh finish, the separate
        launches it merges, and the floor."""
        from tempestmodel_tpu_torch.fast import engine
        P, A, B = fg.inv_mult.shape
        links, im, rot = fg.dss_links, fg.inv_mult, fg.e_rot
        shape = (K, P, A, B)

        def state():
            return {k: rnd(K + (k == "W"), P, A, B)
                    for k in dss_cuda.STATE_FIELDS}

        sets = []
        for _ in range(max(1, ncopies // 4)):
            fac = {k: rnd(*v.shape).abs() for k, v in state().items()}
            sets.append((state(), (fac, state())))

        def separate(d, ray=None):
            u, v = dss_cuda.dss_vector(d["U"], d["V"], im, rot, links, fg.p,
                                       **kw)
            out = {"U": u, "V": v,
                   "W": dss_cuda.dss_scalar(d["W"], im, links, fg.p, **kw)}
            out["Rt"], out["Rho"] = dss_cuda.dss_scalar2(
                d["Rt"], d["Rho"], im, links, fg.p, **kw)
            return out if ray is None else engine.apply_rayleigh(out, *ray)

        for tag, ray in (("", False), ("_rayleigh", True)):
            args = [(d, r if ray else None) for d, r in sets]
            emit(f"state{tag}_{label}", lambda d, r: dss_cuda.dss_state(
                d, im, rot, links, fg.p, rayleigh=r, **kw), args, reps, fg,
                shape, "state")
            emit(f"state{tag}_{label}", separate, args, reps, fg, shape,
                 what="the separate launches")
            emit(f"state{tag}_{label}", lambda d, r: [
                d[k] * im[None] if r is None
                else torch.addcmul(r[1][k], r[0][k], d[k])
                for k in dss_cuda.STATE_FIELDS], args, reps, fg, shape,
                what="floor")

    def bench(label, fg, K, ncopies, reps):
        dtype = fg.inv_mult.dtype
        P, A, B = fg.inv_mult.shape
        links, im, rot, table = fg.dss_links, fg.inv_mult, fg.e_rot, \
            fg.dss_table
        gen = torch.Generator(device=dev).manual_seed(0)

        def rnd(*shape):
            return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

        kw = dict(wrap=fg.wrap, table=table)
        if "scalar" in modes:
            xs = [(rnd(K, P, A, B),) for _ in range(ncopies)]
            emit(f"scalar_{label}", lambda x: dss_cuda.dss_scalar(
                x, im, links, fg.p, **kw), xs, reps, fg, (K, P, A, B),
                "scalar")
            emit(f"scalar_{label}", lambda x: x * im[None], xs, reps, fg,
                 (K, P, A, B), what="floor")
            del xs
        if label.startswith("k90"):
            return
        if "state" in modes:
            bench_state(label, fg, K, ncopies, reps, rnd, kw)
        pairs = [(rnd(K, P, A, B), rnd(K, P, A, B))
                 for _ in range(max(1, ncopies // 2))]
        if "vector" in modes:
            emit(f"vector_{label}", lambda u, v: dss_cuda.dss_vector(
                u, v, im, rot, links, fg.p, **kw), pairs, reps, fg,
                (K, P, A, B), "vector")
            emit(f"vector_{label}", lambda u, v: (u * im[None],
                                                  v * im[None]),
                 pairs, reps, fg, (K, P, A, B), what="floor")
        if "scalar2" in modes:
            emit(f"scalar2_{label}", lambda x1, x2: dss_cuda.dss_scalar2(
                x1, x2, im, links, fg.p, **kw), pairs, reps, fg,
                (K, P, A, B), "scalar2")
            emit(f"scalar2_{label}", lambda x1, x2: (
                dss_cuda.dss_scalar(x1, im, links, fg.p, **kw),
                dss_cuda.dss_scalar(x2, im, links, fg.p, **kw)), pairs,
                reps, fg, (K, P, A, B), what="two dss_scalar launches")
            if label == "flagship":
                op = dss_operator.scalar_operator(im, links, fg.p, fg.wrap)
                stacked = [(torch.cat([x1, x2]),) for x1, x2 in pairs]
                emit(f"scalar2_{label}", lambda x: dss_operator.apply(op, x),
                     stacked, reps, fg, (K, P, A, B),
                     what="one torch.sparse.mm on the two fields side by "
                          "side")
                del op, stacked
        del pairs
        if "uvw" not in modes:
            return
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
                (K, P, A, B), "uvw")
        emit(f"uvw_{label}", lambda u, v, w: (
            u * im[None], v * im[None],
            torch.addcmul(w["bw1"], w["bw2"], w["dW"])), sets, reps, fg,
            (K, P, A, B), what="floor")

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
