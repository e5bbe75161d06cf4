#!/usr/bin/env python3
"""Sweep the launch shapes of the nu4 tail's kernels on a GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 -m tempestmodel_tpu_torch.kernels.tune_tail [hyper]

``hyper``: ``nu4_pass1`` and ``nu4_pass2`` at the
launch shapes around ``hyper_cuda.hyper_launch_shape``'s (band rows, levels
a block, ring depth; chosen at run time, no rebuild) at the flagship shapes
(ne30 p4 L30) and on the 3-D bubble's two planes, float32 and float64, each
shape's result held against the rule's; then ``csrc/hyper.cu`` built once
per ``HYPER_MIN_BLOCKS`` variant (the registers a thread may use), each
timed at the rule's shape (``dss_state`` and ``dss_scalar2`` are modes of
the band DSS kernel: ``kernels/tune_dss.py band state`` and ``band
scalar2`` sweep them).  Every variant build is swapped in behind the
wrappers and held against the default build's result.  Times are taken as
in ``chip_smoke.py``: launches queued behind a busy device; at the flagship
every launch reads more than the L2 holds.
"""

import itertools
import subprocess
import sys
import tempfile

import torch

import tempestmodel_tpu_torch as tm
from tempestmodel_tpu_torch import fast
from tempestmodel_tpu_torch.fast import hyper_cuda
from tempestmodel_tpu_torch.kernels import build, synthetic
from tempestmodel_tpu_torch.kernels.timing import time_cuda
from tempestmodel_tpu_torch.kernels.tune_fused import (compile_variants, load,
                                                       rel_err)
from tempestmodel_tpu_torch.models import nh_model
from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS)

# source stem -> variants of its -D flags (the first is the default build)
VARIANTS = {
    "hyper": [{}] + [{"HYPER_MIN_BLOCKS": b, "HYPER_MIN_BLOCKS_F64": b2}
                     for b, b2 in ((1, 2), (3, 1), (4, 1))],
}
# run-time launch shapes of the nu4 kernels: band rows (in elements), levels
# a block, ring depth
SWEEP_ROWS = (1, 2, 3)
SWEEP_LEVELS = (2, 3, 4, 6, 8, 11, 16, 31, 41)
SWEEP_RINGS = (2, 3, 4)
NE, ORDER, NZ = 30, 4, 30


def main(argv=()):
    if not torch.cuda.is_available():
        print("tune_tail: no CUDA device", file=sys.stderr)
        return 1
    if list(argv) not in ([], ["hyper"]):
        print(f"tune_tail: unknown arguments {list(argv)}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    build.build_all()
    tc = BaroclinicWaveUMJS(pert="exp")
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_variants(tmp, VARIANTS)
        for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
            cfg = tm.ModelConfig(
                grid_kind=tm.GridKind.CUBED_SPHERE, ne=NE, order=ORDER,
                nz=NZ, ztop=tc.ztop, vertical_solver="pallas", dtype=dtype)
            geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
            fg = synthetic.terrain_like(
                fast.build_fast_geometry(geom, dtype=dtype, device=dev),
                vary_jac=True)
            shapes(fg, sfx, "flagship")
            import chip_smoke
            for where, ney in (("plane", chip_smoke.PLANE_NE),
                               ("plane_rectangular",
                                chip_smoke.PLANE_NE // 2)):
                _, _, pgeom = chip_smoke.cartesian_setup(
                    "bubble3d", dtype, chip_smoke.PLANE_NE, ney,
                    chip_smoke.SCHAR_NZ)
                shapes(fast.build_fast_geometry_cartesian(
                    pgeom, dtype=dtype, device=dev), sfx, where)
            sweep(fg, sfx, libs)
            del fg
            torch.cuda.empty_cache()
    return 0


def _pass_fns(fg, hst):
    """(name, pass2, fn(d, w, launch) -> list of outputs) of both passes."""
    return (("nu4_pass1", False, lambda d, w, sh: list(hyper_cuda._launch(
                "nu4_pass1", d, None, (1.0, 1.0, 0.0, 0.0), hst,
                sh).values())),
            ("nu4_pass2", True, lambda d, w, sh: list(hyper_cuda._launch(
                "nu4_pass2", w, d, (1e10, 1e10, 100.0, 1e12), hst,
                sh).values())))


def shapes(fg, sfx, where):
    """Both passes at the run-time launch shapes around the rule's."""
    hst = hyper_cuda.hyper_statics(fg)
    sets = [(synthetic.random_state(fg, seed), synthetic.random_state(
        fg, seed + 10)) for seed in (1, 2)]
    K, (P, A, B), p = fg.nz, fg.inv_mult.shape, fg.p
    reps = 20 if P * A * B * K > 1e6 else 100
    for name, pass2, fn in _pass_fns(fg, hst):
        rule = hyper_cuda.hyper_launch_shape(K, P, A, B, p, fg.inv_mult.dtype,
                                             pass2)
        want = fn(*sets[0], rule)
        seen = set()
        for e, lv, r in itertools.product(SWEEP_ROWS, SWEEP_LEVELS,
                                          SWEEP_RINGS):
            try:
                sh = hyper_cuda.hyper_launch_shape(
                    K, P, A, B, p, fg.inv_mult.dtype, pass2, rows=e * p,
                    levels=lv, ring=r)
            except ValueError:
                continue
            if sh in seen:
                continue
            seen.add(sh)
            err = rel_err(fn(*sets[0], sh), want)
            ms = time_cuda(lambda d, w: fn(d, w, sh), sets, reps=reps,
                           queued=True)
            print(f"{sfx} {name} {where} rows {sh.rows} cols {sh.cols} "
                  f"levels {sh.levels} ring {sh.ring} blocks {sh.blocks}: "
                  f"{ms:.4f} ms{'  (rule)' if sh == rule else ''}  rel err "
                  f"vs the rule's shape {err:.1e}", flush=True)


def sweep(fg, sfx, libs):
    """Each variant build against the default one, at the rule's shapes."""
    hst = hyper_cuda.hyper_statics(fg)
    # two sets of inputs: 2 x 104 MB (float32) cycle through the L2
    sets = [(synthetic.random_state(fg, seed), synthetic.random_state(
        fg, seed + 10)) for seed in (1, 2)]
    kernels = {name: (lambda d, w, fn=fn: fn(d, w, None))
               for name, _, fn in _pass_fns(fg, hst)}
    default = dict(build._libs)
    want = {name: fn(*sets[0]) for name, fn in kernels.items()}
    torch.cuda.synchronize()
    try:
        for stem, flags, path in libs:
            build._libs[stem] = load(stem, path)
            for name, fn in kernels.items():
                err = rel_err(fn(*sets[0]), want[name])
                ms = time_cuda(fn, sets, reps=20, queued=True)
                print(f"{sfx} {name} {flags or 'default'}: {ms:.4f} ms  "
                      f"rel err vs default build {err:.1e}", flush=True)
            build._libs[stem] = default[stem]
    finally:
        build._libs.update(default)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
