#!/usr/bin/env python3
"""Sweep the launch shapes of the nu4 tail's kernels on a GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 -m tempestmodel_tpu_torch.kernels.tune_tail

Compiles ``csrc/hyper.cu`` and ``csrc/dss.cu`` once per variant of their
``-D`` tunables into a temporary directory, swaps each variant in behind the
wrappers, holds its result against the default build's, and prints the
device time per launch of ``nu4_pass1``, ``nu4_pass2``, ``dss_state`` (with
and without the Rayleigh finish) and ``dss_scalar2`` at the flagship shapes
(ne30 p4 L30), float32 and float64.  Times are taken as in
``chip_smoke.py``: launches queued behind a busy device; every launch reads
more than the L2 holds.
"""

import subprocess
import sys
import tempfile

import torch

import tempestmodel_tpu_torch as tm
from tempestmodel_tpu_torch import fast
from tempestmodel_tpu_torch.fast import dss_cuda, hyper_cuda
from tempestmodel_tpu_torch.kernels import build, synthetic
from tempestmodel_tpu_torch.kernels.timing import time_cuda
from tempestmodel_tpu_torch.kernels.tune_fused import (compile_variants, load,
                                                       rel_err)
from tempestmodel_tpu_torch.models import nh_model
from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS)

# source stem -> variants of its -D flags (the first is the default build)
VARIANTS = {
    "hyper": [{}] + [{"HYPER_LEVELS": lv, "HYPER_TILE_A": a,
                      "HYPER_TILE_B": b}
                     for lv, a, b in ((8, 4, 32), (16, 4, 32), (31, 4, 32),
                                      (4, 8, 32), (4, 4, 64), (4, 4, 24),
                                      (4, 4, 40), (2, 4, 32))],
    "dss": [{}] + [{"STATE_THREADS": t, "STATE_LEVELS": lv, "S2_THREADS": t,
                    "S2_LEVELS": lv2}
                   for t, lv, lv2 in ((128, 1, 1), (128, 2, 2), (128, 3, 3),
                                      (128, 4, 5), (128, 5, 8), (256, 2, 4),
                                      (64, 2, 4), (256, 1, 2))],
}
NE, ORDER, NZ = 30, 4, 30


def main():
    if not torch.cuda.is_available():
        print("tune_tail: no CUDA device", file=sys.stderr)
        return 1
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
            sweep(geom, dtype, sfx, dev, libs)
    return 0


def sweep(geom, dtype, sfx, dev, libs):
    fg = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device=dev),
        vary_jac=True)
    hst = hyper_cuda.hyper_statics(fg)
    # two sets of inputs: 2 x 104 MB (float32) cycle through the L2
    sets = [(synthetic.random_state(fg, seed), synthetic.random_state(
        fg, seed + 10)) for seed in (1, 2)]
    gen = torch.Generator(device=dev).manual_seed(0)
    ray = tuple({k: torch.rand(v.shape, dtype=dtype, device=dev,
                               generator=gen) for k, v in sets[0][0].items()}
                for _ in range(2))
    dss = (fg.inv_mult, fg.e_rot, fg.dss_links, fg.p)

    def state(d, _, rayleigh=None):
        out = dss_cuda.dss_state(d, *dss, rayleigh=rayleigh,
                                 table=fg.dss_table)
        return [out[k] for k in dss_cuda.STATE_FIELDS]

    def listed(fn):
        return lambda *a: list(fn(*a).values())

    # name -> (source stem, function of (d, work) returning a list)
    kernels = {
        "nu4_pass1": ("hyper", listed(
            lambda d, w: hyper_cuda.nu4_pass1(d, fg, hst))),
        "nu4_pass2": ("hyper", listed(lambda d, w: hyper_cuda.nu4_pass2(
            d, w, 1e10, 1e10, 1e10, 100.0, fg, hst))),
        "dss_state": ("dss", state),
        "dss_state_rayleigh": ("dss", lambda d, w: state(d, w, ray)),
        "dss_scalar2": ("dss", lambda d, w: list(dss_cuda.dss_scalar2(
            d["Rt"], d["Rho"], fg.inv_mult, fg.dss_links, fg.p,
            table=fg.dss_table))),
    }
    default = dict(build._libs)
    want = {name: fn(*sets[0]) for name, (_, fn) in kernels.items()}
    torch.cuda.synchronize()
    try:
        for stem, flags, path in libs:
            build._libs[stem] = load(stem, path)
            for name, (kstem, fn) in kernels.items():
                if kstem != stem:
                    continue
                err = rel_err(fn(*sets[0]), want[name])
                ms = time_cuda(fn, sets, reps=20, queued=True)
                print(f"{sfx} {name} {flags or 'default'}: {ms:.4f} ms  "
                      f"rel err vs default build {err:.1e}", flush=True)
            build._libs[stem] = default[stem]
    finally:
        build._libs.update(default)


if __name__ == "__main__":
    sys.exit(main())
