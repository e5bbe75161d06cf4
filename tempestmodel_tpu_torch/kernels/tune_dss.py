#!/usr/bin/env python3
"""Sweep the DSS CUDA kernels' block size and levels per thread on a GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 -m tempestmodel_tpu_torch.kernels.tune_dss

Compiles ``tempestmodel_tpu_torch/csrc/dss.cu`` once per (DSS_THREADS,
DSS_LEVELS) pair into a temporary directory, checks every variant against
the plain PyTorch versions, and prints the device time per launch of
``dss_scalar`` and ``dss_vector`` at the flagship shape (30, 6, 120, 120),
float32 and float64, beside three PyTorch elementwise passes over the same
bytes (the practical floor of one read and one write on this card).  Times
are taken as in ``chip_smoke.py``: launches queued behind a busy device,
inputs cycled through 8 buffers so that each launch finds them cold.
"""

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import torch

import tempestmodel_tpu_torch as tm
from tempestmodel_tpu_torch import fast
from tempestmodel_tpu_torch.fast import dss_cuda
from tempestmodel_tpu_torch.kernels import build
from tempestmodel_tpu_torch.kernels.timing import time_cuda
from tempestmodel_tpu_torch.models import nh_model

VARIANTS = [(128, 5), (256, 5), (64, 5), (128, 10), (256, 10), (128, 3),
            (128, 2), (128, 1), (256, 1), (128, 6), (256, 15), (128, 15)]
K, P, A, ORDER = 30, 6, 120, 4


def main():
    if not torch.cuda.is_available():
        print("tune_dss: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=A // ORDER,
                         order=ORDER, nz=K, ztop=30000.0, dtype=torch.float32)
    geom = nh_model.build_nh_sphere_geometry(cfg)
    fg = fast.build_fast_geometry(geom, dtype=torch.float32, device=dev)

    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for th, lv in VARIANTS:
            out = str(pathlib.Path(tmp) / f"dss_{th}_{lv}.so")
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DDSS_THREADS={th}",
                   f"-DDSS_LEVELS={lv}", "-o", out,
                   str(build.CSRC / "dss.cu")]
            procs.append((th, lv, out, subprocess.Popen(cmd)))
        for th, lv, _, proc in procs:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for variant {(th, lv)}")
        sweep(fg, dev, [(th, lv, so) for th, lv, so, _ in procs])
    return 0


def sweep(fg, dev, libs):
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        us = [torch.randn((K, P, A, A), dtype=dtype, device=dev,
                          generator=gen) for _ in range(8)]
        vs = [torch.randn((K, P, A, A), dtype=dtype, device=dev,
                          generator=gen) for _ in range(8)]
        imult = fg.inv_mult.to(dtype)
        rot = fg.e_rot.to(dtype).contiguous()
        want = dss_cuda.dss_scalar_plain(us[0], imult, fg.dss_links, ORDER)
        wu, wv = dss_cuda.dss_vector_plain(us[0], vs[0], imult, rot,
                                           fg.dss_links, ORDER)
        one = [(u,) for u in us]
        two = list(zip(us, vs))
        for name, fn, args in (
                ("torch x*w (1 in, 1 out)", lambda x: x * imult[None], one),
                ("torch clone", lambda x: x.clone(), one),
                ("torch u*w, v*w (2 in, 2 out)",
                 lambda u, v: (u * imult[None], v * imult[None]), two)):
            ms = time_cuda(fn, args, 40, queued=True)
            print(f"{sfx} {name}: {ms:.4f} ms", flush=True)
        for th, lv, so in libs:
            lib = ctypes.CDLL(so)
            fs = getattr(lib, "dss_scalar_" + sfx)
            fv = getattr(lib, "dss_vector_" + sfx)
            sig = build.SIGNATURES["dss"]
            fs.argtypes, fs.restype = sig["dss_scalar_" + sfx], ctypes.c_int
            fv.argtypes, fv.restype = sig["dss_vector_" + sfx], ctypes.c_int

            def run_s(x):
                out = torch.empty_like(x)
                err = fs(x.data_ptr(), imult.data_ptr(),
                         fg.dss_table.data_ptr(), out.data_ptr(), K, P, A, A,
                         ORDER, len(fg.dss_links), 0, stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
                return out

            def run_v(u, v):
                uo, vo = torch.empty_like(u), torch.empty_like(v)
                err = fv(u.data_ptr(), v.data_ptr(), imult.data_ptr(),
                         rot.data_ptr(), fg.dss_table.data_ptr(),
                         uo.data_ptr(), vo.data_ptr(), K, P, A, A, ORDER,
                         len(fg.dss_links), 0, stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
                return uo, vo

            es = float((run_s(us[0]) - want).abs().max())
            gu, gv = run_v(us[0], vs[0])
            ev = float((gu - wu).abs().max() + (gv - wv).abs().max())
            ts = time_cuda(run_s, one, 40, queued=True)
            tv = time_cuda(run_v, two, 40, queued=True)
            print(f"{sfx} threads {th:4d} levels {lv:3d}: scalar {ts:.4f} ms"
                  f"  vector {tv:.4f} ms  max-abs err {es:.1e} {ev:.1e}",
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
