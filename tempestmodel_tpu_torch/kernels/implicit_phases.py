#!/usr/bin/env python3
"""Per-phase SM cycles and SASS instruction counts of the implicit kernel
(``csrc/implicit.cu``) on a GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 -m tempestmodel_tpu_torch.kernels.implicit_phases

Builds a copy of the source with ``clock64()`` stamps after each barrier and
after the forward elimination (the repository's source is not changed),
launches it at the flagship's columns (UMJS ne30 p4 L30, f32 and f64) at the
rule's tile and at 8 and 16 columns of 128 threads, and prints the median
cycles of each phase over the first 256 blocks: staging, level values,
interface values and W rows, level rows, forward elimination, back
substitution (these blocks start together, so the staging reads in a
burst).  Then it counts the SASS instructions (``cuobjdump -sass``) of each
phase of the float32 instantiation with 16-byte copies, the elimination and
the back substitution as one.  The first line holds the card's name and
power limit.
"""

import ctypes
import json
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

NBLOCKS = 256
PHASES = ("stage", "levels", "interfaces", "level_rows", "lu_forward",
          "lu_back")
LU_DONE = "    eliminate<T, 0>(w, up, yp);  // W_nz\n"


def stamped_source(src: str) -> str:
    """``src`` with a clock stamp at the kernel's start, after each
    barrier, after the forward elimination and at its end, into the device
    array ``implicit_clocks`` (read back by ``implicit_read_clocks``)."""
    begin = src.index("fused_implicit_kernel(const ImplicitArgs<T> g) {")
    end = src.index("template <typename T, int V>\nint launch_one")
    kern = src[begin:end]
    n = 0

    def stamp(slot):
        return (f" if (threadIdx.x == 0 && blockIdx.x < {NBLOCKS}) "
                f"implicit_clocks[blockIdx.x][{slot}] = clock64();")

    def after_barrier(m):
        nonlocal n
        n += 1
        return m.group(0) + stamp(n)

    kern = re.sub(r"__syncthreads\(\);", after_barrier, kern)
    if n != 4 or LU_DONE not in kern:
        raise RuntimeError("the kernel's phases are not where this tool "
                           "expects them")
    kern = kern.replace("{", "{" + stamp(0), 1)
    kern = kern.replace(LU_DONE, LU_DONE + stamp(5) + "\n", 1)
    kern = kern.rstrip()
    kern = kern[:-1] + stamp(6) + "\n}\n\n"
    return (src[:begin].replace(
        "namespace {\n",
        f"__device__ long long implicit_clocks[{NBLOCKS}][8];\nnamespace {{\n",
        1) + kern + src[end:] +
        '\nextern "C" int implicit_read_clocks(long long* h) {\n'
        '  return (int)cudaMemcpyFromSymbol(h, implicit_clocks, '
        f'sizeof(long long) * {NBLOCKS} * 8);\n}}\n')


def sass_counts(cubin: str) -> dict:
    """Instructions of each phase of the float32, 16-byte-copy
    instantiation, split at its barriers."""
    text = subprocess.run(["cuobjdump", "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    body = text[text.index("fused_implicit_kernelIfLi4E"):]
    nxt = body.find("Function :", 10)
    body = body if nxt < 0 else body[:nxt]
    counts, seg = [0], 0
    for line in body.splitlines():
        if re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", line):
            counts[seg] += 1
            if "BAR.SYNC" in line:
                counts.append(0)
                seg += 1
    names = ("stage", "levels", "interfaces", "level_rows", "lu")
    return dict(zip(names, counts))


def main():
    if not torch.cuda.is_available():
        print("implicit_phases: no CUDA device", file=sys.stderr)
        return 1
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import implicit_cuda
    from tempestmodel_tpu_torch.kernels import build, synthetic, tune_fused
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    build.build_all()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        src = (build.CSRC / "implicit.cu").read_text()
        with open(f"{tmp}/stamped.cu", "w") as f:
            f.write(stamped_source(src))
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                        f"{tmp}/stamped.so", f"{tmp}/stamped.cu"],
                       check=True)
        plain = [a for a in build.NVCC_FLAGS
                 if a not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([build.nvcc_path(), *plain, "-cubin", "-o",
                        f"{tmp}/implicit.cubin", str(build.CSRC /
                                                     "implicit.cu")],
                       check=True)
        print(json.dumps({"sass_instructions_f32_16B":
                          sass_counts(f"{tmp}/implicit.cubin")}),
              flush=True)
        lib = tune_fused.load("implicit", f"{tmp}/stamped.so")
        lib.implicit_read_clocks.argtypes = [ctypes.c_void_p]
        default = build._libs["implicit"]
        build._libs["implicit"] = lib
        try:
            tc = BaroclinicWaveUMJS(pert="exp")
            for dtype in (torch.float32, torch.float64):
                cfg = tm.ModelConfig(
                    grid_kind=tm.GridKind.CUBED_SPHERE, ne=30, order=4,
                    nz=30, ztop=tc.ztop, dt=100.0, vertical_solver="pallas",
                    dtype=dtype)
                geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
                fg = synthetic.terrain_like(fast.build_fast_geometry(
                    geom, dtype=dtype, device=dev), seed=0)
                d = fast.pack_state(tc.initial_state(
                    geom, cfg.constants, dtype=dtype, device=dev),
                    device=dev)
                ist, x0, aux = tune_fused._implicit_inputs(
                    geom, fg, d, cfg.constants, 0, dev)
                nz, ncol = x0[0].shape
                rule = implicit_cuda.implicit_launch_shape(nz, ncol, dtype)
                for cols, nth in sorted({(rule.cols, rule.threads), (8, 128),
                                         (16, 128)}):
                    sh = implicit_cuda.implicit_launch_shape(
                        nz, ncol, dtype, cols=cols, threads=nth)
                    for _ in range(2):
                        implicit_cuda._fused_implicit_cuda(
                            x0, x0, aux, ist, 50.0, cfg.constants, False,
                            False, sh)
                    torch.cuda.synchronize()
                    h = (ctypes.c_longlong * (NBLOCKS * 8))()
                    if lib.implicit_read_clocks(ctypes.addressof(h)) != 0:
                        raise RuntimeError("reading the clocks failed")
                    a = np.array(h[:], dtype=np.int64).reshape(NBLOCKS, 8)
                    cycles = np.median(np.diff(a[:, :7], axis=1), axis=0)
                    print(json.dumps({
                        "dtype": str(dtype)[6:], "cols": cols,
                        "threads": sh.threads,
                        "rule": (cols, nth) == (rule.cols, rule.threads),
                        "median_cycles": dict(zip(PHASES,
                                                  cycles.tolist())),
                        "total": float(np.median(a[:, 6] - a[:, 0]))}),
                        flush=True)
                del fg, d, ist, x0, aux
        finally:
            build._libs["implicit"] = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
