#!/usr/bin/env python3
"""Per-phase SM cycles and SASS instruction counts of the nu4 kernels
``nu4_pass1`` and ``nu4_pass2`` of a checkout on a GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 tempestmodel_tpu_torch/kernels/hyper_phases.py [--root DIR]

Builds a copy of ``DIR``'s ``csrc/hyper.cu`` (default: this checkout's) with
``clock64()`` laps (the checkout's source is not changed), swaps it in
behind the wrappers, launches each pass at the flagship shapes (ne30 p4,
float32, (30 | 31, 6, 120, 120), a terrain-like metric) and on the 3-D
bubble's plane (40 | 41, 1, 128, 128), and prints, per pass, the median over
blocks of the cycles thread 0 of a block spent in each phase, the longest
block's total and the first block's phases, with the launch's time (laps
included) and the unstamped build's.  A lap reads the clock when it is
issued: a phase ends where its last instruction issues, and a load's
latency falls to the phase that first uses the value.

Two kernel designs are known.  The band kernel carries ``HYPER_LAP(i)``
marks and takes the phases ``setup`` (mbarriers readied, the first copies
issued, the metric and the element matrices' columns read), ``meet`` (the
block's first barrier), ``wait`` (for a level's copies), ``layer1a`` (J u^a
into its tile, the b-sums of J u^b and u, the a-sum of v, the curl),
``barrier_a`` (the first barrier of a level and the refill of the stage the
previous level freed), ``layer1b`` (the a-sum of J u^a, the scalars'
gradients, the second layer's tiles), ``barrier_b`` and ``layer2`` (the
weak sums, the axpy and the stores), summed over a block's levels.  The
one-thread-a-node kernel that came before it gets laps at fixed lines:
``metric`` (its eight metric reads, the element matrices into shared memory,
the block's first barrier), ``loads`` (a level's five loads into the first
tiles and the barrier after them), ``layer1``, ``layer2`` and ``stores``
(pass 2 reads its five base fields there).

The SASS of each instantiation (``cuobjdump``) is counted by class: every
instruction, shared-memory loads and stores (``LDS``, ``STS``), global ones
(``LDG``, ``STG``), ``cp.async`` (``LDGSTS``), bulk copies (``UBLKCP``) and
barriers (``BAR``); and so is each loop (a backward branch and its target),
so that the level loop's counts can be read per level.  For the earlier
kernel, whose element width is a run-time value, a copy with p fixed at 4
is counted too: its sums unroll, so its level loop holds what one level
issues.  The first line holds the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

NPHASE = 8
MAXBLOCKS = 16384
BAND = ("setup", "meet", "wait", "layer1a", "barrier_a", "layer1b",
        "barrier_b", "layer2")
NODE = ("metric", "loads", "layer1", "layer2", "stores")
CLASSES = ("LDS", "STS", "LDG", "STG", "LDGSTS", "UBLKCP", "BAR")

PRELUDE = f"""
#include <cuda_runtime.h>
#define HYPER_PHASES 1
__device__ long long hyper_clocks[{MAXBLOCKS}][{NPHASE}];
#define HYPER_PHASE_BEGIN() \\
  long long hyp_t_ = clock64(); long long hyp_acc_[{NPHASE}] = {{}}
#define HYPER_LAP(i) do {{ const long long t_ = clock64(); \\
  hyp_acc_[i] += t_ - hyp_t_; hyp_t_ = t_; }} while (0)
#define HYPER_PHASE_END() do {{ const unsigned b_ = blockIdx.x + \\
  gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \\
  if (threadIdx.x == 0 && b_ < {MAXBLOCKS}) \\
    for (int i_ = 0; i_ < {NPHASE}; ++i_) hyper_clocks[b_][i_] = hyp_acc_[i_]; \\
  }} while (0)
extern "C" int hyper_read_clocks(long long* h) {{
  return (int)cudaMemcpyFromSymbol(h, hyper_clocks, sizeof(hyper_clocks));
}}
extern "C" int hyper_clear_clocks() {{
  static long long zero[{MAXBLOCKS}][{NPHASE}];
  return (int)cudaMemcpyToSymbol(hyper_clocks, zero, sizeof(hyper_clocks));
}}
"""


def _insert(src, anchor, text, at=None):
    """``src`` with ``text`` inserted into the first ``anchor``, ``at``
    characters into it (default: after it); raises where the anchor is
    missing."""
    i = src.find(anchor)
    if i < 0:
        raise RuntimeError(f"hyper_phases: anchor not found: {anchor[:60]!r}")
    j = i + (len(anchor) if at is None else at)
    return src[:j] + text + src[j:]


def node_source(src):
    """The one-thread-a-node kernel with laps at fixed lines."""
    bar = "    __syncthreads();\n"
    src = _insert(src, "unsigned char smem_raw[];\n",
                  "  HYPER_PHASE_BEGIN();\n")
    src = _insert(src, "jlinv = g.m2d[7 * level + col];\n  __syncthreads();\n",
                  "  HYPER_LAP(0);\n")
    src = _insert(src, bar + "    if (active) {\n      T dju",
                  "    HYPER_LAP(1);\n", at=len(bar))
    src = _insert(src, bar + "    if (active) {\n      T wda",
                  "    HYPER_LAP(2);\n", at=len(bar))
    src = _insert(src, "      if (lev) {\n        // the weak gradients",
                  "      HYPER_LAP(3);\n", at=0)
    src = _insert(src, "  }\n}\n\n// ptrs:", "    HYPER_LAP(4);\n", at=0)
    src = _insert(src, "    HYPER_LAP(4);\n  }\n", "  HYPER_PHASE_END();\n")
    return PRELUDE + src


def pinned_source(src):
    """The one-thread-a-node kernel with the element width fixed at 4."""
    if "p = g.p, A = g.A" not in src:
        raise RuntimeError("hyper_phases: the element width is not where "
                           "expected")
    return src.replace("p = g.p, A = g.A", "p = 4, A = g.A", 1)


_LABEL = re.compile(r"^\s*(\.L_x_\d+):\s*$")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# a branch's target: a label, or an address (cuobjdump prints either)
_BRANCH = re.compile(r"\bBRA\b[^;]*?(?:\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b)")


def _classes(ops):
    out = {"all": len(ops)}
    for c in CLASSES:
        out[c] = sum(1 for o in ops
                     if re.search(rf"(^|\s|\}})({c})(\.|\s|$)", o))
    return out


def sass_counts(sass, keep):
    """{function: {"all": ..., "LDS": ..., "loops": [{"start", "end",
    counts...}]}} of the functions whose name contains one of ``keep``; a
    loop is a backward branch and its target, the largest first."""
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = {"ops": [], "at": {}}
        elif name is None:
            continue
        elif _LABEL.match(line):
            funcs[name]["at"][_LABEL.match(line).group(1)] = \
                len(funcs[name]["ops"])
        elif _INSTR.match(line):
            addr, op = _INSTR.match(line).groups()
            funcs[name]["at"][int(addr, 16)] = len(funcs[name]["ops"])
            funcs[name]["ops"].append(op)
    out = {}
    for name, f in funcs.items():
        if not any(k in name for k in keep):
            continue
        ops, loops = f["ops"], []
        for i, o in enumerate(ops):
            m = _BRANCH.search(o)
            if not m:
                continue
            s = f["at"].get(m.group(1) if m.group(1) else int(m.group(2), 16))
            if s is not None and s <= i:
                loops.append(dict(start=s, end=i, **_classes(ops[s:i + 1])))
        loops.sort(key=lambda d: d["all"], reverse=True)
        out[name] = dict(_classes(ops), loops=loops[:6])
    return out


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
        print("hyper_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import hyper_cuda
    from tempestmodel_tpu_torch.kernels import build, synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nh_model

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    build.build_all()
    dev = torch.device("cuda")
    src = (build.CSRC / "hyper.cu").read_text()
    band = "HYPER_LAP(" in src
    names = BAND if band else NODE
    stamped = PRELUDE + src if band else node_source(src)

    counted = {"source": src} if band else {"source": src,
                                            "p_fixed_at_4": pinned_source(src)}
    plain = [a for a in build.NVCC_FLAGS
             if a not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        for tag, text in counted.items():
            cu = pathlib.Path(tmp, f"{tag}.cu")
            cu.write_text(text)
            subprocess.run([build.nvcc_path(), *plain, "-cubin", "-o",
                            f"{tmp}/{tag}.cubin", str(cu)], check=True)
            sass = subprocess.run(["cuobjdump", "-sass", f"{tmp}/{tag}.cubin"],
                                  check=True, capture_output=True,
                                  text=True).stdout
            print(json.dumps({"sass": tag, "functions": sass_counts(
                sass, ("nu4_kernel",))}), flush=True)

    runs = {}
    cases = []
    cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=30, order=4,
                         nz=30, ztop=30000.0, dtype=torch.float32)
    cases.append(("flagship", synthetic.terrain_like(
        fast.build_fast_geometry(nh_model.build_nh_sphere_geometry(cfg),
                                 dtype=torch.float32, device=dev),
        seed=chip_smoke.SEED, vary_jac=True)))
    _, _, pgeom = chip_smoke.cartesian_setup(
        "bubble3d", torch.float32, chip_smoke.PLANE_NE, chip_smoke.PLANE_NE,
        chip_smoke.SCHAR_NZ)
    cases.append(("plane", fast.build_fast_geometry_cartesian(
        pgeom, dtype=torch.float32, device=dev)))
    for where, fg in cases:
        hst = hyper_cuda.hyper_statics(fg)
        sets = [(synthetic.random_state(fg, seed=s),
                 synthetic.random_state(fg, seed=s + 10)) for s in (1, 2)]
        runs[f"nu4_pass1_{where}"] = (
            lambda x, y, fg=fg, hst=hst: hyper_cuda.nu4_pass1(x, fg, hst),
            sets)
        runs[f"nu4_pass2_{where}"] = (
            lambda x, y, fg=fg, hst=hst: hyper_cuda.nu4_pass2(
                x, y, 1.0, 1.0, 1.0, 1.0, fg, hst), sets)
    for kernel, (fn, sets) in runs.items():
        print(json.dumps({"kernel": kernel, "variant": "unstamped",
                          "ms": time_cuda(fn, sets, 20, queued=True)}),
              flush=True)

    default = build._libs["hyper"]
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = f"{tmp}/stamped.cu", f"{tmp}/stamped.so"
        pathlib.Path(cu).write_text(stamped)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", so, cu], check=True)
        lib = ctypes.CDLL(so)
        for name, argtypes in build.SIGNATURES["hyper"].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        lib.hyper_read_clocks.argtypes = [ctypes.c_void_p]
        build._libs["hyper"] = lib
        try:
            for kernel, (fn, sets) in runs.items():
                fn(*sets[0])
                torch.cuda.synchronize()
                if lib.hyper_clear_clocks() != 0:
                    raise RuntimeError("clearing the clocks failed")
                fn(*sets[0])
                torch.cuda.synchronize()
                h = (ctypes.c_longlong * (MAXBLOCKS * NPHASE))()
                if lib.hyper_read_clocks(ctypes.addressof(h)) != 0:
                    raise RuntimeError("reading the clocks failed")
                a = np.array(h[:], dtype=np.int64).reshape(
                    MAXBLOCKS, NPHASE)[:, :len(names)]
                a = a[a.sum(axis=1) > 0]
                ms = time_cuda(fn, sets, 20, queued=True)
                tot = a.sum(axis=1)
                print(json.dumps({
                    "kernel": kernel, "variant": "stamped", "ms": ms,
                    "blocks": int(a.shape[0]),
                    "median_cycles": dict(zip(
                        names, np.median(a, axis=0).tolist())),
                    "median_total": float(np.median(tot)),
                    "max_total": float(tot.max()),
                    "block0_cycles": dict(zip(names, a[0].tolist()))}),
                    flush=True)
        finally:
            build._libs["hyper"] = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
