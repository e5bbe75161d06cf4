#!/usr/bin/env python3
"""Per-phase SM cycles of the DSS kernels ``dss_scalar``, ``dss_uvw`` and
(where it is a band kernel) ``dss_vector`` of a checkout on a GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 tempestmodel_tpu_torch/kernels/dss_phases.py [--root DIR]

Builds a copy of ``DIR``'s ``csrc/dss.cu`` (default: this checkout's) with
``clock64()`` laps (the checkout's source is not changed), swaps it in
behind the wrappers, launches each kernel at the flagship shapes (ne30 p4,
float32: ``dss_scalar`` and ``dss_vector`` on (30, 6, 120, 120),
``dss_uvw`` with two bases; and the Schar slice's swapped (40 | 41, 1, 4,
400) and, for ``dss_uvw`` and ``dss_vector``, natural (40 | 41, 1, 400,
4)) and prints, per kernel,
the median over blocks of the cycles thread 0 of a block spent in each
phase, the longest block's total and the first block's phases, with the
launch's time (laps included) and the unstamped build's.  A lap reads the
clock when it is issued: a phase ends where its last instruction issues,
and a load's latency falls to the phase that first uses the value.

Two kernel designs are known.  The staged kernels (``band_kernel``) carry
``DSS_LAP(i)`` marks and take the phases
``barrier_init`` (thread 0 readies the mbarriers, where the kernel marks
it apart), ``first_copies`` (thread 0's first bulk copies),
``meet`` (the block's first barrier), ``first_gathers`` (the first steps'
edge-line gathers, the (U, V) pair's edge rotations), ``segment`` (a
thread's segment worked out), ``wait`` (for a level's copies; the first
level's apart as ``first_wait``, where the kernel marks it), ``assemble``
(``dss_uvw``: the W finish into shared memory), ``work`` (pair sums, edge
terms and stores of a thread's segments) and ``refill`` (the barrier and
the next copies), summed over a block's levels; a block's set-up is
``barrier_init``, ``first_copies`` to ``segment`` and ``first_wait``; the
SASS
instructions of each instantiation are counted too (``cuobjdump``).
The gather kernels that came before them (one thread a node, no staging)
get laps inserted at fixed lines: ``setup``, ``loads`` (every level's
gathers, edge terms included, and their sums) and ``stores``; for them a
second copy without the edge terms (wrong results, timing only) is timed
too, so that the edge terms' share shows by difference.  The first line
holds the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import tempfile

NPHASE = 10
MAXBLOCKS = 16384
STAGED = ("first_copies", "meet", "first_gathers", "segment", "wait",
          "assemble", "work", "refill", "first_wait", "barrier_init")
GATHER = ("setup", "loads", "stores")

PRELUDE = f"""
#include <cuda_runtime.h>
#define DSS_PHASES 1
__device__ long long dss_clocks[{MAXBLOCKS}][{NPHASE}];
#define DSS_PHASE_BEGIN() \\
  long long dss_t_ = clock64(); long long dss_acc_[{NPHASE}] = {{}}
#define DSS_LAP(i) do {{ const long long t_ = clock64(); \\
  dss_acc_[i] += t_ - dss_t_; dss_t_ = t_; }} while (0)
#define DSS_PHASE_END() do {{ const unsigned b_ = blockIdx.x + gridDim.x * \\
  (blockIdx.y + gridDim.y * blockIdx.z); \\
  if (threadIdx.x == 0 && b_ < {MAXBLOCKS}) \\
    for (int i_ = 0; i_ < {NPHASE}; ++i_) dss_clocks[b_][i_] = dss_acc_[i_]; \\
  }} while (0)
extern "C" int dss_read_clocks(long long* h) {{
  return (int)cudaMemcpyFromSymbol(h, dss_clocks, sizeof(dss_clocks));
}}
extern "C" int dss_clear_clocks() {{
  static long long zero[{MAXBLOCKS}][{NPHASE}];
  return (int)cudaMemcpyToSymbol(dss_clocks, zero, sizeof(dss_clocks));
}}
"""


def _insert(src, start, anchor, text, before=False):
    """``src`` with ``text`` after (or before) the first ``anchor`` past
    index ``start``; raises where the anchor is missing."""
    i = src.find(anchor, start)
    if i < 0:
        raise RuntimeError(f"dss_phases: anchor not found: {anchor[:60]!r}")
    j = i if before else i + len(anchor)
    return src[:j] + text + src[j:]


def gather_source(src, edges=True):
    """The gather kernels (before ``band_kernel``) with laps at fixed
    lines."""
    stores = ("#pragma unroll\n  for (int kk = 0; kk < LEVELS; ++kk) {\n"
              "    const int k = k0 + kk;\n")
    for head, setup_end in (
            ("dss_scalar_kernel(const T* __restrict__ x,",
             "  const T w = imult[pa * slab + node];\n"),
            ("dss_uvw_kernel(WFinish<T> wf,",
             "r[n][c] = rot[base + c * stride];\n    }\n  }\n")):
        start = src.index(head)
        src = _insert(src, start, ") {\n", "  DSS_PHASE_BEGIN();\n")
        src = _insert(src, start, setup_end, "  DSS_LAP(0);\n")
        src = _insert(src, start, stores, "  DSS_LAP(1);\n", before=True)
        end = src.index("\n}\n", src.index("DSS_LAP(1)", start))
        src = src[:end] + "\n  DSS_LAP(2);\n  DSS_PHASE_END();" + src[end:]
    if not edges:
        call = "CART ? EdgeTerms{} : edge_terms(table, pa, a, b, A, B, p)"
        if src.count(call) < 2:
            raise RuntimeError("dss_phases: edge terms not where expected")
        src = src.replace(call, "EdgeTerms{}")
    return PRELUDE + src


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
        print("dss_phases: no CUDA device", file=sys.stderr)
        return 1
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import dss_cuda
    from tempestmodel_tpu_torch.kernels import build
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nh_model

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    build.build_all()
    dev = torch.device("cuda")
    src = (build.CSRC / "dss.cu").read_text()
    staged = "DSS_LAP(" in src
    variants = {"stamped": PRELUDE + src} if staged else {
        "stamped": gather_source(src),
        "stamped_without_edges": gather_source(src, edges=False)}
    names = STAGED if staged else GATHER
    with tempfile.TemporaryDirectory() as tmp:
        plain = [a for a in build.NVCC_FLAGS
                 if a not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([build.nvcc_path(), *plain, "-cubin", "-o",
                        f"{tmp}/dss.cubin", str(build.CSRC / "dss.cu")],
                       check=True)
        sass = subprocess.run(["cuobjdump", "-sass", f"{tmp}/dss.cubin"],
                              check=True, capture_output=True,
                              text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and line.strip().startswith("/*") and "*/" in line \
                and line.split("*/", 1)[1].strip():
            counts[name] += 1
    print(json.dumps({"sass_instructions": {
        k: v for k, v in counts.items()
        if "band_kernel" in k or "dss_scalar_kernel" in k
        or "dss_uvw_kernel" in k}}), flush=True)

    dtype = torch.float32
    cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=30, order=4,
                         nz=30, ztop=30000.0, dtype=dtype)
    fg = fast.build_fast_geometry(nh_model.build_nh_sphere_geometry(cfg),
                                  dtype=dtype, device=dev)
    K, P, A = 30, 6, fg.A
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

    xs = [(rnd(K, P, A, A),) for _ in range(8)]
    wf = {"bw1": rnd(K + 1, P, A, A), "bw2": rnd(K + 1, P, A, A),
          "dW": rnd(K + 1, P, A, A), "cax0": rnd(P, A, A),
          "cbx0": rnd(P, A, A), "cxx0": 1.0 + rnd(P, A, A).abs(),
          "cb1": 0.3, "cb2": 0.7, "dt_s": 12.5, "c00": 0.6, "c01": 0.4}
    u, v = rnd(K, P, A, A), rnd(K, P, A, A)
    runs = {
        "dss_scalar": (lambda x: dss_cuda.dss_scalar(
            x, fg.inv_mult, fg.dss_links, fg.p, table=fg.dss_table), xs),
        "dss_uvw": (lambda: dss_cuda.dss_uvw(
            u, v, fg.inv_mult, fg.e_rot, fg.dss_links, fg.p, wf,
            table=fg.dss_table), [()])}
    # the Schar slice, swapped layout: launch-bound, 1600 nodes a level
    import chip_smoke
    _, _, sgeom = chip_smoke.cartesian_setup(
        "schar", dtype, chip_smoke.SCHAR_NEX, 1, chip_smoke.SCHAR_NZ)
    sfg = fast.build_fast_geometry_cartesian(sgeom, dtype=dtype, device=dev,
                                             swap_ab=True)
    sk, (sP, sA, sB) = chip_smoke.SCHAR_NZ, sfg.inv_mult.shape
    sx = rnd(sk, sP, sA, sB)
    swf = {"bw1": rnd(sk + 1, sP, sA, sB), "bw2": rnd(sk + 1, sP, sA, sB),
           "dW": rnd(sk + 1, sP, sA, sB), "cax0": rnd(sP, sA, sB),
           "cbx0": rnd(sP, sA, sB), "cxx0": 1.0 + rnd(sP, sA, sB).abs(),
           "cb1": 0.3, "cb2": 0.7, "dt_s": 0.5, "c00": 0.6, "c01": 0.4}
    su, sv = rnd(sk, sP, sA, sB), rnd(sk, sP, sA, sB)
    runs["dss_scalar_schar"] = (lambda: dss_cuda.dss_scalar(
        sx, sfg.inv_mult, (), sfg.p, wrap=sfg.wrap, table=sfg.dss_table),
        [()])
    runs["dss_uvw_schar"] = (lambda: dss_cuda.dss_uvw(
        su, sv, sfg.inv_mult, sfg.e_rot, (), sfg.p, swf, wrap=sfg.wrap,
        table=sfg.dss_table), [()])
    # the natural layout (40 | 41, 1, 400, 4): the same values transposed
    nfg = fast.build_fast_geometry_cartesian(sgeom, dtype=dtype, device=dev,
                                             swap_ab=False)

    def nat(t):
        return t.transpose(-1, -2).contiguous()

    nwf = {k: nat(v) if isinstance(v, torch.Tensor) else v
           for k, v in swf.items()}
    nu, nv = nat(su), nat(sv)
    runs["dss_uvw_schar_natural"] = (lambda: dss_cuda.dss_uvw(
        nu, nv, nfg.inv_mult, nfg.e_rot, (), nfg.p, nwf, wrap=nfg.wrap,
        table=nfg.dss_table), [()])
    if hasattr(dss_cuda, "NFIELDS"):       # dss_vector is a band kernel
        runs["dss_vector"] = (lambda: dss_cuda.dss_vector(
            u, v, fg.inv_mult, fg.e_rot, fg.dss_links, fg.p,
            table=fg.dss_table), [()])
        runs["dss_vector_schar"] = (lambda: dss_cuda.dss_vector(
            su, sv, sfg.inv_mult, sfg.e_rot, (), sfg.p, wrap=sfg.wrap,
            table=sfg.dss_table), [()])
        runs["dss_vector_schar_natural"] = (lambda: dss_cuda.dss_vector(
            nu, nv, nfg.inv_mult, nfg.e_rot, (), nfg.p, wrap=nfg.wrap,
            table=nfg.dss_table), [()])
    for kernel, (fn, sets) in runs.items():
        print(json.dumps({"kernel": kernel, "variant": "unstamped",
                          "ms": time_cuda(fn, sets, 40, queued=True)}),
              flush=True)

    default = build._libs["dss"]
    with tempfile.TemporaryDirectory() as tmp:
        for variant, text in variants.items():
            cu, so = f"{tmp}/{variant}.cu", f"{tmp}/{variant}.so"
            pathlib.Path(cu).write_text(text)
            subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                            str(build.CSRC), "-o", so, cu], check=True)
            lib = ctypes.CDLL(so)
            for name, argtypes in build.SIGNATURES["dss"].items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
            lib.dss_read_clocks.argtypes = [ctypes.c_void_p]
            build._libs["dss"] = lib
            try:
                for kernel, (fn, sets) in runs.items():
                    fn(*sets[0])
                    torch.cuda.synchronize()
                    if lib.dss_clear_clocks() != 0:
                        raise RuntimeError("clearing the clocks failed")
                    fn(*sets[0])
                    torch.cuda.synchronize()
                    h = (ctypes.c_longlong * (MAXBLOCKS * NPHASE))()
                    if lib.dss_read_clocks(ctypes.addressof(h)) != 0:
                        raise RuntimeError("reading the clocks failed")
                    a = np.array(h[:], dtype=np.int64).reshape(
                        MAXBLOCKS, NPHASE)[:, :len(names)]
                    a = a[a.sum(axis=1) > 0]
                    ms = time_cuda(fn, sets, 40, queued=True)
                    tot = a.sum(axis=1)
                    print(json.dumps({
                        "kernel": kernel, "variant": variant, "ms": ms,
                        "blocks": int(a.shape[0]),
                        "median_cycles": dict(zip(
                            names, np.median(a, axis=0).tolist())),
                        "median_total": float(np.median(tot)),
                        "max_total": float(tot.max()),
                        "block0_cycles": dict(zip(names, a[0].tolist()))}),
                        flush=True)
            finally:
                build._libs["dss"] = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
