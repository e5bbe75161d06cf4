#!/usr/bin/env python3
"""Sweep the launch shapes of the fused kernels on a GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 -m tempestmodel_tpu_torch.kernels.tune_fused \
        [stage | implicit | banded [multi | solve]]

The three kernels take their launch shapes at run time (no rebuild): the
default build is launched at every shape of ``STAGE_SHAPES`` (tile, levels
per block, ring depth) of ``fused_stage``, one base and two, without
tracers and with three species; at every shape of ``IMPLICIT_COLS`` x
``IMPLICIT_THREADS`` (columns and threads a block) of
``fused_implicit_update`` at the flagship's 86 400 columns and Schar's 1600
(nex 100, 40 levels), without and with the time term; and at every shape
of ``MULTI_COLS`` x ``MULTI_CHUNKS`` (columns a block, rows an mbarrier),
with 1 to R groups of threads, of ``banded_solve_multi``'s tile form and of ``MULTI_COLS`` of its stream form
at the moist wave's systems (n 30, q 1, R 3) and at n 30, q 4, R 5, the
flagship's 86 400 columns; and (``banded solve``; ``banded`` alone sweeps
both) at every ring form of ``banded_solve`` (``RING_COLS`` columns a block
that fit), its stream form at ``MULTI_COLS`` and
its tile form where it fits, at the unfused path's Newton systems (n 91,
q 4) and at n 30, q 4, the flagship's 86 400 columns; each held against the
rules' shape (``stage_cuda.stage_launch_shape``,
``implicit_cuda.implicit_launch_shape``,
``cuda_banded.banded_multi_launch_shape``,
``cuda_banded.banded_solve_launch_shape``), float32 and float64.  Times are
taken as in ``chip_smoke.py``: launches queued behind a busy device; every
flagship launch reads more than the L2 holds.  With an argument, only that
kernel is swept.  ``compile_variants`` and ``load`` build and load ``-D``
variants of a source for ``kernels/tune_tail.py``.
"""

import ctypes
import pathlib
import subprocess
import sys

import torch

import tempestmodel_tpu_torch as tm
from tempestmodel_tpu_torch import fast
from tempestmodel_tpu_torch.fast import (stage_cuda, implicit_cuda,
                                         implicit as fimp)
from tempestmodel_tpu_torch.kernels import build, synthetic
from tempestmodel_tpu_torch.kernels.timing import time_cuda
from tempestmodel_tpu_torch.models import nh_model, nonhydro
from tempestmodel_tpu_torch.ops import cuda_banded
from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS)

# launch shapes of banded_solve_multi: columns a block x rows an mbarrier
MULTI_COLS = (32, 64, 128, 256)
MULTI_CHUNKS = (1, 2, 4, 8)
# launch shapes of the stage kernel: (TA, TB) x levels per block x ring
STAGE_TILES = ((4, 40), (4, 24), (8, 24), (4, 60), (4, 32), (8, 40),
               (8, 8), (12, 12), (8, 16), (4, 20), (4, 16))
STAGE_LEVELS = (30, 15, 10, 8, 6)
STAGE_RINGS = (3, 4, 5, 6)
# launch shapes of the implicit kernel: columns x threads a block (the
# columns divide the threads)
IMPLICIT_COLS = (2, 4, 8, 16, 32)
IMPLICIT_THREADS = (64, 96, 128)
NE, ORDER, NZ, DT = 30, 4, 30, 100.0
NTR = 3


def compile_variants(tmp, all_variants):
    """One nvcc per (source, flags) pair of ``all_variants`` ({stem: [flags
    dict, ...]}), all started together; returns [(stem, flags, path)]."""
    procs = []
    for stem, variants in all_variants.items():
        for i, flags in enumerate(variants):
            out = str(pathlib.Path(tmp) / f"{stem}_{i}.so")
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS,
                   *[f"-D{k}={v}" for k, v in flags.items()], "-o", out,
                   str(build.CSRC / f"{stem}.cu")]
            procs.append((stem, flags, out, subprocess.Popen(cmd)))
    for stem, flags, _, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {stem} {flags}")
    return [(stem, flags, out) for stem, flags, out, _ in procs]


def load(stem, path):
    lib = ctypes.CDLL(path)
    for name, argtypes in build.SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def rel_err(got, want):
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def main(argv=()):
    if not torch.cuda.is_available():
        print("tune_fused: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    build.build_all()
    only, part = list(argv)[:1], list(argv)[1:2]
    tc = BaroclinicWaveUMJS(pert="exp")
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        cfg = tm.ModelConfig(
            grid_kind=tm.GridKind.CUBED_SPHERE, ne=NE, order=ORDER,
            nz=NZ, ztop=tc.ztop, dt=DT, vertical_solver="pallas",
            dtype=dtype)
        geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
        if only in ([], ["stage"]):
            sweep_stage(cfg, geom, dtype, sfx, dev)
        if only in ([], ["implicit"]):
            sweep_implicit(cfg, geom, tc, dtype, sfx, dev)
        if only in ([], ["banded"]) and part in ([], ["multi"]):
            sweep_banded(dtype, sfx, dev)
        if only in ([], ["banded"]) and part in ([], ["solve"]):
            sweep_solve(dtype, sfx, dev)
    return 0


def _implicit_inputs(geom, fg, d, consts, seed, dev):
    """(statics, state columns, aux) of the implicit update: the state
    with per-mille noise and a random W, as ``chip_smoke.py`` builds
    them."""
    q = nonhydro.estimate_bandwidth(geom, consts)
    ist = implicit_cuda.implicit_statics(fimp.statics_to_device(
        nonhydro.band_assembly_statics(geom, q), fg.inv_mult.dtype, dev), fg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for k in ("U", "V", "Rt", "Rho"):
        d[k] = d[k] * (1.0 + 1e-3 * torch.randn(
            d[k].shape, dtype=d[k].dtype, device=dev, generator=gen))
    d["W"] = 0.01 * torch.randn(d["W"].shape, dtype=d["W"].dtype,
                                device=dev, generator=gen)
    x0, aux = fimp._prep_aux(d, fg, None, interfaces=False)
    return ist, x0, aux


def sweep_implicit(cfg, geom, tc, dtype, sfx, dev):
    """Time the implicit kernel at every launch shape of IMPLICIT_COLS x
    IMPLICIT_THREADS that fits, at the flagship's columns and at Schar's,
    without and with the time term, each held against the rule's shape."""
    import chip_smoke
    consts = cfg.constants
    fg = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device=dev), seed=0)
    d = fast.pack_state(tc.initial_state(geom, consts, dtype=dtype,
                                         device=dev), device=dev)
    cases = {"flagship": (*_implicit_inputs(geom, fg, d, consts, 0, dev),
                          consts, 0.5 * DT, 10)}
    del fg, d
    _, scfg, sgeom, state, _ = chip_smoke.cartesian_setup(
        "schar", dtype, chip_smoke.SCHAR_NEX, 1, chip_smoke.SCHAR_NZ, dev)
    sfg = fast.build_fast_geometry_cartesian(sgeom, dtype=dtype, device=dev,
                                             swap_ab=True)
    sd = fast.engine._swap_ab_state(fast.pack_state(state, device=dev))
    cases["schar"] = (*_implicit_inputs(sgeom, sfg, sd, scfg.constants, 12,
                                        dev),
                      scfg.constants, 0.5 * chip_smoke.SCHAR_DT, 50)
    for name, (ist, x0, aux, cst, dt, reps) in cases.items():
        nz, ncol = x0[0].shape
        x1 = tuple((p * 1.001).contiguous() for p in x0)
        for tt in (False, True):
            xs = x1 if tt else x0

            def run(launch=None):
                return implicit_cuda._fused_implicit_cuda(
                    xs, x0, aux, ist, dt, cst, False, tt, launch)

            want = run()
            rule = implicit_cuda.launch_config(xs, x0, aux, ist, tt)
            label = f"{sfx} fused_implicit_update {name}" + \
                (" time term" if tt else "")
            ms = time_cuda(run, [()], reps, queued=True)
            print(f"{label} rule C{rule['cols_per_block']} "
                  f"T{rule['threads']}: {ms:.4f} ms", flush=True)
            for cols in IMPLICIT_COLS:
                for threads in IMPLICIT_THREADS:
                    try:
                        sh = implicit_cuda.implicit_launch_shape(
                            nz, ncol, dtype, cols=cols, threads=threads)
                    except ValueError:
                        continue
                    try:
                        err = rel_err(run(sh), want)
                    except RuntimeError as exc:   # too many registers
                        print(f"{label} C{cols} T{threads}: does not "
                              f"launch ({exc})", flush=True)
                        continue
                    ms = time_cuda(lambda: run(sh), [()], reps, queued=True)
                    print(f"{label} C{cols} T{threads} "
                          f"({sh.blocks(ncol)} blocks, {sh.smem} B): "
                          f"{ms:.4f} ms  rel err vs rule {err:.1e}",
                          flush=True)


def sweep_stage(cfg, geom, dtype, sfx, dev):
    """Time the stage kernel at every launch shape of STAGE_TILES x
    STAGE_LEVELS x STAGE_RINGS that fits, one base and two, with and
    without three species, each held against the rules' shape."""
    consts = cfg.constants
    fg = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device=dev),
        vary_jac=True)
    sst = stage_cuda.stage_statics(fg)
    ue, b1, b2 = (synthetic.random_state(fg, seed) for seed in (1, 2, 3))
    ue_t, b1_t, b2_t = (dict(d, Tracers=synthetic.random_tracers(fg, NTR, s))
                        for s, d in enumerate((ue, b1, b2), 7))
    cases = {"one_base": (False, b1, None, ue), "two_base": (True, b1, b2, ue),
             f"one_base+{NTR}tracers": (False, b1_t, None, ue_t),
             f"two_base+{NTR}tracers": (True, b1_t, b2_t, ue_t)}
    for name, (tb, x1, x2, ev) in cases.items():
        ntr = NTR if "Tracers" in ev else 0

        def run(launch=None):
            return stage_cuda._fused_stage_cuda(tb, 0.3 if tb else 1.0, x1,
                                                0.7, x2, ev, 12.5, fg, consts,
                                                sst, launch)

        want = run()
        rule = stage_cuda.launch_config(((0.3, x1), (0.7, x2)) if tb else x1,
                                        ev, fg, sst)
        ms = time_cuda(run, [()], 20, queued=True)
        print(f"{sfx} fused_stage {name} rule {rule['tile']} "
              f"L{rule['levels_per_block']} R{rule['ring']}: {ms:.4f} ms",
              flush=True)
        for tile in STAGE_TILES:
            for lv in STAGE_LEVELS:
                for ring in STAGE_RINGS:
                    try:
                        sh = stage_cuda.stage_launch_shape(
                            NZ, fg.A, fg.B, fg.p, ntr, dtype, tb,
                            sst.use_sep, 6, tile=tile, levels=lv, ring=ring)
                    except ValueError:
                        continue
                    try:
                        err = rel_err(run(sh), want)
                    except RuntimeError as exc:   # too many registers
                        print(f"{sfx} fused_stage {name} {tile} L{lv} "
                              f"R{ring}: does not launch ({exc})", flush=True)
                        continue
                    ms = time_cuda(lambda: run(sh), [()], 20, queued=True)
                    print(f"{sfx} fused_stage {name} {tile} L{lv} R{ring}: "
                          f"{ms:.4f} ms  rel err vs rule {err:.1e}",
                          flush=True)


def sweep_banded(dtype, sfx, dev):
    """Time banded_solve_multi at every launch shape of MULTI_COLS x
    MULTI_CHUNKS (tile form) and MULTI_COLS (stream form) that fits, at
    the moist wave's systems and at n 30, q 4, R 5 (two sets of inputs
    cycle through the L2), each held against the rule's shape."""
    from tempestmodel_tpu_torch.kernels import banded_edges
    ncol = 6 * (NE * ORDER) ** 2
    for q, R in ((1, NTR), (4, 5)):
        sets = []
        for seed in range(2):
            b, r = banded_edges.systems(NZ, q, R, ncol, seed)
            sets.append((torch.as_tensor(b, dtype=dtype, device=dev),
                         torch.as_tensor(r, dtype=dtype, device=dev)))
        rule = cuda_banded.banded_multi_launch_shape(NZ, q, R, ncol, dtype)
        want = cuda_banded._banded_solve_multi_cuda(*sets[0], q, rule)
        label = f"{sfx} banded_solve_multi n{NZ} q{q} R{R}"
        ms = time_cuda(lambda b, r: cuda_banded._banded_solve_multi_cuda(
            b, r, q, rule), sets, 20, queued=True)
        print(f"{label} rule {rule.form} C{rule.cols} T{rule.threads} chunk "
              f"{rule.chunk}: {ms:.4f} ms", flush=True)
        shapes = [dict(form="tile", cols=c, chunk=h, threads=c * k)
                  for c in MULTI_COLS for h in MULTI_CHUNKS
                  for k in range(1, R + 1)] + [dict(form="stream", cols=c)
                                               for c in MULTI_COLS]
        for kw in shapes:
            try:
                sh = cuda_banded.banded_multi_launch_shape(NZ, q, R, ncol,
                                                           dtype, **kw)
            except ValueError:
                continue
            got = cuda_banded._banded_solve_multi_cuda(*sets[0], q, sh)
            err = rel_err([got], [want])
            ms = time_cuda(lambda b, r: cuda_banded._banded_solve_multi_cuda(
                b, r, q, sh), sets, 20, queued=True)
            print(f"{label} {sh.form} C{sh.cols} T{sh.threads} chunk "
                  f"{sh.chunk} ({sh.smem} B): {ms:.4f} ms  rel err vs rule "
                  f"{err:.1e}", flush=True)



def sweep_solve(dtype, sfx, dev):
    """Time banded_solve at every ring form of RING_COLS that fits, its
    stream form at MULTI_COLS and its tile form where it
    fits, at n 91, q 4 and n 30, q 4 (two sets of inputs cycle through the
    L2), each held against the rule's shape."""
    from tempestmodel_tpu_torch.kernels import banded_edges
    ncol = 6 * (NE * ORDER) ** 2
    q = 4
    for n in (3 * NZ + 1, NZ):
        sets = []
        for seed in range(2):
            b, r = banded_edges.systems(n, q, 1, ncol, seed)
            sets.append((torch.as_tensor(b, dtype=dtype, device=dev),
                         torch.as_tensor(r[:, 0], dtype=dtype, device=dev)))
        rule = cuda_banded.banded_solve_launch_shape(n, q, ncol, dtype)
        want = cuda_banded._banded_solve_cuda(*sets[0], q, rule)
        label = f"{sfx} banded_solve n{n} q{q}"
        ms = time_cuda(lambda b, r: cuda_banded._banded_solve_cuda(
            b, r, q, rule), sets, 20, queued=True)
        print(f"{label} rule {rule.form} C{rule.cols} chunk {rule.chunk}: "
              f"{ms:.4f} ms", flush=True)
        shapes = [dict(form="ring", cols=c)
                  for c in cuda_banded.RING_COLS] + [
            dict(form="stream", cols=c) for c in MULTI_COLS] + [
            dict(form="tile")]
        for kw in shapes:
            try:
                sh = cuda_banded.banded_solve_launch_shape(n, q, ncol, dtype,
                                                           **kw)
            except ValueError:
                continue
            got = cuda_banded._banded_solve_cuda(*sets[0], q, sh)
            err = rel_err([got], [want])
            ms = time_cuda(lambda b, r: cuda_banded._banded_solve_cuda(
                b, r, q, sh), sets, 20, queued=True)
            print(f"{label} {sh.form} C{sh.cols} chunk {sh.chunk} "
                  f"({sh.smem} B, {cuda_banded.blocks_per_sm(sh.smem)} "
                  f"blocks an SM): {ms:.4f} ms  rel err vs rule {err:.1e}",
                  flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
