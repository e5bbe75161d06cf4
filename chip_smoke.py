#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It imports ``tempestmodel_tpu_torch`` only (never jax, never the JAX
package), builds the hand-written CUDA kernels from ``csrc/`` with nvcc,
and runs these phases, each printing one JSON line:

1. device   the card's name and power limit as nvidia-smi gives them;
2. build    every kernel source compiled and loaded, with the seconds;
3. kernel   each of the eleven kernels against its plain PyTorch version on
            the card at the flagship shapes, float32 and float64, with times
            (``fused_stage`` also with three seeded tracer species and at
            its edge shapes: two levels, a level count no multiple of the
            chunk or the ring, one-value and 8-byte copies, one species and
            two groups of species; each stage line names its launch shape,
            ring depth and copy route, and the build line the registers
            and spills of every instantiation of the stage kernel;
            ``dss_scalar`` also on their flat 90-row field, the five
            modes of the band DSS kernel (``dss_scalar``, ``dss_vector``,
            ``dss_uvw``, ``dss_scalar2``, ``dss_state``) at their edge
            shapes (p 2-4, one element a panel, unaligned inputs, several
            blocks' worth of segments a band, rings of one and three
            stages, two levels, Cartesian wraps along one axis or both),
            each bit for bit equal to its plain version (``dss_scalar2``
            also to two ``dss_scalar`` launches, ``dss_state``, with and
            without its Rayleigh finish, also to the separate launches
            followed by the plain finish), each DSS line naming its launch
            shape and copy route, ``dss_scalar``, ``dss_vector`` and ``dss_scalar2`` timed
            beside one ``torch.sparse.mm`` of the same operator (also
            ``dss_vector`` on the Cartesian grids below), ``nu4_pass1``
            and ``nu4_pass2`` at their edge
            shapes (p 2-8, one element a panel, one level, unaligned
            inputs, rings of two to four stages, narrow bands, planes in
            both layouts), each nu4 line naming its launch shape and copy
            route,
            ``banded_solve_multi`` at the moist wave's shapes, at n 30,
            q 4, R 5 and at the edge shapes of ``kernels/banded_edges.py``
            (2-300 rows, q 1-8, R 1-5, 1-1000 columns, unaligned inputs,
            tiles of 64 columns, the stream form), ``banded_solve`` at the
            flagship's Newton systems (n 91, q 4) in each of its forms (the
            same bits in each), at n 30, q 4, with the memory a launch
            allocates, and at its edge shapes (2-800 rows, q 1-8, 1-1000
            columns, unaligned inputs, blocks of 32, 16 and 8 columns,
            fewer rows than slots, tiny and huge pivots, the tile and
            stream forms), each line naming its form, columns, ring or
            tile, copy route; the build line also gives the registers and
            spills of every instantiation of the band DSS kernel and of
            ``csrc/banded_multi.cu``); then what
            periodic Cartesian grids reach: the five DSS kernels with the
            wrap-sum at the Schar slice's shapes in both layouts and on a
            128 x 128 plane, ``fused_stage`` with ``xz_zero`` on the Schar
            slice (terrain: the full 3-D metric), ``fused_implicit_update`` at
            its 1600 columns, ``nu4_pass1/2`` on the 3-D bubble's plane;
            ``fused_implicit_update`` also at its edge shapes (2, 8 and 40
            levels; 1, 7, 1532 (a partial last tile) and 1600 columns;
            one-value and 8-byte copies from unaligned inputs), each
            implicit line naming its launch shape and copy route and the
            build line the registers and spills of every instantiation of
            the implicit kernel; and ``fused_stage`` over a real mountain
            (``MountainRossby3D``'s metric at the flagship shape, the
            geometry built in float64) in its separable and its full 3-D
            form, float32 and float64, timed beside the flagship line;
4. slice    the Strang-HEVI step at small size in float64 on the card three
            ways — fused kernel path, unfused kernel path, plain path — each
            pair to 1e-11 relative per field, and ``make_fast_multistep``
            (one CUDA-graph replay of 3 steps) against 3 eager steps; all of
            it dry, and again with three seeded tracer species in the state;
            then the Schar slice (nex 8, nz 8, both layouts) and the 3-D
            bubble (nex 4, ney 2, nu4 on): kernel path against plain path,
            graph replay against eager steps; then the IMEX step
            (``make_fast_imex_step``, 2 steps, float64) kernel path against
            plain path to 1e-11: ne4 nz8 with ARS343 and GARK2, each with
            the DSS as ``dss_state`` and as the default grouping, and the
            Schar slice (ARS343, its sponge on) in both layouts; then
            terrain: ``MountainRossby3D``, ``ScharMountainSphere`` (X=500)
            and JW at ne4 nz8 and the shear jet over its mountain (nex 8
            nz 8, both layouts), kernel path against plain path to 1e-11
            and a 3-step graph replay bit for bit the eager steps;
5. flagship the main paths at full width: UMJS baroclinic wave, ne30 p4
            nz30 float32: ``make_fast_multistep`` (``first_step``, then
            replays of a 10-step CUDA graph), the eager fused path of
            ``make_fast_step`` (``first_step`` and 5 ``step``s), then the
            unfused path (``fused=False``, ``first_step`` and 1 ``step``);
            finite fields, launch counts, ms/step of each; then the moist
            baroclinic wave (DCMIP2016, the same grid, + 3 tracers) through
            ``make_fast_multistep`` and eagerly, with the global mass of each
            species before and after; then the Schar mountain waves at the
            JAX package's second bench line (x-z slice, nex 100, p 4, 40
            levels, f32, dt 0.5) through ``make_fast_multistep`` in both
            layouts, timed in turns, and on the eager fused path; then
            (5e) the IMEX-ARK step on the flagship grid (ARS343, the
            fused implicit kernel, dt 100 s): 1 + 3 eager steps and a
            10-step CUDA graph of ``make_fast_imex_step``'s ``step``
            captured here, replayed 4 times, with its launches a step,
            device busy time a step (torch.profiler) and peak memory;
            then (5f) the model driver: the CLI's flagship run
            (``cli.main``, UMJS with its perturbation and Rayleigh layer,
            the fused implicit kernel, 40 steps, checksums, invariants,
            lat-lon NetCDF output and checkpoints every 20 steps): its
            timers beside the graph replay of the same configuration, its
            final state bitwise equal to ``first_step`` and three replays
            of a 13-step graph, restarts from its step-20 ``.tarena``
            checkpoint and from an ``.npz`` one continued bit for bit, a
            run without hooks timed and profiled, one firing of each
            output timed; the Held-Suarez case (20 steps, the physics
            every step) and the DCMIP2016 tropical cyclone with Kessler and
            the simple physics (10 steps; water within 5 %, no species
            negative), each with its launch counts; then (5g) the
            flagship grid over a mountain: ``MountainRossby3D`` (ne30 p4
            L30 f32, its 2 km mountain, Rayleigh layer, nu4) through
            ``make_fast_multistep`` (a 10-step graph, 4 timed replays; then
            in turns beside the same graph over the float64-built geometry
            and the flat flagship with its Rayleigh layer), eagerly (1 + 5)
            and ``Model.go`` (20 steps, no hooks): the path predicates held
            to the JAX package's, the launches a step exact, device busy
            and launches a step (``utils.devprof``), the largest terrain
            term, max |U - U0| and the change of the total Rho mass;
6. dss      the step with the tail's DSS as four launches or as
            ``dss_state`` and the stages' Rt/Rho as two launches or as
            ``dss_scalar2``, eagerly and under graph replay, in turns; the
            same four groupings under graph replay on the Schar slice and
            on the IMEX flagship (every DSS of the IMEX step is a
            full-state DSS);
7. kernels  one line listing every kernel with its time, bound, plain
            version's time and launches on the flagship runs, its launches
            on the IMEX, the Schar and the terrain paths, and its Cartesian
            figures.

With ``--profile PATH`` it also traces steps of each flagship path, of the
moist replay and of the Schar paths with torch.profiler and writes the
device time by kernel to the JSON file PATH.

Any failure raises: the exit code is then non-zero and no result line is
printed.  Without a CUDA device the script exits with code 1 at once.  The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and float32 / float64 rates outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# flagship configuration (the UMJS baroclinic wave of the JAX package's
# bench: ne30, p=4, 30 levels, float32, one device)
NE, ORDER, NZ, DT, NU = 30, 4, 30, 100.0, 1.0e15
FLAGSHIP_STEPS = 5          # eager, on the fused path
UNFUSED_STEPS = 1
INNER_STEPS = 10            # steps in one CUDA graph of make_fast_multistep
REPLAYS = 4                 # timed replays of that graph
SEED = 0
MOIST_STEPS = 3             # eager, moist wave
NTR = 3                     # tracer species of the moist wave
# the Schar mountain waves of the JAX package's second bench line
# (bench.py:339-413): x-z slice, nex 100, ney 1, p 4, 40 levels, float32
SCHAR_NEX, SCHAR_NZ, SCHAR_DT, SCHAR_NU = 100, 40, 0.5, 1.0e7
PLANE_NE = 32               # elements a side of the 3-D bubble's plane
# the IMEX-ARK step on the flagship grid: ARS343 (four stages, three with an
# implicit part, one Newton iteration each), the fused implicit kernel
IMEX_SCHEME, IMEX_STEPS = "ars343", 3      # eager steps after one warm-up
# the driver (phase 5f): the CLI's flagship run, as a user types it (with
# the fused implicit kernel, --vmethod V2), then Held-Suarez and the
# tropical cyclone through Model.go; DRIVER_GRAPH steps a graph in the
# direct run it is held against (1 + 3 * 13 = 40 steps)
DRIVER_STEPS, DRIVER_EVERY, DRIVER_GRAPH = 40, 20, 13
DRIVER_ARGV = ["--case", "umjs_pert", "--resolution", str(NE), "--levels",
               str(NZ), "--order", str(ORDER), "--fp32", "--vmethod", "V2",
               "--dt", f"{DT:g}s", "--nsteps", str(DRIVER_STEPS),
               "--checksum_dt", f"{DRIVER_EVERY * DT:g}s",
               "--output_dt", f"{DRIVER_EVERY * DT:g}s",
               "--output_format", "nc",
               "--output_restart_dt", f"{DRIVER_EVERY * DT:g}s"]
HS_STEPS, TC_STEPS = 20, 10
# the terrain cell (phase 5g): MountainRossby3D on the flagship grid
TERRAIN_STEPS = 20          # Model.go without hooks
# the JAX package's path predicates for that configuration, whose geometry
# the entry points build in float32: over a mountain a float32 geometry
# fails the Gal-Chen factorization's 1e-10 residual test (the stage then
# takes its full 3-D metric form), and the z-constant Jacobian keeps the nu4
# kernels (the JAX package's host geometry at ne30 L30; the port's
# predicates equal JAX's for every sphere case, tests/test_torch_testcases.py)
TERRAIN_PATH = {"sep_ok": False, "stage": True, "nu4": True}
# the seeded W (covariant) of the Schar and JW starts of phase 4
W_SEEDED = 1.0e4
KERNELS = ("dss_scalar", "dss_vector", "banded_solve", "dss_uvw",
           "fused_stage", "nu4_pass1", "nu4_pass2", "fused_implicit_update",
           "dss_state", "dss_scalar2", "banded_solve_multi")
# the solves of the implicit half step, of which ``first_step`` has two
IMPLICIT_SOLVES = ("fused_implicit_update", "banded_solve",
                   "banded_solve_multi")
# kernel launches per ``step`` (``first_step`` has one implicit solve more)
# with the DSS as separate launches ...
FUSED_PER_STEP = {"fused_stage": 5, "dss_uvw": 5, "dss_scalar": 16,
                  "dss_vector": 2, "fused_implicit_update": 1,
                  "banded_solve": 0, "nu4_pass1": 1, "nu4_pass2": 1,
                  "dss_state": 0, "dss_scalar2": 0, "banded_solve_multi": 0}
UNFUSED_PER_STEP = {"fused_stage": 0, "dss_uvw": 0, "dss_scalar": 21,
                    "dss_vector": 7, "fused_implicit_update": 0,
                    "banded_solve": 1, "nu4_pass1": 0, "nu4_pass2": 0,
                    "dss_state": 0, "dss_scalar2": 0, "banded_solve_multi": 0}
DSS_MERGES = ((), ("state",), ("scalar2",), ("state", "scalar2"))
# kernel launches per IMEX step (ARS343) with the DSS as separate launches:
# a full-state DSS after each of the four stages and two in the nu4 tail
IMEX_PER_STEP = {"fused_stage": 0, "dss_uvw": 0, "dss_scalar": 18,
                 "dss_vector": 6, "fused_implicit_update": 3,
                 "banded_solve": 0, "nu4_pass1": 1, "nu4_pass2": 1,
                 "dss_state": 0, "dss_scalar2": 0, "banded_solve_multi": 0}


def fused_per_step(merge):
    """... and with the groups of ``merge`` in one launch each: the tail's
    two full-state DSS through ``dss_state``; Rt and Rho through
    ``dss_scalar2`` wherever they are still scalars of their own (the five
    stages, and the tail's two DSS unless ``dss_state`` has them)."""
    n = dict(FUSED_PER_STEP)
    if "state" in merge:
        n.update(dss_state=2, dss_vector=0, dss_scalar=n["dss_scalar"] - 6)
    if "scalar2" in merge:
        pairs = 5 if "state" in merge else 7
        n.update(dss_scalar2=pairs, dss_scalar=n["dss_scalar"] - 2 * pairs)
    return n


def imex_per_step(merge, ndss=6, nimp=3, nu4=True):
    """... and with the groups of ``merge`` in one launch each: every
    full-state DSS through ``dss_state``, or Rt and Rho through
    ``dss_scalar2``.  ``ndss``, ``nimp``: the full-state DSS and implicit
    solves a step of another scheme (GARK2: 5 and 2); ``nu4``: whether the
    nu4 kernels run (not where the terrain makes the Jacobian vary in
    z)."""
    n = dict(IMEX_PER_STEP, dss_vector=ndss, dss_scalar=3 * ndss,
             fused_implicit_update=nimp)
    if not nu4:
        n.update(nu4_pass1=0, nu4_pass2=0)
    if "state" in merge:
        n.update(dss_state=ndss, dss_vector=0, dss_scalar=0)
    elif "scalar2" in merge:
        n.update(dss_scalar2=ndss, dss_scalar=ndss)
    return n


def moist(per_step):
    """... and with tracers in the state: the flat tracer field takes one
    ``dss_scalar`` launch more in each of the 7 DSS of a step (5 stages, 2 in
    the tail), and the implicit half step one ``banded_solve_multi``.  The
    stage kernel advects the tracers inside its one launch."""
    return dict(per_step, dss_scalar=per_step["dss_scalar"] + 7,
                banded_solve_multi=1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(got, want):
    scale = float(want.abs().max()) + 1e-300
    return float((got - want).abs().max()) / scale


def randn(shape, dtype, gen, dev):
    return torch.randn(shape, dtype=dtype, device=dev, generator=gen)


def make_bands(n, q, ncol, dtype, gen, dev):
    """Diagonally dominant banded systems with the out-of-range entries
    zero (the layout contract of the solver)."""
    b = 2 * q + 1
    bands = randn((n, b, ncol), dtype, gen, dev)
    bands[:, q, :] += 4.0 * b
    rows = torch.arange(n, device=dev)[:, None]
    cols = rows + torch.arange(b, device=dev)[None, :] - q
    valid = ((cols >= 0) & (cols < n)).to(dtype)
    bands *= valid[:, :, None]
    rhs = randn((n, ncol), dtype, gen, dev)
    return bands.contiguous(), rhs.contiguous()


def dense_from_bands(bands, q):
    n, b, ncol = bands.shape
    dense = torch.zeros((ncol, n, n), dtype=bands.dtype, device=bands.device)
    for d in range(b):
        off = d - q
        diag = torch.diagonal(dense, offset=off, dim1=1, dim2=2)
        lo, hi = max(0, -off), min(n, n - off)
        diag.copy_(bands[lo:hi, d, :].T)
    return dense


def max_rel_err(gots, wants):
    return max(rel_err(g, w) for g, w in zip(gots, wants))


def stage_report(base, ueval, fg, statics, tag, tracers=False, cart=False):
    """The launch shape, ring depth and copy route of the stage kernel on
    these inputs, and the registers and spills of the instantiation it
    runs (from the build's ``-Xptxas -v`` report)."""
    from tempestmodel_tpu_torch.fast import stage_cuda
    inst = tag + ("+tracers" if tracers else "") + ("+cart" if cart else "")
    return {"launch": stage_cuda.launch_config(base, ueval, fg, statics),
            "instantiation": inst,
            "ptxas": stage_cuda.kernel_resources().get(inst)}


def check_stage_edges(dtype, dev):
    """Phase 3: ``fused_stage`` at the edge shapes of
    ``kernels/stage_edges.py`` against its plain version (a cubed sphere
    of ne 2-4, p 3-5, 2-8 levels, 0-6 species, with a terrain-like metric;
    one and two bases, at the stage's step and at steps as long as each
    field's own scale)."""
    from tempestmodel_tpu_torch.kernels import stage_edges
    tag = "f32" if dtype == torch.float32 else "f64"
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    for case in stage_edges.CASES:
        got = stage_edges.run_case(case, dtype, dev)
        emit({"phase": "kernel", "dtype": tag, "tol": tol,
              "name": "fused_stage_edge", "case": case, **got})
        if not got["max_err"] <= tol:
            raise RuntimeError(f"fused_stage edge case {case} {tag}: rel "
                               f"err {got['err_by_output']} > {tol}")


def check_implicit_edges(dtype, dev):
    """Phase 3: ``fused_implicit_update`` at the edge shapes of
    ``kernels/implicit_edges.py`` against its plain version (2-40 levels,
    1-1600 columns, unaligned inputs), both Jacobian modes, with and
    without the time term."""
    from tempestmodel_tpu_torch.kernels import implicit_edges
    tag = "f32" if dtype == torch.float32 else "f64"
    tol = 2e-3 if dtype == torch.float32 else 1e-10
    for case in implicit_edges.CASES:
        got = implicit_edges.run_case(case, dtype, dev)
        emit({"phase": "kernel", "dtype": tag, "tol": tol,
              "name": "fused_implicit_update_edge", "case": case, **got})
        if not got["max_err"] <= tol:
            raise RuntimeError(f"fused_implicit_update edge case {case} "
                               f"{tag}: rel err {got['err_by_output']} > "
                               f"{tol}")


def check_dss_edges(dtype, dev):
    """Phase 3: the band kernel's five modes ``dss_scalar``,
    ``dss_vector``, ``dss_uvw``, ``dss_scalar2`` and ``dss_state`` at the
    edge shapes of ``kernels/dss_edges.py`` against their plain versions,
    bit for bit (cubed spheres of ne 1-4 with p 2-4, periodic Cartesian
    panels wrapped along one axis or both, unaligned inputs, bands of
    several blocks' worth of segments, rings of one and three stages, two
    levels); ``dss_uvw`` with two bases and one, its bottom W row also
    alone, on the panel edges and at the corners; ``dss_scalar2`` also bit
    for bit against two ``dss_scalar`` launches; ``dss_state`` without and
    with its Rayleigh finish, also bit for bit against the separate
    launches followed by the plain finish."""
    from tempestmodel_tpu_torch.kernels import dss_edges
    tag = "f32" if dtype == torch.float32 else "f64"
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    for case in dss_edges.CASES:
        got = dss_edges.run_case(case, dtype, dev)
        emit({"phase": "kernel", "dtype": tag, "tol": tol,
              "name": "dss_edge", "case": case, **got})
        if not (got["max_err"] <= tol and got["bitwise"]
                and got["scalar2_equals_two_launches"]
                and got["state_equals_separate_launches"]):
            raise RuntimeError(f"DSS edge case {case} {tag}: rel err "
                               f"{got['err_by_output']} (tolerance {tol}), "
                               f"bitwise {got['bitwise']}, dss_scalar2 "
                               f"equal to two dss_scalar launches "
                               f"{got['scalar2_equals_two_launches']}, "
                               f"dss_state equal to the separate launches "
                               f"{got['state_equals_separate_launches']}")


def check_banded_edges(dtype, dev):
    """Phase 3: ``banded_solve_multi`` and ``banded_solve`` at the edge
    shapes of ``kernels/banded_edges.py`` against their plain versions
    (2-800 rows, q 1-8, R 1-5, 1-1000 columns, unaligned inputs, tiles of
    64 columns, two rows an mbarrier, the stream form forced and chosen by
    shape; ``banded_solve``'s ring form with blocks of 32, 16 and 8 columns
    and fewer rows than its ring has slots, pivots past both ends of the
    range of its quick quotients, and its other forms forced)."""
    from tempestmodel_tpu_torch.kernels import banded_edges
    tag = "f32" if dtype == torch.float32 else "f64"
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for case, spec in banded_edges.CASES.items():
        got = banded_edges.run_case(case, dtype, dev)
        emit({"phase": "kernel", "dtype": tag, "tol": tol,
              "name": "banded_solve_multi_edge", "case": case, **got})
        if not got["max_err"] <= tol or got["launch"]["form"] != spec[6]:
            raise RuntimeError(f"banded_solve_multi edge case {case} {tag}: "
                               f"rel err {got['err_by_species']} > {tol} "
                               f"or form {got['launch']['form']} is not "
                               f"{spec[6]}")
    for case, spec in banded_edges.SOLVE_CASES.items():
        got = banded_edges.run_solve_case(case, dtype, dev)
        emit({"phase": "kernel", "dtype": tag, "tol": tol,
              "name": "banded_solve_edge", "case": case, **got})
        if not got["max_err"] <= tol or got["launch"]["form"] != spec[5]:
            raise RuntimeError(f"banded_solve edge case {case} {tag}: rel "
                               f"err {got['max_err']} > {tol} or form "
                               f"{got['launch']['form']} is not {spec[5]}")


def check_hyper_edges(dtype, dev):
    """Phase 3: ``nu4_pass1`` and ``nu4_pass2`` at the edge shapes of
    ``kernels/hyper_edges.py`` against their plain versions (cubed spheres
    of ne 1-4 with p 2-8, one level, unaligned inputs, rings of two to four
    stages, bands narrower than the panel; periodic planes with element
    widths that differ along a and b, in both layouts, and one too wide
    for a band of whole rows); pass 2 also by its increment alone."""
    from tempestmodel_tpu_torch.kernels import hyper_edges
    tag = "f32" if dtype == torch.float32 else "f64"
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    for case in hyper_edges.CASES:
        got = hyper_edges.run_case(case, dtype, dev)
        emit({"phase": "kernel", "dtype": tag, "tol": tol,
              "name": "nu4_edge", "case": case, **got})
        if not got["max_err"] <= tol:
            raise RuntimeError(f"nu4 edge case {case} {tag}: rel err "
                               f"{got['err_by_output']} > {tol}")


def check_fused_kernels(cfg, geom, state, dtype, rows, dev):
    """Phase 3, second half: ``dss_uvw``, ``fused_stage`` and
    ``fused_implicit_update`` against their plain versions at the flagship
    shapes in ``dtype``.  The geometry gets a terrain-like metric (the
    flagship's terrain is flat, which would hide every terrain term) and
    the stage and DSS inputs are random; the implicit update starts from the
    balanced flagship state with per-mille noise, as a step does."""
    import dataclasses
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import (dss_cuda, stage_cuda,
                                             implicit_cuda, implicit as fimp)
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nonhydro

    tag = "f32" if dtype == torch.float32 else "f64"
    f32 = dtype == torch.float32
    esize = 4 if f32 else 8
    consts = cfg.constants
    # the geometry in the kernels' own dtype (a float32 geometry cast up
    # would carry float32 rounding in the plain version's dense operators)
    fgt = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device=dev), seed=SEED)
    K, P, A = fgt.nz, 6, fgt.A
    nlev, nint, n2d = K * P * A * A, (K + 1) * P * A * A, P * A * A
    ue = synthetic.random_state(fgt, seed=1)
    b1 = synthetic.random_state(fgt, seed=2)
    b2 = synthetic.random_state(fgt, seed=3)

    # --- fused_stage: one base and two, both metric forms ---------------
    stage_tol = 1e-4 if f32 else 1e-11
    sst = stage_cuda.stage_statics(fgt)
    fg3d = dataclasses.replace(fgt, sep_ok=False)       # full 3-D metric
    sst3d = stage_cuda.stage_statics(fg3d)
    if not sst.use_sep or sst3d.use_sep:
        raise RuntimeError("stage statics chose the wrong metric form")
    err = 0.0
    for g, st in ((fgt, sst), (fg3d, sst3d)):
        for base in (b1, ((0.3, b1), (0.7, b2))):
            got, gwf = stage_cuda.fused_stage(base, ue, 12.5, g, consts,
                                              defer_w=True, statics=st)
            torch.cuda.synchronize()
            want, wwf = stage_cuda.fused_stage_plain(base, ue, 12.5, g,
                                                     consts, defer_w=True)
            err = max(err, max_rel_err(
                [got[k] for k in stage_cuda.STATE4] + [gwf["dW"]],
                [want[k] for k in stage_cuda.STATE4] + [wwf["dW"]]))
    if not err <= stage_tol:
        raise RuntimeError(f"fused_stage {tag}: rel err {err} > {stage_tol}")
    two = ((0.3, b1), (0.7, b2))
    for name, base, nbase in (("fused_stage", b1, 4),
                              ("fused_stage_two_base", two, 8)):
        tb, c1, x1, c2, x2 = stage_cuda._split_base(base)
        ms = time_cuda(lambda: stage_cuda._fused_stage_cuda(
            tb, c1, x1, c2, x2, ue, 12.5, fgt, consts, sst), [()], reps=20,
            queued=True)
        wrapper_ms = time_cuda(lambda: stage_cuda.fused_stage(
            base, ue, 12.5, fgt, consts, defer_w=True, statics=sst), [()],
            reps=20)
        plain_ms = time_cuda(lambda: stage_cuda.fused_stage_plain(
            base, ue, 12.5, fgt, consts, defer_w=True), [()], reps=3,
            warmup=1)
        # reads: 4 level + 1 interface evaluation fields, the base fields,
        # the 12 2-D metric fields and the table; writes 5 level fields
        nb = ((4 + nbase + 5) * nlev + nint + 12 * n2d
              + sst.tab.numel()) * esize
        bnd, by = bound_ms(nb, 400 * nlev, dtype)
        row = {"name": name, "route": "cuda",
               "source": "tempestmodel_tpu_torch/csrc/stage.cu",
               "replaces": "tempestmodel_tpu/fast/stage_pallas.py:440",
               "shape": [K, P, A, A], "max_abs_err": err, "ms": ms,
               "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               "bound_ms": bnd, "bound_by": by, "library_ms": None}
        emit({"phase": "kernel", "dtype": tag, "tol": stage_tol, **row,
              **stage_report(base, ue, fgt, sst, tag)})
        if name == "fused_stage":
            rows.setdefault("fused_stage_ms", {})[tag] = ms
        if f32:
            rows[name] = row

    # --- dss_uvw: the W finish of that stage, two bases and one ---------
    dss_tol = 1e-6 if f32 else 1e-13
    gen = torch.Generator(device=dev).manual_seed(SEED)
    upd, wf = stage_cuda.fused_stage(two, ue, 12.5, fgt, consts,
                                     defer_w=True, statics=sst)
    # surface metric rows with every term present (flat terrain has zeros)
    wf = dict(wf, cax0=randn((P, A, A), dtype, gen, dev),
              cbx0=randn((P, A, A), dtype, gen, dev),
              cxx0=1.0 + randn((P, A, A), dtype, gen, dev).abs())
    err = 0.0
    for w in (wf, dict(wf, bw2=None)):
        got = dss_cuda.dss_uvw(upd["U"], upd["V"], fgt.inv_mult, fgt.e_rot,
                               fgt.dss_links, fgt.p, w, table=fgt.dss_table)
        torch.cuda.synchronize()
        want = dss_cuda.dss_uvw_plain(upd["U"], upd["V"], fgt.inv_mult,
                                      fgt.e_rot, fgt.dss_links, fgt.p, w)
        # the bottom row on its own: it is assembled from U, V of the node
        # being gathered, on panel edges from the partner panel
        err = max(err, max_rel_err(got + (got[2][0],), want + (want[2][0],)))
    if not err <= dss_tol:
        raise RuntimeError(f"dss_uvw {tag}: rel err {err} > {dss_tol}")
    ms = time_cuda(lambda: dss_cuda.dss_uvw(
        upd["U"], upd["V"], fgt.inv_mult, fgt.e_rot, fgt.dss_links, fgt.p,
        wf, table=fgt.dss_table), [()], reps=40, queued=True)
    plain_ms = time_cuda(lambda: dss_cuda.dss_uvw_plain(
        upd["U"], upd["V"], fgt.inv_mult, fgt.e_rot, fgt.dss_links, fgt.p,
        wf), [()], reps=4)
    # reads U, V, bw1, bw2, dW and the 2-D tables; writes U, V, W
    nb = (4 * nlev + 4 * nint + 4 * n2d + fgt.e_rot.numel()) * esize \
        + fgt.dss_table.numel() * 4
    bnd, by = bound_ms(nb, 16 * nlev + 12 * nint, dtype)
    row = {"name": "dss_uvw", "route": "cuda",
           "source": "tempestmodel_tpu_torch/csrc/dss.cu",
           "replaces": "tempestmodel_tpu/fast/dss_pallas.py:453",
           "shape": [K, P, A, A], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
           "library_ms": None}
    emit({"phase": "kernel", "dtype": tag, "tol": dss_tol, **row,
          "launch": dss_cuda.launch_config(
              upd["U"], fgt.p, "uvw", dss_cuda._uvw_ptrs(upd["U"], upd["V"], wf,
                                                      fgt.inv_mult), True)})
    if f32:
        rows["dss_uvw"] = row
    del upd, wf, got, want, ue, b1, b2

    # --- fused_implicit_update: both Jacobian modes, time term on/off ----
    imp_tol = 2e-3 if f32 else 1e-10
    q = nonhydro.estimate_bandwidth(geom, consts)
    statics = fimp.statics_to_device(
        nonhydro.band_assembly_statics(geom, q), dtype, dev)
    ist = implicit_cuda.implicit_statics(statics, fgt)
    if not implicit_cuda.fused_supported(ist):
        raise RuntimeError("the flagship is outside the fused implicit "
                           "update's envelope")
    d = fast.pack_state({k: v.to(dtype) for k, v in state.items()},
                        device=dev)
    for k in ("U", "V", "Rt", "Rho"):
        d[k] = d[k] * (1.0 + 1e-3 * randn(d[k].shape, dtype, gen, dev))
    d["W"] = 0.01 * randn(d["W"].shape, dtype, gen, dev)
    x0, aux = fimp._prep_aux(d, fgt, None, interfaces=False)
    x1 = tuple((p * 1.001).contiguous() for p in x0)
    dt_imp = 0.5 * DT
    err = 0.0
    for ref_j in (False, True):
        for time_term in (False, True):
            xs = x1 if time_term else x0
            got = implicit_cuda.fused_implicit_update(
                xs, x0, aux, ist, dt_imp, consts, ref_jacobian=ref_j,
                newton_time_term=time_term)
            torch.cuda.synchronize()
            want = implicit_cuda.fused_implicit_update_plain(
                xs, x0, aux, ist, dt_imp, consts, ref_jacobian=ref_j,
                newton_time_term=time_term)
            err = max(err, max_rel_err(got, want))
            del got, want
    if not err <= imp_tol:
        raise RuntimeError(f"fused_implicit_update {tag}: rel err {err} > "
                           f"{imp_tol}")
    ncol = x0[0].shape[1]
    ms = time_cuda(lambda: implicit_cuda.fused_implicit_update(
        x0, x0, aux, ist, dt_imp, consts), [()], reps=10, queued=True)
    ms_time = time_cuda(lambda: implicit_cuda.fused_implicit_update(
        x1, x0, aux, ist, dt_imp, consts, newton_time_term=True), [()],
        reps=10, queued=True)
    plain_ms = time_cuda(lambda: implicit_cuda.fused_implicit_update_plain(
        x0, x0, aux, ist, dt_imp, consts), [()], reps=2, warmup=1)
    # reads rt, w, rho, u_n, v_n, 9 metric fields, c2 and the table;
    # writes the three increments
    nb = ((4 + 4 + 2) * K * ncol + (1 + 5 + 1) * (K + 1) * ncol + 4 * ncol
          + ist.tab.numel()) * esize
    n = 3 * K + 1
    flops = ncol * (n * (q * (2 * q + 3) + 2 * q + 1) + (K + 1) * 400)
    bnd, by = bound_ms(nb, flops, dtype)
    row = {"name": "fused_implicit_update", "route": "cuda",
           "source": "tempestmodel_tpu_torch/csrc/implicit.cu",
           "replaces": "tempestmodel_tpu/fast/pallas_implicit.py:597",
           "shape": [K, ncol], "max_abs_err": err, "ms": ms,
           "ms_with_time_term": ms_time, "plain_ms": plain_ms,
           "bound_ms": bnd, "bound_by": by, "library_ms": None}
    emit({"phase": "kernel", "dtype": tag, "tol": imp_tol, **row,
          "launch": implicit_cuda.launch_config(x0, x0, aux, ist),
          "launch_with_time_term": implicit_cuda.launch_config(
              x1, x0, aux, ist, True)})
    if f32:
        rows["fused_implicit_update"] = row
    torch.cuda.empty_cache()


def check_tail_kernels(geom, dtype, rows, dev):
    """Phase 3, third part: ``nu4_pass1``, ``nu4_pass2``, ``dss_state``
    (with and without the Rayleigh finish) and ``dss_scalar2`` against their
    plain versions at the flagship shapes in ``dtype``.  The metric is
    terrain-like with a z-constant 3-D Jacobian that is no multiple of the
    2-D one (flat terrain would hide a mix-up of the two); the fields are
    random."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import dss_cuda, hyper_cuda
    from tempestmodel_tpu_torch.kernels import dss_operator, synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda

    tag = "f32" if dtype == torch.float32 else "f64"
    f32 = dtype == torch.float32
    esize = 4 if f32 else 8
    fgt = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device=dev), seed=SEED,
        vary_jac=True)
    K, P, A = fgt.nz, 6, fgt.A
    nlev, nint, n2d = K * P * A * A, (K + 1) * P * A * A, P * A * A
    nstate = 4 * nlev + nint
    FIELDS = dss_cuda.STATE_FIELDS
    # two sets of inputs cycle through the L2 (2 x 104 MB in float32)
    sets = [(synthetic.random_state(fgt, seed=s), synthetic.random_state(
        fgt, seed=s + 10)) for s in (1, 2)]
    d, w = sets[0]

    # --- nu4_pass1, nu4_pass2 -------------------------------------------
    hyper_tol = 1e-4 if f32 else 1e-11
    hst = hyper_cuda.hyper_statics(fgt)
    # viscosities that make the increment as large as the state, so that
    # neither hides the other
    unit = hyper_cuda.nu4_pass1_plain(w, fgt, hst)  # what pass 2 scales
    nu_s = float(d["Rho"].abs().max() / unit["Rho"].abs().max())
    nu_v = float(d["U"].abs().max() / unit["U"].abs().max())
    nu = (nu_s, nu_v, 0.7 * nu_v, 1.0)            # nu_s, nu_d, nu_v, dt
    del unit
    got = hyper_cuda.nu4_pass1(d, fgt, hst)
    torch.cuda.synchronize()
    want = hyper_cuda.nu4_pass1_plain(d, fgt, hst)
    err1 = {k: rel_err(got[k], want[k]) for k in FIELDS}
    got = hyper_cuda.nu4_pass2(d, w, *nu, fgt, hst)
    torch.cuda.synchronize()
    want = hyper_cuda.nu4_pass2_plain(d, w, *nu, fgt, hst)
    # the whole result, and the increment on its own
    err2 = {k: max(rel_err(got[k], want[k]),
                   rel_err(got[k] - d[k], want[k] - d[k])) for k in FIELDS}
    del got, want
    for name, errs in (("nu4_pass1", err1), ("nu4_pass2", err2)):
        if not max(errs.values()) <= hyper_tol:
            raise RuntimeError(f"{name} {tag}: rel err {errs} > {hyper_tol}")
    scal2 = (nu[1], nu[2], nu[3], nu[3] * nu[0])
    for name, errs, launch, plain, nfields, line in (
            ("nu4_pass1", err1,
             lambda x, y: hyper_cuda._launch("nu4_pass1", x, None,
                                             (1.0, 1.0, 0.0, 0.0), hst),
             lambda x, y: hyper_cuda.nu4_pass1_plain(x, fgt, hst), 2, 177),
            ("nu4_pass2", err2,
             lambda x, y: hyper_cuda._launch("nu4_pass2", y, x, scal2, hst),
             lambda x, y: hyper_cuda.nu4_pass2_plain(x, y, *nu, fgt, hst),
             3, 192)):
        ms = time_cuda(launch, sets, reps=20, queued=True)
        plain_ms = time_cuda(plain, sets, reps=3, warmup=1)
        # reads the five (or ten) fields, the 8 2-D metric fields and the
        # element matrices; writes five fields
        nb = (nfields * nstate + 8 * n2d + hst.ds.numel()) * esize
        bnd, by = bound_ms(nb, 220 * nint, dtype)
        row = {"name": name, "route": "cuda",
               "source": "tempestmodel_tpu_torch/csrc/hyper.cu",
               "replaces": f"tempestmodel_tpu/fast/hyper_pallas.py:{line}",
               "shape": [K, P, A, A], "max_abs_err": max(errs.values()),
               "err_by_field": errs, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bnd, "bound_by": by, "library_ms": None}
        emit({"phase": "kernel", "dtype": tag, "tol": hyper_tol, **row})
        if f32:
            rows[name] = row

    # --- dss_state, dss_scalar2 -----------------------------------------
    dss_tol = 1e-6 if f32 else 1e-13
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ray = tuple({k: torch.rand(v.shape, dtype=dtype, device=dev,
                               generator=gen) for k, v in d.items()}
                for _ in range(2))
    dss = (fgt.inv_mult, fgt.e_rot, fgt.dss_links, fgt.p)
    sc = (fgt.inv_mult, fgt.dss_links, fgt.p)

    def separate(x, rayleigh=None):
        """The launches (and the plain finish) ``dss_state`` merges:
        ``dss_vector``, ``dss_scalar`` on W, ``dss_scalar2`` on Rt, Rho."""
        u, v = dss_cuda.dss_vector(x["U"], x["V"], *dss, table=fgt.dss_table)
        out = {"U": u, "V": v,
               "W": dss_cuda.dss_scalar(x["W"], *sc, table=fgt.dss_table)}
        out["Rt"], out["Rho"] = dss_cuda.dss_scalar2(x["Rt"], x["Rho"], *sc,
                                                     table=fgt.dss_table)
        if rayleigh is not None:
            out = {k: rayleigh[0][k] * out[k] + rayleigh[1][k] for k in out}
        return out

    err, equal, bitwise = 0.0, True, True
    for r in (None, ray):
        got = dss_cuda.dss_state(d, *dss, rayleigh=r, table=fgt.dss_table)
        torch.cuda.synchronize()
        want = dss_cuda.dss_state_plain(d, *dss, rayleigh=r)
        sep = separate(d, r)
        err = max(err, max(rel_err(got[k], want[k]) for k in FIELDS))
        bitwise = bitwise and all(torch.equal(got[k], want[k])
                                  for k in FIELDS)
        equal = equal and all(torch.equal(got[k], sep[k]) for k in FIELDS)
    del got, want, sep
    if not err <= dss_tol or not equal or not bitwise:
        raise RuntimeError(f"dss_state {tag}: rel err {err} (tol {dss_tol}), "
                           f"bit for bit equal to the plain version: "
                           f"{bitwise}, to the separate launches: {equal}")
    timed = {}
    for key, r in (("", None), ("_rayleigh", ray)):
        timed["ms" + key] = time_cuda(
            lambda x, y: dss_cuda.dss_state(x, *dss, rayleigh=r,
                                            table=fgt.dss_table),
            sets, reps=20, queued=True)
        timed["separate_ms" + key] = time_cuda(
            lambda x, y: separate(x, r), sets, reps=20, queued=True)
        timed["plain_ms" + key] = time_cuda(
            lambda x, y: dss_cuda.dss_state_plain(x, *dss, rayleigh=r), sets,
            reps=3, warmup=1)
        nb = ((4 if r else 2) * nstate + n2d + fgt.e_rot.numel()) * esize \
            + fgt.dss_table.numel() * 4
        flops = 16 * nlev + 5 * (2 * nlev + nint) + (2 * nstate if r else 0)
        timed["bound_ms" + key], by = bound_ms(nb, flops, dtype)
    row = {"name": "dss_state", "route": "cuda",
           "source": "tempestmodel_tpu_torch/csrc/dss.cu",
           "replaces": "tempestmodel_tpu/fast/dss_pallas.py:343",
           "shape": [K, P, A, A], "max_abs_err": err, "bitwise": bitwise,
           "bitwise_equal_to_separate_launches": equal, **timed,
           "bound_by": by, "library_ms": None}
    emit({"phase": "kernel", "dtype": tag, "tol": dss_tol, **row,
          "launch": dss_cuda.launch_config(
              d["U"], fgt.p, "state", dss_cuda._state_ptrs(d, fgt.inv_mult),
              True)})
    if f32:
        rows["dss_state"] = row

    g1, g2 = dss_cuda.dss_scalar2(d["Rt"], d["Rho"], *sc,
                                  table=fgt.dss_table)
    torch.cuda.synchronize()
    w1, w2 = dss_cuda.dss_scalar2_plain(d["Rt"], d["Rho"], *sc)
    err = max(rel_err(g1, w1), rel_err(g2, w2))
    bitwise = torch.equal(g1, w1) and torch.equal(g2, w2)
    equal = all(torch.equal(g, dss_cuda.dss_scalar(d[k], *sc,
                                                   table=fgt.dss_table))
                for g, k in ((g1, "Rt"), (g2, "Rho")))
    if not err <= dss_tol or not equal or not bitwise:
        raise RuntimeError(f"dss_scalar2 {tag}: rel err {err} (tol "
                           f"{dss_tol}), bit for bit equal to the plain "
                           f"version: {bitwise}, to two launches: {equal}")
    ms = time_cuda(lambda x, y: dss_cuda.dss_scalar2(
        x["Rt"], x["Rho"], *sc, table=fgt.dss_table), sets, reps=40,
        queued=True)
    separate_ms = time_cuda(lambda x, y: [dss_cuda.dss_scalar(
        x[k], *sc, table=fgt.dss_table) for k in ("Rt", "Rho")], sets,
        reps=40, queued=True)
    plain_ms = time_cuda(lambda x, y: dss_cuda.dss_scalar2_plain(
        x["Rt"], x["Rho"], *sc), sets, reps=4)
    # the library yardstick: one torch.sparse.mm with the scalar operator on
    # the two fields side by side (the stacking is not timed)
    op = dss_operator.scalar_operator(fgt.inv_mult, fgt.dss_links, fgt.p)
    pairs = [(torch.cat([x["Rt"], x["Rho"]]),) for x, _ in sets]
    got = dss_operator.apply(op, pairs[0][0]).t()
    lib_err = max(rel_err(got[:K].reshape(w1.shape), w1),
                  rel_err(got[K:].reshape(w2.shape), w2))
    library_ms = time_cuda(lambda x: dss_operator.apply(op, x), pairs,
                           reps=20, queued=True)
    del op, pairs, got
    bnd, by = bound_ms((4 * nlev + n2d) * esize + fgt.dss_table.numel() * 4,
                       10 * nlev, dtype)
    row = {"name": "dss_scalar2", "route": "cuda",
           "source": "tempestmodel_tpu_torch/csrc/dss.cu",
           "replaces": "tempestmodel_tpu/fast/dss_pallas.py:231",
           "shape": [K, P, A, A], "max_abs_err": err, "bitwise": bitwise,
           "bitwise_equal_to_separate_launches": equal, "ms": ms,
           "separate_ms": separate_ms, "plain_ms": plain_ms, "bound_ms": bnd,
           "bound_by": by, "library_ms": library_ms,
           "library_rel_err": lib_err}
    emit({"phase": "kernel", "dtype": tag, "tol": dss_tol, **row,
          "launch": dss_cuda.launch_config(
              d["Rt"], fgt.p, "scalar2",
              dss_cuda._scalar2_ptrs(d["Rt"], d["Rho"], fgt.inv_mult),
              True)})
    if f32:
        rows["dss_scalar2"] = row
    torch.cuda.empty_cache()


def check_tracer_kernels(cfg, geom, dtype, rows, dev):
    """Phase 3, fourth part: what the moist wave adds, at its shapes in
    ``dtype``: ``banded_solve_multi`` (n 30, q 1, R 3, and a wider case),
    ``fused_stage`` with three tracer species, ``dss_scalar`` on their flat
    90-row field.  The tracers are seeded (species of different size, some
    negative values): two of the wave's own three species are all zeros and
    would hide a mix-up.  The stage is checked at its usual step and at one
    so long that the tracers' increment is as large as the tracers."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import (dss_cuda, stage_cuda,
                                             tracers as ftr)
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.ops import cuda_banded

    tag = "f32" if dtype == torch.float32 else "f64"
    f32 = dtype == torch.float32
    esize = 4 if f32 else 8
    consts = cfg.constants
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    # --- banded_solve_multi ---------------------------------------------
    band_tol = 1e-4 if f32 else 1e-10
    n, ncol = NZ, 6 * (NE * ORDER) ** 2

    def systems(n, q, R, ncol):
        bands, _ = make_bands(n, q, ncol, dtype, gen, dev)
        # right-hand sides of different size, as the species are
        rhs = randn((n, R, ncol), dtype, gen, dev) * (10.0 ** -torch.arange(
            R, device=dev, dtype=dtype))[None, :, None]
        return bands, rhs.contiguous()

    cases = {}
    for name, q, R in (("", 1, NTR), ("_q4_r5", 4, 5)):
        sets = [systems(n, q, R, ncol) for _ in range(2)]   # > the 50 MB L2
        bands, rhs = sets[0]
        # the rule's form (the tile) and the stream form
        stream = cuda_banded.banded_multi_launch_shape(n, q, R, ncol, dtype,
                                                       form="stream")
        want = cuda_banded.banded_solve_multi_plain(bands, rhs, q)
        got = cuda_banded.banded_solve_multi(bands, rhs, q)
        torch.cuda.synchronize()
        back = cuda_banded._banded_solve_multi_cuda(bands, rhs, q, stream)
        torch.cuda.synchronize()
        err = max(rel_err(g[:, r], want[:, r]) for g in (got, back)
                  for r in range(R))
        del got, back
        if not err <= band_tol:
            raise RuntimeError(f"banded_solve_multi{name} {tag}: rel err "
                               f"{err} > {band_tol}")
        t = {"max_abs_err": err,
             "launch": cuda_banded.launch_config(bands, rhs, q),
             "launch_stream_form": cuda_banded.launch_config(bands, rhs, q,
                                                             stream)}
        t["ms"] = time_cuda(lambda b, r: cuda_banded.banded_solve_multi(
            b, r, q), sets, reps=20, queued=True)
        t["ms_stream_form"] = time_cuda(
            lambda b, r: cuda_banded._banded_solve_multi_cuda(
                b, r, q, stream), sets, reps=20, queued=True)
        t["plain_ms"] = time_cuda(
            lambda b, r: cuda_banded.banded_solve_multi_plain(b, r, q), sets,
            reps=2, warmup=1)
        # the library yardstick: one dense batched solve of the same systems
        # with the (n, R) right-hand sides (timed here, used nowhere else)
        dense = dense_from_bands(bands, q)
        rhs_t = rhs.permute(2, 0, 1).contiguous()            # (ncol, n, R)
        lib_x = torch.linalg.solve(dense, rhs_t).permute(1, 2, 0)
        t["library_rel_err"] = max(rel_err(lib_x[:, r], want[:, r])
                                   for r in range(R))
        t["library_ms"] = time_cuda(lambda: torch.linalg.solve(dense, rhs_t),
                                    [()], reps=2, warmup=1)
        del dense, lib_x, rhs_t, want
        nb = (bands.numel() + 2 * rhs.numel()) * esize
        flops = n * ncol * (q * (2 * q + 2) + R * (4 * q + 1))
        t["bound_ms"], t["bound_by"] = bound_ms(nb, flops, dtype)
        t["shape"] = [n, 2 * q + 1, R, ncol]
        cases[name] = t
        del sets, bands, rhs
        torch.cuda.empty_cache()
    row = {"name": "banded_solve_multi", "route": "cuda",
           "source": "tempestmodel_tpu_torch/csrc/banded_multi.cu",
           "replaces": "tempestmodel_tpu/ops/pallas_banded.py:142",
           **cases[""], "wider_case_q4_r5": cases["_q4_r5"]}
    emit({"phase": "kernel", "dtype": tag, "tol": band_tol, **row})
    if f32:
        rows["banded_solve_multi"] = row

    # --- fused_stage with tracers -----------------------------------------
    stage_tol = 1e-4 if f32 else 1e-11
    fgt = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device=dev), seed=SEED,
        vary_jac=True)
    K, P, A = fgt.nz, 6, fgt.A
    nlev, nint, n2d = K * P * A * A, (K + 1) * P * A * A, P * A * A
    sst = stage_cuda.stage_statics(fgt)
    dry = [synthetic.random_state(fgt, seed=s) for s in (1, 2, 3)]
    ue, b1, b2 = (dict(d, Tracers=synthetic.random_tracers(fgt, NTR, s + 6))
                  for s, d in enumerate(dry, 1))
    tend = ftr.horizontal_update(torch.zeros_like(ue["Tracers"]), ue, 1.0,
                                 fgt)
    dt_big = float(ue["Tracers"].abs().max() / tend.abs().max())
    del tend
    errs = {}
    two = ((0.3, b1), (0.7, b2))
    for dt_s in (12.5, dt_big):
        for base in (b1, two):
            got, gwf = stage_cuda.fused_stage(base, ue, dt_s, fgt, consts,
                                              defer_w=True, statics=sst)
            torch.cuda.synchronize()
            want, wwf = stage_cuda.fused_stage_plain(base, ue, dt_s, fgt,
                                                     consts, defer_w=True)
            e = {k: rel_err(got[k], want[k]) for k in stage_cuda.STATE4}
            e["dW"] = rel_err(gwf["dW"], wwf["dW"])
            for i in range(NTR):
                sl = slice(i * K, (i + 1) * K)
                e[f"species{i}"] = rel_err(got["Tracers"][sl],
                                           want["Tracers"][sl])
            errs = {k: max(v, errs.get(k, 0.0)) for k, v in e.items()}
            del got, want, gwf, wwf
    if not max(errs.values()) <= stage_tol:
        raise RuntimeError(f"fused_stage with tracers {tag}: rel err {errs} "
                           f"> {stage_tol}")
    timed = {}
    for key, base, nbase in (("", b1, 4), ("_two_base", two, 8)):
        tb, c1, x1, c2, x2 = stage_cuda._split_base(base)
        dry_base = tuple((c, {k: v for k, v in b.items() if k != "Tracers"})
                         for c, b in base) if tb else dry[1]
        tdb, d1, y1, d2, y2 = stage_cuda._split_base(dry_base)
        timed["ms_tracers" + key] = time_cuda(
            lambda: stage_cuda._fused_stage_cuda(
                tb, c1, x1, c2, x2, ue, 12.5, fgt, consts, sst), [()],
            reps=20, queued=True)
        timed["ms_no_tracers_same_call" + key] = time_cuda(
            lambda: stage_cuda._fused_stage_cuda(
                tdb, d1, y1, d2, y2, dry[0], 12.5, fgt, consts, sst), [()],
            reps=20, queued=True)
        timed["plain_ms_tracers" + key] = time_cuda(
            lambda: stage_cuda.fused_stage_plain(
                base, ue, 12.5, fgt, consts, defer_w=True), [()], reps=3,
            warmup=1)
        # as without tracers, plus per species: the tracer and its base (or
        # two) read, the result written
        nb = ((4 + nbase + 5 + NTR * (2 + nbase // 4)) * nlev + nint
              + 12 * n2d + sst.tab.numel()) * esize
        timed["bound_ms_tracers" + key], _ = bound_ms(
            nb, (400 + 40 * NTR) * nlev, dtype)
    emit({"phase": "kernel", "dtype": tag, "tol": stage_tol,
          "name": "fused_stage_with_tracers", "species": NTR,
          "shape": [K, P, A, A], "max_abs_err": max(errs.values()),
          "err_by_output": errs, "long_step_s": dt_big, **timed,
          **stage_report(two, ue, fgt, sst, tag, tracers=True)})
    if f32:
        rows["fused_stage_tracers"] = dict(timed, max_abs_err_tracers=max(
            errs.values()))

    # --- dss_scalar on the flat tracer field (K = 90) -----------------------
    dss_tol = 1e-6 if f32 else 1e-13
    sets = [(t["Tracers"],) for t in (ue, b1, b2)]
    x = sets[0][0]
    got = dss_cuda.dss_scalar(x, fgt.inv_mult, fgt.dss_links, fgt.p,
                              table=fgt.dss_table)
    torch.cuda.synchronize()
    want = dss_cuda.dss_scalar_plain(x, fgt.inv_mult, fgt.dss_links, fgt.p)
    err = max(rel_err(got[i * K:(i + 1) * K], want[i * K:(i + 1) * K])
              for i in range(NTR))
    if not err <= dss_tol:
        raise RuntimeError(f"dss_scalar K={NTR * K} {tag}: rel err {err} > "
                           f"{dss_tol}")
    ms = time_cuda(lambda x: dss_cuda.dss_scalar(
        x, fgt.inv_mult, fgt.dss_links, fgt.p, table=fgt.dss_table), sets,
        reps=30, queued=True)
    bnd, _ = bound_ms((2 * NTR * nlev + n2d) * esize
                      + fgt.dss_table.numel() * 4, 5 * NTR * nlev, dtype)
    emit({"phase": "kernel", "dtype": tag, "tol": dss_tol,
          "name": "dss_scalar_flat_tracers", "shape": [NTR * K, P, A, A],
          "max_abs_err": err, "ms": ms, "bound_ms": bnd})
    if f32:
        rows["dss_scalar_tracers"] = {"ms_tracers_k90": ms,
                                      "bound_ms_tracers_k90": bnd,
                                      "max_abs_err_tracers_k90": err}
    torch.cuda.empty_cache()


def check_kernels(fg, cfg, geom, state, dev):
    """Phase 3: every kernel against its plain version at the flagship
    shapes; returns {name: row of the kernels line (without launches)}."""
    from tempestmodel_tpu_torch.fast import dss_cuda
    from tempestmodel_tpu_torch.ops import cuda_banded
    from tempestmodel_tpu_torch.kernels import dss_operator
    from tempestmodel_tpu_torch.kernels.timing import time_cuda

    K, P, A = fg.nz, 6, fg.A
    n, ncol = 3 * fg.nz + 1, 6 * fg.A * fg.A
    q = 4
    rows = {}
    dss_tol = {torch.float32: 1e-6, torch.float64: 1e-13}
    band_tol = {torch.float32: 1e-4, torch.float64: 1e-10}
    ncopies = 8          # 8 x 10.4 MB (f32) inputs cycle through the L2

    for dtype in (torch.float64, torch.float32):
        tag = "f32" if dtype == torch.float32 else "f64"
        gen = torch.Generator(device=dev).manual_seed(SEED)
        imult = fg.inv_mult.to(dtype).contiguous()
        rot = fg.e_rot.to(dtype).contiguous()
        esize = torch.empty((), dtype=dtype).element_size()
        nfield = K * P * A * A

        # --- dss_scalar (level and interface fields) --------------------
        xs = [randn((K, P, A, A), dtype, gen, dev) for _ in range(ncopies)]
        xw = randn((K + 1, P, A, A), dtype, gen, dev)
        err = 0.0
        for x in (xs[0], xw):
            got = dss_cuda.dss_scalar(x, imult, fg.dss_links, fg.p,
                                      table=fg.dss_table)
            torch.cuda.synchronize()
            want = dss_cuda.dss_scalar_plain(x, imult, fg.dss_links, fg.p)
            e = float((got - want).abs().max()) / float(want.abs().max())
            err = max(err, e)
        if not err <= dss_tol[dtype]:
            raise RuntimeError(f"dss_scalar {tag}: max-abs err/scale {err} "
                               f"> {dss_tol[dtype]}")
        ms = time_cuda(lambda x: dss_cuda.dss_scalar(
            x, imult, fg.dss_links, fg.p, table=fg.dss_table),
            [(x,) for x in xs], reps=40, queued=True)
        plain_ms = time_cuda(lambda x: dss_cuda.dss_scalar_plain(
            x, imult, fg.dss_links, fg.p), [(x,) for x in xs], reps=8)
        # the library yardstick: one torch.sparse.mm with the DSS as a
        # sparse operator on the field viewed as (nodes, levels)
        op = dss_operator.scalar_operator(imult, fg.dss_links, fg.p)
        lib_err = rel_err(dss_operator.apply(op, xs[0]).t().reshape(
            xs[0].shape), dss_cuda.dss_scalar_plain(xs[0], imult,
                                                   fg.dss_links, fg.p))
        library_ms = time_cuda(lambda x: dss_operator.apply(op, x),
                               [(x,) for x in xs], reps=20, queued=True)
        del op
        bnd, by = bound_ms((2 * nfield + imult.numel()) * esize
                           + fg.dss_table.numel() * 4, 5 * nfield, dtype)
        row = {"name": "dss_scalar", "route": "cuda",
               "source": "tempestmodel_tpu_torch/csrc/dss.cu",
               "replaces": "tempestmodel_tpu/fast/dss_pallas.py:474",
               "shape": [K, P, A, A], "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
               "library_ms": library_ms, "library_rel_err": lib_err}
        emit({"phase": "kernel", "dtype": tag, "tol": dss_tol[dtype], **row,
              "launch": dss_cuda.launch_config(
                  xs[0], fg.p, "scalar", dss_cuda._scalar_ptrs(xs[0], imult),
                  True)})
        if dtype == torch.float32:
            rows["dss_scalar"] = row

        # --- dss_vector ---------------------------------------------------
        us = xs
        vs = [randn((K, P, A, A), dtype, gen, dev) for _ in range(ncopies)]
        gu, gv = dss_cuda.dss_vector(us[0], vs[0], imult, rot, fg.dss_links,
                                     fg.p, table=fg.dss_table)
        torch.cuda.synchronize()
        wu, wv = dss_cuda.dss_vector_plain(us[0], vs[0], imult, rot,
                                           fg.dss_links, fg.p)
        scale = max(float(wu.abs().max()), float(wv.abs().max()))
        err = max(float((gu - wu).abs().max()),
                  float((gv - wv).abs().max())) / scale
        bitwise = torch.equal(gu, wu) and torch.equal(gv, wv)
        if not (err <= dss_tol[dtype] and bitwise):
            raise RuntimeError(f"dss_vector {tag}: max-abs err/scale {err} "
                               f"(tolerance {dss_tol[dtype]}), bit for bit "
                               f"equal to the plain version: {bitwise}")
        ms = time_cuda(lambda u, v: dss_cuda.dss_vector(
            u, v, imult, rot, fg.dss_links, fg.p, table=fg.dss_table),
            list(zip(us, vs)), reps=40, queued=True)
        plain_ms = time_cuda(lambda u, v: dss_cuda.dss_vector_plain(
            u, v, imult, rot, fg.dss_links, fg.p), list(zip(us, vs)), reps=8)
        # the library yardstick: one torch.sparse.mm with the rotated
        # pair's operator on (U, V) stacked along the nodes (the stacking
        # is not timed)
        op = dss_operator.vector_operator(imult, rot, fg.dss_links, fg.p)
        uvs = [(torch.cat([u.reshape(K, -1), v.reshape(K, -1)], 1),)
               for u, v in zip(us[:4], vs[:4])]
        got = dss_operator.apply(op, uvs[0][0]).t()
        lib_err = max(rel_err(got[:, :nfield // K].reshape(wu.shape), wu),
                      rel_err(got[:, nfield // K:].reshape(wv.shape), wv))
        library_ms = time_cuda(lambda uv: dss_operator.apply(op, uv), uvs,
                               reps=20, queued=True)
        del op, uvs, got
        bnd, by = bound_ms((4 * nfield + imult.numel() + rot.numel()) * esize
                           + fg.dss_table.numel() * 4, 16 * nfield, dtype)
        row = {"name": "dss_vector", "route": "cuda",
               "source": "tempestmodel_tpu_torch/csrc/dss.cu",
               "replaces": "tempestmodel_tpu/fast/dss_pallas.py:489",
               "shape": [K, P, A, A], "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
               "library_ms": library_ms, "library_rel_err": lib_err,
               "bitwise": bitwise}
        emit({"phase": "kernel", "dtype": tag, "tol": dss_tol[dtype], **row,
              "launch": dss_cuda.launch_config(
                  us[0], fg.p, "vector",
                  dss_cuda._vector_ptrs(us[0], vs[0], imult), True)})
        if dtype == torch.float32:
            rows["dss_vector"] = row
        del xs, us, vs, xw

        # --- banded_solve ---------------------------------------------------
        # the unfused path's Newton systems (n 91, q 4) and n 30, q 4, each
        # in the rule's form and in the forms it does not choose there (the
        # same bits in every form)
        bands, rhs = make_bands(n, q, ncol, dtype, gen, dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = cuda_banded.banded_solve(bands, rhs, q)
        torch.cuda.synchronize()
        allocates = (torch.cuda.max_memory_allocated() - base) / 1e6
        want = cuda_banded.banded_solve_plain(bands, rhs, q)
        err = rel_err(got, want)
        if allocates > 1.01e-6 * got.numel() * esize:
            raise RuntimeError(f"banded_solve {tag}: a launch allocated "
                               f"{allocates} MB, more than its output's "
                               f"{got.numel() * esize / 1e6}")
        forms, n30 = {}, {}
        for form in cuda_banded.SOLVE_FORMS:
            try:
                sh = cuda_banded.banded_solve_launch_shape(n, q, ncol, dtype,
                                                           form=form)
            except ValueError:
                continue              # the tile form's tile does not fit
            g2 = cuda_banded._banded_solve_cuda(bands, rhs, q, sh)
            torch.cuda.synchronize()
            if not torch.equal(g2, got):
                raise RuntimeError(f"banded_solve {tag}: the {form} form's "
                                   f"solution is not the rule's bit for bit "
                                   f"(every form divides alike)")
            forms[form] = {"max_abs_err": rel_err(g2, want),
                           "launch": cuda_banded.launch_config(bands, rhs, q,
                                                               sh),
                           "ms": time_cuda(
                               lambda: cuda_banded._banded_solve_cuda(
                                   bands, rhs, q, sh), [()], reps=10,
                               queued=True)}
            err = max(err, forms[form]["max_abs_err"])
        b30, r30 = make_bands(30, q, ncol, dtype, gen, dev)
        g30 = cuda_banded.banded_solve(b30, r30, q)
        torch.cuda.synchronize()
        n30["max_abs_err"] = rel_err(g30, cuda_banded.banded_solve_plain(
            b30, r30, q))
        n30["launch"] = cuda_banded.launch_config(b30, r30, q)
        n30["ms"] = time_cuda(lambda: cuda_banded.banded_solve(b30, r30, q),
                              [()], reps=20, queued=True)
        err = max(err, n30["max_abs_err"])
        del b30, r30, g30
        if not err <= band_tol[dtype]:
            raise RuntimeError(f"banded_solve {tag}: rel err {err} "
                               f"> {band_tol[dtype]}")
        ms = time_cuda(lambda: cuda_banded.banded_solve(bands, rhs, q),
                       [()], reps=10, queued=True)
        plain_ms = time_cuda(
            lambda: cuda_banded.banded_solve_plain(bands, rhs, q), [()],
            reps=2, warmup=1)
        # the library yardstick: one dense batched solve of the same
        # systems (timed here, used nowhere in the port)
        dense = dense_from_bands(bands, q)
        lib_x = torch.linalg.solve(dense, rhs.T.contiguous()).T
        lib_err = rel_err(lib_x, want)
        library_ms = time_cuda(
            lambda: torch.linalg.solve(dense, rhs.T), [()], reps=2, warmup=1)
        del dense, lib_x
        nb = (bands.numel() + 2 * rhs.numel()) * esize
        flops = n * ncol * (q * (2 * q + 3) + 2 * q + 1)
        bnd, by = bound_ms(nb, flops, dtype)
        row = {"name": "banded_solve", "route": "cuda",
               "source": "tempestmodel_tpu_torch/csrc/banded_multi.cu",
               "replaces": "tempestmodel_tpu/ops/pallas_banded.py:185",
               "shape": [n, 2 * q + 1, ncol], "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
               "library_ms": library_ms, "library_rel_err": lib_err,
               "launch_allocates_MB": allocates, "by_form": forms,
               "n30_q4": n30}
        emit({"phase": "kernel", "dtype": tag, "tol": band_tol[dtype], **row,
              "launch": cuda_banded.launch_config(bands, rhs, q)})
        if dtype == torch.float32:
            rows["banded_solve"] = row
        del bands, rhs, got, want
        torch.cuda.empty_cache()

        check_fused_kernels(cfg, geom, state, dtype, rows, dev)
        check_stage_edges(dtype, dev)
        check_implicit_edges(dtype, dev)
        check_dss_edges(dtype, dev)
        check_banded_edges(dtype, dev)
        check_hyper_edges(dtype, dev)
        check_tail_kernels(geom, dtype, rows, dev)
        check_tracer_kernels(cfg, geom, dtype, rows, dev)
        check_cartesian_kernels(dtype, rows, dev)
    return rows


def check_slice(dev, with_tracers=False):
    """Phase 4: 3 steps at ne4 p4 nz8 in float64 on the card three ways:
    the fused path with kernels (fused nu4 tail included), the unfused path
    with kernels, and the path with the plain versions; each pair to 1e-11
    relative per field.  Then ``make_fast_multistep(inner_steps=3)`` -- one
    replay of a 3-step CUDA graph -- against 3 eager steps from the same
    state (the same kernels in the same order: 1e-13), with the DSS as
    separate launches and with every group in one launch.
    ``with_tracers``: the same from the start perturbed by seeded noise, with
    three seeded tracer species in the state (species of different size, some
    negative values, columns and elements without positive mass)."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts, synthetic
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)

    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = tm.ModelConfig(
        grid_kind=tm.GridKind.CUBED_SPHERE, ne=4, order=4, nz=8,
        ztop=tc.ztop, dt=200.0, hyperdiffusion=True, nu_scalar=1e15,
        nu_div=1e15, nu_vort=1e15, vertical_solver="pallas",
        dtype=torch.float64)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    state = tc.initial_state(geom, cfg.constants, dtype=torch.float64,
                             device=dev)
    X0 = fast.pack_state(state, device=dev)
    per = (lambda n: n)
    what = "ne4 p4 nz8 f64"
    if with_tracers:
        rng = np.random.default_rng(SEED + 7)

        def noise(x):
            return torch.as_tensor(rng.standard_normal(tuple(x.shape)),
                                   device=dev)

        for k in ("U", "V", "Rt", "Rho"):
            X0[k] = X0[k] * (1.0 + 1e-3 * noise(X0[k]))
        X0["W"] = 0.01 * noise(X0["W"])
        X0["Tracers"] = torch.as_tensor(synthetic.random_tracers_numpy(
            cfg.nz, 6, 16, 16, NTR, cfg.order, seed=SEED + 8), device=dev)
        per = moist
        what += f", {NTR} seeded tracer species"
    outs = {}
    for name, kw in (("fused", {}), ("unfused", {"fused": False}),
                     ("plain", {"plain": True})):
        counts.reset_launch_counts()
        first, step = fast.make_fast_step(cfg, geom, device=dev, **kw)
        X, c = first(X0)
        for _ in range(2):
            X, c = step(X, c)
        torch.cuda.synchronize()
        outs[name] = X
        launched = {k for k, v in counts.launch_counts.items() if v}
        want = {"fused": {k for k, v in per(fused_per_step(
                    fast.engine.DSS_MERGE_DEFAULT)).items() if v},
                "unfused": {k for k, v in per(UNFUSED_PER_STEP).items() if v},
                "plain": set()}[name]
        if launched != want:
            raise RuntimeError(f"slice, {name} path launched {launched}, "
                               f"expected {want}")
    errs = {}
    for a, b in (("fused", "unfused"), ("fused", "plain"),
                 ("unfused", "plain")):
        errs[f"{a}_vs_{b}"] = {k: rel_err(outs[a][k], outs[b][k])
                               for k in outs[a]}
    emit({"phase": "slice", "config": what + ", 3 steps",
          "rel_err": errs, "tol": 1e-11})
    bad = {p: {k: e for k, e in d.items() if not e < 1e-11}
           for p, d in errs.items()}
    if any(bad.values()):
        raise RuntimeError(f"paths disagree: {bad}")

    replay = {}
    for merge in ((), ("state", "scalar2")):
        first, step = fast.make_fast_step(cfg, geom, device=dev,
                                          dss_merge=merge)
        X1, c1 = first(X0)
        E, ce = X1, c1
        for _ in range(3):
            E, ce = step(E, ce)
        counts.reset_launch_counts()
        _, multi = fast.make_fast_multistep(cfg, geom, 3, device=dev,
                                            dss_merge=merge)
        G, cg = multi(X1, c1)             # captures, then replays
        captured = dict(counts.launch_counts)
        G2, cg2 = multi(X1, c1)           # a pure replay: no launch counted
        torch.cuda.synchronize()
        # the warm-up step and the 3 captured ones
        want = {k: 4 * v for k, v in per(fused_per_step(merge)).items()}
        if captured != want or dict(counts.launch_counts) != captured:
            raise RuntimeError(f"slice, graph capture ({merge}): launch "
                               f"counts {captured} != expected {want}")
        replay["+".join(merge) or "separate"] = {
            **{k: max(rel_err(G[k], E[k]), rel_err(G2[k], E[k])) for k in E},
            **{"carry_" + k: rel_err(cg2[k], ce[k]) for k in ce}}
    emit({"phase": "slice", "config": what + ", graph replay of 3 steps vs "
          "3 eager steps", "rel_err": replay, "tol": 1e-13})
    bad = {p: {k: e for k, e in d.items() if not e < 1e-13}
           for p, d in replay.items()}
    if any(bad.values()):
        raise RuntimeError(f"graph replay disagrees with eager steps: {bad}")
    for k, v in outs["fused"].items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"slice: non-finite {k}")


# ---------------------------------------------------------------------------
# periodic Cartesian grids: the Schar mountain waves and the 3-D bubble
# ---------------------------------------------------------------------------

def cartesian_setup(name, dtype, nex, ney, nz, dev=None):
    """(test case, cfg, geom[, initial state, reference state]) of a
    periodic Cartesian configuration: ``"schar"`` (the x-z slice of the JAX
    package's second bench line, ``bench.py:339-413``: dt 0.5, nu 1e7,
    Rayleigh on) or ``"bubble3d"`` (the 3-D thermal bubble, hyperdiffusion
    on).  The states are built on ``dev`` when it is given."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases import nonhydro_xz
    if name == "schar":
        tc = nonhydro_xz.ScharMountain()
        kw = dict(grid_kind=tm.GridKind.CARTESIAN_XZ, dt=SCHAR_DT,
                  nu_scalar=SCHAR_NU, nu_div=SCHAR_NU, nu_vort=SCHAR_NU,
                  rayleigh_damping=True)
        extra = dict(topography=tc.topography, rayleigh=tc.rayleigh_strength)
    else:
        tc = nonhydro_xz.ThermalBubble3D()
        kw = dict(grid_kind=tm.GridKind.CARTESIAN_3D, dt=0.1, nu_scalar=1e6,
                  nu_div=1e6, nu_vort=1e6)
        extra = {}
    cfg = tm.ModelConfig(nex=nex, ney=ney, order=ORDER, nz=nz,
                         x_extent=tc.x_extent, y_extent=tc.y_extent,
                         ztop=tc.ztop, hyperdiffusion=True,
                         vertical_solver="pallas", dtype=dtype, **kw)
    geom = nh_model.build_nh_cartesian_geometry(cfg, ztop=tc.ztop, **extra)
    if dev is None:
        return tc, cfg, geom
    state = tc.initial_state(geom, cfg.constants, dtype=dtype, device=dev)
    ref = (tc.reference_state(geom, cfg.constants, dtype=dtype, device=dev)
           if cfg.rayleigh_damping else None)
    return tc, cfg, geom, state, ref


def check_cartesian_dss(fgs, dtype, rows, dev):
    """The five DSS kernels with the periodic wrap-sum against their plain
    versions: one panel, no links, at Schar's shapes in both layouts
    ((K, 1, 4, 400) and (K, 1, 400, 4)) and on a 3-D plane (K, 1, 128,
    128), K = 40 levels (41 interfaces).  ``dss_state`` with and without the
    Rayleigh finish (its x-z-exempt slot with the factor 1); ``dss_scalar``
    also with the link table's pointer set to an invalid address, which a
    grid without links must never read; ``dss_vector`` bit for bit equal
    to its plain version, with its launch shape and copy route, timed
    beside one ``torch.sparse.mm`` of the pair's operator.  Times at each
    shape."""
    import ctypes
    from tempestmodel_tpu_torch.fast import dss_cuda
    from tempestmodel_tpu_torch.kernels import build, dss_operator, synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda

    tag = "f32" if dtype == torch.float32 else "f64"
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    esize = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    out = {}
    for where, fg in fgs.items():
        K, (P, A, B) = fg.nz, fg.inv_mult.shape
        links, rot, table = (), fg.e_rot, fg.dss_table
        im, wrap = fg.inv_mult, fg.wrap
        sets = [synthetic.random_state(fg, seed=s) for s in (31, 32, 33)]
        d = sets[0]
        nlev, nint, n2d = K * P * A * B, (K + 1) * P * A * B, P * A * B
        errs = {}
        # dss_scalar: a level and an interface field, and the raw launch
        # with an invalid table address
        for x in (d["Rt"], d["W"]):
            got = dss_cuda.dss_scalar(x, im, links, fg.p, wrap=wrap,
                                      table=table)
            torch.cuda.synchronize()
            errs["dss_scalar"] = max(errs.get("dss_scalar", 0.0), rel_err(
                got, dss_cuda.dss_scalar_plain(x, im, links, fg.p, wrap)))
        lib = build.library("dss")
        fn = lib.dss_scalar_f32 if dtype == torch.float32 \
            else lib.dss_scalar_f64
        raw = torch.empty_like(d["Rt"])
        cfg = dss_cuda.launch_config(
            d["Rt"], fg.p, "scalar", dss_cuda._scalar_ptrs(d["Rt"], im),
            False)
        err = fn(d["Rt"].data_ptr(), im.data_ptr(), ctypes.c_void_p(16),
                 raw.data_ptr(), K, P, A, B, fg.p, 0,
                 int(wrap[0]) | 2 * int(wrap[1]), cfg["rows"],
                 cfg["levels"], cfg["threads"], cfg["ring"], cfg["copy"],
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0 or not torch.equal(raw, dss_cuda.dss_scalar(
                d["Rt"], im, links, fg.p, wrap=wrap, table=table)):
            raise RuntimeError(f"cartesian dss_scalar {where} {tag}: the "
                               f"launch with no table differs (err {err})")
        gu, gv = dss_cuda.dss_vector(d["U"], d["V"], im, rot, links, fg.p,
                                     wrap=wrap, table=table)
        torch.cuda.synchronize()
        wu, wv = dss_cuda.dss_vector_plain(d["U"], d["V"], im, rot, links,
                                           fg.p, wrap)
        errs["dss_vector"] = max(rel_err(gu, wu), rel_err(gv, wv))
        if not (torch.equal(gu, wu) and torch.equal(gv, wv)):
            raise RuntimeError(f"cartesian dss_vector {where} {tag}: not bit "
                               f"for bit equal to the plain version")
        shp = d["W"].shape
        wf = {"bw1": sets[1]["W"], "bw2": sets[2]["W"],
              "dW": randn(shp, dtype, gen, dev),
              "cax0": randn(shp[1:], dtype, gen, dev),
              "cbx0": randn(shp[1:], dtype, gen, dev),
              "cxx0": 1.0 + randn(shp[1:], dtype, gen, dev).abs(),
              "cb1": 0.3, "cb2": 0.7, "dt_s": 0.5, "c00": 0.6, "c01": 0.4}
        e = 0.0
        for w in (wf, dict(wf, bw2=None)):
            got = dss_cuda.dss_uvw(d["U"], d["V"], im, rot, links, fg.p, w,
                                   wrap=wrap, table=table)
            torch.cuda.synchronize()
            want = dss_cuda.dss_uvw_plain(d["U"], d["V"], im, rot, links,
                                          fg.p, w, wrap)
            e = max(e, max_rel_err(got + (got[2][0],), want + (want[2][0],)))
        errs["dss_uvw"] = e
        fac = {k: torch.rand(v.shape, dtype=dtype, device=dev, generator=gen)
               for k, v in d.items()}
        fac["Rho"] = torch.ones_like(fac["Rho"])
        fac[fg.xz_zero or "V"] = torch.ones_like(fac["V"])
        ray = (fac, {k: (1.0 - fac[k]) * sets[1][k] for k in d})
        e = 0.0
        for r in (None, ray):
            got = dss_cuda.dss_state(d, im, rot, links, fg.p, rayleigh=r,
                                     wrap=wrap, table=table)
            torch.cuda.synchronize()
            want = dss_cuda.dss_state_plain(d, im, rot, links, fg.p, r, wrap)
            sep = dict(zip(("U", "V"), dss_cuda.dss_vector(
                d["U"], d["V"], im, rot, links, fg.p, wrap=wrap,
                table=table)))
            sep["Rt"], sep["Rho"] = dss_cuda.dss_scalar2(
                d["Rt"], d["Rho"], im, links, fg.p, wrap=wrap, table=table)
            sep["W"] = dss_cuda.dss_scalar(d["W"], im, links, fg.p,
                                           wrap=wrap, table=table)
            torch.cuda.synchronize()
            if r is not None:
                sep = {k: r[0][k] * sep[k] + r[1][k] for k in sep}
            e = max(e, max(rel_err(got[k], want[k]) for k in want))
            if not all(torch.equal(got[k], want[k])
                       and torch.equal(got[k], sep[k]) for k in want):
                raise RuntimeError(
                    f"cartesian dss_state {where} {tag} (Rayleigh "
                    f"{r is not None}): not bit for bit equal to the plain "
                    f"version and to the separate launches")
        errs["dss_state"] = e
        g1, g2 = dss_cuda.dss_scalar2(d["Rt"], d["Rho"], im, links, fg.p,
                                      wrap=wrap, table=table)
        torch.cuda.synchronize()
        w1, w2 = dss_cuda.dss_scalar2_plain(d["Rt"], d["Rho"], im, links,
                                            fg.p, wrap)
        errs["dss_scalar2"] = max(rel_err(g1, w1), rel_err(g2, w2))
        two = [dss_cuda.dss_scalar(d[k], im, links, fg.p, wrap=wrap,
                                   table=table) for k in ("Rt", "Rho")]
        torch.cuda.synchronize()
        if not (torch.equal(g1, w1) and torch.equal(g2, w2)
                and torch.equal(g1, two[0]) and torch.equal(g2, two[1])):
            raise RuntimeError(f"cartesian dss_scalar2 {where} {tag}: not bit "
                               f"for bit equal to the plain version and to "
                               f"two dss_scalar launches")
        del two
        if not max(errs.values()) <= tol:
            raise RuntimeError(f"cartesian DSS {where} {tag}: rel err {errs} "
                               f"> {tol}")
        sw = dict(wrap=wrap, table=table)
        calls = {
            "dss_scalar": (
                lambda x: dss_cuda.dss_scalar(x["Rt"], im, links, fg.p, **sw),
                lambda x: dss_cuda.dss_scalar_plain(x["Rt"], im, links, fg.p,
                                                    wrap),
                (2 * nlev + n2d) * esize, 5 * nlev),
            "dss_vector": (
                lambda x: dss_cuda.dss_vector(x["U"], x["V"], im, rot, links,
                                              fg.p, **sw),
                lambda x: dss_cuda.dss_vector_plain(x["U"], x["V"], im, rot,
                                                    links, fg.p, wrap),
                (4 * nlev + n2d) * esize, 10 * nlev),
            "dss_uvw": (
                lambda x: dss_cuda.dss_uvw(x["U"], x["V"], im, rot, links,
                                           fg.p, wf, **sw),
                lambda x: dss_cuda.dss_uvw_plain(x["U"], x["V"], im, rot,
                                                 links, fg.p, wf, wrap),
                (4 * nlev + 4 * nint + 4 * n2d) * esize,
                16 * nlev + 12 * nint),
            "dss_state": (
                lambda x: dss_cuda.dss_state(x, im, rot, links, fg.p,
                                             rayleigh=ray, **sw),
                lambda x: dss_cuda.dss_state_plain(x, im, rot, links, fg.p,
                                                   ray, wrap),
                (4 * (4 * nlev + nint) + n2d) * esize,
                5 * (4 * nlev + nint) + 2 * (4 * nlev + nint)),
            "dss_scalar2": (
                lambda x: dss_cuda.dss_scalar2(x["Rt"], x["Rho"], im, links,
                                               fg.p, **sw),
                lambda x: dss_cuda.dss_scalar2_plain(x["Rt"], x["Rho"], im,
                                                     links, fg.p, wrap),
                (4 * nlev + n2d) * esize, 10 * nlev)}
        timed = {}
        for name, (kern, plain, nb, flops) in calls.items():
            bnd, by = bound_ms(nb, flops, dtype)
            timed[name] = {
                "max_abs_err": errs[name],
                "ms": time_cuda(kern, [(x,) for x in sets], reps=50,
                                queued=True),
                "plain_ms": time_cuda(plain, [(x,) for x in sets], reps=5),
                "bound_ms": bnd, "bound_by": by}
        # dss_vector's library yardstick: one torch.sparse.mm with the
        # pair's operator on (U, V) stacked along the nodes (not timed)
        op = dss_operator.vector_operator(im, rot, links, fg.p, wrap)
        uvs = [(torch.cat([x["U"].reshape(K, -1), x["V"].reshape(K, -1)],
                          1),) for x in sets]
        timed["dss_state"].update(
            bitwise=True, rayleigh=True,
            ms_no_rayleigh=time_cuda(
                lambda x: dss_cuda.dss_state(x, im, rot, links, fg.p, **sw),
                [(x,) for x in sets], reps=50, queued=True),
            launch=dss_cuda.launch_config(
                d["U"], fg.p, "state", dss_cuda._state_ptrs(d, im), False))
        timed["dss_vector"].update(
            bitwise=True,
            library_ms=time_cuda(lambda uv: dss_operator.apply(op, uv), uvs,
                                 reps=50, queued=True),
            launch=dss_cuda.launch_config(
                d["U"], fg.p, "vector",
                dss_cuda._vector_ptrs(d["U"], d["V"], im), False))
        del op, uvs
        emit({"phase": "cartesian_kernel", "dtype": tag, "tol": tol,
              "kernels": "dss", "shape": [K, P, A, B], "where": where,
              "wrap": list(wrap), "by_kernel": timed})
        out[where] = timed
        del sets, d
    if dtype == torch.float32:
        rows["cartesian_dss"] = out
    torch.cuda.empty_cache()


def check_cartesian_kernels(dtype, rows, dev):
    """Phase 3, fifth part: what periodic Cartesian grids reach, at their
    full shapes in ``dtype``: the five DSS kernels with the wrap-sum
    (``check_cartesian_dss``); ``fused_stage`` on the Schar slice (nex 100,
    40 levels; terrain, so the full 3-D metric: ``use_sep = 0``) with
    ``xz_zero`` "U" (swapped) and "V" (natural), one base and two, at the
    step's dt and at one long enough that the increment is as large as the
    state; ``fused_implicit_update`` at Schar's 1600 columns; ``nu4_pass1``,
    ``nu4_pass2`` on the 3-D bubble's plane, A = B = 128 and A = 128, B =
    64."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import (stage_cuda, hyper_cuda,
                                             implicit_cuda, implicit as fimp)
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nonhydro

    tag = "f32" if dtype == torch.float32 else "f64"
    f32 = dtype == torch.float32
    esize = 4 if f32 else 8
    tc, cfg, geom, state, _ = cartesian_setup("schar", dtype, SCHAR_NEX, 1,
                                              SCHAR_NZ, dev)
    consts = cfg.constants
    fgs = {layout: fast.build_fast_geometry_cartesian(
        geom, dtype=dtype, device=dev, swap_ab=(layout == "swapped"))
        for layout in ("swapped", "natural")}
    _, pcfg, pgeom = cartesian_setup("bubble3d", dtype, PLANE_NE, PLANE_NE,
                                     SCHAR_NZ)
    plane = fast.build_fast_geometry_cartesian(pgeom, dtype=dtype,
                                               device=dev)
    check_cartesian_dss({"schar_swapped": fgs["swapped"],
                         "schar_natural": fgs["natural"],
                         "plane": plane}, dtype, rows, dev)

    # --- fused_stage, x-z branch -------------------------------------------
    stage_tol = 1e-4 if f32 else 1e-11
    stage = {}
    for layout, fg in fgs.items():
        sst = stage_cuda.stage_statics(fg)
        if sst.use_sep or fg.xz_zero != ("U" if layout == "swapped" else "V"):
            raise RuntimeError(f"Schar {layout}: wrong metric form or slot")
        K, (P, A, B) = fg.nz, fg.inv_mult.shape
        nlev, nint, n2d = K * P * A * B, (K + 1) * P * A * B, P * A * B
        ue, b1, b2 = (synthetic.random_state(fg, seed=s) for s in (1, 2, 3))
        zero = {k: torch.zeros_like(v) for k, v in ue.items()}
        tend = stage_cuda.fused_stage_plain(zero, ue, 1.0, fg, consts,
                                            defer_w=True)[0]
        other = "V" if fg.xz_zero == "U" else "U"
        dt_big = float(min(ue[k].abs().max() / tend[k].abs().max()
                           for k in (other, "Rt", "Rho")))
        errs = {}
        two = ((0.3, b1), (0.7, b2))
        for dt_s in (SCHAR_DT, dt_big):
            for base in (b1, two):
                got, gwf = stage_cuda.fused_stage(base, ue, dt_s, fg, consts,
                                                  defer_w=True, statics=sst)
                torch.cuda.synchronize()
                want, wwf = stage_cuda.fused_stage_plain(base, ue, dt_s, fg,
                                                         consts, defer_w=True)
                e = {k: rel_err(got[k], want[k]) for k in stage_cuda.STATE4}
                e["dW"] = rel_err(gwf["dW"], wwf["dW"])
                errs = {k: max(v, errs.get(k, 0.0)) for k, v in e.items()}
        if not max(errs.values()) <= stage_tol:
            raise RuntimeError(f"fused_stage x-z {layout} {tag}: rel err "
                               f"{errs} > {stage_tol}")
        timed = {}
        full3d = 6 * nlev + 3 * nint     # the 3-D metric: 6 level fields,
        #                                  # 3 interface fields
        for key, base, nbase in (("", b1, 4), ("_two_base", two, 8)):
            tb, c1, x1, c2, x2 = stage_cuda._split_base(base)
            timed["ms" + key] = time_cuda(lambda: stage_cuda._fused_stage_cuda(
                tb, c1, x1, c2, x2, ue, SCHAR_DT, fg, consts, sst), [()],
                reps=50, queued=True)
            timed["plain_ms" + key] = time_cuda(
                lambda: stage_cuda.fused_stage_plain(
                    base, ue, SCHAR_DT, fg, consts, defer_w=True), [()],
                reps=5, warmup=1)
            nb = ((4 + nbase + 5) * nlev + nint + 5 * n2d + full3d
                  + sst.tab.numel()) * esize
            timed["bound_ms" + key], timed["bound_by"] = bound_ms(
                nb, 400 * nlev, dtype)
        stage[layout] = dict(timed, max_abs_err=max(errs.values()),
                             err_by_output=errs, long_step_s=dt_big,
                             xz_zero=fg.xz_zero, shape=[K, P, A, B])
        emit({"phase": "cartesian_kernel", "dtype": tag, "tol": stage_tol,
              "name": "fused_stage_xz", "layout": layout, **stage[layout],
              **stage_report(two, ue, fg, sst, tag, cart=True)})
        del ue, b1, b2, zero, tend
    if f32:
        rows["cartesian_stage"] = stage

    # --- fused_implicit_update off the sphere, at Schar's columns ----------
    imp_tol = 2e-3 if f32 else 1e-10
    fg = fgs["swapped"]
    q = nonhydro.estimate_bandwidth(geom, consts)
    statics = fimp.statics_to_device(
        nonhydro.band_assembly_statics(geom, q), dtype, dev)
    ist = implicit_cuda.implicit_statics(statics, fg)
    if not implicit_cuda.fused_supported(ist):
        raise RuntimeError("Schar is outside the fused implicit envelope")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    d = fast.engine._swap_ab_state(fast.pack_state(state, device=dev))
    for k in ("U", "V", "Rt", "Rho"):
        d[k] = d[k] * (1.0 + 1e-3 * randn(d[k].shape, dtype, gen, dev))
    d["W"] = 0.01 * randn(d["W"].shape, dtype, gen, dev)
    x0, aux = fimp._prep_aux(d, fg, None, interfaces=False)
    x1 = tuple((p * 1.001).contiguous() for p in x0)
    dt_imp = 0.5 * SCHAR_DT
    err = 0.0
    for ref_j in (False, True):
        for time_term in (False, True):
            xs = x1 if time_term else x0
            got = implicit_cuda.fused_implicit_update(
                xs, x0, aux, ist, dt_imp, consts, ref_jacobian=ref_j,
                newton_time_term=time_term)
            torch.cuda.synchronize()
            want = implicit_cuda.fused_implicit_update_plain(
                xs, x0, aux, ist, dt_imp, consts, ref_jacobian=ref_j,
                newton_time_term=time_term)
            err = max(err, max_rel_err(got, want))
    if not err <= imp_tol:
        raise RuntimeError(f"fused_implicit_update Schar {tag}: rel err "
                           f"{err} > {imp_tol}")
    K, ncol = fg.nz, x0[0].shape[1]
    n = 3 * K + 1
    nb = ((4 + 4 + 2) * K * ncol + (1 + 5 + 1) * (K + 1) * ncol + 4 * ncol
          + ist.tab.numel()) * esize
    bnd, by = bound_ms(nb, ncol * (n * (q * (2 * q + 3) + 2 * q + 1)
                                   + (K + 1) * 400), dtype)
    imp = {"shape": [K, ncol], "n": n, "q": q, "max_abs_err": err,
           "ms": time_cuda(lambda: implicit_cuda.fused_implicit_update(
               x0, x0, aux, ist, dt_imp, consts), [()], reps=50,
               queued=True),
           "plain_ms": time_cuda(
               lambda: implicit_cuda.fused_implicit_update_plain(
                   x0, x0, aux, ist, dt_imp, consts), [()], reps=5,
               warmup=1),
           "bound_ms": bnd, "bound_by": by}
    emit({"phase": "cartesian_kernel", "dtype": tag, "tol": imp_tol,
          "name": "fused_implicit_update_schar", **imp,
          "launch": implicit_cuda.launch_config(x0, x0, aux, ist)})
    if f32:
        rows["cartesian_implicit"] = imp

    # --- nu4_pass1, nu4_pass2 on a plane ------------------------------------
    hyper_tol = 1e-4 if f32 else 1e-11
    _, _, rgeom = cartesian_setup("bubble3d", dtype, PLANE_NE,
                                  PLANE_NE // 2, SCHAR_NZ)
    rect = fast.build_fast_geometry_cartesian(rgeom, dtype=dtype, device=dev)
    nu4 = {}
    for where, fg in (("plane", plane), ("plane_rectangular", rect)):
        if not hyper_cuda.supported(fg, pcfg):
            raise RuntimeError(f"nu4 {where}: outside the kernels' envelope")
        hst = hyper_cuda.hyper_statics(fg)
        K, (P, A, B) = fg.nz, fg.inv_mult.shape
        nint = (K + 1) * P * A * B
        nstate = 4 * K * P * A * B + nint
        sets = [(synthetic.random_state(fg, seed=s),
                 synthetic.random_state(fg, seed=s + 10)) for s in (41, 42)]
        d, w = sets[0]
        unit = hyper_cuda.nu4_pass1_plain(w, fg, hst)
        nu_s = float(d["Rho"].abs().max() / unit["Rho"].abs().max())
        nu_v = float(d["U"].abs().max() / unit["U"].abs().max())
        nu = (nu_s, nu_v, 0.7 * nu_v, 1.0)
        got1 = hyper_cuda.nu4_pass1(d, fg, hst)
        got2 = hyper_cuda.nu4_pass2(d, w, *nu, fg, hst)
        torch.cuda.synchronize()
        want1 = hyper_cuda.nu4_pass1_plain(d, fg, hst)
        want2 = hyper_cuda.nu4_pass2_plain(d, w, *nu, fg, hst)
        errs = {"nu4_pass1": max(rel_err(got1[k], want1[k]) for k in want1),
                "nu4_pass2": max(max(rel_err(got2[k], want2[k]),
                                     rel_err(got2[k] - d[k], want2[k] - d[k]))
                                 for k in want2)}
        if not max(errs.values()) <= hyper_tol:
            raise RuntimeError(f"nu4 {where} {tag}: rel err {errs} > "
                               f"{hyper_tol}")
        scal2 = (nu[1], nu[2], nu[3], nu[3] * nu[0])
        timed = {}
        for name, launch, plain, nfields in (
                ("nu4_pass1",
                 lambda x, y: hyper_cuda._launch("nu4_pass1", x, None,
                                                 (1.0, 1.0, 0.0, 0.0), hst),
                 lambda x, y: hyper_cuda.nu4_pass1_plain(x, fg, hst), 2),
                ("nu4_pass2",
                 lambda x, y: hyper_cuda._launch("nu4_pass2", y, x, scal2,
                                                 hst),
                 lambda x, y: hyper_cuda.nu4_pass2_plain(x, y, *nu, fg, hst),
                 3)):
            nb = (nfields * nstate + 8 * P * A * B + hst.ds.numel()) * esize
            bnd, by = bound_ms(nb, 220 * nint, dtype)
            timed[name] = {"max_abs_err": errs[name],
                           "ms": time_cuda(launch, sets, reps=20,
                                           queued=True),
                           "plain_ms": time_cuda(plain, sets, reps=3,
                                                 warmup=1),
                           "bound_ms": bnd, "bound_by": by}
        nu4[where] = dict(timed, shape=[K, P, A, B])
        emit({"phase": "cartesian_kernel", "dtype": tag, "tol": hyper_tol,
              "kernels": "nu4", "where": where, **nu4[where]})
        del sets, d, w, unit
    if f32:
        rows["cartesian_nu4"] = nu4
    torch.cuda.empty_cache()


def compare_xz(got, want):
    """Relative error per field; U and V against their common scale (V of
    an x-z slice is roundoff only)."""
    vel = max(float(want["U"].abs().max()), float(want["V"].abs().max()))
    out = {}
    for k in want:
        scale = vel if k in ("U", "V") else float(want[k].abs().max())
        out[k] = float((got[k] - want[k]).abs().max()) / (scale + 1e-300)
    return out


def check_cartesian_slice(dev):
    """Phase 4, Cartesian: 3 steps in float64 on the card of Schar at test
    scale (nex 8, nz 8, both layouts) and of the 3-D bubble (nex 4, ney 2,
    hyperdiffusion on, so the nu4 passes run): the kernel path against the
    plain path to 1e-11, then a 3-step graph replay against 3 eager steps
    to 1e-13.  Returns the launch counts of each kernel path's run."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    launched = {}
    for name, nex, ney, swap in (("schar", 8, 1, True), ("schar", 8, 1, False),
                                 ("bubble3d", 4, 2, None)):
        _, cfg, geom, state, ref = cartesian_setup(name, torch.float64, nex,
                                                   ney, 8, dev)
        X0 = fast.pack_state(state, device=dev)
        what = f"{name} nex{nex} ney{ney} nz8 f64" + (
            "" if swap is None else (", swapped" if swap else ", natural"))
        outs = {}
        for path, kw in (("kernels", {}), ("plain", {"plain": True})):
            counts.reset_launch_counts()
            first, step = fast.make_fast_step(cfg, geom, ref_state=ref,
                                              device=dev, swap_ab=swap, **kw)
            X, c = first(X0)
            for _ in range(2):
                X, c = step(X, c)
            torch.cuda.synchronize()
            outs[path] = X
            if path == "kernels":
                launched[what] = dict(counts.launch_counts)
        per_step = dict(fused_per_step(fast.engine.DSS_MERGE_DEFAULT), **(
            {"nu4_pass1": 0, "nu4_pass2": 0} if name == "schar" else {}))
        want = {k: 3 * v + (1 if k == "fused_implicit_update" else 0)
                for k, v in per_step.items()}
        if launched[what] != want:
            raise RuntimeError(f"{what}: launch counts {launched[what]} != "
                               f"expected {want}")
        errs = compare_xz(outs["kernels"], outs["plain"])
        first, step = fast.make_fast_step(cfg, geom, ref_state=ref,
                                          device=dev, swap_ab=swap)
        X1, c1 = first(X0)
        E, ce = X1, c1
        for _ in range(3):
            E, ce = step(E, ce)
        _, multi = fast.make_fast_multistep(cfg, geom, 3, ref_state=ref,
                                            device=dev, swap_ab=swap)
        G, cg = multi(X1, c1)
        G2, cg2 = multi(X1, c1)
        torch.cuda.synchronize()
        replay = {k: max(rel_err(G[k], E[k]), rel_err(G2[k], E[k]))
                  for k in ("Rt", "Rho", "W")}
        replay.update({k: max(compare_xz(G, E)[k], compare_xz(G2, E)[k])
                       for k in ("U", "V")})
        emit({"phase": "cartesian_slice", "config": what + ", 3 steps",
              "kernels_vs_plain": errs, "tol": 1e-11,
              "graph_replay_vs_eager": replay, "replay_tol": 1e-13,
              "launches": launched[what]})
        if not max(errs.values()) < 1e-11 or not max(replay.values()) < 1e-13:
            raise RuntimeError(f"{what}: paths disagree {errs} / {replay}")
        for k, v in outs["kernels"].items():
            if not bool(torch.isfinite(v).all()):
                raise RuntimeError(f"{what}: non-finite {k}")
    return launched


# ---------------------------------------------------------------------------
# the IMEX-ARK family
# ---------------------------------------------------------------------------

def capture_imex(step, S, nsteps):
    """``nsteps`` steps of an IMEX ``step`` (reference-layout state ->
    state) as one CUDA graph (``engine.graph_runner``: a warm-up step on a
    side stream, the capture from static buffers, then a first replay, all
    here, from ``S``).  Returns ``replay(S) -> S``: copies ``S`` into the
    buffers, replays the graph and returns clones of the outputs.  The
    runner keeps the step (and its set-up, which the graph reads) alive."""
    from tempestmodel_tpu_torch.fast.engine import graph_runner
    run = graph_runner(lambda s, carry: (step(s), carry), nsteps)
    run(S, {})
    return lambda s: run(s, {})[0]


def check_imex_slice(dev):
    """Phase 4, IMEX: 2 steps of ``make_fast_imex_step`` in float64 on the
    card, the kernel path against the plain path (``plain=True``) to 1e-11
    relative per field: ne4 p4 nz8 (UMJS) with ARS343 and GARK2, each with
    every DSS through ``dss_state``, with the default grouping and with
    separate launches (the band kernel's other modes); the
    Schar slice (nex 8, nz 8, ARS343, its sponge on) in both layouts (U and
    V against their common scale).  The kernel path's launches are checked
    against the IMEX table; the plain path launches nothing."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)

    tc = BaroclinicWaveUMJS(pert="exp")
    base = tm.ModelConfig(
        grid_kind=tm.GridKind.CUBED_SPHERE, ne=4, order=4, nz=8,
        ztop=tc.ztop, dt=200.0, hyperdiffusion=True, nu_scalar=1e15,
        nu_div=1e15, nu_vort=1e15, vertical_solver="pallas",
        dtype=torch.float64)
    geom = nh_model.build_nh_sphere_geometry(base, ztop=tc.ztop)
    state = tc.initial_state(geom, base.constants, dtype=torch.float64,
                             device=dev)
    default = tuple(fast.engine.DSS_MERGE_DEFAULT)
    cases = []
    for scheme, ndss, nimp in (("ars343", 6, 3), ("gark2", 5, 2)):
        for merge in sorted({("state",), default, ()}):
            cases.append((f"ne4 p4 nz8 f64 {scheme}", base.with_(
                timescheme=tm.TimestepSchemeType(scheme)), geom, state, None,
                None, merge, imex_per_step(merge, ndss, nimp)))
    for swap in (True, False):
        _, cfg, sgeom, sstate, ref = cartesian_setup("schar", torch.float64,
                                                     8, 1, 8, dev)
        cases.append((f"schar nex8 nz8 f64 ars343, "
                      f"{'swapped' if swap else 'natural'}",
                      cfg.with_(timescheme=tm.TimestepSchemeType.ARS343),
                      sgeom, sstate, ref, swap, default,
                      imex_per_step(default, nu4=False)))
    for what, cfg, g, S0, ref, swap, merge, per in cases:
        outs, launched = {}, None
        for path, plain in (("kernels", False), ("plain", True)):
            counts.reset_launch_counts()
            step = fast.make_fast_imex_step(cfg, g, ref_state=ref,
                                            device=dev, plain=plain,
                                            dss_merge=merge, swap_ab=swap)
            S = S0
            for _ in range(2):
                S = step(S)
            torch.cuda.synchronize()
            outs[path] = S
            if path == "kernels":
                launched = dict(counts.launch_counts)
            elif any(counts.launch_counts.values()):
                raise RuntimeError(f"IMEX {what}: the plain path launched "
                                   f"{dict(counts.launch_counts)}")
        want = {k: 2 * v for k, v in per.items()}
        if launched != want:
            raise RuntimeError(f"IMEX {what} ({merge}): launch counts "
                               f"{launched} != expected {want}")
        errs = compare_xz(outs["kernels"], outs["plain"]) if swap is not None \
            else {k: rel_err(outs["kernels"][k], outs["plain"][k])
                  for k in outs["plain"]}
        emit({"phase": "imex_slice", "config": what + ", 2 steps",
              "dss_merge": merge, "kernels_vs_plain": errs, "tol": 1e-11,
              "launches": launched})
        if not max(errs.values()) < 1e-11:
            raise RuntimeError(f"IMEX {what} ({merge}): paths disagree "
                               f"{errs}")
        for k, v in outs["kernels"].items():
            if not bool(torch.isfinite(v).all()):
                raise RuntimeError(f"IMEX {what}: non-finite {k}")


def imex_line(dev, smi, cfg, geom, state, launches, profiles):
    """Phase 5e: the IMEX-ARK step (ARS343, ``vertical_solver="pallas"``:
    the fused implicit kernel) on the flagship grid, reusing the flagship's
    geometry and start, the DSS grouped as ``DSS_MERGE_DEFAULT`` says: 1
    warm-up and ``IMEX_STEPS`` eager steps timed by CUDA events, then a
    10-step CUDA graph of ``step`` (``capture_imex``) replayed ``REPLAYS``
    times; each run starts with the counts at 0 and is checked against the
    IMEX table; the device busy time of one replay from torch.profiler.
    Where a field is not finite after the eager steps at dt 100 s, it runs
    at 50 s and says so (a step's cost does not depend on dt).  Returns
    the configuration it ran."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    merge = tuple(fast.engine.DSS_MERGE_DEFAULT)
    per_step = imex_per_step(merge)
    npts = 6 * (NE * ORDER) ** 2 * NZ
    shapes = {k: tuple(v.shape) for k, v in state.items()}

    def check(S, what):
        for k, v in S.items():
            if tuple(v.shape) != shapes[k] or v.dtype != torch.float32 \
                    or not bool(torch.isfinite(v).all()):
                raise RuntimeError(f"{what}: {k} is not a finite float32 "
                                   f"field of the start's shape")
        drift = {k: rel_err(S[k], state[k]) for k in ("Rho", "Rt")}
        if not all(d < 1e-2 for d in drift.values()):
            raise RuntimeError(f"{what}: state drifted {drift}")
        return drift

    note = None
    for dt in (DT, 0.5 * DT):
        icfg = cfg.with_(timescheme=tm.TimestepSchemeType(IMEX_SCHEME),
                         dt=dt)
        t0 = time.perf_counter()
        step = fast.make_fast_imex_step(icfg, geom, device=dev)
        make_s = time.perf_counter() - t0
        S = step(state)                  # warm-up outside the counted run
        torch.cuda.synchronize()
        counts.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        S = state
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        for _ in range(IMEX_STEPS):
            S = step(S)
        ev1.record()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / IMEX_STEPS
        ms = ev0.elapsed_time(ev1) / IMEX_STEPS
        launches["imex_eager"] = dict(counts.launch_counts)
        if all(bool(torch.isfinite(v).all()) for v in S.values()):
            break
        note = (f"dt {DT:g} s gave non-finite fields after {IMEX_STEPS} "
                f"steps; run at dt {0.5 * DT:g} s")
        emit({"phase": "imex", "note": note})
    else:
        raise RuntimeError(f"IMEX flagship: non-finite fields at dt {DT:g} "
                           f"and {0.5 * DT:g} s")
    config = (f"UMJS ne{NE} p{ORDER} nz{NZ} f32 {IMEX_SCHEME} dt{dt:g} "
              f"nu{NU:g}")
    want = {k: v * IMEX_STEPS for k, v in per_step.items()}
    if launches["imex_eager"] != want:
        raise RuntimeError(f"IMEX eager: launch counts "
                           f"{launches['imex_eager']} != expected {want}")
    emit({"phase": "imex", "path": "eager", "config": config,
          "steps": IMEX_STEPS, "ms_per_step": ms, "wall_ms_per_step": wall,
          "gridpoint_steps_per_s": npts / (ms * 1e-3),
          "launches": launches["imex_eager"], "launches_per_step": per_step,
          "dss_merge": merge, "make_fast_imex_step_s": make_s,
          "drift": check(S, "IMEX eager"), "note": note,
          "peak_device_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": smi})

    counts.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    replay = capture_imex(step, state, INNER_STEPS)
    S = replay(state)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches["imex_multistep"] = dict(counts.launch_counts)
    want = {k: v * (INNER_STEPS + 1) for k, v in per_step.items()}
    if launches["imex_multistep"] != want:
        raise RuntimeError(f"IMEX graph: launch counts "
                           f"{launches['imex_multistep']} != expected {want}")
    replay_ms = []
    for _ in range(REPLAYS):
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        S = replay(S)
        ev1.record()
        torch.cuda.synchronize()
        replay_ms.append(ev0.elapsed_time(ev1) / INNER_STEPS)
    drift = check(S, "IMEX graph replay")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_steps(lambda x, c: (replay(x), c), S, None, 1,
                         "imex_multistep", INNER_STEPS)
    profiles["imex_multistep"] = prof
    ms = sorted(replay_ms)[len(replay_ms) // 2]
    emit({"phase": "imex", "path": "multistep", "config": config,
          "inner_steps": INNER_STEPS, "replays": REPLAYS,
          "steps": INNER_STEPS * (REPLAYS + 1), "ms_per_step": ms,
          "ms_per_step_each_replay": replay_ms,
          "gridpoint_steps_per_s": npts / (ms * 1e-3),
          "device_busy_ms_per_step": prof["device_ms_per_step"],
          "device_launches_per_step": prof["device_launches_per_step"],
          "launches": launches["imex_multistep"],
          "launches_per_step": per_step,
          "launches_counted": "at capture (1 warm-up step + "
                              f"{INNER_STEPS} captured steps), not at replay",
          "dss_merge": merge, "warmup_capture_and_two_replays_s": capture_s,
          "drift": drift, "note": note, "peak_device_GiB": peak,
          "card": smi})
    del replay, step, S
    torch.cuda.empty_cache()
    return icfg


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_timers(text):
    """``{name: (mean ms, count, min ms, max ms)}`` from a
    ``Timers.report`` in ``text``."""
    out, inside = {}, False
    for line in text.splitlines():
        if line.startswith("TIME  NAME"):
            inside = True
            continue
        parts = line.split()
        if inside and len(parts) == 5:
            out[parts[0]] = (float(parts[1]) / 1e3, int(parts[2]),
                             float(parts[3]) / 1e3, float(parts[4]) / 1e3)
    return out


def run_cli(argv, dev):
    """``cli.main(argv)`` with its standard output kept (and returned);
    (text, wall seconds, launch counts of the run)."""
    import contextlib
    import io
    from tempestmodel_tpu_torch import cli
    from tempestmodel_tpu_torch.kernels import counts
    buf = io.StringIO()
    counts.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--device", str(dev)])
    sync(dev)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}")
    return buf.getvalue(), wall, dict(counts.launch_counts)


def driver_counts(per_step, graphs, eager=1):
    """Launch counts of a driver run: ``eager`` steps outside graphs (the
    first has one implicit solve more) and, for each graph of ``k`` steps,
    one warm-up step and the ``k`` captured steps (replays pass no
    wrapper)."""
    n = eager + sum(1 + k for k in graphs)
    want = {k: v * n for k, v in per_step.items()}
    for k in IMPLICIT_SOLVES:
        want[k] += 1 if per_step[k] else 0
    return want


def check_finite(state, what, dtype):
    for k, v in state.items():
        if v.dtype != dtype or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"{what}: {k} is not a finite {dtype} field")


def driver_line(dev, smi, launches, replay_5a_ms):
    """Phase 5f, the driver.  (a) The CLI's flagship run (``cli.main``:
    UMJS with its perturbation and Rayleigh layer, ne30 p4 L30 f32, dt 100
    s, the fused implicit kernel, 40 steps, checksums, invariants, lat-lon
    NetCDF output and checkpoints every 20 steps): its timers, its
    checkpoints (the arena library built here: ``.tarena`` files), its final
    state bitwise equal to ``first_step`` and three replays of a 13-step
    graph of ``make_fast_multistep``, whose replays also give the ms/step
    of the same configuration; restarts from the step-20 checkpoint, as
    ``.tarena`` and as ``.npz``, continued bit for bit to step 40; a run
    without hooks, timed and profiled; what one firing of each output costs.
    (b) The Held-Suarez case, 20 steps, the physics every step.  (c) The
    DCMIP2016 tropical cyclone with Kessler and the simple physics every
    step, 10 steps: finite, no species negative, total water within 5 %.
    Each run starts with the launch counts at 0 and is checked against the
    steps it captured."""
    import tempfile
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import cli, fast
    from tempestmodel_tpu_torch.io.output import (
        CompositeCheckpoint, ChecksumOutput, EnergyOutput, ReferenceOutput)
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.physics.dcmip_simple import (
        DCMIPSimplePhysics)
    from tempestmodel_tpu_torch.physics.kessler import KesslerPhysics
    from tempestmodel_tpu_torch.testcases.dcmip2016 import TropicalCyclone
    per_step = fused_per_step(tuple(fast.engine.DSS_MERGE_DEFAULT))
    every_s = DRIVER_EVERY * DT
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the CLI run
        argv = DRIVER_ARGV + ["--output_dir", tmp]
        text, cli_s, launches["driver"] = run_cli(argv, dev)
        timers = parse_timers(text)
        want = driver_counts(per_step, (DRIVER_EVERY - 1, DRIVER_EVERY))
        if launches["driver"] != want:
            raise RuntimeError(f"driver: launch counts {launches['driver']} "
                               f"!= expected {want}")
        files = sorted(os.listdir(tmp))
        nc = [f for f in files if f.endswith(".nc")]
        tarena = [f for f in files if f.endswith(".tarena")]
        if len(nc) != DRIVER_STEPS // DRIVER_EVERY + 1 or len(tarena) != 2:
            raise RuntimeError(f"driver: wrote {files}; expected 3 NetCDF "
                               f"files and 2 .tarena checkpoints (the arena "
                               f"library builds with g++)")
        path20, path40 = (os.path.join(tmp, f"restart.{t:012.2f}.tarena")
                          for t in (every_s, DRIVER_STEPS * DT))
        final = CompositeCheckpoint.load(path40, device=dev)[0]
        rest = DRIVER_STEPS - DRIVER_EVERY
        check_finite(final, "driver", torch.float32)
        loop_ms = timers["Loop"][0]
        ms_cli = loop_ms / DRIVER_STEPS

        # the same configuration, stepped directly
        args = cli.make_parser().parse_args(argv)
        tc, cfg, _ = cli.configure(args)
        m = Model(cfg, tc, device=dev)
        first_step, multi = fast.make_fast_multistep(
            cfg, m.geom, DRIVER_GRAPH, ref_state=m.reference, device=dev)
        X, c = first_step(fast.pack_state(m.state, device=dev))
        for _ in range((DRIVER_STEPS - 1) // DRIVER_GRAPH):
            X, c = multi(X, c)
        direct = fast.unpack_state(X)
        if not all(torch.equal(final[k], direct[k]) for k in direct):
            raise RuntimeError("driver: the CLI run's step-40 state is not "
                               "bitwise the direct run's")
        replay_ms = []
        for _ in range(REPLAYS):
            sync(dev)
            t0 = time.perf_counter()
            X, c = multi(X, c)
            sync(dev)
            replay_ms.append(1e3 * (time.perf_counter() - t0)
                             / DRIVER_GRAPH)
        replay_same = sorted(replay_ms)[len(replay_ms) // 2]
        del first_step, multi, X, c, direct

        # restarts from step 20: the .tarena file, then an .npz one
        restarts = {}
        m.restart_from(path20)
        sync(dev)
        t0 = time.perf_counter()
        m.go(nsteps=rest)                   # its graph captured here
        capture_go_ms = 1e3 * (time.perf_counter() - t0) / rest
        restarts["tarena"] = all(torch.equal(m.state[k], final[k])
                                 for k in final)
        m.restart_from(path20)
        npz_path = CompositeCheckpoint(every_s, tmp, prefix="npz",
                                       fmt="npz").output(m, m.time)
        m.restart_from(npz_path)
        sync(dev)
        t0 = time.perf_counter()
        m.go(nsteps=rest)                   # no hooks, its graph captured
        no_hooks_ms = 1e3 * (time.perf_counter() - t0) / rest
        restarts["npz"] = all(torch.equal(m.state[k], final[k])
                              for k in final)
        if not all(restarts.values()):
            raise RuntimeError(f"driver: restarts bit for bit {restarts}")
        m.restart_from(npz_path)
        prof = profile_steps(lambda x, c: (m.go(nsteps=rest), c),
                             None, None, 1, "driver_no_hooks", rest) \
            if dev.type == "cuda" else {"device_ms_per_step": None}

        # one firing of each output at step 40, and what a hook that
        # replaces the state costs: one pack and one unpack
        m.restart_from(path20)
        m.go(nsteps=rest)
        sync(dev)
        t0 = time.perf_counter()
        fast.unpack_state(fast.pack_state(m.state, device=dev))
        sync(dev)
        breakdown = {"pack_and_unpack": 1e3 * (time.perf_counter() - t0)}
        ref = ReferenceOutput(every_s, tmp, prefix="again", fmt="nc")
        for name, om in (("checksums", ChecksumOutput(every_s)),
                         ("invariants", EnergyOutput(every_s)),
                         ("latlon_nc_first", ref), ("latlon_nc", ref),
                         ("checkpoint_tarena",
                          CompositeCheckpoint(every_s, tmp, prefix="again"))):
            t0 = time.perf_counter()
            om.output(m, m.time)
            sync(dev)
            breakdown[name] = 1e3 * (time.perf_counter() - t0)
        del m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        results["flagship"] = {
            "phase": "driver", "path": "cli", "argv": argv[:-2],
            "steps": DRIVER_STEPS, "cli_main_s": cli_s,
            "wall_ms_per_step": ms_cli, "loop_ms": loop_ms,
            "step_timer_mean_min_max_ms": [timers["Step"][0],
                                           timers["Step"][2],
                                           timers["Step"][3]],
            "step_timer_count": timers["Step"][1],
            "output_timer_mean_ms": timers["Output"][0],
            "output_timer_count": timers["Output"][1],
            "output_ms_per_step": timers["Output"][0] * timers["Output"][1]
            / DRIVER_STEPS,
            "one_firing_ms": breakdown,
            "model_go_no_hooks_ms_per_step": no_hooks_ms,
            "model_go_no_hooks_with_capture_ms_per_step": capture_go_ms,
            "device_busy_ms_per_step_no_hooks": prof["device_ms_per_step"],
            "replay_ms_per_step_same_config": replay_same,
            "replay_ms_each": replay_ms,
            "replay_ms_per_step_phase5a_no_rayleigh": replay_5a_ms,
            "over_same_config_replay": ms_cli / replay_same - 1.0,
            "bitwise_direct": True, "bitwise_restarts": restarts,
            "checkpoint_files": tarena, "netcdf_files": nc,
            "launches": launches["driver"], "card": smi}
        emit(results["flagship"])

        # (b) Held-Suarez every step
        argv = ["--case", "held_suarez", "--resolution", str(NE),
                "--levels", str(NZ), "--order", str(ORDER), "--fp32",
                "--vmethod", "V2", "--dt", f"{DT:g}s", "--nsteps",
                str(HS_STEPS), "--output_dir", os.path.join(tmp, "hs"),
                "--output_restart_dt", f"{HS_STEPS * DT:g}s"]
        text, cli_s, launches["driver_held_suarez"] = run_cli(argv, dev)
        timers = parse_timers(text)
        want = driver_counts(per_step, (1,))
        if launches["driver_held_suarez"] != want:
            raise RuntimeError(f"Held-Suarez: launch counts "
                               f"{launches['driver_held_suarez']} != {want}")
        hs = CompositeCheckpoint.load(os.path.join(
            tmp, "hs", f"restart.{HS_STEPS * DT:012.2f}.tarena"),
            device=dev)[0]
        check_finite(hs, "Held-Suarez", torch.float32)
        loop_ms = timers["Loop"][0]
        wp_ms, wp_n = timers["WorkflowProcess"][:2]
        steps_ms = timers["Step"][0] * timers["Step"][1] + wp_ms * wp_n
        results["held_suarez"] = {
            "phase": "driver", "path": "held_suarez", "steps": HS_STEPS,
            "cli_main_s": cli_s, "wall_ms_per_step": loop_ms / HS_STEPS,
            "ms_per_step_steps_and_physics": steps_ms / HS_STEPS,
            "step_timer_mean_min_max_ms": [timers["Step"][0],
                                           timers["Step"][2],
                                           timers["Step"][3]],
            "checkpoint_ms": timers["Output"][0],
            "physics_ms_per_firing": wp_ms, "physics_firings": wp_n,
            "physics_share_of_steps_and_physics": wp_ms * wp_n / steps_ms,
            "launches": launches["driver_held_suarez"], "card": smi}
        emit(results["held_suarez"])

    # (c) the tropical cyclone with Kessler and the simple physics
    from tempestmodel_tpu_torch.kernels import counts
    tc = TropicalCyclone()
    cfg = tm.ModelConfig(
        grid_kind=tm.GridKind.CUBED_SPHERE,
        equation_set=tm.EquationSet.PRIMITIVE_NONHYDRO, ne=NE, order=ORDER,
        nz=NZ, ztop=tc.ztop, dt=DT, nu_scalar=NU, nu_div=NU, nu_vort=NU,
        vertical_solver="pallas", dtype=torch.float32)
    t0 = time.perf_counter()
    m = Model(cfg, tc, workflow_processes=[KesslerPhysics(0.0),
                                           DCMIPSimplePhysics(0.0)],
              device=dev)
    setup_s = time.perf_counter() - t0
    area = m.geom_dev.area3d.double()

    def water(state):
        return float((state["Tracers"].double() * area).sum())

    w0 = water(m.state)
    counts.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    m.go(nsteps=TC_STEPS)
    sync(dev)
    tc_ms = 1e3 * (time.perf_counter() - t0) / TC_STEPS
    launches["driver_tropical_cyclone"] = dict(counts.launch_counts)
    want = driver_counts(moist(per_step), (1,))
    if launches["driver_tropical_cyclone"] != want:
        raise RuntimeError(f"tropical cyclone: launch counts "
                           f"{launches['driver_tropical_cyclone']} != {want}")
    check_finite(m.state, "tropical cyclone", torch.float32)
    w1 = water(m.state)
    qmin = float(m.state["Tracers"].min())
    if not (abs(w1 / w0 - 1.0) < 0.05 and qmin >= 0.0):
        raise RuntimeError(f"tropical cyclone: water {w0} -> {w1}, least "
                           f"species value {qmin}")
    wp = m.timers.groups["WorkflowProcess"]
    # one more firing of each physics package, timed alone
    physics_ms = {}
    for p in m.workflow_processes:
        sync(dev)
        t0 = time.perf_counter()
        m.state = p.fire(m, m.time)
        sync(dev)
        physics_ms[type(p).__name__] = 1e3 * (time.perf_counter() - t0)
    results["tropical_cyclone"] = {
        "phase": "driver", "path": "tropical_cyclone",
        "config": f"DCMIP2016 tropical cyclone ne{NE} p{ORDER} nz{NZ} "
                  f"+3 tracers f32 dt{DT:g}, Kessler + simple physics",
        "steps": TC_STEPS, "setup_s": setup_s, "ms_per_step": tc_ms,
        "physics_ms_per_step": 1e3 * wp.total / TC_STEPS,
        "one_firing_ms": physics_ms,
        "total_water_before": w0, "total_water_after": w1,
        "least_species_value": qmin,
        "launches": launches["driver_tropical_cyclone"], "card": smi}
    emit(results["tropical_cyclone"])
    del m
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return results


def replay_in_turns(variants, nsteps):
    """Each variant's ``replay(state) -> state`` (a graph of ``nsteps``
    steps) once untimed, then timed by CUDA events in turns, forward then
    backward; appends ms/step to each variant's ``"ms"``."""
    for v in variants.values():
        v["state"] = v["replay"](v["state"])
    torch.cuda.synchronize()
    for name in list(variants) + list(variants)[::-1]:
        v = variants[name]
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        v["state"] = v["replay"](v["state"])
        ev1.record()
        torch.cuda.synchronize()
        v["ms"].append(ev0.elapsed_time(ev1) / nsteps)


def dss_merges_imex(dev, smi, icfg, geom, state, launches):
    """Phase 6, IMEX: the IMEX flagship (``imex_line``'s configuration)
    with each of the four DSS groupings, each a 10-step graph captured with
    the counts at 0 and checked, replayed in turns."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    variants = {}
    for merge in DSS_MERGES:
        name = "+".join(merge) or "separate"
        step = fast.make_fast_imex_step(icfg, geom, device=dev,
                                        dss_merge=merge)
        counts.reset_launch_counts()
        replay = capture_imex(step, state, INNER_STEPS)
        torch.cuda.synchronize()
        launches[f"imex_{name}"] = dict(counts.launch_counts)
        want = {k: v * (INNER_STEPS + 1)
                for k, v in imex_per_step(merge).items()}
        if launches[f"imex_{name}"] != want:
            raise RuntimeError(f"IMEX dss {name}: launch counts "
                               f"{launches[f'imex_{name}']} != {want}")
        variants[name] = {"replay": replay, "state": state, "ms": []}
    replay_in_turns(variants, INNER_STEPS)
    for name, v in variants.items():
        if not all(bool(torch.isfinite(x).all()) for x in v["state"].values()):
            raise RuntimeError(f"IMEX dss {name}: non-finite fields")
    out = {name: {"replay_ms_per_step": v["ms"],
                  "launches_per_step": imex_per_step(
                      tuple(name.split("+")) if name != "separate" else ())}
           for name, v in variants.items()}
    emit({"phase": "dss", "config": f"IMEX {IMEX_SCHEME} UMJS ne{NE} "
          f"p{ORDER} nz{NZ} f32 dt{icfg.dt:g}", "inner_steps": INNER_STEPS,
          "order": "forward then backward, one replay each",
          "variants": out, "fastest_under_replay": min(
              variants, key=lambda n: min(variants[n]["ms"])),
          "default": "+".join(fast.engine.DSS_MERGE_DEFAULT) or "separate",
          "card": smi})
    del variants
    torch.cuda.empty_cache()


def dss_merges_schar(dev, smi, launches):
    """Phase 6, Schar: the Schar slice at the JAX bench's size (its default
    layout, its sponge on) through ``make_fast_multistep`` with each of the
    four DSS groupings, each captured with the counts at 0 and checked,
    replayed in turns."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    _, cfg, geom, state, ref = cartesian_setup(
        "schar", torch.float32, SCHAR_NEX, 1, SCHAR_NZ, dev)
    X0 = fast.pack_state(state, device=dev)
    variants = {}
    for merge in DSS_MERGES:
        name = "+".join(merge) or "separate"
        first, multi = fast.make_fast_multistep(
            cfg, geom, INNER_STEPS, ref_state=ref, device=dev,
            dss_merge=merge)
        counts.reset_launch_counts()
        X, carry = multi(*first(X0))     # warm-up step, capture, replay
        torch.cuda.synchronize()
        launches[f"schar_{name}"] = dict(counts.launch_counts)
        per_step = dict(fused_per_step(merge), nu4_pass1=0, nu4_pass2=0)
        want = {k: v * (INNER_STEPS + 2) + (1 if k == "fused_implicit_update"
                                            else 0)
                for k, v in per_step.items()}
        if launches[f"schar_{name}"] != want:
            raise RuntimeError(f"Schar dss {name}: launch counts "
                               f"{launches[f'schar_{name}']} != {want}")
        variants[name] = {"replay": lambda s, m=multi: m(*s),
                          "state": (X, carry), "ms": [],
                          "per_step": per_step}
    replay_in_turns(variants, INNER_STEPS)
    out = {name: {"replay_ms_per_step": v["ms"],
                  "launches_per_step": v["per_step"]}
           for name, v in variants.items()}
    emit({"phase": "dss", "config": f"Schar x-z nex{SCHAR_NEX} p{ORDER} "
          f"nz{SCHAR_NZ} f32 dt{SCHAR_DT:g}, default layout",
          "inner_steps": INNER_STEPS,
          "order": "forward then backward, one replay each",
          "variants": out, "fastest_under_replay": min(
              variants, key=lambda n: min(variants[n]["ms"])),
          "default": "+".join(fast.engine.DSS_MERGE_DEFAULT) or "separate",
          "card": smi})
    del variants
    torch.cuda.empty_cache()


def schar_line(dev, smi, launches, profiles, profile):
    """Phase 5d: the Schar mountain waves at the JAX bench's size (x-z
    slice, nex 100, p 4, 40 levels, f32, dt 0.5) through
    ``make_fast_multistep`` (a 10-step CUDA graph) in both layouts -- each
    captured with the counts at 0 and read just after, then timed by CUDA
    events in turns (swapped, natural, natural, swapped, ...), the median of
    4 replays each -- and on the eager fused path of ``make_fast_step`` (the
    default layout, first_step + 5 steps).  Returns {layout: ms/step under
    replay, "default": the default layout}."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    tc, cfg, geom, state, ref = cartesian_setup(
        "schar", torch.float32, SCHAR_NEX, 1, SCHAR_NZ, dev)
    X0 = fast.pack_state(state, device=dev)
    npts = SCHAR_NEX * ORDER * ORDER * SCHAR_NZ      # bench.py's count
    config = (f"Schar mountain x-z nex{SCHAR_NEX} p{ORDER} nz{SCHAR_NZ} f32 "
              f"dt{SCHAR_DT:g} nu{SCHAR_NU:g}")
    default = fast.engine.swap_ab_default(geom)
    per_step = dict(fused_per_step(fast.engine.DSS_MERGE_DEFAULT),
                    nu4_pass1=0, nu4_pass2=0)

    def check(X, what):
        for k, v in X.items():
            nzk = SCHAR_NZ + (1 if k == "W" else 0)
            if tuple(v.shape) != (nzk, 1, SCHAR_NEX * ORDER, ORDER) \
                    or v.dtype != torch.float32 \
                    or not bool(torch.isfinite(v).all()):
                raise RuntimeError(f"{what}: {k} is not a finite float32 "
                                   f"field of the natural layout")
        drift = {k: rel_err(X[k], X0[k]) for k in ("Rho", "Rt")}
        if not all(dd < 1e-2 for dd in drift.values()):
            raise RuntimeError(f"{what}: state drifted {drift}")
        return drift

    runs = {}
    for layout in ("swapped", "natural"):
        swap = layout == "swapped"
        t0 = time.perf_counter()
        first, multi = fast.make_fast_multistep(cfg, geom, INNER_STEPS,
                                                ref_state=ref, device=dev,
                                                swap_ab=swap)
        make_s = time.perf_counter() - t0
        counts.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        X, carry = first(X0)
        t0 = time.perf_counter()
        X, carry = multi(X, carry)       # warm-up step, capture, first replay
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        launches[f"schar_{layout}"] = dict(counts.launch_counts)
        want = {k: v * (INNER_STEPS + 2) + (1 if k == "fused_implicit_update"
                                            else 0)
                for k, v in per_step.items()}
        if launches[f"schar_{layout}"] != want:
            raise RuntimeError(f"Schar {layout}: launch counts "
                               f"{launches[f'schar_{layout}']} != {want}")
        runs[layout] = {"multi": multi, "X": X, "carry": carry, "ms": [],
                        "make_s": make_s, "capture_s": capture_s,
                        "peak": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "resident": resident / 2 ** 30}
    order = ["swapped", "natural", "natural", "swapped"] * (REPLAYS // 2)
    for layout in order:
        r = runs[layout]
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        r["X"], r["carry"] = r["multi"](r["X"], r["carry"])
        ev1.record()
        torch.cuda.synchronize()
        r["ms"].append(ev0.elapsed_time(ev1) / INNER_STEPS)
    result = {"default": "swapped" if default else "natural"}
    for layout, r in runs.items():
        ms = sorted(r["ms"])[len(r["ms"]) // 2]
        result[layout] = ms
        emit({"phase": "schar", "path": "multistep", "layout": layout,
              "default_layout": layout == ("swapped" if default
                                           else "natural"),
              "config": config, "inner_steps": INNER_STEPS,
              "replays": len(r["ms"]), "ms_per_step": ms,
              "ms_per_step_each_replay": r["ms"],
              "gridpoint_steps_per_s": npts / (ms * 1e-3),
              "launches": launches[f"schar_{layout}"],
              "launches_per_step": per_step,
              "launches_counted": "at capture (first_step + 1 warm-up step + "
                                  f"{INNER_STEPS} captured steps)",
              "make_fast_multistep_s": r["make_s"],
              "warmup_capture_first_replay_s": r["capture_s"],
              "drift": check(r["X"], f"Schar {layout}"),
              "peak_device_GiB": r["peak"],
              "resident_before_GiB": r["resident"], "card": smi})
        if profile:
            profiles[f"schar_{layout}"] = profile_steps(
                r["multi"], r["X"], r["carry"], 2, f"schar_{layout}",
                INNER_STEPS)
    del runs
    torch.cuda.empty_cache()

    first, step = fast.make_fast_step(cfg, geom, ref_state=ref, device=dev)
    Xw, cw = step(*first(X0))            # warm-up outside the counted run
    torch.cuda.synchronize()
    del Xw, cw
    counts.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    X, carry = first(X0)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    for _ in range(FLAGSHIP_STEPS):
        X, carry = step(X, carry)
    ev1.record()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / FLAGSHIP_STEPS
    ms = ev0.elapsed_time(ev1) / FLAGSHIP_STEPS
    launches["schar_eager"] = dict(counts.launch_counts)
    want = {k: v * (FLAGSHIP_STEPS + 1) + (1 if k == "fused_implicit_update"
                                           else 0)
            for k, v in per_step.items()}
    if launches["schar_eager"] != want:
        raise RuntimeError(f"Schar eager: launch counts "
                           f"{launches['schar_eager']} != {want}")
    emit({"phase": "schar", "path": "fused",
          "layout": "swapped" if default else "natural", "config": config,
          "steps": FLAGSHIP_STEPS, "ms_per_step": ms, "wall_ms_per_step": wall,
          "gridpoint_steps_per_s": npts / (ms * 1e-3),
          "launches": launches["schar_eager"], "launches_per_step": per_step,
          "drift": check(X, "Schar eager"),
          "peak_device_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
          "resident_before_GiB": resident / 2 ** 30, "card": smi})
    if profile:
        profiles["schar_eager"] = profile_steps(step, X, carry, 3,
                                                "schar_eager")
    del first, step, X, carry
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# terrain on the cubed sphere and the shear jet over a mountain
# ---------------------------------------------------------------------------

def terrain_setup(name, dtype, ne, nz, dev=None):
    """(test case, cfg, geom[, start, reference]) of a sphere case over a
    mountain, with the case's own ztop and constants, its topography
    ``topography(lon, lat, c)`` handed to the geometry as a lambda (as the
    JAX package's tests do) and its Rayleigh layer: ``"rossby"``
    (``MountainRossby3D``: 2 km mountain at 30N, Rayleigh, nu4; dt 100 s on
    the flagship grid, 200 s below it), ``"schar"``
    (``ScharMountainSphere`` on the X=500 planet: Rayleigh, no
    hyperdiffusion, dt 0.4 s) or ``"jw"`` (``BaroclinicWaveJW`` with its
    perturbation: the surface geopotential, nu4, dt 200 s).  The geometry is
    built in ``dtype``.  With ``dev`` also the start (Schar and JW with the
    seeded W of ``tests/test_torch_terrain_sphere.py``: from rest the
    implicit Jacobian's upwind sign is that of roundoff there) and the
    reference state where the case damps."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases import nonhydro_sphere as nsp
    tc, dt, hyper, ray = {
        "rossby": (nsp.MountainRossby3D(), DT if ne == NE else 200.0, True,
                   True),
        "schar": (nsp.ScharMountainSphere(), 0.4, False, True),
        "jw": (nsp.BaroclinicWaveJW(pert="exp"), 200.0, True, False)}[name]
    c = tc.constants(tm.PhysicalConstants()) if hasattr(tc, "constants") \
        else tm.PhysicalConstants()
    cfg = tm.ModelConfig(
        grid_kind=tm.GridKind.CUBED_SPHERE,
        equation_set=tm.EquationSet.PRIMITIVE_NONHYDRO, ne=ne, order=ORDER,
        nz=nz, ztop=tc.ztop, dt=dt, constants=c, hyperdiffusion=hyper,
        nu_scalar=NU, nu_div=NU, nu_vort=NU, rayleigh_damping=ray,
        vertical_solver="pallas", dtype=dtype)
    geom = nh_model.build_nh_sphere_geometry(
        cfg, ztop=tc.ztop,
        topography=lambda lon, lat: tc.topography(lon, lat, c),
        rayleigh=tc.rayleigh_strength if ray else None)
    if dev is None:
        return tc, cfg, geom
    state = tc.initial_state(geom, c, dtype=dtype, device=dev)
    if name != "rossby":
        w = W_SEEDED * np.random.default_rng(7).standard_normal(
            tuple(state["W"].shape))
        w[..., 0] = w[..., -1] = 0.0
        state["W"] = torch.as_tensor(w, device=dev).to(dtype)
    ref = tc.reference_state(geom, c, dtype=dtype, device=dev) \
        if ray else None
    return tc, cfg, geom, state, ref


def terrain_terms(fg):
    """The largest terrain term of a fast geometry's metric: |dZs/da| and
    |dZs/db| through ``deriv_r_a/b``, and the contravariant
    ``con_a_xi`` / ``con_b_xi`` (the separable factors where they hold)."""
    names = (("sep_da", "sep_db", "sep_ca", "sep_cb") if fg.sep_ok
             else ("deriv_r_a", "deriv_r_b", "con_a_xi", "con_b_xi"))
    return {k: float(getattr(fg, k).abs().max()) for k in names}


def check_terrain_stage(dev, rows):
    """Phase 3, terrain: ``fused_stage`` at the flagship shape over a real
    mountain, ``MountainRossby3D``'s metric at ne30 p4 L30 (the geometry
    built in float64, so its Gal-Chen factorization holds and the
    separable fields are real; the fast geometry cast to each dtype),
    against the plain version in float32 and float64 (phase 3's
    tolerances), in the separable form and in the full 3-D form (the form
    a float32 geometry takes on the main path, phase 5g), one base and two,
    each timed beside phase 3's flagship line (the flat grid with a
    synthetic separable metric).  Returns the float64 host geometry."""
    import dataclasses
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import stage_cuda
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    t0 = time.perf_counter()
    _, cfg, geom = terrain_setup("rossby", torch.float64, NE, NZ)
    consts = cfg.constants
    setup_s = time.perf_counter() - t0
    for dtype in (torch.float64, torch.float32):
        tag = "f32" if dtype == torch.float32 else "f64"
        tol = 1e-4 if dtype == torch.float32 else 1e-11
        fg = fast.build_fast_geometry(geom, dtype=dtype, device=dev)
        terms = terrain_terms(fg)
        if not fg.sep_ok or not min(terms.values()) > 0.0:
            raise RuntimeError(f"terrain stage {tag}: the Rossby metric is "
                               f"not separable with terrain terms {terms}")
        ue, b1, b2 = (synthetic.random_state(fg, seed) for seed in (1, 2, 3))
        two = ((0.3, b1), (0.7, b2))
        line = {"phase": "kernel", "name": "fused_stage_terrain",
                "dtype": tag, "tol": tol,
                "config": f"MountainRossby3D ne{NE} p{ORDER} nz{NZ}, the "
                          f"geometry built in f64", "terrain_terms": terms,
                "host_geometry_s": setup_s,
                "flat_flagship_ms": rows["fused_stage_ms"][tag]}
        for form, g in (("separable", fg),
                        ("full3d", dataclasses.replace(fg, sep_ok=False))):
            st = stage_cuda.stage_statics(g)
            if st.use_sep != (form == "separable"):
                raise RuntimeError(f"terrain stage: statics chose the wrong "
                                   f"metric form for {form}")
            err = 0.0
            for base in (b1, two):
                got, gwf = stage_cuda.fused_stage(base, ue, 12.5, g, consts,
                                                  defer_w=True, statics=st)
                torch.cuda.synchronize()
                want, wwf = stage_cuda.fused_stage_plain(
                    base, ue, 12.5, g, consts, defer_w=True)
                err = max(err, max_rel_err(
                    [got[k] for k in stage_cuda.STATE4] + [gwf["dW"]],
                    [want[k] for k in stage_cuda.STATE4] + [wwf["dW"]]))
            if not err <= tol:
                raise RuntimeError(f"fused_stage over the mountain, {tag} "
                                   f"{form}: rel err {err} > {tol}")
            tb, c1, x1, c2, x2 = stage_cuda._split_base(b1)
            ms = time_cuda(lambda: stage_cuda._fused_stage_cuda(
                tb, c1, x1, c2, x2, ue, 12.5, g, consts, st), [()], reps=20,
                queued=True)
            # reads: 4 level + 1 interface evaluation fields, 4 base
            # fields, the 2-D metric (12 fields separable, 5 else), the 3-D
            # metric (6 level and 3 interface fields, 3-D form only) and
            # the table; writes 5 level fields
            K, P, A = g.nz, 6, g.A
            nlev, nint, n2d = K * P * A * A, (K + 1) * P * A * A, P * A * A
            esize = torch.empty((), dtype=dtype).element_size()
            n3d = 0 if form == "separable" else 6 * nlev + 3 * nint
            nb = ((4 + 4 + 5) * nlev + nint + st.m2d.numel() + n3d
                  + st.tab.numel()) * esize
            bnd, by = bound_ms(nb, 400 * nlev, dtype)
            line[form] = {"max_abs_err": err, "ms": ms, "bound_ms": bnd,
                          "bound_by": by,
                          "launch": stage_cuda.launch_config(b1, ue, g, st)}
            if dtype == torch.float32:
                rows["fused_stage"][f"ms_terrain_{form}"] = ms
        emit(line)
        del fg, ue, b1, b2, two
    torch.cuda.empty_cache()
    return geom


def check_terrain_slice(dev):
    """Phase 4, terrain: 3 steps in float64 on the card over a mountain,
    ``MountainRossby3D``, ``ScharMountainSphere`` (X=500) and JW at ne4 p4
    nz8 (the geometry in float64: the separable metric with its terrain
    terms) and ``ShearJetMountainWave`` at nex 8 nz 8 in both layouts: the
    kernel path against the plain path to 1e-11 per field (x-z: U and V
    against their common scale), then ``make_fast_multistep(3)`` against
    ``first_step`` + 3 eager steps, bit for bit.  The launched kernels are
    those of the fused path (no nu4 where the case has no hyperdiffusion or
    the x-z terrain makes the Jacobian vary in z)."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases import nonhydro_xz
    merge = tuple(fast.engine.DSS_MERGE_DEFAULT)
    cases = [(n, None) for n in ("rossby", "schar", "jw")] + [
        ("shear_jet", True), ("shear_jet", False)]

    def compare_sphere(got, want):
        return {k: rel_err(got[k], want[k]) for k in want}

    for name, swap in cases:
        if name == "shear_jet":
            tc = nonhydro_xz.ShearJetMountainWave()
            cfg = tm.ModelConfig(
                grid_kind=tm.GridKind.CARTESIAN_XZ, nex=8, ney=1,
                order=ORDER, nz=8, x_extent=tc.x_extent,
                y_extent=tc.y_extent, ztop=tc.ztop, dt=1.0,
                hyperdiffusion=True, nu_scalar=SCHAR_NU, nu_div=SCHAR_NU,
                nu_vort=SCHAR_NU, rayleigh_damping=True,
                vertical_solver="pallas", dtype=torch.float64)
            geom = nh_model.build_nh_cartesian_geometry(
                cfg, ztop=tc.ztop, topography=tc.topography,
                rayleigh=tc.rayleigh_strength)
            state = tc.initial_state(geom, cfg.constants, device=dev)
            ref = tc.reference_state(geom, cfg.constants, device=dev)
            what = ("ShearJetMountainWave nex8 nz8 f64, "
                    + ("swapped" if swap else "natural"))
            compare = compare_xz
        else:
            _, cfg, geom, state, ref = terrain_setup(name, torch.float64, 4,
                                                     8, dev)
            what = f"{name} ne4 p4 nz8 f64"
            compare = compare_sphere
        X0 = fast.pack_state(state, device=dev)
        # no nu4 kernels where the x-z terrain makes the Jacobian vary in
        # z; no tail at all (so no dss_state) without hyperdiffusion
        skip = {"rossby": (), "jw": (), "shear_jet": ("nu4_pass1",
                                                     "nu4_pass2"),
                "schar": ("nu4_pass1", "nu4_pass2", "dss_state")}[name]
        want = {k for k, v in fused_per_step(merge).items()
                if v and k not in skip}
        outs = {}
        for path, kw in (("kernels", {}), ("plain", {"plain": True})):
            counts.reset_launch_counts()
            first, step = fast.make_fast_step(cfg, geom, ref_state=ref,
                                              device=dev, swap_ab=swap, **kw)
            X, c = first(X0)
            for _ in range(2):
                X, c = step(X, c)
            torch.cuda.synchronize()
            outs[path] = X
            launched = {k for k, v in counts.launch_counts.items() if v}
            if launched != (want if path == "kernels" else set()):
                raise RuntimeError(f"{what}, {path} path launched "
                                   f"{launched}, expected {want}")
        errs = compare(outs["kernels"], outs["plain"])
        first, step = fast.make_fast_step(cfg, geom, ref_state=ref,
                                          device=dev, swap_ab=swap)
        X1, c1 = first(X0)
        E, ce = X1, c1
        for _ in range(3):
            E, ce = step(E, ce)
        _, multi = fast.make_fast_multistep(cfg, geom, 3, ref_state=ref,
                                            device=dev, swap_ab=swap)
        G, cg = multi(X1, c1)             # captures, then replays
        G2, cg2 = multi(X1, c1)           # a pure replay
        torch.cuda.synchronize()
        bitwise = all(torch.equal(G[k], E[k]) and torch.equal(G2[k], E[k])
                      for k in E) and all(torch.equal(cg2[k], ce[k])
                                          for k in ce)
        finite = all(bool(torch.isfinite(v).all())
                     for v in outs["kernels"].values())
        emit({"phase": "terrain_slice", "config": what + ", 3 steps",
              "kernels_vs_plain": errs, "tol": 1e-11,
              "graph_replay_bitwise_eager": bitwise, "finite": finite})
        if not (max(errs.values()) < 1e-11 and bitwise and finite):
            raise RuntimeError(f"{what}: paths disagree {errs}, replay "
                               f"bitwise {bitwise}, finite {finite}")


def terrain_line(dev, smi, launches, geom64, flat_cfg):
    """Phase 5g: the flagship grid over a mountain, ``MountainRossby3D`` at
    ne30 p4 L30 f32 (its 2 km Gaussian mountain at 30N, ztop 30 km, its
    Rayleigh layer, nu 1e15, dt 100 s), through the entry points a user
    calls: ``make_fast_multistep`` (a 10-step graph, 4 timed replays),
    eager fused steps (1 + 5) and ``Model(...).go`` for 20 steps without
    hooks.  The geometry is built as those entry points build it, in
    float32: the path predicates must give what the JAX package's give for
    this configuration (``TERRAIN_PATH``).  Each run starts with the counts
    at 0 and is held to the dry path's launches per step exactly.  Then, in
    turns, that replay beside the same graph over the float64-built
    geometry (the separable form, ``geom64`` of phase 3) and the flat
    flagship with its Rayleigh layer (``flat_cfg`` with it: UMJS, the
    configuration of phase 5f's direct replay).  Prints ms/step, device
    busy and device launches a step (``utils.devprof``), peak memory, the
    largest terrain term, max |U - U0| and the relative change of the total
    Rho mass."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import hyper_cuda, stage_cuda
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    from tempestmodel_tpu_torch.utils import devprof
    merge = tuple(fast.engine.DSS_MERGE_DEFAULT)
    per_step = fused_per_step(merge)
    t0 = time.perf_counter()
    tc, cfg, geom, state, ref = terrain_setup("rossby", torch.float32, NE,
                                              NZ, dev)
    setup_s = time.perf_counter() - t0
    config = (f"MountainRossby3D ne{NE} p{ORDER} nz{NZ} f32 dt{DT:g} "
              f"nu{NU:g}, Rayleigh, ztop {tc.ztop:g}")
    fg = fast.build_fast_geometry(geom, dtype=cfg.dtype, device=dev)
    path = {"sep_ok": bool(fg.sep_ok),
            "stage": bool(stage_cuda.stage_supported(fg)),
            "nu4": bool(hyper_cuda.supported(fg, cfg))}
    if path != TERRAIN_PATH:
        raise RuntimeError(f"terrain: path predicates {path} != the JAX "
                           f"package's {TERRAIN_PATH}")
    terms = terrain_terms(fg)
    if not min(terms.values()) > 0.0:
        raise RuntimeError(f"terrain: a terrain term is zero {terms}")
    del fg
    X0 = fast.pack_state(state, device=dev)
    area = torch.as_tensor(np.ascontiguousarray(np.moveaxis(
        np.asarray(geom.area3d, np.float64), -1, 0)), device=dev)

    def mass(X):
        return float((X["Rho"].double() * area).sum())

    mass0 = mass(X0)

    def check(X, what):
        check_finite(X, what, torch.float32)
        du = float((X["U"] - X0["U"]).abs().max())
        dmass = mass(X) / mass0 - 1.0
        if not (abs(dmass) < 1e-4 and
                rel_err(X["Rho"], X0["Rho"]) < 1e-2):
            raise RuntimeError(f"{what}: Rho mass changed by {dmass}")
        return {"max_abs_U_minus_U0": du, "rho_mass_rel_change": dmass}

    def check_counts(what, got, nsteps):
        want = {k: v * (nsteps + 1) for k, v in per_step.items()}
        for k in IMPLICIT_SOLVES:
            want[k] += 1 if per_step[k] else 0
        if got != want:
            raise RuntimeError(f"{what}: launch counts {got} != expected "
                               f"{want}")

    # make_fast_multistep: a 10-step graph, 4 timed replays
    first_step, multi = fast.make_fast_multistep(cfg, geom, INNER_STEPS,
                                                 ref_state=ref, device=dev)
    counts.reset_launch_counts()
    # what earlier phases still hold counts in the peak: report it beside
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    X, carry = first_step(X0)
    X, carry = multi(X, carry)          # warm-up step, capture, first replay
    torch.cuda.synchronize()
    launches["terrain"] = dict(counts.launch_counts)
    check_counts("terrain multistep", launches["terrain"], INNER_STEPS + 1)
    replay_ms = []
    for _ in range(REPLAYS):
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        X, carry = multi(X, carry)
        ev1.record()
        torch.cuda.synchronize()
        replay_ms.append(ev0.elapsed_time(ev1) / INNER_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy_ms, nkern = devprof.device_time_ms(multi, X, carry)
    X, carry = multi(X, carry)
    ms = sorted(replay_ms)[len(replay_ms) // 2]
    emit({"phase": "terrain", "path": "multistep", "config": config,
          "path_predicates": path, "path_predicates_jax": TERRAIN_PATH,
          "largest_terrain_terms": terms, "host_setup_s": setup_s,
          "inner_steps": INNER_STEPS, "replays": REPLAYS,
          "steps": 1 + INNER_STEPS * (REPLAYS + 2),
          "ms_per_step": ms, "ms_per_step_each_replay": replay_ms,
          "gridpoint_steps_per_s": 6 * (NE * ORDER) ** 2 * NZ / (ms * 1e-3),
          "device_busy_ms_per_step": busy_ms / INNER_STEPS,
          "device_launches_per_step": nkern / INNER_STEPS,
          "launches": launches["terrain"], "launches_per_step": per_step,
          "launches_counted": "at capture (first_step + 1 warm-up step + "
                              f"{INNER_STEPS} captured steps), not at replay",
          **check(X, "terrain multistep"), "peak_device_GiB": peak,
          "allocated_before_the_run_GiB": held, "card": smi})

    # the same graph over the float64-built geometry (separable form), and
    # the flat flagship with its Rayleigh layer, timed in turns
    variants = {"terrain": {"replay": lambda s: multi(*s),
                            "state": (X, carry), "ms": []}}
    first64, multi64 = fast.make_fast_multistep(cfg, geom64, INNER_STEPS,
                                                ref_state=ref, device=dev)
    variants["terrain_separable"] = {"replay": lambda s: multi64(*s),
                                     "state": first64(X0), "ms": []}
    umjs = BaroclinicWaveUMJS(pert="exp", rayleigh=True)
    fcfg = flat_cfg.with_(rayleigh_damping=True)
    flat_geom = nh_model.build_nh_sphere_geometry(
        fcfg, ztop=umjs.ztop, rayleigh=umjs.rayleigh_strength)
    fref = umjs.reference_state(flat_geom, fcfg.constants, dtype=fcfg.dtype,
                                device=dev)
    ffirst, fmulti = fast.make_fast_multistep(fcfg, flat_geom, INNER_STEPS,
                                              ref_state=fref, device=dev)
    variants["flat_rayleigh"] = {"replay": lambda s: fmulti(*s),
                                 "state": ffirst(fast.pack_state(
                                     umjs.initial_state(
                                         flat_geom, fcfg.constants,
                                         dtype=fcfg.dtype, device=dev),
                                     device=dev)), "ms": []}
    replay_in_turns(variants, INNER_STEPS)
    check(variants["terrain_separable"]["state"][0], "terrain separable")
    emit({"phase": "terrain", "path": "multistep in turns",
          "order": "forward then backward, one replay each",
          "ms_per_step": {k: v["ms"] for k, v in variants.items()},
          "note": "terrain: the geometry built in f32 as the entry points "
                  "build it (the 3-D metric form); terrain_separable: built "
                  "in f64, the fast geometry cast to f32 (the separable "
                  "form); flat_rayleigh: UMJS with its Rayleigh layer",
          "card": smi})
    del variants, first_step, multi, first64, multi64, ffirst, fmulti, X
    del carry, flat_geom
    torch.cuda.empty_cache()

    # eager fused steps: first_step and 5 steps
    first_step, step = fast.make_fast_step(cfg, geom, ref_state=ref,
                                           device=dev)
    Xw, cw = step(*first_step(X0))      # warm-up outside the counted run
    torch.cuda.synchronize()
    del Xw, cw
    counts.reset_launch_counts()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    X, carry = first_step(X0)
    ev0.record()
    for _ in range(FLAGSHIP_STEPS):
        X, carry = step(X, carry)
    ev1.record()
    torch.cuda.synchronize()
    launches["terrain_eager"] = dict(counts.launch_counts)
    check_counts("terrain eager", launches["terrain_eager"], FLAGSHIP_STEPS)
    emit({"phase": "terrain", "path": "fused", "config": config,
          "steps": FLAGSHIP_STEPS,
          "ms_per_step": ev0.elapsed_time(ev1) / FLAGSHIP_STEPS,
          "launches": launches["terrain_eager"],
          **check(X, "terrain eager"), "card": smi})
    del first_step, step, X, carry

    # Model.go, 20 steps without hooks
    t0 = time.perf_counter()
    m = Model(cfg, tc, topography=lambda lon, lat: tc.topography(
        lon, lat, cfg.constants), rayleigh=tc.rayleigh_strength, device=dev)
    setup_s = time.perf_counter() - t0
    counts.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    m.go(nsteps=TERRAIN_STEPS)
    sync(dev)
    go_ms = 1e3 * (time.perf_counter() - t0) / TERRAIN_STEPS
    launches["terrain_model"] = dict(counts.launch_counts)
    want = driver_counts(per_step, (TERRAIN_STEPS - 1,))
    if launches["terrain_model"] != want:
        raise RuntimeError(f"terrain Model.go: launch counts "
                           f"{launches['terrain_model']} != {want}")
    Xm = fast.pack_state(m.state, device=dev)
    drift = check(Xm, "terrain Model")
    # a second go of 19 steps replays the graph the first one captured
    sync(dev)
    t0 = time.perf_counter()
    m.go(nsteps=TERRAIN_STEPS - 1)
    sync(dev)
    again_ms = 1e3 * (time.perf_counter() - t0) / (TERRAIN_STEPS - 1)
    check(fast.pack_state(m.state, device=dev), "terrain Model, again")
    emit({"phase": "terrain", "path": "model_go", "config": config,
          "steps": TERRAIN_STEPS, "setup_s": setup_s,
          "ms_per_step_with_first_step_and_capture": go_ms,
          "ms_per_step_second_go_replay": again_ms,
          "launches": launches["terrain_model"], **drift, "card": smi})
    del m, Xm
    torch.cuda.empty_cache()


def profile_steps(step, X, carry, ncalls, path_name, steps_per_call=1):
    """Optional (``--profile PATH``): device time by kernel over ``ncalls``
    steady calls of ``step`` (each ``steps_per_call`` model steps: 1 for an
    eager step, ``inner_steps`` for a graph replay) of one flagship path,
    from torch.profiler; printed as one JSON line and returned."""
    from torch.profiler import profile, ProfilerActivity
    nsteps = ncalls * steps_per_call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ncalls):
            X, carry = step(X, carry)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        # kernels only: an operator row repeats its kernels' device time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": e.key[:100], "calls": e.count,
                         "device_ms_per_step": dev_us / 1e3 / nsteps})
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    total = sum(r["device_ms_per_step"] for r in rows)
    summary = {"phase": "profile", "path": path_name, "steps": nsteps,
               "wall_ms_per_step_under_profiler": wall_ms / nsteps,
               "device_ms_per_step": total,
               "device_launches_per_step":
                   sum(r["calls"] for r in rows) / nsteps,
               "top": rows[:25]}
    emit(summary)
    return dict(summary, all=rows)


def main():
    args = sys.argv[1:]
    profile_path = None
    if args[:1] == ["--profile"] and len(args) == 2:
        profile_path = args[1]
    elif args:
        print("usage: chip_smoke.py [--profile PATH]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import build, counts
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build ------------------------------------------------------------
    info = build.build_all(verbose=True)
    from tempestmodel_tpu_torch.fast import implicit_cuda, stage_cuda
    resources = stage_cuda.kernel_resources()
    if len(resources) != 8:
        raise RuntimeError(f"the build reported {len(resources)} of the "
                           f"stage kernel's 8 instantiations")
    imp_resources = implicit_cuda.kernel_resources()
    if len(imp_resources) != 5:
        raise RuntimeError(f"the build reported {len(imp_resources)} of the "
                           f"implicit kernel's 5 instantiations")
    from tempestmodel_tpu_torch.fast import dss_cuda, hyper_cuda
    from tempestmodel_tpu_torch.ops import cuda_banded
    nu4_resources = hyper_cuda.kernel_resources()
    if len(nu4_resources) != 8:
        raise RuntimeError(f"the build reported {len(nu4_resources)} of the "
                           f"nu4 kernel's 8 instantiations")
    dss_resources = dss_cuda.kernel_resources()
    if len(dss_resources) != 40:
        raise RuntimeError(f"the build reported {len(dss_resources)} of the "
                           f"band DSS kernel's 40 instantiations")
    multi_resources = cuda_banded.kernel_resources()
    if len(multi_resources) != 48:
        raise RuntimeError(f"the build reported {len(multi_resources)} of "
                           f"the banded solve's 48 instantiations (tile, "
                           f"stream and ring forms)")
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"], "libraries": len(info["libraries"]),
          "fused_stage_registers_and_spills": resources,
          "fused_stage_registers_assumed_by_the_launch_rule": {
              f"f{8 * e}{'+tracers' if tr else ''}": n
              for (e, tr), n in stage_cuda.REGISTERS.items()},
          "fused_implicit_registers_and_spills": imp_resources,
          "fused_implicit_registers_assumed_by_the_launch_rule": {
              f"f{8 * e}": n for e, n in implicit_cuda.REGISTERS.items()},
          "nu4_registers_and_spills": nu4_resources,
          "nu4_registers_assumed_by_the_launch_rule": {
              f"f{8 * e} p4": n for e, n in hyper_cuda.REGISTERS.items()},
          "band_dss_registers_and_spills": dss_resources,
          "banded_solve_registers_and_spills": multi_resources})

    # flagship geometry and state (host numpy, then tensors on the card)
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = tm.ModelConfig(
        grid_kind=tm.GridKind.CUBED_SPHERE, ne=NE, order=ORDER, nz=NZ,
        ztop=tc.ztop, dt=DT, hyperdiffusion=True, nu_scalar=NU, nu_div=NU,
        nu_vort=NU, vertical_solver="pallas", dtype=torch.float32)
    t0 = time.perf_counter()
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    state = tc.initial_state(geom, cfg.constants, dtype=cfg.dtype, device=dev)
    fg = fast.build_fast_geometry(geom, dtype=cfg.dtype, device=dev)
    emit({"phase": "setup", "host_geometry_and_state_s":
          time.perf_counter() - t0})

    # 3. kernels against their plain versions -----------------------------
    rows = check_kernels(fg, cfg, geom, state, dev)
    del fg
    geom64 = check_terrain_stage(dev, rows)

    # 4. the slice at small size, three ways, dry and with tracers --------
    check_slice(dev)
    check_slice(dev, with_tracers=True)
    cart_launches = check_cartesian_slice(dev)
    check_imex_slice(dev)
    check_terrain_slice(dev)

    # 5. the main paths at full width -------------------------------------
    X0 = fast.pack_state(state, device=dev)
    npts = 6 * (NE * ORDER) ** 2 * NZ
    config = f"UMJS ne{NE} p{ORDER} nz{NZ} f32 dt{DT:g} nu{NU:g}"
    default_merge = tuple(fast.engine.DSS_MERGE_DEFAULT)
    launches, profiles = {}, {}

    def check_state(X, what, X0=X0):
        for k, v in X.items():
            nzk = {"W": NZ + 1, "Tracers": NTR * NZ}.get(k, NZ)
            if tuple(v.shape) != (nzk, 6, NE * ORDER, NE * ORDER):
                raise RuntimeError(f"{what}: {k} has shape {tuple(v.shape)}")
            if v.dtype != torch.float32 or not bool(torch.isfinite(v).all()):
                raise RuntimeError(f"{what}: {k} is not finite float32")
        # the wave must have stayed near its balanced start: density and
        # rho*theta move by a small fraction over a few steps
        drift = {k: rel_err(X[k], X0[k]) for k in ("Rho", "Rt")}
        if not all(d < 1e-2 for d in drift.values()):
            raise RuntimeError(f"{what}: state drifted {drift}")
        return drift

    def check_counts(what, got, per_step, nsteps):
        """``nsteps`` steps and one ``first_step``, which has one more
        implicit solve."""
        want = {k: v * (nsteps + 1) for k, v in per_step.items()}
        for k in IMPLICIT_SOLVES:
            want[k] += 1 if per_step[k] else 0
        if got != want:
            raise RuntimeError(f"{what}: launch counts {got} != expected "
                               f"{want}")

    def timed(fn, X, carry, ncalls):
        """``ncalls`` calls of ``fn`` one after the other: (X, carry, ms per
        call by CUDA events, wall ms per call)."""
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        for _ in range(ncalls):
            X, carry = fn(X, carry)
        ev1.record()
        torch.cuda.synchronize()
        return (X, carry, ev0.elapsed_time(ev1) / ncalls,
                1e3 * (time.perf_counter() - t0) / ncalls)

    # 5a. this slice's path: make_fast_multistep, a 10-step CUDA graph
    t0 = time.perf_counter()
    first_step, multi = fast.make_fast_multistep(cfg, geom, INNER_STEPS,
                                                 device=dev)
    make_s = time.perf_counter() - t0
    counts.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    X, carry = first_step(X0)
    t0 = time.perf_counter()
    X, carry = multi(X, carry)          # warm-up step, capture, first replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replay_ms = []
    for _ in range(REPLAYS):
        X, carry, ms, _ = timed(multi, X, carry, 1)
        replay_ms.append(ms / INNER_STEPS)
    launches["multistep"] = dict(counts.launch_counts)
    # the wrappers count where they launch, which under a graph is at
    # capture: first_step, the warm-up step and the INNER_STEPS captured
    # steps; the replays launch the same kernels without passing a wrapper
    per_step = fused_per_step(default_merge)
    check_counts("multistep path", launches["multistep"], per_step,
                 INNER_STEPS + 1)
    drift = check_state(X, "flagship, multistep")
    ms_per_step = replay_5a_ms = sorted(replay_ms)[len(replay_ms) // 2]
    emit({"phase": "flagship", "path": "multistep", "config": config,
          "inner_steps": INNER_STEPS, "replays": REPLAYS,
          "steps": INNER_STEPS * (REPLAYS + 1),
          "ms_per_step": ms_per_step, "ms_per_step_each_replay": replay_ms,
          "gridpoint_steps_per_s": npts / (ms_per_step * 1e-3),
          "launches": launches["multistep"], "launches_per_step": per_step,
          "launches_counted": "at capture (first_step + 1 warm-up step + "
                              f"{INNER_STEPS} captured steps), not at replay",
          "dss_merge": default_merge, "make_fast_multistep_s": make_s,
          "warmup_capture_first_replay_s": capture_s, "drift": drift,
          "peak_device_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": smi})
    if profile_path is not None:
        profiles["multistep"] = profile_steps(multi, X, carry, 2,
                                              "multistep", INNER_STEPS)
    del first_step, multi, X, carry
    torch.cuda.empty_cache()

    # 5b. the eager paths of make_fast_step
    for path, kw, nsteps, per_step in (
            ("fused", {}, FLAGSHIP_STEPS, fused_per_step(default_merge)),
            ("unfused", {"fused": False}, UNFUSED_STEPS, UNFUSED_PER_STEP)):
        t0 = time.perf_counter()
        first_step, step = fast.make_fast_step(cfg, geom, device=dev, **kw)
        make_s = time.perf_counter() - t0
        # warm-up outside the counted run (library handles, allocator)
        Xw, cw = first_step(X0)
        Xw, cw = step(Xw, cw)
        torch.cuda.synchronize()
        del Xw, cw

        counts.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        X, carry = first_step(X0)
        X, carry, ms_per_step, wall_ms = timed(step, X, carry, nsteps)
        launches[path] = dict(counts.launch_counts)
        check_counts(f"{path} path", launches[path], per_step, nsteps)
        drift = check_state(X, f"flagship, {path}")
        emit({"phase": "flagship", "path": path, "config": config,
              "steps": nsteps, "ms_per_step": ms_per_step,
              "wall_ms_per_step": wall_ms,
              "gridpoint_steps_per_s": npts / (ms_per_step * 1e-3),
              "launches": launches[path], "launches_per_step": per_step,
              "make_fast_step_s": make_s, "drift": drift,
              "peak_device_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
              "card": smi})
        if profile_path is not None:
            profiles[path] = profile_steps(step, X, carry, 3, path)
        del first_step, step, X, carry
    torch.cuda.empty_cache()

    # 5c. this slice's path: the moist baroclinic wave (the same grid, + 3
    # tracers), under graph replay and eagerly
    from tempestmodel_tpu_torch.testcases.dcmip2016 import MoistBaroclinicWave
    M0 = fast.pack_state(MoistBaroclinicWave().initial_state(
        geom, cfg.constants, dtype=cfg.dtype, device=dev), device=dev)
    area = torch.as_tensor(np.ascontiguousarray(np.moveaxis(
        np.asarray(geom.area3d, np.float64), -1, 0)), device=dev)
    moist_config = (f"DCMIP2016 moist baroclinic wave ne{NE} p{ORDER} nz{NZ} "
                    f"+{NTR} tracers f32 dt{DT:g} nu{NU:g}")

    def species_mass(X):
        """sum(tracer * area3d) of each species, in float64."""
        return [float((X["Tracers"][i * NZ:(i + 1) * NZ].double() * area)
                      .sum()) for i in range(NTR)]

    def check_moist(X, what):
        drift = check_state(X, what, M0)
        mass = species_mass(X)
        if not abs(mass[0] - mass0[0]) <= 1e-4 * mass0[0]:
            raise RuntimeError(f"{what}: the mass of species 0 moved from "
                               f"{mass0[0]} to {mass[0]}")
        if float(X["Tracers"].min()) < 0.0:
            raise RuntimeError(f"{what}: negative tracer values")
        return drift, mass

    mass0 = species_mass(M0)
    if not (mass0[0] > 0.0 and mass0[1] == mass0[2] == 0.0):
        raise RuntimeError(f"moist wave: initial species masses {mass0}")
    per_step = moist(fused_per_step(default_merge))
    t0 = time.perf_counter()
    first_step, multi = fast.make_fast_multistep(cfg, geom, INNER_STEPS,
                                                 device=dev, ntracers=NTR)
    make_s = time.perf_counter() - t0
    counts.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    X, carry = first_step(M0)
    t0 = time.perf_counter()
    X, carry = multi(X, carry)          # warm-up step, capture, first replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replay_ms = []
    for _ in range(REPLAYS):
        X, carry, ms, _ = timed(multi, X, carry, 1)
        replay_ms.append(ms / INNER_STEPS)
    launches["moist_multistep"] = dict(counts.launch_counts)
    check_counts("moist multistep path", launches["moist_multistep"],
                 per_step, INNER_STEPS + 1)
    drift, mass = check_moist(X, "moist wave, multistep")
    ms_per_step = sorted(replay_ms)[len(replay_ms) // 2]
    emit({"phase": "moist", "path": "multistep", "config": moist_config,
          "inner_steps": INNER_STEPS, "replays": REPLAYS,
          "steps": INNER_STEPS * (REPLAYS + 1),
          "ms_per_step": ms_per_step, "ms_per_step_each_replay": replay_ms,
          "gridpoint_steps_per_s": npts / (ms_per_step * 1e-3),
          "launches": launches["moist_multistep"],
          "launches_per_step": per_step,
          "launches_counted": "at capture (first_step + 1 warm-up step + "
                              f"{INNER_STEPS} captured steps), not at replay",
          "make_fast_multistep_s": make_s,
          "warmup_capture_first_replay_s": capture_s, "drift": drift,
          "species_mass_before": mass0, "species_mass_after": mass,
          "peak_device_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": smi})
    if profile_path is not None:
        profiles["moist_multistep"] = profile_steps(
            multi, X, carry, 2, "moist_multistep", INNER_STEPS)
    del first_step, multi, X, carry
    torch.cuda.empty_cache()

    first_step, step = fast.make_fast_step(cfg, geom, device=dev)
    Xw, cw = step(*first_step(M0))      # warm-up outside the counted run
    torch.cuda.synchronize()
    del Xw, cw
    counts.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    X, carry = first_step(M0)
    X, carry, ms_per_step, wall_ms = timed(step, X, carry, MOIST_STEPS)
    launches["moist_eager"] = dict(counts.launch_counts)
    check_counts("moist eager path", launches["moist_eager"], per_step,
                 MOIST_STEPS)
    drift, mass = check_moist(X, "moist wave, eager")
    emit({"phase": "moist", "path": "fused", "config": moist_config,
          "steps": MOIST_STEPS, "ms_per_step": ms_per_step,
          "wall_ms_per_step": wall_ms,
          "gridpoint_steps_per_s": npts / (ms_per_step * 1e-3),
          "launches": launches["moist_eager"], "launches_per_step": per_step,
          "drift": drift, "species_mass_before": mass0,
          "species_mass_after": mass,
          "peak_device_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": smi})
    del first_step, step, X, carry, M0, area
    torch.cuda.empty_cache()

    # 5d. the Schar mountain waves at the JAX bench's size
    schar_ms = schar_line(dev, smi, launches, profiles,
                          profile_path is not None)

    # 5e. the IMEX-ARK step on the flagship grid
    icfg = imex_line(dev, smi, cfg, geom, state, launches, profiles)

    # 5f. this slice's path: the model driver and the CLI
    t0 = time.perf_counter()
    driver_line(dev, smi, launches, replay_5a_ms)
    emit({"phase": "driver", "seconds": time.perf_counter() - t0})

    # 5g. this slice's path: the flagship grid over a mountain
    t0 = time.perf_counter()
    terrain_line(dev, smi, launches, geom64, cfg)
    del geom64
    emit({"phase": "terrain", "seconds": time.perf_counter() - t0})

    if profile_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(profile_path)),
                    exist_ok=True)
        with open(profile_path, "w") as fh:
            json.dump(profiles, fh, indent=1)

    # 6. which DSS launches to merge: the step four ways, eagerly and under
    # graph replay, in turns (forward, then backward) on this one card ------
    variants = {}
    for merge in DSS_MERGES:
        name = "+".join(merge) or "separate"
        first_step, step = fast.make_fast_step(cfg, geom, device=dev,
                                               dss_merge=merge)
        _, multi = fast.make_fast_multistep(cfg, geom, INNER_STEPS,
                                            device=dev, dss_merge=merge)
        X, carry = first_step(X0)
        X, carry = step(X, carry)
        counts.reset_launch_counts()
        Xg, cg = multi(X, carry)                    # capture
        torch.cuda.synchronize()
        launches[name] = dict(counts.launch_counts)
        want = {k: v * (INNER_STEPS + 1)
                for k, v in fused_per_step(merge).items()}
        if launches[name] != want:
            raise RuntimeError(f"dss {name}: launch counts {launches[name]} "
                               f"!= expected {want}")
        variants[name] = {"step": step, "multi": multi, "state": (X, carry),
                          "eager_ms": [], "replay_ms": []}
        del Xg, cg
    for v in variants.values():                     # untimed warm-up turn
        timed(v["step"], *v["state"], 2)
        timed(v["multi"], *v["state"], 1)
    for name in list(variants) + list(variants)[::-1]:
        v = variants[name]
        _, _, ms, _ = timed(v["step"], *v["state"], FLAGSHIP_STEPS)
        v["eager_ms"].append(ms)
        Xg, cg, ms, _ = timed(v["multi"], *v["state"], 3)
        v["replay_ms"].append(ms / INNER_STEPS)
        check_state(Xg, f"dss {name}")
    dss_choice = {name: {"eager_ms_per_step": v["eager_ms"],
                         "replay_ms_per_step": v["replay_ms"],
                         "launches_per_step": fused_per_step(
                             tuple(name.split("+")) if name != "separate"
                             else ())}
                  for name, v in variants.items()}
    fastest = min(variants, key=lambda n: min(variants[n]["replay_ms"]))
    emit({"phase": "dss", "config": config, "inner_steps": INNER_STEPS,
          "order": "forward then backward; eager over "
                   f"{FLAGSHIP_STEPS} steps, replay over 3 replays",
          "variants": dss_choice, "fastest_under_replay": fastest,
          "default": "+".join(default_merge) or "separate", "card": smi})
    del variants
    torch.cuda.empty_cache()
    dss_merges_schar(dev, smi, launches)
    dss_merges_imex(dev, smi, icfg, geom, state, launches)

    # 7. the kernels line, the card, the result ---------------------------
    # launches: the count of the dry flagship's path (the multistep run); for
    # a kernel that path does not run, the count of the run that does: the
    # moist path, the IMEX path (its graph with the default grouping, then
    # with every DSS through dss_state, phase 6), the Strang DSS variants of
    # phase 6, then the unfused path.  Each of these runs began with the
    # counts at 0.  Beside it, the count of the IMEX path (phase 5e's
    # graph), of the Schar path in its default layout (the multistep run of
    # phase 5d) and of the 3-D bubble's kernel path (phase 4); the Cartesian
    # figures of phase 3 (float32) sit under "cartesian".
    schar_default = schar_ms["default"]
    bubble = next(v for k, v in cart_launches.items()
                  if k.startswith("bubble3d"))
    kernels = []
    for name in KERNELS:
        row = dict(rows[name])
        runs = ["multistep", "moist_multistep", "imex_multistep",
                "imex_state", "state+scalar2", "separate", "unfused"]
        row["launches"], row["launches_on"] = next(
            ((launches[r][name], r) for r in runs if launches[r][name]),
            (0, None))
        row["launches_unfused_path"] = launches["unfused"][name]
        row["launches_imex_path"] = launches["imex_multistep"][name]
        if imex_per_step(default_merge)[name] \
                and row["launches_imex_path"] < 1:
            raise RuntimeError(f"{name} was not launched on the IMEX path")
        row["launches_moist_path"] = launches["moist_multistep"][name]
        row["launches_driver_path"] = launches["driver"][name]
        row["launches_driver_tropical_cyclone"] = \
            launches["driver_tropical_cyclone"][name]
        row["launches_terrain_path"] = launches["terrain"][name]
        if fused_per_step(default_merge)[name] \
                and row["launches_terrain_path"] < 1:
            raise RuntimeError(f"{name} was not launched on the terrain "
                               f"path")
        if moist(fused_per_step(default_merge))[name] \
                and row["launches_moist_path"] < 1:
            raise RuntimeError(f"{name} was not launched on the moist path")
        row.update(rows.get(name + "_tracers", {}))
        if row["launches"] < 1:
            raise RuntimeError(f"{name} was launched on no path")
        row["launches_schar_path"] = launches[f"schar_{schar_default}"][name]
        row["launches_bubble3d_slice"] = bubble[name]
        if dict(fused_per_step(default_merge), nu4_pass1=0,
                nu4_pass2=0)[name] and row["launches_schar_path"] < 1:
            raise RuntimeError(f"{name} was not launched on the Schar path")
        cart = {}
        if name in rows["cartesian_dss"]["schar_swapped"]:
            cart = {where: t[name]
                    for where, t in rows["cartesian_dss"].items()}
        elif name == "fused_stage":
            cart = rows["cartesian_stage"]
        elif name == "fused_implicit_update":
            cart = {"schar_swapped": rows["cartesian_implicit"]}
        elif name in ("nu4_pass1", "nu4_pass2"):
            cart = {where: t[name]
                    for where, t in rows["cartesian_nu4"].items()}
        if cart:
            row["cartesian"] = cart
        if name == "fused_stage":
            two = rows["fused_stage_two_base"]
            row.update(ms_two_base=two["ms"], bound_ms_two_base=two["bound_ms"],
                       plain_ms_two_base=two["plain_ms"])
        kernels.append(row)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
