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
            tile, copy route; both above q 8 at the cases of
            ``banded_edges.HIGHQ_CASES`` (q 9-22: the template forms at q
            10 and 16, the wide form else) and timed at q 10, 16 and the
            tracers' q 9 on the flagship's columns; the build line also gives the registers and
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
            form, float32 and float64, timed beside the flagship line; and
            the five DSS modes with the no-flux walls' halo (a halo's wall
            rows and the zero halo; ``dss_state`` with its Rayleigh finish
            and pre-finish wall rows) at the density current's shapes in
            both layouts and the channel's, bit for bit their plain forms,
            timed with and without the walls; then the shallow-water
            shapes: ``dss_vector`` and ``dss_scalar`` at K = 1 on the ne 60
            grid (1, 6, 240, 240), ``dss_scalar`` at (3, 6, 120, 120),
            bit for bit their plain forms, each beside one
            ``torch.sparse.mm``, ``nu4_pass1/2`` in the U, V, H field set
            at (1, 6, 240, 240) against their plain forms, and the
            nonhydrostatic nu4 instantiations' SHA-256 digests at the
            flagship held to the ones the commit before that field set
            gave (``NU4_DIGESTS``, ``kernels/hyper_digest.py``); and
            ``banded_solve`` at the Schur solver's reduced system on the
            flagship's columns (n 60, q 9: the wide form) beside one
            ``torch.linalg.solve_ex`` of the densified systems by
            PyTorch's default backend and by cuSOLVER; and the nu4
            kernels' staggered field sets (CPH: Rt and W on the nz + 1
            interfaces; LEV, and INT with it: every field on the nz
            levels) at the flagship shapes in float32 and float64 beside
            the Lorenz set on the same inputs, timed, and at the edge
            shapes of ``STAG_EDGES``; and what SPEX and HS reach:
            ``banded_solve`` at q 1 on HS's tridiagonal systems (n 31,
            the flagship's 86 400 columns) beside one
            ``torch.linalg.solve_ex`` of the densified systems through
            cuSOLVER, and ``dss_state`` with the contravariant edge
            table (HS's momentum DSS) bit for bit its plain version,
            float32 and float64;
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
            and a 3-step graph replay bit for bit the eager steps; then the
            no-flux grids (the density current at nex 8 nz 16 in both
            layouts and unfused, the channel at nex 4 ney 2 with nu4) and
            UMJS at ne4 with vertical order 2 (q 10) and ``"pallas"``,
            kernel path against plain path to 1e-11; then the
            shallow-water step (Williamson 5 with nu4, order 2, none and a
            tracer; Galewsky) and the advection step at ne4 in fp64,
            kernel path against plain path to 1e-11 with their launches a
            step, and a 3-step graph replay bit for bit 3 eager steps;
            then the vertical options at ne4 nz8 in fp64 (the dense,
            Schur and JFNK solvers, the explicit vertical path at dt 5 s,
            ``upwind_thermo=False``, the dense solver with three seeded
            species), kernel path against plain path to 1e-11, launches a
            step exact, a 3-step graph replay against 3 eager steps; then
            the CPH, LEV and INT staggerings (UMJS ne4 nz8 with its
            Rayleigh layer and nu4, and the inertia-gravity wave x-z slice
            with nu4; INT at nz 9, vertical order 2) in fp64: kernel path
            against plain path to 1e-11, launches a step exact, a 3-step
            graph replay against 3 eager steps to 1e-13; then SPEX (three
            seeded species, a seeded W) and HS at ne4 nz8 in fp64: kernel
            path against plain path to 1e-11, launches a step exact, a
            3-step graph replay against 3 eager steps to 1e-13; then IMEX
            outside the z-first envelope (ARS343, 2 steps of
            ``make_nh_imex_step`` in fp64): the moist step with three
            seeded species, the dense solver, the density current (nex 8
            nz 16, walls, no halo) and CPH (ne4 nz8, Rayleigh layer, nu4),
            kernel path against plain path to 1e-11, launches a step
            exact; and ``Model(fuse_pallas=False)`` under ARS343 and
            Strang-HEVI against the unfused path's plain version;
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
            term, max |U - U0| and the change of the total Rho mass; then
            (5h) the no-flux slice: the Straka density current at 50 m
            node spacing (nex 128 p4 nz 128 f32, dt 0.1 s, Rayleigh
            sponges, nu2 300/300) through ``make_fast_multistep`` for 151
            steps (replay ms/step, device busy and launches a step, the
            path predicates, eager ms/step; the cold pool's theta' and W
            bars) and without nu2 for 301 steps (30 s; with nu2 the run
            turns non-finite near 20 s in the JAX package's step too), the
            CLI's ``--case density_current``, and the
            baroclinic channel at 100 km node spacing (nex 75 ney 15 p4
            nz 30, dt 100 s, nu4): replay ms/step, launches a step, the
            wall-normal V against the interior V; then (5i) the
            shallow-water set: Galewsky's barotropic instability at ne 60
            p4 f32 (dt 30 s, nu4 1e15 scaled locally) for 6 model days
            through ``make_sw_multistep`` (20-step graphs): replay and
            eager ms/step, device busy and launches a step, the kernel
            launches a step, max |relative vorticity| at days 0, 4 and 6,
            the energy and mass changes (mass within 1e-5, the kernel path
            within 1e-5 of the plain path after 20 steps); Williamson 2 at
            ne 30 f64 for a day to ``tests/test_shallow_water.py``'s bars;
            the CLI's ``sw_galewsky`` at resolution 60 for 20 steps; and
            ``Model.go`` restarted from ``.tarena`` and ``.npz``, bit for
            bit; then (5j) the vertical options on the flagship grid
            through ``Model.go`` (10 steps, then 40 under replay): the
            banded run, the dense, Schur and JFNK solvers, the explicit
            path at dt 2 s beside the banded run at dt 2 s, JW with and
            without ``upwind_thermo``, JFNK in float64 beside a banded
            float64 run: ms/step by graph replay, device busy and launches
            a step, finite fields, each against its banded run; then (5k)
            the staggerings on the flagship grid (UMJS with its Rayleigh
            layer) through ``Model.go`` under LOR, LEV, INT and CPH (10
            steps, then 30 more under replay): ms/step by graph replay,
            device busy and launches a step, the nu4 and DSS kernels'
            shares, peak memory, max |W| after 10 and 40 steps beside the
            LOR run's; the DSS grouping of the CPH and LEV steps timed both
            ways under replay; the CLI's inertia-gravity wave under each
            staggering (40 steps); then (5l) SPEX and HS on the flagship
            grid (no Rayleigh layer) through ``Model.go`` beside the LOR
            run: each scheme's dt by the rule of ``SPLIT_DTS`` (100 s where
            10 steps stay finite), ms/step by graph replay, device busy and
            launches a step, the banded, DSS and nu4 kernels' shares, peak
            memory, max |W| after 10 and 40 steps; then (5m) IMEX outside
            the z-first envelope through ``Model.go`` under ARS343: the
            moist baroclinic wave (ne30 p4 L30, 3 species, f32), the
            density current at 5h's width and CPH on the flagship grid (no
            Rayleigh layer); the moist wave's and CPH's dt by the rule of
            ``IMEX_WIDE_DTS``; ms/step and ms a model second by graph
            replay, device busy and launches a step, the kernels' shares,
            peak memory, the global mass of each species before and after,
            max |W| after 10 and 40 steps; then (5n) the device mesh: the
            flagship on a ``ShardMesh`` of the card at 2 x 2 and 1 x 3
            (``MESH_SHAPES``), a 10-step graph of the sharded step within
            1e-4 relative per field of the single-device replay, the two
            replays timed in turns, launches exact, the exchange tally of
            an eager step (7 DSS calls of ``expected_exchange_bytes``); the
            flagship ``Model``'s ``profile_phases`` on one device and on
            the 2 x 2 mesh; ``DistMesh`` over NCCL is not run (one card);
            its kernels at the shards' blocks are held in phase 3 and the
            sharded step at ne4 in float64 in phase 4 (``check_mesh_slice``:
            2 x 2 and 1 x 4, inline and overlap, against one device to
            1e-11, the tally exact, a graph bit for bit its eager steps);
6. dss      the step with the tail's DSS as four launches or as
            ``dss_state`` and the stages' Rt/Rho as two launches or as
            ``dss_scalar2``, eagerly and under graph replay, in turns; the
            same four groupings under graph replay on the Schar slice and
            on the IMEX flagship (every DSS of the IMEX step is a
            full-state DSS);
7. kernels  one line listing every kernel with its time, bound, plain
            version's time and launches on the flagship runs, its launches
            on the IMEX, the Schar, the terrain, the no-flux, the
            shallow-water paths, the vertical options' (phases 4 and
            5j), the staggerings' (phases 4 and 5k), SPEX's and HS's
            (phases 4 and 5l), the wider IMEX's (phases 4 and 5m) and the
            mesh's (phases 4 and 5n, with the kernel's figures at each
            shard's block from phase 3), and its Cartesian
            and shallow-water figures; the nu4 kernels' CPH and LEV
            instantiations on lines of their own (``nu4_pass1[CPH]``, ...).

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
# the no-flux slice (phase 5h): the Straka density current at 50 m node
# spacing (the reference's physics: Rayleigh sponges, nu2 300/300) for 151
# steps, and without nu2 for 301 (30 s: the cold pool forms), then the CLI's
# case for a few steps; the baroclinic channel at 100 km node spacing.  With
# nu2 the run turns non-finite near 20 s at this spacing (step 200-220 at dt
# 0.1, step 380-400 at dt 0.05: a growing mode, not a time-step limit) on
# the kernel path and the plain path, in f32 and f64 alike, and the JAX
# package's reference-layout step, the one the port is held to, gives the
# same max |U| to 6 digits up to its own NaN at step 220 (on the CPU, f64);
# its vector part alone does it, its scalar part alone does not
DC_NEX, DC_NZ, DC_DT, DC_NU2, DC_CLI_STEPS = 128, 128, 0.1, 300.0, 20
DC_STEPS = {"dc": 151, "dc_no_nu2": 301}
# (nu4 1e13: 1e15, the flagship's, is unstable there within 20 steps, as the
# Cartesian local scale (delta / min(width, 110 km))^3.2 makes it 62x; the
# density current's reference physics has no nu4)
CH_NEX, CH_NEY, CH_NZ, CH_DT, CH_STEPS, CH_NU = 75, 15, 30, 100.0, 51, 1e13
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
                 None, torch.cuda.current_stream().cuda_stream)
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


# ---------------------------------------------------------------------------
# no-flux Cartesian grids with uniform nu2 (phases 3, 4 and 5h), and the
# banded solves above q 8
# ---------------------------------------------------------------------------

def noflux_setup(name, dtype, nex, ney, nz, dev=None, nu=NU, rayleigh=True,
                 nu2=DC_NU2):
    """(test case, cfg, geom[, initial state, reference state]) of a grid
    with no-flux walls: ``"dc"``, the Straka density current (x walls, the
    reference's physics: Rayleigh sponges, nu2 300/300, no nu4,
    ``tests/test_reference_parity.py:241-256``; ``nu2`` its coefficient),
    or ``"channel"``, the Ullrich-Jablonowski baroclinic channel (y walls,
    nu4 ``nu``, Rayleigh unless ``rayleigh`` is False)."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases import nonhydro_xz
    if name == "dc":
        tc = nonhydro_xz.DensityCurrent()
        kw = dict(grid_kind=tm.GridKind.CARTESIAN_XZ, dt=DC_DT,
                  hyperdiffusion=False, nu_uniform_scalar=nu2,
                  nu_uniform_vector=nu2)
        bc = dict(bc_x="noflux")
    else:
        tc = nonhydro_xz.Baroclinic3DChannel()
        kw = dict(grid_kind=tm.GridKind.CARTESIAN_3D, dt=CH_DT,
                  hyperdiffusion=True, nu_scalar=nu, nu_div=nu, nu_vort=nu)
        bc = dict(bc_y="noflux", reference_latitude=tc.reference_latitude)
    cfg = tm.ModelConfig(nex=nex, ney=ney, order=ORDER, nz=nz,
                         x_extent=tc.x_extent, y_extent=tc.y_extent,
                         ztop=tc.ztop, rayleigh_damping=rayleigh,
                         vertical_solver="pallas", dtype=dtype, **kw)
    geom = nh_model.build_nh_cartesian_geometry(
        cfg, ztop=tc.ztop, rayleigh=tc.rayleigh_strength, **bc)
    if dev is None:
        return tc, cfg, geom
    state = tc.initial_state(geom, cfg.constants, dtype=dtype, device=dev)
    ref = tc.reference_state(geom, cfg.constants, dtype=dtype, device=dev)
    return tc, cfg, geom, state, ref


def check_noflux_dss(dev, rows):
    """Phase 3, no-flux walls: the five modes of the band DSS kernel with
    the walls' halo (a halo tensor's wall rows, and the zero halo) at the
    density current's shapes of phase 5h in both layouts (walls along b
    and along a) and at the channel's (walls along b, the wrap along a),
    float32 and float64, each bit for bit equal to its plain form;
    ``dss_state`` also with its Rayleigh finish and the wall rows it writes
    before the finish.  Then, float32, each mode with the halo timed beside
    the same launch without walls (the periodic grid's), and the state
    mode at the density current beside its plain form and bound."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import dss_cuda
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    cases = (("dc_swapped", "dc", DC_NEX, 1, DC_NZ, True),
             ("dc_natural", "dc", DC_NEX, 1, DC_NZ, False),
             ("channel", "channel", CH_NEX, CH_NEY, CH_NZ, False))
    timing = {}
    for where, name, nex, ney, nz, swap in cases:
        for dtype in (torch.float32, torch.float64):
            _, cfg, geom = noflux_setup(name, dtype, nex, ney, nz)
            fg = fast.build_fast_geometry_cartesian(geom, dtype=dtype,
                                                    device=dev, swap_ab=swap)
            im, p, wrap, nf = fg.inv_mult, fg.p, fg.wrap, fg.noflux
            rot, table = fg.e_rot, fg.dss_table
            d = synthetic.random_state(fg, seed=41)
            h = {k: dss_cuda.wall_rows(v, nf) for k, v in
                 synthetic.random_state(fg, seed=42).items()}
            wf = {"bw1": d["W"], "bw2": None, "dW": 0.5 * d["W"],
                  "dt_s": 0.25, "c00": 0.75, "c01": 0.25,
                  "cax0": fg.con_a_xi_int[0].contiguous(),
                  "cbx0": fg.con_b_xi_int[0].contiguous(),
                  "cxx0": fg.con_xi_xi_int[0].contiguous()}
            fac = {k: torch.rand_like(v) for k, v in d.items()}
            ref = {k: torch.randn_like(v) for k, v in d.items()}
            tag = "f32" if dtype == torch.float32 else "f64"
            # the uvw mode stages 11 fields a ring of two: its band of 4
            # rows of 512 nodes does not fit a block in float64 (the engine
            # then takes no W fold)
            K, P, A, B = d["U"].shape
            try:
                dss_cuda.dss_launch_shape(K, P, A, B, p, dtype, "uvw",
                                          links=False)
                uvw_fits = True
            except ValueError:
                uvw_fits = False
            for halo in ("tensor", "zero"):
                H = h if halo == "tensor" else dss_cuda.ZERO_HALO

                def part(*keys):
                    if H is dss_cuda.ZERO_HALO:
                        return H
                    return H[keys[0]] if len(keys) == 1 else tuple(
                        H[k] for k in keys)

                kw = dict(wrap=wrap, noflux=nf)
                runs = {
                    "dss_scalar": lambda fn, **t: fn(
                        d["Rt"], im, (), p, **kw, **t, halo=part("Rt")),
                    "dss_vector": lambda fn, **t: fn(
                        d["U"], d["V"], im, rot, (), p, **kw, **t,
                        halo=part("U", "V")),
                    "dss_uvw": lambda fn, **t: fn(
                        d["U"], d["V"], im, rot, (), p, wf, **kw, **t,
                        halo=part("U", "V", "W")),
                    "dss_scalar2": lambda fn, **t: fn(
                        d["Rt"], d["Rho"], im, (), p, **kw, **t,
                        halo=part("Rt", "Rho")),
                    "dss_state": lambda fn, **t: fn(
                        d, im, rot, (), p, **kw, **t, halo=H,
                        walls_out=True),
                    "dss_state_rayleigh": lambda fn, **t: fn(
                        d, im, rot, (), p, rayleigh=(fac, ref), **kw, **t,
                        halo=H, walls_out=True),
                }
                bitwise = {}
                if not uvw_fits:
                    runs.pop("dss_uvw")
                for mode, run in runs.items():
                    base = mode.replace("_rayleigh", "")
                    got = run(getattr(dss_cuda, base), table=table)
                    torch.cuda.synchronize()
                    want = run(getattr(dss_cuda, base + "_plain"))
                    flat = (lambda o: [o] if torch.is_tensor(o) else (
                        [x for part_ in o for x in (
                            part_.values() if isinstance(part_, dict)
                            else [part_])] if isinstance(o, tuple)
                        else list(o.values())))
                    bitwise[mode] = all(torch.equal(a, b) for a, b in zip(
                        flat(got), flat(want)))
                emit({"phase": "kernel", "name": "dss_noflux",
                      "where": where, "dtype": tag, "halo": halo,
                      "shape": list(d["U"].shape), "noflux": list(nf),
                      "wrap": list(wrap), "bitwise": bitwise,
                      "dss_uvw": "run" if uvw_fits else
                      "no launch shape fits a block (not taken)"})
                if not all(bitwise.values()):
                    raise RuntimeError(f"no-flux DSS {where} {tag} {halo} "
                                       f"halo: not bit for bit {bitwise}")
            if dtype != torch.float32:
                continue
            # float32 times: each mode with the walls' halo and without
            sets = [()]
            row = {}
            for mode, args in (
                    ("dss_scalar", lambda H: ((d["Rt"], im, (), p), {
                        "halo": None if H is None else H["Rt"]})),
                    ("dss_vector", lambda H: ((d["U"], d["V"], im, rot, (),
                                               p), {
                        "halo": None if H is None else (H["U"], H["V"])})),
                    ("dss_uvw", lambda H: ((d["U"], d["V"], im, rot, (), p,
                                            wf), {
                        "halo": None if H is None else (H["U"], H["V"],
                                                        H["W"])})),
                    ("dss_scalar2", lambda H: ((d["Rt"], d["Rho"], im, (),
                                                p), {
                        "halo": None if H is None else (H["Rt"],
                                                        H["Rho"])})),
                    ("dss_state", lambda H: ((d, im, rot, (), p), {
                        "halo": H, "walls_out": H is not None}))):
                fn = getattr(dss_cuda, mode)
                ms = {}
                for label, H in (("walls", h), ("no_walls", None)):
                    a, k = args(H)
                    ms[label] = time_cuda(
                        lambda: fn(*a, wrap=wrap, noflux=nf, table=table,
                                   **k), sets, reps=20, queued=True)
                row[mode] = ms
            timing[where] = row
            if where == "dc_swapped":
                st = time_cuda(lambda: dss_cuda.dss_state_plain(
                    d, im, rot, (), p, wrap=wrap, noflux=nf, halo=h,
                    walls_out=True), sets, reps=3, warmup=1)
                nbytes = 2 * sum(v.numel() for v in d.values()) * 4
                b, by = bound_ms(nbytes, 4 * sum(v.numel() for v in
                                                 d.values()), dtype)
                rows["noflux_dss_state"] = {
                    "ms": row["dss_state"]["walls"], "plain_ms": st,
                    "bound_ms": b, "bound_by": by,
                    "shape": list(d["U"].shape)}
    emit({"phase": "kernel", "name": "dss_noflux_times", "dtype": "f32",
          "ms_with_and_without_walls": timing,
          "dc_state_mode": rows["noflux_dss_state"]})
    rows["noflux_dss_times"] = timing


def check_wide_banded(dev, rows):
    """Phase 3, q above 8: ``banded_solve`` and ``banded_solve_multi`` at
    the edge shapes of ``kernels/banded_edges.HIGHQ_CASES`` (the Lorenz
    systems of vertical orders 2, 3 and 4, n 91, q 10, 16 and 22; the
    tracer systems of order 5, n 30, q 9, R 3; the wide form's U rows
    rebuilt chunk by chunk; blocks of 8 columns; unaligned inputs; the
    stream and wide forms forced), float32 and float64, each line naming
    its form; then, float32, ``banded_solve`` at q 10 and 16 (the ring
    form) on the flagship's 86 400 columns, q 10 also in the wide form, and
    ``banded_solve_multi`` at q 9, R 3 (the wide form), timed beside the
    plain version and the bound."""
    from tempestmodel_tpu_torch.kernels import banded_edges
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.ops import cuda_banded
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        tol = 1e-4 if dtype == torch.float32 else 1e-10
        for case, spec in banded_edges.HIGHQ_CASES.items():
            got = banded_edges.run_highq_case(case, dtype, dev)
            emit({"phase": "kernel", "dtype": tag, "tol": tol,
                  "name": "banded_highq_edge", "case": case, **got})
            if not got["max_err"] <= tol or got["launch"]["form"] != spec[7]:
                raise RuntimeError(f"banded case {case} {tag}: rel err "
                                   f"{got['max_err']} > {tol} or form "
                                   f"{got['launch']['form']} is not "
                                   f"{spec[7]}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ncol = 6 * (NE * ORDER) ** 2
    out = {}
    for name, n, q, R, form in (("banded_solve", 3 * NZ + 1, 10, 1, None),
                                ("banded_solve", 3 * NZ + 1, 10, 1, "wide"),
                                ("banded_solve", 3 * NZ + 1, 16, 1, None),
                                ("banded_solve_multi", NZ, 9, NTR, None),
                                # the Schur solver's reduced system
                                ("banded_solve", 2 * NZ, 9, 1, None)):
        dtype = torch.float32
        sets = []
        for _ in range(2):
            bands, rhs = make_bands(n, q, ncol, dtype, gen, dev)
            if R > 1:
                rhs = torch.stack([rhs] * R, 1).contiguous()
            sets.append((bands, rhs))
        plain = getattr(cuda_banded, name + "_plain")
        if form is None:
            fn = getattr(cuda_banded, name)
        else:
            sh = cuda_banded.banded_solve_launch_shape(n, q, ncol, dtype,
                                                       form=form)
            fn = (lambda b, r, q_, sh=sh:
                  cuda_banded._banded_solve_cuda(b, r, q_, sh))
        got = fn(*sets[0], q)
        torch.cuda.synchronize()
        err = rel_err(got, plain(*sets[0], q))
        ms = time_cuda(lambda b, r: fn(b, r, q), sets, reps=10, queued=True)
        plain_ms = time_cuda(lambda b, r: plain(b, r, q), sets, reps=1,
                             warmup=1)
        nbytes = 4 * (sets[0][0].numel() + 2 * sets[0][1].numel())
        flops = 2 * n * ncol * (q * (q + 1) + R * 3 * q)
        b, by = bound_ms(nbytes, flops, dtype)
        key = f"{name} n{n} q{q} R{R}" + (f" {form} form" if form else "")
        out[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                    "bound_by": by, "max_rel_err": err,
                    "launch": cuda_banded.launch_config(
                        *sets[0], q, None if form is None else sh)}
        if n == 2 * NZ:
            # one library call of the same function: a batched dense LU,
            # by PyTorch's default backend and by cuSOLVER (the dense
            # column solver's, ``fast/implicit.dense_solve``)
            dense = [(dense_from_bands(bb, q), rr.T.contiguous()[..., None])
                     for bb, rr in sets[:1]]
            out[key]["library_ms"] = time_cuda(
                lambda a, r: torch.linalg.solve_ex(a, r), dense, reps=3)
            torch.backends.cuda.preferred_linalg_library("cusolver")
            try:
                out[key]["library_ms_cusolver"] = time_cuda(
                    lambda a, r: torch.linalg.solve_ex(a, r), dense, reps=3)
            finally:
                torch.backends.cuda.preferred_linalg_library("default")
            del dense
        if not err < 1e-4:
            raise RuntimeError(f"{key}: rel err {err}")
        del sets
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "banded_wide_flagship", "dtype": "f32",
          "ncol": ncol, "cases": out})
    rows["banded_wide"] = out


def noflux_per_step(name, fused=True):
    """Kernel launches per step of the no-flux paths: the density current
    (nu2, no nu4: each stage's DSS one ``dss_state`` launch (no W fold
    with nu2 between the stage and its DSS), its Laplacians one
    ``nu4_pass1``, no DSS in the tail) and the channel (nu4: the flagship's
    grouping); unfused: the separate launches (4 a full-state DSS), the
    banded kernel."""
    zero = {k: 0 for k in KERNELS}
    if not fused:
        ndss = 5 + (0 if name == "dc" else 2)
        return dict(zero, dss_vector=ndss, dss_scalar=3 * ndss,
                    banded_solve=1)
    if name == "dc":
        return dict(zero, fused_stage=5, dss_state=5, nu4_pass1=5,
                    fused_implicit_update=1)
    if name == "dc_no_nu2":    # the W fold, no DSS in the tail
        return dict(zero, fused_stage=5, dss_uvw=5, dss_scalar2=5,
                    fused_implicit_update=1)
    from tempestmodel_tpu_torch.fast import engine
    return fused_per_step(tuple(engine.DSS_MERGE_DEFAULT))


def check_noflux_slice(dev):
    """Phase 4, no-flux walls and q above 8: 3 steps in float64 on the card,
    the kernel path against the plain path to 1e-11: the density current
    at nex 8, nz 16 (fused in both layouts, unfused), the channel at nex 4,
    ney 2, nz 8 with nu4 (fused, unfused), and UMJS at ne4 nz8 with
    vertical order 2 and ``"pallas"`` (q 10: the wide form of
    ``banded_solve`` on the unfused path's route).  Returns the launch
    counts of each kernel run."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    launched = {}
    runs = [("dc", 8, 1, 16, dict(swap_ab=True)),
            ("dc", 8, 1, 16, dict(swap_ab=False)),
            ("dc", 8, 1, 16, dict(fused=False)),
            ("channel", 4, 2, 8, {}), ("channel", 4, 2, 8, dict(fused=False)),
            ("umjs_vo2", 4, 4, 8, dict(fused=False))]
    for name, nex, ney, nz, kw in runs:
        if name == "umjs_vo2":
            tc = BaroclinicWaveUMJS(pert="exp")
            cfg = tm.ModelConfig(
                grid_kind=tm.GridKind.CUBED_SPHERE, ne=nex, order=ORDER,
                nz=nz, ztop=tc.ztop, dt=DT, hyperdiffusion=True,
                nu_scalar=NU, nu_div=NU, nu_vort=NU, vertical_order=2,
                vertical_solver="pallas", dtype=torch.float64)
            geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
            state, ref = tc.initial_state(geom, cfg.constants,
                                          dtype=cfg.dtype, device=dev), None
            what = f"UMJS ne{nex} nz{nz} vertical order 2 pallas f64"
        else:
            _, cfg, geom, state, ref = noflux_setup(name, torch.float64,
                                                    nex, ney, nz, dev)
            what = f"{name} nex{nex} ney{ney} nz{nz} f64"
        what += "".join(f", {k}={v}" for k, v in kw.items())
        X0 = fast.pack_state(state, device=dev)
        outs = {}
        for path, pk in (("kernels", {}), ("plain", {"plain": True})):
            counts.reset_launch_counts()
            first, step = fast.make_fast_step(cfg, geom, ref_state=ref,
                                              device=dev, **kw, **pk)
            X, c = first(X0)
            for _ in range(2):
                X, c = step(X, c)
            torch.cuda.synchronize()
            outs[path] = X
            if path == "kernels":
                launched[what] = dict(counts.launch_counts)
        errs = compare_xz(outs["kernels"], outs["plain"])
        emit({"phase": "noflux_slice", "config": what + ", 3 steps",
              "kernels_vs_plain": errs, "tol": 1e-11,
              "launches": launched[what]})
        if not max(errs.values()) < 1e-11:
            raise RuntimeError(f"{what}: paths disagree {errs}")
        if name != "umjs_vo2":
            per = noflux_per_step(name, kw.get("fused", True))
            want = {k: 3 * v + (1 if k in IMPLICIT_SOLVES and v else 0)
                    for k, v in per.items()}
            if launched[what] != want:
                raise RuntimeError(f"{what}: launch counts {launched[what]} "
                                   f"!= expected {want}")
        elif launched[what]["banded_solve"] != 4:
            raise RuntimeError(f"{what}: banded_solve launched "
                               f"{launched[what]['banded_solve']} times")
        for k, v in outs["kernels"].items():
            if not bool(torch.isfinite(v).all()):
                raise RuntimeError(f"{what}: non-finite {k}")
    return launched


def noflux_line(dev, smi, launches):
    """Phase 5h: the slice at full width.  The Straka density current at 50 m
    node spacing (nex 128, p 4: 512 columns across 25.6 km; nz 128 to 6.4
    km; float32; dt 0.1 s; Rayleigh sponges, nu2 300/300, no nu4) through
    ``make_fast_multistep`` (``first_step``, then a 10-step graph replayed
    to 151 steps; ms/step the median of 4 timed replays; device busy and
    launches a step from one profiled replay, ``utils.devprof``), eager
    steps (1 + 3), and the path each predicate took; then the same grid
    without nu2 for 301 steps (the reference physics turns non-finite near
    20 s in the port and in the JAX package alike, see ``DC_STEPS``); after
    each run the cold pool must have formed (min theta' < -2 K, min
    physical W < -0.5 m/s, the bar of ``tests/test_nonhydro_xz.py:175-193``
    at 30 s).  Then the
    CLI's ``--case density_current`` at that grid for a few steps, and the
    baroclinic channel at 100 km node spacing (nex 75, ney 15, p 4, nz 30
    to 30 km, dt 100 s, nu4 ``CH_NU``) under graph replay, 51 steps with its
    Rayleigh sponge (ms/step, launches a step; the wall-normal V below 5 %
    of U) and 31 without, as the battery test runs it (the whole bar of
    ``tests/test_testcase_battery.py:109-134``: also the wall V below half
    the interior V; the reference's channel sponge damps the whole channel
    toward its balanced state, which leaves the interior V below the
    walls').  Each run starts with the counts at 0 and is held to its
    path's launches a step."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import (hyper_cuda, implicit_cuda,
                                             stage_cuda)
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.utils import devprof
    out = {}
    for run, nex, ney, nz, steps in (
            ("dc", DC_NEX, 1, DC_NZ, DC_STEPS["dc"]),
            ("dc_no_nu2", DC_NEX, 1, DC_NZ, DC_STEPS["dc_no_nu2"]),
            ("channel", CH_NEX, CH_NEY, CH_NZ, CH_STEPS),
            ("channel_no_rayleigh", CH_NEX, CH_NEY, CH_NZ, 31)):
        name = run.split("_")[0]
        t0 = time.perf_counter()
        tc, cfg, geom, state, ref = noflux_setup(
            name, torch.float32, nex, ney, nz, dev, nu=CH_NU,
            rayleigh=run != "channel_no_rayleigh",
            nu2=0.0 if run == "dc_no_nu2" else DC_NU2)
        setup_s = time.perf_counter() - t0
        X0 = fast.pack_state(state, device=dev)
        fg = fast.build_fast_geometry_cartesian(geom, dtype=cfg.dtype,
                                                device=dev)
        from tempestmodel_tpu_torch.fast import implicit as fimp
        from tempestmodel_tpu_torch.models import nonhydro
        q = nonhydro.estimate_bandwidth(geom, cfg.constants)
        ist = implicit_cuda.implicit_statics(fimp.statics_to_device(
            nonhydro.band_assembly_statics(geom, q), cfg.dtype, dev), fg)
        path = {"swap_ab": bool(fg.ab_swapped), "noflux": list(fg.noflux),
                "stage_supported": bool(stage_cuda.stage_supported(fg)),
                "w_fold": run != "dc",
                "laplacians_by_nu4_pass1": bool(
                    hyper_cuda.laplacians_supported(fg)),
                "nu4_supported": bool(hyper_cuda.supported(fg, cfg)),
                "fused_implicit_supported": bool(
                    implicit_cuda.fused_supported(ist)), "q": q}
        want_path = (path["stage_supported"] and path["laplacians_by_nu4_pass1"]
                     and path["fused_implicit_supported"])
        if not want_path:
            raise RuntimeError(f"{name}: path predicates {path}")
        per_step = noflux_per_step(run if run == "dc_no_nu2" else name)
        counts.reset_launch_counts()
        first, multi = fast.make_fast_multistep(cfg, geom, INNER_STEPS,
                                                ref_state=ref, device=dev)
        X, c = first(X0)
        X, c = multi(X, c)                 # warm-up, capture, first replay
        torch.cuda.synchronize()
        got = dict(counts.launch_counts)
        want = {k: v * (INNER_STEPS + 2) + (1 if k in IMPLICIT_SOLVES and v
                                           else 0)
                for k, v in per_step.items()}
        if got != want:
            raise RuntimeError(f"{name}: launch counts {got} != expected "
                               f"{want}")
        launches[f"noflux_{run}"] = got
        done = 1 + INNER_STEPS
        replay_ms = []
        while done + INNER_STEPS <= steps:
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            X, c = multi(X, c)
            ev1.record()
            torch.cuda.synchronize()
            if len(replay_ms) < REPLAYS:
                replay_ms.append(ev0.elapsed_time(ev1) / INNER_STEPS)
            done += INNER_STEPS
        # two replays from the same inputs (a warm-up and the traced one):
        # the state does not advance
        busy_ms, nkern = devprof.device_time_ms(multi, X, c)
        torch.cuda.synchronize()
        S = fast.unpack_state(X)
        for k, v in S.items():
            if not bool(torch.isfinite(v).all()):
                raise RuntimeError(f"{name}: non-finite {k}")
        row = {"phase": "noflux", "case": run,
               "config": (f"{type(tc).__name__} nex{nex} ney{ney} p{ORDER} "
                          f"nz{nz} f32 dt{cfg.dt:g}" + (
                              f" nu2 {cfg.nu_uniform_vector:g}"
                              if name == "dc" else
                              f" nu4 {CH_NU:g}") + (
                              ", Rayleigh" if cfg.rayleigh_damping else
                              ", no Rayleigh")),
               "path": path, "setup_s": setup_s,
               "replay_ms_per_step": sorted(replay_ms)[len(replay_ms) // 2],
               "replay_ms_each": replay_ms,
               "device_busy_ms_per_step": busy_ms / INNER_STEPS,
               "device_launches_per_step": nkern / INNER_STEPS,
               "launches_per_step": per_step, "steps": done,
               "card": smi}
        if name == "dc":
            theta = (S["Rt"] / S["Rho"]).double() - tc.theta_bar
            dxr = torch.as_tensor(np.asarray(geom.deriv_r_int)[..., 2],
                                  device=dev)
            w_phys = S["W"].double() / dxr
            row.update(min_theta_prime_K=float(theta.min()),
                       min_physical_w_m_s=float(w_phys.min()),
                       model_time_s=done * cfg.dt)
            if not (row["min_theta_prime_K"] < -2.0
                    and row["min_physical_w_m_s"] < -0.5):
                raise RuntimeError(f"density current: no cold pool after "
                                   f"{done} steps: {row}")
        if run == "dc":
            # eager steps, counted
            f1, st = fast.make_fast_step(cfg, geom, ref_state=ref,
                                         device=dev)
            Xe, ce = st(*f1(X0))
            torch.cuda.synchronize()
            counts.reset_launch_counts()
            Xe, ce = f1(X0)
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(3):
                Xe, ce = st(Xe, ce)
            ev1.record()
            torch.cuda.synchronize()
            got = dict(counts.launch_counts)
            want = {k: 4 * v + (1 if k in IMPLICIT_SOLVES and v else 0)
                    for k, v in per_step.items()}
            if got != want:
                raise RuntimeError(f"density current eager: launch counts "
                                   f"{got} != expected {want}")
            row["eager_ms_per_step"] = ev0.elapsed_time(ev1) / 3
            del f1, st, Xe, ce
        if name == "channel":
            v = S["V"]
            v_wall = max(float(v[:, :, 0].abs().max()),
                         float(v[:, :, -1].abs().max()))
            v_int = float(v[:, :, 1:-1].abs().max())
            u_scale = float(S["U"].abs().max())
            row.update(v_wall=v_wall, v_interior=v_int, u_scale=u_scale,
                       model_time_s=done * cfg.dt)
            if not (v_wall < 0.05 * u_scale and (
                    cfg.rayleigh_damping or v_wall < 0.5 * v_int)):
                raise RuntimeError(f"{run}: wall-normal V {v_wall} against "
                                   f"interior {v_int}, U {u_scale}")
        emit(row)
        out[run] = row
        del first, multi, X, c, X0, S, state, ref
        torch.cuda.empty_cache()
    # the CLI's density current (no nu2: the JAX CLI sets none), a few steps
    argv = ["--case", "density_current", "--resolution", str(DC_NEX),
            "--levels", str(DC_NZ), "--fp32", "--vmethod", "V2", "--dt",
            f"{DC_DT:g}s", "--nsteps", str(DC_CLI_STEPS), "--nohypervis",
            "--checksum_dt", f"{DC_CLI_STEPS * DC_DT / 2:g}s"]
    text, wall, got = run_cli(argv, dev)
    checks = [l for l in text.splitlines() if "..Checksums" in l]
    if len(checks) != 3 or any("nan" in l for l in checks):
        raise RuntimeError(f"CLI density current: checksum lines {checks}")
    # no nu2 and no nu4 there: the W fold (dss_uvw), Rt and Rho in
    # dss_scalar2, no DSS in the tail
    per = ("fused_stage", "dss_uvw", "dss_scalar2", "fused_implicit_update")
    if not all(got[k] >= 1 for k in per) or got["dss_state"]:
        raise RuntimeError(f"CLI density current: launches {got}")
    emit({"phase": "noflux", "case": "cli_density_current", "argv": argv,
          "wall_s": wall, "checksums": checks, "launches": got,
          "card": smi})
    launches["noflux_cli"] = got
    return out


# ---------------------------------------------------------------------------
# the shallow-water and advection sets (phases 3, 4 and 5i)
# ---------------------------------------------------------------------------

# phase 5i: Galewsky et al.'s barotropic instability at ne 60 p 4 (6 x 240 x
# 240 nodes, about 42 km between nodes, near their T341 reference), f32,
# KGU35, dt 30 s (the Courant number of tests/test_shallow_water.py's TC2
# run), the CLI's nu4 1e15 scaled locally, 6 model days through
# make_sw_multistep in 20-step graphs; then Williamson 2 at ne 30, f64, dt
# 100 s, one day without hyperdiffusion, held to that test's bars; the CLI's
# sw_galewsky for 20 steps; Model.go restarted from both checkpoint formats
SW_NE, SW_DT, SW_GRAPH, SW_DAYS, SW_CHECK_STEPS = 60, 30.0, 20, 6, 20
TC2_NE, TC2_DT, TC2_STEPS, TC2_GRAPH = 30, 100.0, 864, 48
SW_CLI_STEPS, SW_EVERY = 20, 10
# kernel launches per shallow-water step: a DSS pair ((U, V) and H) after
# each of the five KGU35 stages and two in the nu4 tail; without
# hyperdiffusion the tail is one DSS pair
SW_PER_STEP = {"dss_vector": 7, "dss_scalar": 7, "nu4_pass1": 1,
               "nu4_pass2": 1}
SW_PER_STEP_NOHYPERVIS = {"dss_vector": 6, "dss_scalar": 6}
# the nonhydrostatic nu4 instantiations' outputs at the flagship
# (kernels/hyper_digest.py), as the commit before the shallow-water field
# set computed them on an H100
NU4_DIGESTS = {
    "f32": "4f646e3b76210602c996e58d91a73e1df061c2b2342da6c22ba6f1eaae99794a",
    "f64": "e9d05c8ac8927eac4b3e80e46aa917026a3a770948dd2b8ecae3e38df8127882"}


def sw_counts(per_step, nsteps=1):
    """Launch counts of ``nsteps`` shallow-water steps over every kernel."""
    return {k: per_step.get(k, 0) * nsteps for k in KERNELS}


def check_sw_kernels(dev, rows):
    """Phase 3, the shallow-water shapes, float64 and float32:
    ``dss_vector`` and ``dss_scalar`` at (1, 6, 240, 240) (ne 60, one
    level), bit for bit their plain forms, each timed beside its plain form
    and one ``torch.sparse.mm`` of ``kernels/dss_operator``;
    ``dss_scalar`` at (3, 6, 120, 120) (three advected species at ne 30),
    bit for bit; ``nu4_pass1`` and ``nu4_pass2`` in the shallow-water field
    set (U, V, H; the 2-D Jacobian) at (1, 6, 240, 240) against their plain
    forms, timed; then the nonhydrostatic nu4 instantiations at the flagship
    held to ``NU4_DIGESTS`` bit for bit.  Adds the float32 figures to
    ``rows[name]["shallow_water"]`` (after ``check_kernels``)."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.fast import dss_cuda, hyper_cuda
    from tempestmodel_tpu_torch.kernels import dss_operator, hyper_digest
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import sw_model

    ncopies = 8
    A = SW_NE * ORDER
    n = 6 * A * A
    for dtype in (torch.float64, torch.float32):
        tag = "f32" if dtype == torch.float32 else "f64"
        esize = 4 if dtype == torch.float32 else 8
        # the rounding of the plain forms (about 2e-7 / 4e-16) with
        # headroom
        hyper_tol = 2e-6 if dtype == torch.float32 else 1e-14
        gen = torch.Generator(device=dev).manual_seed(SEED)
        st = sw_model.sw_statics(sw_model.build_sw_geometry(tm.ModelConfig(
            ne=SW_NE, order=ORDER, dtype=dtype)), dev)
        imult, rot, links, p, table = (st.inv_mult, st.e_rot, st.links,
                                       st.p, st.dss_table)
        us = [randn((1, 6, A, A), dtype, gen, dev) for _ in range(ncopies)]
        vs = [randn((1, 6, A, A), dtype, gen, dev) for _ in range(ncopies)]
        found = {}

        # --- dss_vector, K = 1 -------------------------------------------
        gu, gv = dss_cuda.dss_vector(us[0], vs[0], imult, rot, links, p,
                                     table=table)
        torch.cuda.synchronize()
        wu, wv = dss_cuda.dss_vector_plain(us[0], vs[0], imult, rot, links,
                                           p)
        if not (torch.equal(gu, wu) and torch.equal(gv, wv)):
            raise RuntimeError(f"dss_vector {tag} (1, 6, {A}, {A}): not bit "
                               f"for bit its plain form")
        ms = time_cuda(lambda u, v: dss_cuda.dss_vector(
            u, v, imult, rot, links, p, table=table), list(zip(us, vs)),
            reps=40, queued=True)
        plain_ms = time_cuda(lambda u, v: dss_cuda.dss_vector_plain(
            u, v, imult, rot, links, p), list(zip(us, vs)), reps=8)
        op = dss_operator.vector_operator(imult, rot, links, p)
        uvs = [(torch.cat([u.reshape(1, -1), v.reshape(1, -1)], 1),)
               for u, v in zip(us[:4], vs[:4])]
        got = dss_operator.apply(op, uvs[0][0]).t()
        lib_err = max(rel_err(got[:, :n].reshape(wu.shape), wu),
                      rel_err(got[:, n:].reshape(wv.shape), wv))
        library_ms = time_cuda(lambda uv: dss_operator.apply(op, uv), uvs,
                               reps=20, queued=True)
        del op, uvs, got
        bnd, by = bound_ms((5 * n + rot.numel()) * esize
                           + table.numel() * 4, 16 * n, dtype)
        found["dss_vector"] = {
            "shape": [1, 6, A, A], "max_abs_err": 0.0, "bitwise": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": library_ms, "library_rel_err": lib_err,
            "launch": dss_cuda.launch_config(
                us[0], p, "vector", dss_cuda._vector_ptrs(us[0], vs[0],
                                                          imult), True)}

        # --- dss_scalar, K = 1 (H) and K = 3 (three species at ne 30) -------
        got = dss_cuda.dss_scalar(us[0], imult, links, p, table=table)
        torch.cuda.synchronize()
        if not torch.equal(got, dss_cuda.dss_scalar_plain(us[0], imult,
                                                          links, p)):
            raise RuntimeError(f"dss_scalar {tag} (1, 6, {A}, {A}): not bit "
                               f"for bit its plain form")
        ms = time_cuda(lambda x: dss_cuda.dss_scalar(
            x, imult, links, p, table=table), [(x,) for x in us], reps=40,
            queued=True)
        plain_ms = time_cuda(lambda x: dss_cuda.dss_scalar_plain(
            x, imult, links, p), [(x,) for x in us], reps=8)
        op = dss_operator.scalar_operator(imult, links, p)
        lib_err = rel_err(dss_operator.apply(op, us[0]).t().reshape(
            us[0].shape), got)
        library_ms = time_cuda(lambda x: dss_operator.apply(op, x),
                               [(x,) for x in us], reps=20, queued=True)
        del op
        bnd, by = bound_ms(3 * n * esize + table.numel() * 4, 5 * n, dtype)
        found["dss_scalar"] = {
            "shape": [1, 6, A, A], "max_abs_err": 0.0, "bitwise": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": library_ms, "library_rel_err": lib_err,
            "launch": dss_cuda.launch_config(
                us[0], p, "scalar", dss_cuda._scalar_ptrs(us[0], imult),
                True)}
        st30 = sw_model.sw_statics(sw_model.build_sw_geometry(
            tm.ModelConfig(ne=NE, order=ORDER, dtype=dtype)), dev)
        A30 = NE * ORDER
        n3 = 3 * 6 * A30 * A30
        trs = [randn((3, 6, A30, A30), dtype, gen, dev)
               for _ in range(ncopies)]
        sc30 = (st30.inv_mult, st30.links, st30.p)
        got = dss_cuda.dss_scalar(trs[0], *sc30, table=st30.dss_table)
        torch.cuda.synchronize()
        if not torch.equal(got, dss_cuda.dss_scalar_plain(trs[0], *sc30)):
            raise RuntimeError(f"dss_scalar {tag} (3, 6, {A30}, {A30}): not "
                               f"bit for bit its plain form")
        ms = time_cuda(lambda x: dss_cuda.dss_scalar(
            x, *sc30, table=st30.dss_table), [(x,) for x in trs], reps=40,
            queued=True)
        plain_ms = time_cuda(lambda x: dss_cuda.dss_scalar_plain(x, *sc30),
                             [(x,) for x in trs], reps=8)
        op = dss_operator.scalar_operator(*sc30)
        library_ms = time_cuda(lambda x: dss_operator.apply(op, x),
                               [(x,) for x in trs], reps=20, queued=True)
        del op
        bnd, by = bound_ms((2 * n3 + n3 // 3) * esize, 5 * n3, dtype)
        found["dss_scalar_advection"] = {
            "shape": [3, 6, A30, A30], "max_abs_err": 0.0, "bitwise": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": library_ms,
            "launch": dss_cuda.launch_config(
                trs[0], p, "scalar", dss_cuda._scalar_ptrs(
                    trs[0], st30.inv_mult), True)}
        del trs, st30

        # --- nu4_pass1, nu4_pass2: the shallow-water field set -------------
        hst = st.hyper
        sets = [({"U": us[i], "V": vs[i], "H": vs[i + 1]},
                 {"U": us[i + 1], "V": vs[i + 2], "H": us[i + 2]})
                for i in (0, 3)]
        d, w = sets[0]
        # viscosities that make the increment as large as the state
        unit = hyper_cuda.nu4_pass1_plain(w, None, hst)
        nu_s = float(d["H"].abs().max() / unit["H"].abs().max())
        nu_v = float(d["U"].abs().max() / unit["U"].abs().max())
        nu = (nu_s, nu_v, 0.7 * nu_v, 1.0)
        del unit
        got = hyper_cuda.nu4_pass1(d, None, hst)
        torch.cuda.synchronize()
        want = hyper_cuda.nu4_pass1_plain(d, None, hst)
        err1 = {k: rel_err(got[k], want[k]) for k in want}
        got = hyper_cuda.nu4_pass2(d, w, *nu, None, hst)
        torch.cuda.synchronize()
        want = hyper_cuda.nu4_pass2_plain(d, w, *nu, None, hst)
        err2 = {k: max(rel_err(got[k], want[k]),
                       rel_err(got[k] - d[k], want[k] - d[k])) for k in want}
        del got, want
        for name, errs in (("nu4_pass1", err1), ("nu4_pass2", err2)):
            if set(errs) != {"U", "V", "H"} \
                    or not max(errs.values()) <= hyper_tol:
                raise RuntimeError(f"{name} {tag} shallow water: rel err "
                                   f"{errs} > {hyper_tol}")
        scal2 = (nu[1], nu[2], nu[3], nu[3] * nu[0])
        for name, errs, launch, plain, nfields in (
                ("nu4_pass1", err1,
                 lambda x, y: hyper_cuda._launch(
                     "nu4_pass1", x, None, (1.0, 1.0, 0.0, 0.0), hst),
                 lambda x, y: hyper_cuda.nu4_pass1_plain(x, None, hst), 2),
                ("nu4_pass2", err2,
                 lambda x, y: hyper_cuda._launch("nu4_pass2", y, x, scal2,
                                                 hst),
                 lambda x, y: hyper_cuda.nu4_pass2_plain(x, y, *nu, None,
                                                         hst), 3)):
            ms = time_cuda(launch, sets, reps=40, queued=True)
            plain_ms = time_cuda(plain, sets, reps=4, warmup=1)
            # reads three (pass 2: six) fields and the 6 metric fields
            # the function needs (c2aa..c2bb, j2, 1/j2: the kernel's jl
            # rows are copies of j2's here and not counted), writes three;
            # about 130 flops a node (the vector part and one scalar
            # Laplacian)
            bnd, by = bound_ms((nfields * 3 * n + 6 * n) * esize,
                               130 * n, dtype)
            found[name] = {
                "shape": [1, 6, A, A], "field_set": "U, V, H",
                "max_abs_err": max(errs.values()), "err_by_field": errs,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                "bound_by": by, "library_ms": None,
                "launch": hyper_cuda.launch_config(
                    d if name == "nu4_pass1" else w,
                    None if name == "nu4_pass1" else d, hst)}
        for name, row in found.items():
            emit({"phase": "kernel", "case": "shallow_water", "dtype": tag,
                  "name": name, **row})
        if dtype == torch.float32:
            for name in ("dss_vector", "dss_scalar", "nu4_pass1",
                         "nu4_pass2"):
                rows[name]["shallow_water"] = found[name]
            rows["dss_scalar"]["advection"] = found["dss_scalar_advection"]
        del us, vs, sets, d, w, st

    # --- the nonhydrostatic nu4 instantiations, bit for bit ---------------
    got = hyper_digest.digests(dev)
    same = got == NU4_DIGESTS
    emit({"phase": "kernel", "name": "nu4_nonhydrostatic_digests",
          "digests": got, "want": NU4_DIGESTS, "bit_for_bit": same})
    if not same:
        raise RuntimeError(f"the nonhydrostatic nu4 instantiations changed: "
                           f"digests {got} != {NU4_DIGESTS}")


def sw_setup(name, dtype, ne, dev, **kw):
    """(testcase, cfg, geom, state on ``dev``) of a shallow-water case."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.models import sw_model
    from tempestmodel_tpu_torch.testcases import shallow_water as swc
    tc = getattr(swc, name)()
    cfg = tm.ModelConfig(ne=ne, order=ORDER, dtype=dtype, **kw)
    geom = sw_model.build_sw_geometry(cfg, getattr(tc, "topography", None))
    return tc, cfg, geom, tc.initial_state(geom, cfg.constants, dtype=dtype,
                                           device=dev)


def check_sw_slice(dev):
    """Phase 4: the shallow-water step at ne 4, fp64, 3 steps, kernel path
    against plain path (``plain=True``) to 1e-11 relative per field:
    Williamson 5 with order-4 hyperviscosity (nu 1e14, dt 600 s), with
    order 2, without, and with one tracer species; Galewsky; the advection
    step with three species; then a 3-step graph replay of
    ``make_sw_multistep`` bit for bit 3 eager steps.  Each kernel run
    starts with the counts at 0 and is held to its launches a step."""
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.models import advection, sw_model
    from tempestmodel_tpu_torch.testcases.shallow_water import (
        sphere_velocity_to_covariant)
    tol, nsteps = 1e-11, 3
    nu = dict(dt=600.0, nu_scalar=1e14, nu_div=1e14, nu_vort=1e14)
    cases = (("Williamson5", {}, SW_PER_STEP, False),
             ("Williamson5", {"hypervis_order": 2, "nu_scalar": 1e5,
                              "nu_div": 1e5, "nu_vort": 1e5},
              SW_PER_STEP_NOHYPERVIS, False),
             ("Williamson5", {"hyperdiffusion": False},
              SW_PER_STEP_NOHYPERVIS, False),
             ("Williamson5", {}, SW_PER_STEP, True),
             ("BarotropicInstability", {}, SW_PER_STEP, False))
    for name, kw, per_step, tracer in cases:
        tc, cfg, geom, s0 = sw_setup(name, torch.float64, 4, dev,
                                     **dict(nu, **kw))
        if tracer:
            lat = torch.as_tensor(np.asarray(geom.lat), device=dev)
            s0 = dict(s0, Tracers=(1.0 + torch.cos(lat))[None].contiguous())
        out = {}
        for plain in (False, True):
            step = sw_model.make_sw_step(cfg, geom, device=dev, plain=plain)
            counts.reset_launch_counts()
            s = s0
            for _ in range(nsteps):
                s = step(s)
            sync(dev)
            got_counts = dict(counts.launch_counts)
            want = sw_counts({} if plain else per_step, nsteps)
            if tracer and not plain:
                want["dss_scalar"] += per_step["dss_vector"] * nsteps
            if got_counts != want:
                raise RuntimeError(f"sw slice {name} {kw} plain={plain}: "
                                   f"launch counts {got_counts} != {want}")
            check_finite(s, f"sw slice {name}", torch.float64)
            out[plain] = s
        errs = {k: rel_err(out[False][k], out[True][k]) for k in s0}
        what = (f"{name} ne4 fp64 {kw or 'nu4'}"
                f"{' + 1 tracer' if tracer else ''}")
        if not max(errs.values()) < tol:
            raise RuntimeError(f"sw slice {what}: kernel vs plain {errs}")
        emit({"phase": "sw_slice", "config": what + ", 3 steps",
              "kernel_vs_plain": errs, "tol": tol,
              "launches_per_step": {k: v for k, v in per_step.items()}})

    # the advection step, three species
    _, cfg, geom, _ = sw_setup("Williamson2", torch.float64, 4, dev,
                               dt=1800.0)
    lon, lat = np.asarray(geom.lon), np.asarray(geom.lat)
    u0 = 2 * np.pi * cfg.constants.earth_radius / (12.0 * 86400.0)
    U, V = sphere_velocity_to_covariant(u0 * np.cos(lat), np.zeros_like(lat),
                                        geom, cfg.constants)
    wind = (torch.as_tensor(U, device=dev), torch.as_tensor(V, device=dev))
    q0 = torch.as_tensor(np.stack([1.0 + np.cos(lat) * np.cos(lon),
                                   np.exp(-4.0 * (lon - np.pi) ** 2),
                                   np.cos(lat) ** 2]), device=dev)
    area = torch.as_tensor(np.asarray(geom.area2d), device=dev)
    out = {}
    for plain in (False, True):
        step = advection.make_advection_step(cfg, geom, wind, device=dev,
                                             plain=plain)
        counts.reset_launch_counts()
        q, t = q0, torch.zeros((), dtype=torch.float64, device=dev)
        for _ in range(nsteps):
            q = step(q, t)
            t = t + cfg.dt
        sync(dev)
        want = sw_counts({} if plain else {"dss_scalar": 5}, nsteps)
        if dict(counts.launch_counts) != want:
            raise RuntimeError(f"advection: launch counts "
                               f"{dict(counts.launch_counts)} != {want}")
        out[plain] = q
    err = rel_err(out[False], out[True])
    mass = [float((out[False][i] * area).sum() / (q0[i] * area).sum()) - 1.0
            for i in range(3)]
    if not (err < tol and max(abs(m) for m in mass) < 1e-12):
        raise RuntimeError(f"advection ne4: kernel vs plain {err}, species "
                           f"mass change {mass}")
    emit({"phase": "sw_slice", "config": "advection ne4 fp64, 3 species, "
          "3 steps", "kernel_vs_plain": err, "tol": tol,
          "species_mass_rel_change": mass,
          "launches_per_step": {"dss_scalar": 5}})

    # a 3-step graph replay against 3 eager steps
    _, cfg, geom, s0 = sw_setup("BarotropicInstability", torch.float64, 4,
                                dev, **nu)
    step = sw_model.make_sw_step(cfg, geom, device=dev)
    multi = sw_model.make_sw_multistep(cfg, geom, nsteps, device=dev)
    eager = s0
    for _ in range(nsteps):
        eager = step(eager)
    multi(s0)                                     # capture, first replay
    replay = multi(s0)
    same = all(torch.equal(replay[k], eager[k]) for k in s0)
    if not same:
        raise RuntimeError("sw slice: the graph replay differs from the "
                           "eager steps")
    emit({"phase": "sw_slice", "config": "Galewsky ne4 fp64, graph replay "
          "of 3 steps vs 3 eager steps", "bit_for_bit": same})


def sw_line(dev, smi, launches):
    """Phase 5i: Galewsky's barotropic instability at ne 60 p 4, f32, KGU35,
    dt 30 s, nu4 1e15 scaled locally, 6 model days through
    ``make_sw_multistep`` (20-step graphs): graph-replay ms/step (median of
    4 timed replays), device busy and device launches a step
    (``utils.devprof``), eager ms/step with the kernel launches a step by
    kernel, max |relative vorticity| at days 0, 4 and 6, the change of
    ``sw_energy`` and of the mass (both summed in float64); bars: every
    field finite at day 6, mass within 1e-5, the kernel path and the plain
    path within 1e-5 after 20 steps.  Then Williamson 2 at ne 30 (f64, dt
    100 s, no hyperdiffusion, one day) against its start to the bars of
    ``tests/test_shallow_water.py``; the CLI's ``sw_galewsky`` at
    resolution 60 for 20 steps with its invariants; and ``Model.go``
    restarted from a ``.tarena`` and an ``.npz`` checkpoint, each bit for
    bit the uninterrupted run."""
    import tempfile
    from tempestmodel_tpu_torch._device import OnDevice
    from tempestmodel_tpu_torch.io.diagnostics import error_norms
    from tempestmodel_tpu_torch.io.output import CompositeCheckpoint
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.models import hyperdiff, sw_model
    from tempestmodel_tpu_torch.models.shallow_water import sw_energy
    from tempestmodel_tpu_torch.utils import devprof

    t0 = time.perf_counter()
    tc, cfg, geom, s0 = sw_setup("BarotropicInstability", torch.float32,
                                 SW_NE, dev, dt=SW_DT)
    st = sw_model.sw_statics(geom, dev)
    g64 = OnDevice(sw_model.build_sw_geometry(cfg.with_(
        dtype=torch.float64)), dev)
    setup_s = time.perf_counter() - t0
    A = SW_NE * ORDER
    config = (f"Galewsky barotropic instability ne{SW_NE} p{ORDER} "
              f"(6 x {A} x {A}) f32 KGU35 dt{SW_DT:g} nu4 {cfg.nu_scalar:g} "
              f"scaled locally")
    steps_a_day = int(round(86400.0 / SW_DT))

    def diag(s):
        s64 = {k: v.double() for k, v in s.items()}
        vort = hyperdiff.curl_and_div(s["U"], s["V"], st)[0]
        return {"max_abs_vorticity": float(vort.abs().max()),
                "energy": float(sw_energy(s64, g64, cfg.constants)),
                "mass": float((s64["H"] * g64.area2d).sum())}

    # the kernel path and the plain path, 20 eager steps each
    ends = {}
    for plain in (False, True):
        step = sw_model.make_sw_step(cfg, geom, device=dev, plain=plain)
        s = s0
        for _ in range(SW_CHECK_STEPS):
            s = step(s)
        sync(dev)
        ends[plain] = s
    kp = {k: rel_err(ends[False][k], ends[True][k]) for k in s0}
    if not max(kp.values()) < 1e-5:
        raise RuntimeError(f"Galewsky: kernel vs plain path after "
                           f"{SW_CHECK_STEPS} steps {kp}")
    del ends

    # eager: launches a step by kernel, ms/step
    step = sw_model.make_sw_step(cfg, geom, device=dev)
    s = step(s0)
    sync(dev)
    counts.reset_launch_counts()
    s = step(s)
    sync(dev)
    launches["sw_eager_step"] = dict(counts.launch_counts)
    if launches["sw_eager_step"] != sw_counts(SW_PER_STEP):
        raise RuntimeError(f"Galewsky eager: launch counts a step "
                           f"{launches['sw_eager_step']} != {SW_PER_STEP}")
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    ev0.record()
    for _ in range(FLAGSHIP_STEPS):
        s = step(s)
    ev1.record()
    torch.cuda.synchronize()
    eager_ms = ev0.elapsed_time(ev1) / FLAGSHIP_STEPS
    eager_wall_ms = 1e3 * (time.perf_counter() - t1) / FLAGSHIP_STEPS
    del s, step

    # six days through make_sw_multistep: counts from 0 over the capture
    multi = sw_model.make_sw_multistep(cfg, geom, SW_GRAPH, device=dev)
    d0 = diag(s0)
    days = {0: d0["max_abs_vorticity"]}
    counts.reset_launch_counts()
    t1 = time.perf_counter()
    s = multi(s0)                       # warm-up step, capture, first replay
    sync(dev)
    capture_s = time.perf_counter() - t1
    launches["sw"] = dict(counts.launch_counts)
    if launches["sw"] != sw_counts(SW_PER_STEP, SW_GRAPH + 1):
        raise RuntimeError(f"Galewsky multistep: launch counts "
                           f"{launches['sw']} != "
                           f"{sw_counts(SW_PER_STEP, SW_GRAPH + 1)}")
    replay_ms = []
    for _ in range(REPLAYS):
        ev0.record()
        s = multi(s)
        ev1.record()
        torch.cuda.synchronize()
        replay_ms.append(ev0.elapsed_time(ev1) / SW_GRAPH)
    busy_ms, nkern = devprof.device_time_ms(multi, s)
    by_kernel = profile_steps(lambda x, c: (multi(x), c), s, {}, 1,
                              "shallow_water_multistep", SW_GRAPH)
    done = SW_GRAPH * (1 + REPLAYS)
    total = SW_DAYS * steps_a_day
    t1 = time.perf_counter()
    while done < total:
        s = multi(s)
        done += SW_GRAPH
        if done % steps_a_day == 0 and done // steps_a_day == 4:
            days[4] = diag(s)["max_abs_vorticity"]
    sync(dev)
    run_s = time.perf_counter() - t1
    check_finite(s, "Galewsky day 6", torch.float32)
    d6 = diag(s)
    days[SW_DAYS] = d6["max_abs_vorticity"]
    dmass = d6["mass"] / d0["mass"] - 1.0
    if not abs(dmass) < 1e-5:
        raise RuntimeError(f"Galewsky: mass changed by {dmass}")
    ms = sorted(replay_ms)[len(replay_ms) // 2]
    emit({"phase": "shallow_water", "path": "multistep", "config": config,
          "steps": total, "model_days": SW_DAYS, "inner_steps": SW_GRAPH,
          "host_setup_s": setup_s, "warmup_capture_first_replay_s": capture_s,
          "ms_per_step": ms, "ms_per_step_each_replay": replay_ms,
          "gridpoint_steps_per_s": 6 * A * A / (ms * 1e-3),
          "device_busy_ms_per_step": busy_ms / SW_GRAPH,
          "device_launches_per_step": nkern / SW_GRAPH,
          "device_ms_per_step_of_the_kernels": {
              k: sum(r["device_ms_per_step"] for r in by_kernel["all"]
                     if k in r["name"])
              for k in ("band_kernel", "nu4_kernel")},
          "eager_ms_per_step": eager_ms,
          "eager_wall_ms_per_step": eager_wall_ms,
          "kernel_launches_per_step": {k: v for k, v in
                                       launches["sw_eager_step"].items()
                                       if v},
          "launches": launches["sw"],
          "launches_counted": f"at capture (1 warm-up step + {SW_GRAPH} "
                              f"captured steps), not at replay",
          "wall_s_of_the_remaining_replays": run_s,
          "max_abs_relative_vorticity_by_day": days,
          "energy_rel_change": d6["energy"] / d0["energy"] - 1.0,
          "mass_rel_change": dmass,
          "kernel_vs_plain_after_20_steps": kp, "card": smi})
    del multi, s

    # Williamson 2 at ne 30, f64, one day without hyperdiffusion
    _, cfg2, geom2, w0 = sw_setup("Williamson2", torch.float64, TC2_NE, dev,
                                  dt=TC2_DT, hyperdiffusion=False)
    st2 = sw_model.sw_statics(geom2, dev)
    multi = sw_model.make_sw_multistep(cfg2, geom2, TC2_GRAPH, device=dev)
    counts.reset_launch_counts()
    s = w0
    t1 = time.perf_counter()
    for _ in range(TC2_STEPS // TC2_GRAPH):
        s = multi(s)
    sync(dev)
    tc2_s = time.perf_counter() - t1
    launches["sw_tc2"] = dict(counts.launch_counts)
    if launches["sw_tc2"] != sw_counts(SW_PER_STEP_NOHYPERVIS,
                                       TC2_GRAPH + 1):
        raise RuntimeError(f"TC2: launch counts {launches['sw_tc2']}")
    check_finite(s, "TC2", torch.float64)
    en = error_norms(s, w0, st2.area2d)
    e0 = float(sw_energy(w0, st2, cfg2.constants))
    e1 = float(sw_energy(s, st2, cfg2.constants))
    bars = {"H_l2_rel": float(en["H"]["l2_rel"]),
            "U_l2_rel": float(en["U"]["l2_rel"]),
            "energy_ratio_minus_1": e1 / e0 - 1.0}
    if not (bars["H_l2_rel"] < 1e-5 and bars["U_l2_rel"] < 1e-4
            and abs(bars["energy_ratio_minus_1"]) < 1e-10):
        raise RuntimeError(f"TC2 ne{TC2_NE}: {bars}")
    emit({"phase": "shallow_water", "path": "tc2",
          "config": f"Williamson 2 ne{TC2_NE} p{ORDER} f64 dt{TC2_DT:g} no "
                    f"hyperdiffusion, {TC2_STEPS} steps (1 day)",
          "bars": bars, "limits": {"H_l2_rel": 1e-5, "U_l2_rel": 1e-4,
                                   "abs_energy_ratio_minus_1": 1e-10},
          "wall_s": tc2_s, "ms_per_step": 1e3 * tc2_s / TC2_STEPS,
          "launches": launches["sw_tc2"], "card": smi})
    del multi, s, st2

    # the CLI's sw_galewsky at resolution 60, and Model.go restarted
    argv = ["--case", "sw_galewsky", "--resolution", str(SW_NE), "--dt",
            f"{SW_DT:g}s", "--nsteps", str(SW_CLI_STEPS), "--checksum_dt",
            f"{SW_EVERY * SW_DT:g}s"]
    text, wall, cli_counts = run_cli(argv, dev)
    inv = [l for l in text.splitlines() if "..Invariants" in l]
    if len(inv) != SW_CLI_STEPS // SW_EVERY + 1 or any(
            "nan" in l or "inf" in l for l in inv):
        raise RuntimeError(f"CLI sw_galewsky: invariants {inv}")
    want = sw_counts(SW_PER_STEP, SW_EVERY + 1)
    if cli_counts != want:
        raise RuntimeError(f"CLI sw_galewsky: launch counts {cli_counts} != "
                           f"{want}")
    emit({"phase": "shallow_water", "path": "cli", "argv": argv,
          "wall_s": wall, "invariants": inv,
          "timers": parse_timers(text), "launches": cli_counts, "card": smi})
    with tempfile.TemporaryDirectory() as tmp:
        every = SW_EVERY * SW_DT
        m = Model(cfg, tc, output_managers=[
            CompositeCheckpoint(every, tmp, fmt="npz"),
            CompositeCheckpoint(every, tmp, prefix="arena", fmt="arena")],
            device=dev)
        m.go(nsteps=2 * SW_EVERY)
        same = {}
        for fmt, path in (("npz", f"restart.{every:012.2f}.npz"),
                          ("tarena", f"arena.{every:012.2f}.tarena")):
            r = Model(cfg, tc, device=dev)
            r.restart_from(os.path.join(tmp, path))
            r.go(nsteps=SW_EVERY)
            same[fmt] = all(torch.equal(r.state[k], m.state[k])
                            for k in m.state)
            del r
    if not all(same.values()):
        raise RuntimeError(f"Galewsky Model.go restarts: bit for bit {same}")
    check_finite(m.state, "Galewsky Model.go", torch.float32)
    emit({"phase": "shallow_water", "path": "model_restarts",
          "steps": 2 * SW_EVERY, "restart_at_step": SW_EVERY,
          "bit_for_bit": same, "card": smi})
    del m
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the vertical options (phases 4 and 5j): the dense, Schur and JFNK column
# solvers, the fully explicit vertical path and upwind_thermo=False
# ---------------------------------------------------------------------------

# the paths of this slice, by name: the configuration's changes from the
# flagship's (``vertical_solver="pallas"``)
VERT_PATHS = {
    "dense": dict(vertical_solver="dense"),
    "schur": dict(vertical_solver="schur"),
    "jfnk": dict(vertical_solver="jfnk"),
    "explicit": dict(explicit_vertical=True),
    "upwind_off": dict(upwind_thermo=False),
}
# the explicit path's dt: vertically stable at the layers' depth.  At ne4
# nz8 (3.75 km layers under 30 km) 5 s; on the flagship grid (1 km layers)
# 2 s: a CPU probe of the port (UMJS ne2 p4 nz30 f64, 150 steps) stayed
# finite at dt 1-5 s and turned non-finite at 6, 8 and 10 s
VERT_EXPLICIT_DT_NE4, VERT_EXPLICIT_DT = 5.0, 2.0
VERT_STEPS = 10             # steps of each Model.go call in phase 5j


def vertical_per_step(name):
    """Kernel launches per step of path ``name`` of this slice (the default
    DSS grouping; ``first_step`` has one implicit solve more): the dense
    and JFNK solves launch no kernel, the Schur solve one ``banded_solve``
    (its reduced system), ``upwind_off`` the fused implicit kernel without
    its penalty; the explicit path has no implicit solve and no W fold, so
    each stage's DSS and the tail's are one ``dss_state`` launch each."""
    n = fused_per_step(("state", "scalar2"))
    if name == "upwind_off":
        return n
    n = dict(n, fused_implicit_update=0)
    if name == "schur":
        n["banded_solve"] = 1
    elif name == "explicit":
        n.update(dss_uvw=0, dss_scalar2=0, dss_state=7)
    return n


def expected_counts(per_step, nsteps):
    """``nsteps`` steps and one ``first_step``, which has one implicit solve
    more (where the path has one)."""
    want = {k: v * (nsteps + 1) for k, v in per_step.items()}
    for k in IMPLICIT_SOLVES:
        want[k] += 1 if per_step[k] else 0
    return want


def vertical_config(name, dtype, ne, nz, explicit_dt):
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    tc = BaroclinicWaveUMJS(pert="exp")
    kw = dict(VERT_PATHS.get(name, {}))
    if name == "explicit":
        kw["dt"] = explicit_dt
    cfg = tm.ModelConfig(
        equation_set=tm.EquationSet.PRIMITIVE_NONHYDRO,
        grid_kind=tm.GridKind.CUBED_SPHERE, ne=ne, order=ORDER, nz=nz,
        ztop=tc.ztop, dt=DT, hyperdiffusion=True, nu_scalar=NU, nu_div=NU,
        nu_vort=NU, vertical_solver="pallas", dtype=dtype).with_(**kw)
    return tc, cfg


def check_vertical_slice(dev):
    """Phase 4, the vertical options: 3 steps of UMJS at ne4 p4 nz8 in
    float64 on the card, the kernel path against the plain path to 1e-11
    per field, for each path of ``VERT_PATHS`` (the explicit path at dt
    ``VERT_EXPLICIT_DT_NE4``) and the dense solver with three seeded tracer
    species (``banded_solve_multi`` under a solver that launches no kernel
    of its own); the kernel path's launches held to ``vertical_per_step``
    exactly; then ``make_fast_multistep`` (one replay of a 3-step CUDA
    graph) against 3 eager steps of each path to 1e-13.  Returns the
    launch counts of each kernel run."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts, synthetic
    from tempestmodel_tpu_torch.models import nh_model
    launched = {}
    for name in list(VERT_PATHS) + ["dense_tracers"]:
        base = "dense" if name == "dense_tracers" else name
        tc, cfg = vertical_config(base, torch.float64, 4, 8,
                                  VERT_EXPLICIT_DT_NE4)
        geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
        X0 = fast.pack_state(tc.initial_state(
            geom, cfg.constants, dtype=cfg.dtype, device=dev), device=dev)
        per = vertical_per_step(base)
        what = f"UMJS ne4 p4 nz8 f64 dt{cfg.dt:g}, {base}"
        if name == "dense_tracers":
            rng = np.random.default_rng(SEED + 17)
            for k in ("U", "V", "Rt", "Rho"):
                X0[k] = X0[k] * (1.0 + 1e-3 * torch.as_tensor(
                    rng.standard_normal(tuple(X0[k].shape)), device=dev))
            X0["Tracers"] = torch.as_tensor(synthetic.random_tracers_numpy(
                cfg.nz, 6, 16, 16, NTR, cfg.order, seed=SEED + 18),
                device=dev)
            per = moist(per)
            what += f", {NTR} seeded tracer species"
        outs = {}
        for path, pk in (("kernels", {}), ("plain", {"plain": True})):
            counts.reset_launch_counts()
            first, step = fast.make_fast_step(cfg, geom, device=dev, **pk)
            X, c = first(X0)
            for _ in range(2):
                X, c = step(X, c)
            torch.cuda.synchronize()
            outs[path] = X
            if path == "kernels":
                launched[name] = dict(counts.launch_counts)
        want = expected_counts(per, 2)
        if launched[name] != want:
            raise RuntimeError(f"{what}: launch counts {launched[name]} != "
                               f"expected {want}")
        errs = {k: rel_err(outs["kernels"][k], outs["plain"][k])
                for k in outs["kernels"]}
        # graph replay of 3 steps against 3 eager steps from one state
        first, step = fast.make_fast_step(cfg, geom, device=dev)
        X1, c1 = first(X0)
        E, ce = X1, c1
        for _ in range(3):
            E, ce = step(E, ce)
        _, multi = fast.make_fast_multistep(cfg, geom, 3, device=dev)
        G, cg = multi(X1, c1)
        G, cg = multi(X1, c1)             # a pure replay
        torch.cuda.synchronize()
        replay = {k: rel_err(G[k], E[k]) for k in E}
        emit({"phase": "vertical_slice", "config": what + ", 3 steps",
              "kernels_vs_plain": errs, "tol": 1e-11,
              "replay_vs_eager": replay, "replay_tol": 1e-13,
              "launches": launched[name], "launches_per_step": per})
        if not (max(errs.values()) < 1e-11
                and max(replay.values()) < 1e-13):
            raise RuntimeError(f"{what}: paths disagree {errs} / replay "
                               f"{replay}")
        check_finite(outs["kernels"], what, torch.float64)
    return launched


def vertical_line(dev, smi, launches):
    """Phase 5j: this slice's paths on the flagship grid (UMJS ne30 p4 L30
    f32, dt 100 s, nu 1e15) through ``Model`` as a user builds it: the
    banded run the others are held to (``"pallas"``, the main path), the
    dense, Schur and JFNK solvers, the explicit vertical path at dt
    ``VERT_EXPLICIT_DT`` beside the banded run at that dt, and JW (its
    terrain; the geometry in float32: the stage's 3-D metric form) with
    ``upwind_thermo=False`` beside JW with it.  Each: ``go`` of
    ``VERT_STEPS`` steps from the start (``first_step`` and a graph of the
    rest: the launches counted there, held to ``vertical_per_step``), one
    more to capture a ``VERT_STEPS``-step graph, one timed (CUDA events:
    graph replay), one profiled (device busy and device launches a step,
    ``utils.devprof``); finite fields; the first run's state against its
    banded run's (relative per field).  JFNK also in float64 beside a
    banded float64 run."""
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveJW)
    from tempestmodel_tpu_torch.utils import devprof
    runs = [("banded", "pallas", "umjs"), ("dense", "dense", "umjs"),
            ("schur", "schur", "umjs"), ("jfnk", "jfnk", "umjs"),
            ("banded_dt2", "pallas", "umjs_dt2"),
            ("explicit", "explicit", "umjs_dt2"),
            ("jw", "pallas", "jw"), ("jw_upwind_off", "upwind_off", "jw"),
            ("banded_f64", "pallas", "umjs_f64"),
            ("jfnk_f64", "jfnk", "umjs_f64")]
    ref = {"umjs": "banded", "umjs_dt2": "banded_dt2", "jw": "jw",
           "umjs_f64": "banded_f64"}
    finals = {}
    for run, path, case in runs:
        tc, cfg = vertical_config(path if path != "pallas" else "",
                                  torch.float32, NE, NZ, VERT_EXPLICIT_DT)
        kw = {}
        if case == "umjs_dt2":
            cfg = cfg.with_(dt=VERT_EXPLICIT_DT)
        if case == "umjs_f64":
            cfg = cfg.with_(dtype=torch.float64)
        if case == "jw":
            tc = BaroclinicWaveJW(pert="exp")
            cfg = cfg.with_(ztop=tc.ztop)
            kw["topography"] = (lambda c: lambda lon, lat: tc.topography(
                lon, lat, c))(cfg.constants)
        t0 = time.perf_counter()
        m = Model(cfg, tc, device=dev, **kw)
        setup_s = time.perf_counter() - t0
        counts.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m.go(nsteps=VERT_STEPS)             # first_step, then a graph
        sync(dev)
        first_go_s = time.perf_counter() - t0
        launches[f"vertical_{run}"] = got = dict(counts.launch_counts)
        per = vertical_per_step(path) if path != "pallas" \
            else fused_per_step(("state", "scalar2"))
        want = expected_counts(per, VERT_STEPS)
        if got != want:
            raise RuntimeError(f"5j {run}: launch counts {got} != expected "
                               f"{want}")
        X10 = {k: v.clone() for k, v in m.state.items()}
        check_finite(X10, f"5j {run}", cfg.dtype)
        finals[run] = X10
        m.go(nsteps=VERT_STEPS)             # captures a VERT_STEPS graph
        sync(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        m.go(nsteps=VERT_STEPS)             # a replay
        ev1.record()
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / VERT_STEPS
        ms = ev0.elapsed_time(ev1) / VERT_STEPS
        busy_ms, nkern = devprof.device_time_ms(
            lambda: m.go(nsteps=VERT_STEPS))
        # finite after the 50 steps: required but of JFNK in float32,
        # whose unpreconditioned GMRES(48) x 2 leaves W 25x the dense
        # solver's after 10 steps at nz 30 in the JAX package as in the port
        # (CPU, ne2), and turns non-finite here within 50 steps
        finite_50 = all(bool(torch.isfinite(v).all())
                        for v in m.state.values())
        if not finite_50 and (path, cfg.dtype) != ("jfnk", torch.float32):
            raise RuntimeError(f"5j {run}: non-finite after 50 steps")
        diff = None
        if run != ref[case]:
            diff = {k: rel_err(X10[k], finals[ref[case]][k]) for k in X10}
        emit({"phase": "vertical", "run": run, "path": path,
              "config": (f"{'JW' if case == 'jw' else 'UMJS'} ne{NE} "
                         f"p{ORDER} nz{NZ} "
                         f"{'f64' if case == 'umjs_f64' else 'f32'} "
                         f"dt{cfg.dt:g} nu{NU:g}, "
                         f"vertical_solver {cfg.vertical_solver}, "
                         f"explicit_vertical {cfg.explicit_vertical}, "
                         f"upwind_thermo {cfg.upwind_thermo}"),
              "ms_per_step": ms, "timed_as": "graph replay through "
              f"Model.go ({VERT_STEPS}-step graph), CUDA events",
              "wall_ms_per_step": wall_ms,
              "device_busy_ms_per_step": busy_ms / VERT_STEPS,
              "device_launches_per_step": nkern / VERT_STEPS,
              "kernel_launches_per_step": {k: v for k, v in per.items()
                                           if v},
              "launches": got, "launches_counted": "first_step + 1 warm-up "
              f"step + {VERT_STEPS - 1} captured steps",
              "first_go_s": first_go_s, "model_setup_s": setup_s,
              "steps": 5 * VERT_STEPS, "finite_after_10_steps": True,
              "finite_after_50_steps": finite_50,
              "rel_diff_from": ref[case] if diff else None,
              "rel_diff_after_10_steps": diff,
              "peak_device_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
              "card": smi})
        del m
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the CPH, LEV and INT staggerings (phases 3, 4 and 5k)
# ---------------------------------------------------------------------------

STAGGERS = ("CPH", "LEV", "INT")
STAG_STEPS = 10             # steps of each Model.go call in phase 5k
# the staggerings' nu4 field sets (the INT state has LEV's shapes): the
# instantiations of csrc/hyper.cu besides the Lorenz one
NU4_SETS = ("CPH", "LEV")
# the port CLI's inertia-gravity wave at its defaults (nex 10, p 4, nu
# 1e15, dt and levels the reference's: dt 1 s, 10 levels; INT at vertical
# order 2), 40 steps
IGW_ARGV = ["--case", "inertia_gravity", "--levels", "10", "--dt", "1s",
            "--nsteps", "40", "--checksum_dt", "10s"]
# the staggered nu4 kernels' edge cases (kernels/hyper_edges.CASES): one
# level, a ring of three, an offset input, the generic instantiation, a
# plane in the swapped layout
STAG_EDGES = ("sphere_nz1", "sphere_ne4_ring3", "sphere_ne4_offset1",
              "sphere_ne2_p3", "cart_plane_swapped")


def stagger_per_step(merge=("state", "scalar2"), nu4=True):
    """Kernel launches per step of a CPH, LEV or INT state (``first_step``
    alike: the dense solve launches no kernel): the stage runs as tensor
    code, each of the 7 DSS (5 stages, 2 in the tail) is ``dss_vector``
    and its scalars (the two of one row count through ``dss_scalar2`` with
    ``"scalar2"``, the third through ``dss_scalar``; else three
    ``dss_scalar``: ``dss_state`` takes Lorenz shapes only), and the nu4
    kernels' staggered field set."""
    n = {k: 0 for k in KERNELS}
    n["dss_vector"] = 7
    if "scalar2" in merge:
        n.update(dss_scalar2=7, dss_scalar=7)
    else:
        n["dss_scalar"] = 21
    if nu4:
        n.update(nu4_pass1=1, nu4_pass2=1)
    return n


def check_stagger_kernels(geom, rows, dev):
    """Phase 3, the staggerings: ``nu4_pass1`` and ``nu4_pass2`` in the
    CPH field set (Rt and W on the nz + 1 interfaces) and the LEV field set
    (every field on the nz levels; INT's too) against their plain versions
    at the flagship shapes (the terrain-like metric of
    ``check_tail_kernels``, random fields), float32 and float64, timed
    beside their plain versions and their bounds, the Lorenz
    instantiation's error on the same inputs beside them; the DSS launches
    of a staggered step at its shapes (``dss_scalar2`` on the two scalars
    of one row count, ``dss_scalar`` on the third), bit for bit their
    plain versions, timed with their bounds; then the nu4 sets at the edge
    shapes of ``STAG_EDGES``.  Adds the float32 figures to
    ``rows[name]["staggered"]``."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import hyper_cuda
    from tempestmodel_tpu_torch.kernels import hyper_edges, synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    for dtype in (torch.float64, torch.float32):
        tag = "f32" if dtype == torch.float32 else "f64"
        f32 = dtype == torch.float32
        esize = 4 if f32 else 8
        # the plain forms' rounding (the Lorenz set: about 2e-7 / 4e-16)
        # with headroom
        tol = 2e-6 if f32 else 1e-14
        fgt = synthetic.terrain_like(
            fast.build_fast_geometry(geom, dtype=dtype, device=dev),
            seed=SEED, vary_jac=True)
        K, P, A = fgt.nz, 6, fgt.A
        hst = hyper_cuda.hyper_statics(fgt)
        n2d = P * A * A
        for stag in ("LOR",) + NU4_SETS:
            sets = [(synthetic.random_state(fgt, seed=s, stagger=stag),
                     synthetic.random_state(fgt, seed=s + 10,
                                            stagger=stag)) for s in (1, 2)]
            d, w = sets[0]
            unit = hyper_cuda.nu4_pass1_plain(w, fgt, hst)
            nu_s = float(d["Rho"].abs().max() / unit["Rho"].abs().max())
            nu_v = float(d["U"].abs().max() / unit["U"].abs().max())
            nu = (nu_s, nu_v, 0.7 * nu_v, 1.0)
            del unit
            got = hyper_cuda.nu4_pass1(d, fgt, hst)
            torch.cuda.synchronize()
            want = hyper_cuda.nu4_pass1_plain(d, fgt, hst)
            err1 = {k: rel_err(got[k], want[k]) for k in got}
            got = hyper_cuda.nu4_pass2(d, w, *nu, fgt, hst)
            torch.cuda.synchronize()
            want = hyper_cuda.nu4_pass2_plain(d, w, *nu, fgt, hst)
            err2 = {k: max(rel_err(got[k], want[k]),
                           rel_err(got[k] - d[k], want[k] - d[k]))
                    for k in got}
            del got, want
            nstate = sum(v.numel() for v in d.values())
            steps = K + (0 if stag == "LEV" else 1)
            scal2 = (nu[1], nu[2], nu[3], nu[3] * nu[0])
            for name, errs, launch, plain, nfields, line in (
                    ("nu4_pass1", err1,
                     lambda x, y: hyper_cuda._launch(
                         "nu4_pass1", x, None, (1.0, 1.0, 0.0, 0.0), hst),
                     lambda x, y: hyper_cuda.nu4_pass1_plain(x, fgt, hst),
                     2, 177),
                    ("nu4_pass2", err2,
                     lambda x, y: hyper_cuda._launch("nu4_pass2", y, x,
                                                     scal2, hst),
                     lambda x, y: hyper_cuda.nu4_pass2_plain(x, y, *nu, fgt,
                                                             hst),
                     3, 192)):
                if not max(errs.values()) <= tol:
                    raise RuntimeError(f"{name} {stag} {tag}: rel err "
                                       f"{errs} > {tol}")
                row = {"name": name, "field_set": stag, "route": "cuda",
                       "source": "tempestmodel_tpu_torch/csrc/hyper.cu",
                       "replaces": "tempestmodel_tpu/fast/hyper_pallas.py:"
                                   f"{line}",
                       "shape": [K, P, A, A],
                       "max_abs_err": max(errs.values()),
                       "err_by_field": errs, "tol": tol,
                       "launch": hyper_cuda.launch_config(
                           w if name == "nu4_pass2" else d,
                           d if name == "nu4_pass2" else None, hst)}
                if stag != "LOR":
                    ms = time_cuda(launch, sets, reps=20, queued=True)
                    plain_ms = time_cuda(plain, sets, reps=3, warmup=1)
                    # each input read once, each output written once; the
                    # arithmetic of ``check_tail_kernels`` a node and step
                    nb = (nfields * nstate + 8 * n2d
                          + hst.ds.numel()) * esize
                    bnd, by = bound_ms(nb, 220 * steps * n2d, dtype)
                    row.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                               bound_by=by, library_ms=None)
                emit({"phase": "kernel", "dtype": tag, **row})
                if f32 and stag != "LOR":
                    rows[name].setdefault("staggered", {})[stag] = row
            del sets, d, w
        # the DSS launches of a staggered step at its shapes: ``dss_scalar2``
        # on the pair of one row count (CPH: Rt and W, 31 rows; LEV: Rt and
        # Rho, 30), ``dss_scalar`` on the odd one (CPH: Rho; LEV: W, 30
        # rows), each bit for bit its plain version, timed with its bound
        from tempestmodel_tpu_torch.fast import dss_cuda
        sc = (fgt.inv_mult, fgt.dss_links, fgt.p)
        for stag, pair, alone in (("CPH", ("Rt", "W"), "Rho"),
                                  ("LEV", ("Rt", "Rho"), "W")):
            sets = [(synthetic.random_state(fgt, seed=s, stagger=stag),)
                    for s in (3, 4, 5, 6)]
            d = sets[0][0]
            g1, g2 = dss_cuda.dss_scalar2(d[pair[0]], d[pair[1]], *sc,
                                          table=fgt.dss_table)
            g3 = dss_cuda.dss_scalar(d[alone], *sc, table=fgt.dss_table)
            torch.cuda.synchronize()
            w1, w2 = dss_cuda.dss_scalar2_plain(d[pair[0]], d[pair[1]], *sc)
            w3 = dss_cuda.dss_scalar_plain(d[alone], *sc)
            bitwise = (torch.equal(g1, w1) and torch.equal(g2, w2)
                       and torch.equal(g3, w3))
            if not bitwise:
                raise RuntimeError(f"the {stag} DSS launches {tag} differ "
                                   f"from their plain versions")
            for name, fn, nf, rows_k in (
                    ("dss_scalar2", lambda x: dss_cuda.dss_scalar2(
                        x[pair[0]], x[pair[1]], *sc, table=fgt.dss_table),
                     2, d[pair[0]].shape[0]),
                    ("dss_scalar", lambda x: dss_cuda.dss_scalar(
                        x[alone], *sc, table=fgt.dss_table), 1,
                     d[alone].shape[0])):
                ms = time_cuda(fn, sets, reps=40, queued=True)
                nvals = nf * rows_k * n2d
                bnd, by = bound_ms((2 * nvals + n2d) * esize
                                   + fgt.dss_table.numel() * 4,
                                   5 * nvals, dtype)
                row = {"name": name, "field_set": stag,
                       "fields": list(pair) if nf == 2 else [alone],
                       "shape": [rows_k, P, A, A], "bitwise": True,
                       "max_abs_err": 0.0, "ms": ms, "bound_ms": bnd,
                       "bound_by": by}
                emit({"phase": "kernel", "dtype": tag, **row})
                if f32:
                    rows.setdefault(name, {}).setdefault(
                        "staggered", {})[stag] = row
            del sets, d
        del fgt, hst
        torch.cuda.empty_cache()
        for stag in NU4_SETS:
            for case in STAG_EDGES:
                got = hyper_edges.run_case(case, dtype, dev, stag)
                edge_tol = 1e-4 if f32 else 1e-11
                emit({"phase": "kernel", "dtype": tag, "tol": edge_tol,
                      "name": "nu4_edge", "field_set": stag, "case": case,
                      **got})
                if not got["max_err"] <= edge_tol:
                    raise RuntimeError(f"nu4 edge case {case} {stag} {tag}: "
                                       f"rel err {got['err_by_output']} > "
                                       f"{edge_tol}")


def stagger_config(stag, dtype, ne, nz, xz=False, rayleigh=True):
    """(testcase, cfg) of the staggering ``stag`` (or ``"LOR"``): UMJS with
    its perturbation (and its Rayleigh layer with ``rayleigh``) at ``ne``
    p4 ``nz`` levels, nu4 1e15, dt 100 s; or (``xz``) the inertia-gravity
    wave x-z slice at nex 4, nu4 1e12, dt 2 s.  INT at vertical order
    2."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    from tempestmodel_tpu_torch.testcases.nonhydro_xz import (
        InertiaGravityWave)
    kw = dict(equation_set=tm.EquationSet.PRIMITIVE_NONHYDRO, order=ORDER,
              nz=nz, vertical_order=2 if stag == "INT" else 1,
              vertical_staggering=tm.VerticalStaggering(stag),
              hyperdiffusion=True, vertical_solver="pallas", dtype=dtype)
    if xz:
        tc = InertiaGravityWave()
        cfg = tm.ModelConfig(grid_kind=tm.GridKind.CARTESIAN_XZ, nex=ne,
                             ney=1, ztop=tc.ztop, x_extent=tc.x_extent,
                             y_extent=tc.y_extent, dt=2.0, nu_scalar=1e12,
                             nu_div=1e12, nu_vort=1e12, **kw)
    else:
        tc = BaroclinicWaveUMJS(pert="exp", rayleigh=rayleigh)
        cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=ne,
                             ztop=tc.ztop, dt=DT, nu_scalar=NU, nu_div=NU,
                             nu_vort=NU, rayleigh_damping=rayleigh, **kw)
    return tc, cfg


def check_stagger_slice(dev):
    """Phase 4, the staggerings: 3 steps in float64 on the card of UMJS at
    ne4 p4 nz8 (its Rayleigh layer, nu4) and of the inertia-gravity wave
    x-z slice (nex 4, nz 8, nu4), each under CPH, LEV and INT (nz 9,
    vertical order 2), through ``Model`` (the staggered start as a user
    gets it): the kernel path against the plain path (``plain=True``) to
    1e-11 per field, the kernel path's launches held to
    ``stagger_per_step`` exactly, and ``make_fast_multistep`` (one replay
    of a 3-step CUDA graph) against 3 eager steps to 1e-13.  Returns the
    launch counts of each kernel run."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.model import Model
    launched = {}
    for grid in ("sphere", "xz"):
        for stag in STAGGERS:
            nz = 9 if stag == "INT" else 8
            tc, cfg = stagger_config(stag, torch.float64, 4, nz,
                                     xz=grid == "xz")
            m = Model(cfg, tc, device=dev)
            X0 = fast.pack_state(m.state, device=dev)
            ref = m.reference
            what = f"{grid} {stag} ne4 nz{nz} f64"
            outs = {}
            for path, pk in (("kernels", {}), ("plain", {"plain": True})):
                counts.reset_launch_counts()
                first, step = fast.make_fast_step(cfg, m.geom, ref_state=ref,
                                                  device=dev, **pk)
                X, c = first(X0)
                for _ in range(2):
                    X, c = step(X, c)
                torch.cuda.synchronize()
                outs[path] = X
                if path == "kernels":
                    launched[f"{grid}_{stag}"] = dict(counts.launch_counts)
            want = expected_counts(stagger_per_step(), 2)
            if launched[f"{grid}_{stag}"] != want:
                raise RuntimeError(f"{what}: launch counts "
                                   f"{launched[f'{grid}_{stag}']} != "
                                   f"expected {want}")
            errs = {k: rel_err(outs["kernels"][k], outs["plain"][k])
                    for k in outs["kernels"]}
            first, step = fast.make_fast_step(cfg, m.geom, ref_state=ref,
                                              device=dev)
            X1, c1 = first(X0)
            E, ce = X1, c1
            for _ in range(3):
                E, ce = step(E, ce)
            _, multi = fast.make_fast_multistep(cfg, m.geom, 3,
                                                ref_state=ref, device=dev)
            G, cg = multi(X1, c1)
            G, cg = multi(X1, c1)             # a pure replay
            torch.cuda.synchronize()
            replay = {k: rel_err(G[k], E[k]) for k in E}
            emit({"phase": "stagger_slice", "config": what + ", 3 steps",
                  "kernels_vs_plain": errs, "tol": 1e-11,
                  "replay_vs_eager": replay, "replay_tol": 1e-13,
                  "launches": launched[f"{grid}_{stag}"],
                  "launches_per_step": stagger_per_step(),
                  "shapes": {k: list(v.shape) for k, v in E.items()}})
            if not (max(errs.values()) < 1e-11
                    and max(replay.values()) < 1e-13):
                raise RuntimeError(f"{what}: paths disagree {errs} / replay "
                                   f"{replay}")
            check_finite(outs["kernels"], what, torch.float64)
            del m, outs, E, G
    return launched


def stagger_line(dev, smi, launches):
    """Phase 5k: the staggerings on the flagship grid (UMJS with its
    perturbation, ne30 p4 L30 f32, dt 100 s, nu 1e15: phase 5a's
    configuration) through ``Model`` as a user builds it, under LOR (the
    run the others stand beside; ``"pallas"``, the main path), LEV, INT
    (vertical order 2) and CPH (each solved densely, as in the JAX
    package), then LEV and INT with the case's Rayleigh layer (damping Rt
    on levels turns LEV and INT non-finite within 20 steps in the JAX
    package's own pieces at ne2 L30 on the CPU: reported, not held).
    Each: ``go`` of
    ``STAG_STEPS`` steps from the start (``first_step`` and a graph of the
    rest: the launches counted there, held to ``stagger_per_step``), one
    more to capture a ``STAG_STEPS``-step graph, one timed (CUDA events:
    graph replay), one profiled (device busy, device launches and the nu4
    and DSS kernels' shares a step); peak memory; max |W| after 10 and 40
    steps; finite after 10, and after 40 without the Rayleigh layer but
    for CPH (the JAX package's CPH grows from this start at ne2: its
    growth is reported, not held).  At ne30 LEV and INT grow past step 20
    with nu4 and without, on the kernel and the plain path, in float32 and
    float64, and are non-finite by step 45 (``kernels/stagger_growth.py``):
    finite after 40, held, is what the run can promise.  Then the CLI's
    inertia-gravity wave (its configuration from
    ``cli.configure`` of ``IGW_ARGV``, float64) the same way under LOR and
    each staggering, finite after 40 steps.  Then the DSS grouping of the
    staggered step timed both ways under graph replay (``dss_merge``
    ``("state", "scalar2")`` against the separate launches, in turns), and
    the CLI's inertia-gravity wave (``IGW_ARGV``) under each staggering
    and LOR: 40 steps, its checksums, wall time and launches."""
    from torch.profiler import profile, ProfilerActivity
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch import cli
    maxw = {}
    runs = ("LOR",) + STAGGERS + ("LEV_rayleigh", "INT_rayleigh")
    for run in runs + tuple(f"igw_{r}" for r in ("LOR",) + STAGGERS):
        igw = run.startswith("igw_")
        stag, _, ray = run.removeprefix("igw_").partition("_")
        if igw:
            # the CLI's configuration of the x-z slice (float64)
            tc, cfg, _ = cli.configure(cli.make_parser().parse_args(
                IGW_ARGV + ["--vstagger", stag]
                + (["--vertorder", "2"] if stag == "INT" else [])))
        else:
            tc, cfg = stagger_config(stag, torch.float32, NE, NZ,
                                     rayleigh=bool(ray))
        t0 = time.perf_counter()
        m = Model(cfg, tc, device=dev)
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.reset_launch_counts()
        t0 = time.perf_counter()
        m.go(nsteps=STAG_STEPS)             # first_step, then a graph
        sync(dev)
        first_go_s = time.perf_counter() - t0
        launches[f"stagger_{run}"] = got = dict(counts.launch_counts)
        per = (fused_per_step(("state", "scalar2")) if stag == "LOR"
               else stagger_per_step())
        want = expected_counts(per, STAG_STEPS)
        # the x-z slice's LOR run takes the CLI's banded solve (tensor
        # code): its launches are reported, not held to the table
        if got != want and not (igw and stag == "LOR"):
            raise RuntimeError(f"5k {run}: launch counts {got} != expected "
                               f"{want}")
        check_finite(m.state, f"5k {run}", cfg.dtype)
        w10 = float(m.state["W"].abs().max())
        m.go(nsteps=STAG_STEPS)             # captures a STAG_STEPS graph
        sync(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        m.go(nsteps=STAG_STEPS)             # a replay
        ev1.record()
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / STAG_STEPS
        ms = ev0.elapsed_time(ev1) / STAG_STEPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.go(nsteps=STAG_STEPS)         # a profiled replay
            sync(dev)
        busy = {"all": 0.0, "nu4": 0.0, "dss": 0.0}
        by_name = {}
        nkern = 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            busy["all"] += us
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + us
            nkern += 1
            if "nu4_kernel" in e.name:
                busy["nu4"] += us
            elif "band_kernel" in e.name:
                busy["dss"] += us
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        w40 = float(m.state["W"].abs().max())
        finite40 = all(bool(torch.isfinite(v).all())
                       for v in m.state.values())
        if not finite40 and (igw or stag != "CPH") and not ray:
            raise RuntimeError(f"5k {run}: non-finite after 40 steps")
        maxw[run] = (w10, w40)
        emit({"phase": "stagger", "staggering": stag, "run": run,
              "config": (f"the CLI's inertia_gravity {' '.join(IGW_ARGV)}: "
                         f"nex {cfg.nex} p{cfg.order} nz{cfg.nz} f64 dt"
                         f"{cfg.dt:g} nu{cfg.nu_scalar:g}" if igw else
                         f"UMJS pert exp{', Rayleigh' if ray else ''}, "
                         f"ne{NE} p{ORDER} nz{NZ} f32 dt{DT:g} nu{NU:g}")
                        + f", vertical order {cfg.vertical_order}, solver "
                        + (cfg.vertical_solver if stag == "LOR"
                           else "dense (forced)"),
              "ms_per_step": ms, "timed_as": "graph replay through "
              f"Model.go ({STAG_STEPS}-step graph), CUDA events",
              "wall_ms_per_step": wall_ms,
              "device_busy_ms_per_step": busy["all"] / 1e3 / STAG_STEPS,
              "device_launches_per_step": nkern / STAG_STEPS,
              "nu4_share_of_busy": busy["nu4"] / max(busy["all"], 1e-30),
              "dss_share_of_busy": busy["dss"] / max(busy["all"], 1e-30),
              "top_kernels_ms_per_step": {
                  k: v / 1e3 / STAG_STEPS for k, v in sorted(
                      by_name.items(), key=lambda kv: -kv[1])[:8]},
              "kernel_launches_per_step": {k: v for k, v in per.items()
                                           if v},
              "launches": got, "launches_counted": "first_step + 1 warm-up "
              f"step + {STAG_STEPS - 1} captured steps",
              "first_go_s": first_go_s, "model_setup_s": setup_s,
              "peak_device_GiB": peak,
              "max_abs_W_after_10": w10, "max_abs_W_after_40": w40,
              "lor_max_abs_W_after_10_40": maxw.get(
                  "igw_LOR" if igw else "LOR"),
              "finite_after_40_steps": finite40, "card": smi})
        del m, prof
        torch.cuda.empty_cache()

    # the DSS grouping of a staggered step, under graph replay, in turns
    for stag in ("CPH", "LEV"):
        tc, cfg = stagger_config(stag, torch.float32, NE, NZ,
                                 rayleigh=False)
        m = Model(cfg, tc, device=dev)
        X0 = fast.pack_state(m.state, device=dev)
        variants = {}
        for merge in (("state", "scalar2"), ()):
            first, multi = fast.make_fast_multistep(
                cfg, m.geom, STAG_STEPS, ref_state=m.reference, device=dev,
                dss_merge=merge)
            X, c = first(X0)
            multi(X, c)                     # capture
            variants["+".join(merge) or "separate"] = (multi, X, c, [])
        for name in list(variants) + list(variants)[::-1]:
            multi, X, c, times = variants[name]
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            multi(X, c)
            ev1.record()
            torch.cuda.synchronize()
            times.append(ev0.elapsed_time(ev1) / STAG_STEPS)
        emit({"phase": "stagger_dss", "staggering": stag,
              "replay_ms_per_step": {n: v[3] for n, v in variants.items()},
              "order": "forward then backward", "card": smi})
        del m, variants
        torch.cuda.empty_cache()

    # the CLI's inertia-gravity wave under each staggering
    for stag in ("LOR",) + STAGGERS:
        argv = IGW_ARGV + ["--vstagger", stag] + (
            ["--vertorder", "2"] if stag == "INT" else [])
        text, wall, got = run_cli(argv, dev)
        launches[f"stagger_igw_{stag}"] = got
        lines = [ln for ln in text.splitlines() if "..Checksums" in ln]
        if len(lines) != 5 or any("nan" in ln or "inf" in ln
                                  for ln in lines):
            raise RuntimeError(f"5k IGW {stag}: checksums {lines}")
        emit({"phase": "stagger_igw", "staggering": stag,
              "argv": argv, "wall_s": wall, "launches": got,
              "checksums_t40": lines[-1].split("  ", 1)[1], "card": smi})


# ---------------------------------------------------------------------------
# split-explicit (SPEX) and HighSpeed (HS) dynamics (phases 3, 4 and 5l)
# ---------------------------------------------------------------------------

SPLITS = ("SPEX", "HS")
SPLIT_STEPS = 10            # steps of each Model.go call in phase 5l
# the dt of each scheme on the flagship grid: 100 s where 10 steps stay
# finite, else the first of these that does.  UMJS at ne2 L30 on the CPU
# (f64): the port's SPEX is non-finite within 10 steps at 100, 50, 25 and
# 10 s and holds 40 steps at 5 s (its slow tendency keeps the vertical
# acoustic terms explicit; at ne2 nz6 and 100 s the JAX package's
# make_nh_step blows up alike, the same W to 4e-13 over 3 steps); HS holds
# 40 steps at 100 s
SPLIT_DTS = (100.0, 50.0, 25.0, 10.0, 5.0, 2.0)
# phase 4's dt at ne4 nz8 (3.75 km layers): SPEX holds 40 steps at 25 s at
# ne2 nz6 (CPU, f64)
SPLIT_DT_NE4 = {"SPEX": 25.0, "HS": 100.0}
# the first diagonal weight of ARS343b: the dt factor of HS's first solve
ARS343B_G = 0.4358665215084590


def split_per_step(scheme, ntr=0):
    """Kernel launches per SPEX or HS step (both self-starting: the first
    step is a step).  SPEX: in each of the five KGU35 stages the DSS of the
    full tendency and of the update (``dss_state``; the tracers through one
    ``dss_scalar`` beside each) and the three acoustic subcycles' vertical
    solves (``banded_solve``), then the nu4 tail (``nu4_pass1``, a
    ``dss_state``, ``nu4_pass2``, a ``dss_state``).  HS: three implicit
    solves (``banded_solve`` at q 1), seven momentum DSS (``dss_state`` with
    the contravariant edge table), then the same tail."""
    n = {k: 0 for k in KERNELS}
    n.update(nu4_pass1=1, nu4_pass2=1)
    if scheme == "SPEX":
        n.update(banded_solve=15, dss_state=12, dss_scalar=12 if ntr else 0)
    else:
        n.update(banded_solve=3, dss_state=9)
    return n


def split_config(scheme, dtype, ne, nz, dt, rayleigh=False):
    """(testcase, cfg): UMJS with its perturbation (its Rayleigh layer with
    ``rayleigh``) at ``ne`` p4 ``nz`` levels, nu4 1e15, under SPEX or HS
    (or ``"LOR"``: the Strang-HEVI run, the fused implicit kernel)."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    tc = BaroclinicWaveUMJS(pert="exp", rayleigh=rayleigh)
    ts = {"SPEX": tm.TimestepSchemeType.SPEX, "HS": tm.TimestepSchemeType.HS
          }.get(scheme, tm.TimestepSchemeType.STRANG)
    cfg = tm.ModelConfig(
        equation_set=tm.EquationSet.PRIMITIVE_NONHYDRO,
        grid_kind=tm.GridKind.CUBED_SPHERE, ne=ne, order=ORDER, nz=nz,
        ztop=tc.ztop, dt=dt, hyperdiffusion=True, nu_scalar=NU, nu_div=NU,
        nu_vort=NU, vertical_solver="pallas", rayleigh_damping=rayleigh,
        timescheme=ts, dtype=dtype)
    return tc, cfg


def check_split_kernels(geom, rows, dev):
    """Phase 3, SPEX and HS: ``banded_solve`` at HS's shape (n 31, q 1, the
    flagship's 86 400 columns: the tridiagonal systems of HS's first
    implicit solve, built from the flagship's start with seeded MW) and the
    momentum DSS (``dss_state`` with the contravariant edge table) on
    seeded momenta at the flagship shapes, each against its plain version
    in float32 and float64 (the DSS bit for bit), timed beside its plain
    version and its bound; ``banded_solve`` also beside the library call on
    the same systems (``torch.linalg.solve_ex`` through cuSOLVER on the
    densified systems, ``implicit.solve_batched``).  Adds the float32 rows
    under ``rows[name]["hs"]``."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.constants import DEFAULT_CONSTANTS
    from tempestmodel_tpu_torch.fast import dss_cuda, implicit
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import highspeed
    from tempestmodel_tpu_torch.ops import cuda_banded
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    tc = BaroclinicWaveUMJS(pert="exp")
    constants = DEFAULT_CONSTANTS
    for dtype in (torch.float64, torch.float32):
        tag = "f32" if dtype == torch.float32 else "f64"
        f32 = dtype == torch.float32
        esize = 4 if f32 else 8
        gen = torch.Generator(device=dev).manual_seed(SEED + 31)
        fg = fast.build_fast_geometry(geom, dtype=dtype, device=dev)
        hs = highspeed.hs_statics(geom, fg)
        X = fast.pack_state(tc.initial_state(geom, constants, dtype=dtype,
                                             device=dev), device=dev)
        m = highspeed.to_momentum(X, fg, hs)
        K, P, A = fg.nz, 6, fg.A
        ncol = P * A * A

        # --- banded_solve at q 1: HS's tridiagonal systems ---------------
        sets = []
        for _ in range(4):
            mw = m["MW"] + 0.1 * randn(tuple(m["MW"].shape), dtype, gen, dev)
            b, r, _, _ = highspeed.hs_tridiagonal(dict(m, MW=mw), hs,
                                                  constants, ARS343B_G * DT)
            sets.append((b.contiguous(), r.contiguous()))
        bands, rhs = sets[0]
        n = bands.shape[0]
        got = cuda_banded.banded_solve(bands, rhs, 1)
        torch.cuda.synchronize()
        want = cuda_banded.banded_solve_plain(bands, rhs, 1)
        err = rel_err(got, want)
        tol = 1e-5 if f32 else 1e-12
        if not err <= tol:
            raise RuntimeError(f"banded_solve q 1 {tag}: rel err {err} > "
                               f"{tol}")
        ms = time_cuda(lambda b, r: cuda_banded.banded_solve(b, r, 1), sets,
                       reps=20, queued=True)
        plain_ms = time_cuda(
            lambda b, r: cuda_banded.banded_solve_plain(b, r, 1), sets[:1],
            reps=2, warmup=1)
        dense = dense_from_bands(bands, 1)
        rhs3 = rhs.T.contiguous()[..., None]
        lib_x = implicit.solve_batched(dense, rhs3)[..., 0].T
        lib_err = rel_err(lib_x, want)
        library_ms = time_cuda(lambda: implicit.solve_batched(dense, rhs3),
                               [()], reps=3, warmup=1)
        del dense, lib_x, rhs3
        nb = (bands.numel() + 2 * rhs.numel()) * esize
        bnd, by = bound_ms(nb, n * ncol * 8, dtype)
        row = {"name": "banded_solve", "route": "cuda",
               "source": "tempestmodel_tpu_torch/csrc/banded_multi.cu",
               "replaces": "tempestmodel_tpu/ops/pallas_banded.py:185",
               "runs_for": "HS implicit solve (JAX: tridiagonal_solve, "
                           "models/highspeed.py:296)",
               "shape": [n, 3, ncol], "q": 1, "max_abs_err": err, "tol": tol,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
               "bound_by": by, "library_ms": library_ms,
               "library": "torch.linalg.solve_ex (cuSOLVER), densified",
               "library_rel_err": lib_err,
               "launch": cuda_banded.launch_config(bands, rhs, 1)}
        emit({"phase": "kernel", "dtype": tag, **row})
        if f32:
            rows["banded_solve"]["hs"] = row
        del sets, bands, rhs, got, want

        # --- the momentum DSS: dss_state with the contravariant table ----
        dsets = [({k: randn((K + (k == "W"), P, A, A), dtype, gen, dev)
                   for k in dss_cuda.STATE_FIELDS},) for _ in range(4)]
        d = dsets[0][0]
        args = (fg.inv_mult, hs.rot, fg.dss_links, fg.p)
        got = dss_cuda.dss_state(d, *args, table=fg.dss_table)
        torch.cuda.synchronize()
        want = dss_cuda.dss_state_plain(d, *args)
        fields = dss_cuda.STATE_FIELDS
        bitwise = all(torch.equal(got[k], want[k]) for k in fields)
        err = max(rel_err(got[k], want[k]) for k in fields)
        # the table rotates: the covariant one gives other MU, MV
        cov = dss_cuda.dss_state(d, fg.inv_mult, fg.e_rot, fg.dss_links,
                                 fg.p, table=fg.dss_table)
        differs = not torch.equal(cov["U"], got["U"])
        if not (bitwise and differs):
            raise RuntimeError(f"momentum DSS {tag}: bit for bit equal to "
                               f"the plain version: {bitwise} (rel err "
                               f"{err}); differs from the covariant "
                               f"table's: {differs}")
        ms = time_cuda(lambda x: dss_cuda.dss_state(x, *args,
                                                    table=fg.dss_table),
                       dsets, reps=20, queued=True)
        plain_ms = time_cuda(lambda x: dss_cuda.dss_state_plain(x, *args),
                             dsets, reps=3, warmup=1)
        nstate = sum(v.numel() for v in d.values())
        nlev, nint, n2d = K * ncol, (K + 1) * ncol, ncol
        nb = (2 * nstate + n2d + hs.rot.numel()) * esize \
            + fg.dss_table.numel() * 4
        bnd, by = bound_ms(nb, 16 * nlev + 5 * (2 * nlev + nint), dtype)
        row = {"name": "dss_state", "route": "cuda",
               "source": "tempestmodel_tpu_torch/csrc/dss.cu",
               "replaces": "tempestmodel_tpu/fast/dss_pallas.py:343",
               "runs_for": "HS momentum DSS, contravariant edge table "
                           "(JAX: models/highspeed.py:319-366)",
               "shape": [K, P, A, A], "max_abs_err": err, "bitwise": True,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
               "bound_by": by, "library_ms": None,
               "launch": dss_cuda.launch_config(
                   d["U"], fg.p, "state", dss_cuda._state_ptrs(
                       d, fg.inv_mult), True)}
        emit({"phase": "kernel", "dtype": tag, **row})
        if f32:
            rows["dss_state"]["hs"] = row
        del dsets, d, got, want, cov, fg, hs, X, m
        torch.cuda.empty_cache()


def check_split_slice(dev):
    """Phase 4, SPEX and HS: 3 steps of UMJS at ne4 p4 nz8 in float64 on
    the card (SPEX at dt 25 s with three seeded tracer species and a seeded
    W, HS at dt 100 s), the kernel path against the plain path
    (``plain=True``) to 1e-11 per field, the kernel path's launches held
    to ``split_per_step`` exactly, then one replay of a 3-step CUDA graph
    (``engine.graph_runner``) against 3 eager steps to 1e-13.  Returns
    the launch counts of each kernel run."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import engine
    from tempestmodel_tpu_torch.kernels import counts, synthetic
    from tempestmodel_tpu_torch.models import highspeed, nh_model
    from tempestmodel_tpu_torch.models import split_explicit
    launched = {}
    for scheme in SPLITS:
        tc, cfg = split_config(scheme, torch.float64, 4, 8,
                               SPLIT_DT_NE4[scheme])
        geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
        X0 = fast.pack_state(tc.initial_state(
            geom, cfg.constants, dtype=cfg.dtype, device=dev), device=dev)
        ntr = 0
        if scheme == "SPEX":
            gen = torch.Generator(device=dev).manual_seed(SEED + 41)
            w = 1e3 * randn(tuple(X0["W"].shape), cfg.dtype, gen, dev)
            w[0] = 0.0
            w[-1] = 0.0
            X0["W"] = w
            X0["Tracers"] = torch.as_tensor(synthetic.random_tracers_numpy(
                cfg.nz, 6, 16, 16, NTR, cfg.order, seed=SEED + 42),
                device=dev)
            ntr = NTR
        make = (split_explicit.make_spex_step if scheme == "SPEX"
                else highspeed.make_hs_step)
        what = f"{scheme} UMJS ne4 p4 nz8 f64 dt{cfg.dt:g}" + (
            f", {NTR} seeded tracer species, seeded W" if ntr else "")
        outs = {}
        for path, pk in (("kernels", {}), ("plain", {"plain": True})):
            counts.reset_launch_counts()
            step, _ = make(cfg, geom, device=dev, **pk)
            X, c = X0, {}
            for _ in range(3):
                X, c = step(X, c)
            torch.cuda.synchronize()
            outs[path] = X
            if path == "kernels":
                launched[scheme] = dict(counts.launch_counts)
        per = split_per_step(scheme, ntr)
        want = {k: 3 * v for k, v in per.items()}
        if launched[scheme] != want:
            raise RuntimeError(f"{what}: launch counts {launched[scheme]} "
                               f"!= expected {want}")
        errs = {k: rel_err(outs["kernels"][k], outs["plain"][k])
                for k in outs["kernels"]}
        step, _ = make(cfg, geom, device=dev)
        run = engine.graph_runner(step, 3)
        G, _ = run(X0, {})
        G, _ = run(X0, {})                  # a pure replay
        torch.cuda.synchronize()
        replay = {k: rel_err(G[k], outs["kernels"][k]) for k in G}
        emit({"phase": "split_slice", "scheme": scheme,
              "config": what + ", 3 steps", "kernels_vs_plain": errs,
              "tol": 1e-11, "replay_vs_eager": replay, "replay_tol": 1e-13,
              "launches": launched[scheme], "launches_per_step": per})
        if not (max(errs.values()) < 1e-11
                and max(replay.values()) < 1e-13):
            raise RuntimeError(f"{what}: paths disagree {errs} / replay "
                               f"{replay}")
        check_finite(outs["kernels"], what, torch.float64)
        del outs, G, run
    return launched


def split_line(dev, smi, launches):
    """Phase 5l: SPEX and HS on the flagship grid (UMJS with its
    perturbation, no Rayleigh layer, ne30 p4 L30 f32, nu 1e15) through
    ``Model`` as a user builds it, beside the LOR Strang-HEVI run (dt 100
    s, the fused implicit kernel) in the same call.  Each scheme's dt: 100
    s where 10 steps stay finite, else the first of ``SPLIT_DTS`` that
    does (the probes run ``step`` eagerly; their max |W| is reported).
    Each run: ``go`` of ``SPLIT_STEPS`` steps from the start (SPEX and HS:
    one graph of 10, its warm-up step and its captured steps counted, held
    to ``split_per_step``; LOR: ``first_step`` and a graph of 9), one more
    to capture a ``SPLIT_STEPS``-step graph, one timed (CUDA events: graph
    replay), one profiled (device busy, device launches, the banded, DSS and
    nu4 kernels' shares a step, the costliest kernels); peak memory; max
    |W| after 10 and 40 steps, finite after 40 (held for LOR and HS; for
    SPEX, whose dt the 10-step rule chose, reported)."""
    from torch.profiler import profile, ProfilerActivity
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.models import nh_model
    t0 = time.perf_counter()
    dts, probes = {"LOR": DT}, {}
    tc, cfg = split_config("LOR", torch.float32, NE, NZ, DT)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    X0 = None
    for scheme in SPLITS:
        for dt in SPLIT_DTS:
            _, c = split_config(scheme, torch.float32, NE, NZ, dt)
            _, step, _ = nh_model._step_fns(c, geom, None, dev)
            if X0 is None:
                from tempestmodel_tpu_torch import fast
                X0 = fast.pack_state(tc.initial_state(
                    geom, c.constants, dtype=c.dtype, device=dev),
                    device=dev)
            X, k = X0, {}
            for _ in range(SPLIT_STEPS):
                X, k = step(X, k)
            finite = all(bool(torch.isfinite(v).all()) for v in X.values())
            probes.setdefault(scheme, []).append(
                {"dt": dt, "finite_after_10": finite,
                 "max_abs_W_after_10": float(X["W"].abs().max())})
            del step, X
            if finite:
                dts[scheme] = dt
                break
        if scheme not in dts:
            raise RuntimeError(f"5l {scheme}: no dt of {SPLIT_DTS} holds 10 "
                               f"steps finite: {probes[scheme]}")
    del geom, X0
    torch.cuda.empty_cache()
    emit({"phase": "split_dt", "dt_used": dts, "probes": probes,
          "rule": "100 s where 10 steps stay finite, else the first of "
                  f"{list(SPLIT_DTS)} that does",
          "seconds": time.perf_counter() - t0, "card": smi})
    for scheme in ("LOR",) + SPLITS:
        tc, cfg = split_config(scheme, torch.float32, NE, NZ, dts[scheme])
        t0 = time.perf_counter()
        m = Model(cfg, tc, device=dev)
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.reset_launch_counts()
        t0 = time.perf_counter()
        m.go(nsteps=SPLIT_STEPS)
        sync(dev)
        first_go_s = time.perf_counter() - t0
        launches[f"split_{scheme}"] = got = dict(counts.launch_counts)
        if scheme == "LOR":
            per = fused_per_step(("state", "scalar2"))
            want = expected_counts(per, SPLIT_STEPS)
        else:
            per = split_per_step(scheme)
            want = {k: (SPLIT_STEPS + 1) * v for k, v in per.items()}
        if got != want:
            raise RuntimeError(f"5l {scheme}: launch counts {got} != "
                               f"expected {want}")
        check_finite(m.state, f"5l {scheme}", cfg.dtype)
        w10 = float(m.state["W"].abs().max())
        m.go(nsteps=SPLIT_STEPS)            # captures a SPLIT_STEPS graph
        sync(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        m.go(nsteps=SPLIT_STEPS)            # a replay
        ev1.record()
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / SPLIT_STEPS
        ms = ev0.elapsed_time(ev1) / SPLIT_STEPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.go(nsteps=SPLIT_STEPS)        # a profiled replay
            sync(dev)
        busy = {"all": 0.0, "banded": 0.0, "dss": 0.0, "nu4": 0.0,
                "stage_implicit": 0.0}
        by_name, nkern = {}, 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            busy["all"] += us
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + us
            nkern += 1
            if "solve_ring_kernel" in e.name or "multi_" in e.name \
                    or "wide_kernel" in e.name:
                busy["banded"] += us
            elif "band_kernel" in e.name:
                busy["dss"] += us
            elif "nu4_kernel" in e.name:
                busy["nu4"] += us
            elif "fused_stage" in e.name or "fused_implicit" in e.name:
                busy["stage_implicit"] += us
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        w40 = float(m.state["W"].abs().max())
        finite40 = all(bool(torch.isfinite(v).all())
                       for v in m.state.values())
        # SPEX's dt is chosen by 10 steps: past them it is reported
        if not finite40 and scheme != "SPEX":
            raise RuntimeError(f"5l {scheme}: non-finite after 40 steps")
        emit({"phase": "split", "scheme": scheme,
              "config": f"UMJS pert exp, no Rayleigh layer, ne{NE} p{ORDER} "
                        f"nz{NZ} f32 dt{cfg.dt:g} nu{NU:g}"
                        + (", Strang-HEVI, the fused implicit kernel"
                           if scheme == "LOR" else f", {scheme}"),
              "dt": cfg.dt, "ms_per_step": ms,
              "ms_per_model_second": ms / cfg.dt,
              "timed_as": "graph replay through Model.go "
                          f"({SPLIT_STEPS}-step graph), CUDA events",
              "wall_ms_per_step": wall_ms,
              "device_busy_ms_per_step": busy["all"] / 1e3 / SPLIT_STEPS,
              "device_launches_per_step": nkern / SPLIT_STEPS,
              "share_of_busy": {k: v / max(busy["all"], 1e-30)
                                for k, v in busy.items() if k != "all"},
              "top_kernels_ms_per_step": {
                  k: v / 1e3 / SPLIT_STEPS for k, v in sorted(
                      by_name.items(), key=lambda kv: -kv[1])[:8]},
              "kernel_launches_per_step": {k: v for k, v in per.items()
                                           if v},
              "launches": got, "launches_counted": (
                  "first_step + 1 warm-up step + "
                  f"{SPLIT_STEPS - 1} captured steps" if scheme == "LOR"
                  else f"1 warm-up step + {SPLIT_STEPS} captured steps"),
              "first_go_s": first_go_s, "model_setup_s": setup_s,
              "peak_device_GiB": peak, "max_abs_W_after_10": w10,
              "max_abs_W_after_40": w40, "finite_after_40_steps": finite40,
              "card": smi})
        del m, prof
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# IMEX outside the z-first envelope: tracers, the column solvers, no-flux
# walls, the staggerings, and Model(fuse_pallas=False) (phases 4 and 5m)
# ---------------------------------------------------------------------------

IMEX_WIDE = ("moist", "dc", "cph")
IMEX_WIDE_STEPS = 10        # steps of each Model.go call in phase 5m
# the dt of the moist wave and of CPH on the flagship grid: 100 s where 10
# steps stay finite, else the first of these that does (CPH at ne2 nz6
# with its Rayleigh layer, CPU f64: finite for 2 ARS343 steps at 100 s and
# non-finite in the third, in the JAX package's IMEX too; finite over 3 at
# 50 and 25 s)
IMEX_WIDE_DTS = (100.0, 50.0, 25.0, 10.0)


def imex_wide_per_step(name, merge=("state", "scalar2")):
    """Kernel launches per IMEX step (ARS343: four stages with a full-state
    DSS each, three implicit solves, two DSS in the nu4 tail; self-starting)
    of this slice's paths: ``"moist"`` (the tracers' flat field one more
    ``dss_scalar`` in each DSS, one ``banded_solve_multi`` in each implicit
    solve), ``"dense"`` (the dense column solve launches no kernel),
    ``"dc"`` (the density current: no nu4, so the tail has no DSS; each
    stage's DSS one ``dss_state`` with no halo), ``"cph"`` (each DSS
    ``dss_vector`` and the scalars by row count, ``dss_scalar2`` and
    ``dss_scalar``; the dense solve; the nu4 kernels' CPH field set) and
    ``"unfused"`` (``fuse_pallas=False``: separate DSS launches, the
    banded kernel's solve, the nu4 tail as tensor code)."""
    n = imex_per_step(merge)
    if name == "moist":
        return dict(n, dss_scalar=n["dss_scalar"] + 6, banded_solve_multi=3)
    if name == "dense":
        return dict(n, fused_implicit_update=0)
    zero = {k: 0 for k in KERNELS}
    if name == "dc":
        return dict(zero, dss_state=4, fused_implicit_update=3)
    if name == "cph":
        return dict(zero, dss_vector=6, dss_scalar2=6, dss_scalar=6,
                    nu4_pass1=1, nu4_pass2=1)
    if name == "unfused":
        return dict(zero, dss_vector=6, dss_scalar=18, banded_solve=3)
    raise ValueError(name)


def imex_wide_config(name, dtype, ne, nz, dt, rayleigh=False):
    """(testcase, cfg) of path ``name`` under ARS343: ``"moist"``, the
    DCMIP2016 moist baroclinic wave (three species) at ``ne`` p4 ``nz``;
    ``"umjs"``, UMJS; ``"dense"``, UMJS with ``vertical_solver="dense"``;
    ``"dc"``, the
    density current at nex ``ne``, nz ``nz`` (walls in x, Rayleigh sponges,
    nu2 300: JAX's IMEX applies no nu2); ``"cph"``, UMJS under CPH (its
    Rayleigh layer with ``rayleigh``).  nu4 1e15 on the sphere, the fused
    implicit kernel's solver (``"pallas"``)."""
    import tempestmodel_tpu_torch as tm
    if name == "cph":
        tc, cfg = stagger_config("CPH", dtype, ne, nz, rayleigh=rayleigh)
        return tc, cfg.with_(dt=dt, timescheme=tm.TimestepSchemeType.ARS343)
    if name == "dc":
        tc, cfg, _ = noflux_setup("dc", dtype, ne, 1, nz)
        return tc, cfg.with_(
            equation_set=tm.EquationSet.PRIMITIVE_NONHYDRO, dt=dt,
            timescheme=tm.TimestepSchemeType.ARS343)
    from tempestmodel_tpu_torch.testcases.dcmip2016 import (
        MoistBaroclinicWave)
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    tc = MoistBaroclinicWave() if name == "moist" \
        else BaroclinicWaveUMJS(pert="exp")
    cfg = tm.ModelConfig(
        equation_set=tm.EquationSet.PRIMITIVE_NONHYDRO,
        grid_kind=tm.GridKind.CUBED_SPHERE, ne=ne, order=ORDER, nz=nz,
        ztop=tc.ztop, dt=dt, hyperdiffusion=True, nu_scalar=NU, nu_div=NU,
        nu_vort=NU, vertical_solver="dense" if name == "dense" else "pallas",
        timescheme=tm.TimestepSchemeType.ARS343, dtype=dtype)
    return tc, cfg


def check_imex_wide_slice(dev):
    """Phase 4, IMEX outside the z-first envelope: 2 ARS343 steps in float64
    on the card, the kernel path against the plain path (``plain=True``) to
    1e-11 per field (U and V against their common scale), through
    ``models/nh_model.make_nh_imex_step``: the moist step (UMJS ne4 p4 nz8,
    three seeded species with negative values), the dense solver, the
    density current (nex 8, nz 16; walls in x, no halo), CPH (UMJS ne4 nz8,
    its Rayleigh layer, nu4; the start converted by ``Model``); then
    ``Model(fuse_pallas=False)`` (UMJS ne4 nz8) under ARS343 and under
    Strang-HEVI against the unfused path's plain version (``engine.
    imex_step`` and ``make_fast_step`` with ``fused=False, plain=True``).
    The kernel path's launches are held to ``imex_wide_per_step`` (the
    Strang run to ``UNFUSED_PER_STEP``) exactly; the plain path launches
    nothing.  Returns the launch counts of each kernel run."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import engine
    from tempestmodel_tpu_torch.kernels import counts, synthetic
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.models import nh_model
    launched = {}
    for name in ("moist", "dense", "dc", "cph"):
        if name == "dc":
            tc, cfg = imex_wide_config(name, torch.float64, 8, 16, DC_DT)
        else:
            tc, cfg = imex_wide_config(name, torch.float64, 4, 8, DT,
                                       rayleigh=True)
        m = Model(cfg, tc, device=dev)
        S0, ref, geom = dict(m.state), m.reference, m.geom
        what = f"{name} ARS343 {'nex8 nz16' if name == 'dc' else 'ne4 nz8'}" \
               f" f64 dt{cfg.dt:g}"
        if name == "moist":
            t = synthetic.random_tracers_numpy(cfg.nz, 6, 16, 16, NTR,
                                               cfg.order, seed=SEED + 51)
            S0["Tracers"] = torch.as_tensor(np.ascontiguousarray(
                np.moveaxis(t.reshape(NTR, cfg.nz, 6, 16, 16), 1, -1)),
                device=dev)
            what += f", {NTR} seeded species (negative values)"
        del m
        outs = {}
        for path, plain in (("kernels", False), ("plain", True)):
            counts.reset_launch_counts()
            step = nh_model.make_nh_imex_step(cfg, geom, ref_state=ref,
                                              device=dev, plain=plain)
            S = S0
            for _ in range(2):
                S = step(S)
            torch.cuda.synchronize()
            outs[path] = S
            if path == "kernels":
                launched[name] = dict(counts.launch_counts)
            elif any(counts.launch_counts.values()):
                raise RuntimeError(f"IMEX {what}: the plain path launched "
                                   f"{dict(counts.launch_counts)}")
        per = imex_wide_per_step(name)
        want = {k: 2 * v for k, v in per.items()}
        if launched[name] != want:
            raise RuntimeError(f"IMEX {what}: launch counts {launched[name]} "
                               f"!= expected {want}")
        errs = compare_xz(outs["kernels"], outs["plain"])
        if "Tracers" in outs["plain"]:
            errs["Tracers"] = max(
                rel_err(outs["kernels"]["Tracers"][i],
                        outs["plain"]["Tracers"][i]) for i in range(NTR))
        emit({"phase": "imex_wide_slice", "config": what + ", 2 steps",
              "kernels_vs_plain": errs, "tol": 1e-11,
              "launches": launched[name], "launches_per_step": per})
        if not max(errs.values()) < 1e-11:
            raise RuntimeError(f"IMEX {what}: paths disagree {errs}")
        check_finite(outs["kernels"], what, torch.float64)
        del outs

    # Model(fuse_pallas=False): ARS343 (no carry: a graph of 2 steps after
    # its warm-up step) and Strang-HEVI (first_step, then a graph of 1)
    for scheme in ("ars343", "strang"):
        tc, cfg = imex_wide_config("umjs", torch.float64, 4, 8, DT)
        cfg = cfg.with_(fuse_pallas=False,
                        timescheme=tm.TimestepSchemeType(scheme))
        what = f"Model(fuse_pallas=False) UMJS ne4 nz8 f64 {scheme}"
        m = Model(cfg, tc, device=dev)
        S0 = {k: v.clone() for k, v in m.state.items()}
        counts.reset_launch_counts()
        m.go(nsteps=2)
        torch.cuda.synchronize()
        name = f"unfused_{scheme}"
        launched[name] = dict(counts.launch_counts)
        counts.reset_launch_counts()
        if scheme == "ars343":
            per = imex_wide_per_step("unfused")
            want = {k: 3 * v for k, v in per.items()}
            step = engine.imex_step(cfg, m.geom, device=dev, plain=True,
                                    fused=False)
            P = S0
            for _ in range(2):
                P = step(P)
        else:
            per = UNFUSED_PER_STEP
            want = expected_counts(per, 2)
            first, step = fast.make_fast_step(cfg, m.geom, device=dev,
                                              fused=False, plain=True)
            X, c = first(fast.pack_state(S0, device=dev))
            X, c = step(X, c)
            P = fast.unpack_state(X)
        torch.cuda.synchronize()
        if any(counts.launch_counts.values()):
            raise RuntimeError(f"{what}: the plain path launched "
                               f"{dict(counts.launch_counts)}")
        if launched[name] != want:
            raise RuntimeError(f"{what}: launch counts {launched[name]} != "
                               f"expected {want}")
        errs = {k: rel_err(m.state[k], P[k]) for k in P}
        emit({"phase": "imex_wide_slice", "config": what + ", 2 steps "
              "through Model.go against the unfused path's plain version",
              "kernels_vs_plain": errs, "tol": 1e-11,
              "launches": launched[name], "launches_per_step": per,
              "launches_counted": "the Model's graph: its warm-up step and "
                                  "its captured steps (Strang: first_step "
                                  "before them)"})
        if not max(errs.values()) < 1e-11:
            raise RuntimeError(f"{what}: paths disagree {errs}")
        check_finite(m.state, what, torch.float64)
        del m
    return launched


def imex_wide_line(dev, smi, launches):
    """Phase 5m: IMEX outside the z-first envelope at full width, through
    ``Model`` as a user builds it, ARS343: the DCMIP2016 moist baroclinic
    wave (ne30 p4 L30, three species, f32), the density current at phase
    5h's width (nex 128 p4 nz 128, dt 0.1 s, f32; walls in x, Rayleigh
    sponges; nu2 300 set and, as in the JAX package's IMEX, not applied)
    and CPH on the flagship grid (UMJS, no Rayleigh layer, f32).  The moist
    wave's and CPH's dt: 100 s where 10 eager steps of
    ``make_nh_imex_step`` stay finite, else the first of
    ``IMEX_WIDE_DTS`` that does.  Each run: ``go`` of ``IMEX_WIDE_STEPS``
    steps from the start (one graph: its warm-up step and its captured
    steps counted, held to ``imex_wide_per_step``), one replay untimed,
    one timed (CUDA events), one profiled (device busy, device launches,
    the kernels' shares a step, the costliest kernels); peak memory; max
    |W| after 10 and 40 steps; the global mass of each species before and
    after (species 0 held to 1e-4 relative after 10 steps, no species
    negative)."""
    from torch.profiler import profile, ProfilerActivity
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.models import nh_model
    t0 = time.perf_counter()
    dts, probes = {"dc": DC_DT}, {}
    for name in ("moist", "cph"):
        tc, cfg = imex_wide_config(name, torch.float32, NE, NZ, DT)
        m = Model(cfg, tc, device=dev)      # the start as a user gets it
        S0, geom = m.state, m.geom
        del m
        for dt in IMEX_WIDE_DTS:
            step = nh_model.make_nh_imex_step(cfg.with_(dt=dt), geom,
                                              device=dev)
            S = S0
            for _ in range(IMEX_WIDE_STEPS):
                S = step(S)
            finite = all(bool(torch.isfinite(v).all()) for v in S.values())
            probes.setdefault(name, []).append(
                {"dt": dt, "finite_after_10": finite,
                 "max_abs_W_after_10": float(S["W"].abs().max())})
            del step, S
            if finite:
                dts[name] = dt
                break
        if name not in dts:
            raise RuntimeError(f"5m {name}: no dt of {IMEX_WIDE_DTS} holds "
                               f"10 steps finite: {probes[name]}")
        del geom, S0
        torch.cuda.empty_cache()
    emit({"phase": "imex_wide_dt", "dt_used": dts, "probes": probes,
          "rule": "100 s where 10 steps stay finite, else the first of "
                  f"{list(IMEX_WIDE_DTS)} that does (the density current: "
                  f"dt {DC_DT:g} s, phase 5h's)",
          "seconds": time.perf_counter() - t0, "card": smi})

    for name in IMEX_WIDE:
        if name == "dc":
            tc, cfg = imex_wide_config(name, torch.float32, DC_NEX, DC_NZ,
                                       DC_DT)
            config = (f"density current nex{DC_NEX} p{ORDER} nz{DC_NZ} f32 "
                      f"dt{DC_DT:g}, walls in x, Rayleigh sponges, nu2 "
                      f"{DC_NU2:g} (not applied under IMEX), ARS343")
        else:
            tc, cfg = imex_wide_config(name, torch.float32, NE, NZ,
                                       dts[name])
            what = ("DCMIP2016 moist baroclinic wave, 3 species"
                    if name == "moist"
                    else "UMJS pert exp under CPH, no Rayleigh layer")
            config = (f"{what}, ne{NE} p{ORDER} nz{NZ} f32 dt{cfg.dt:g} "
                      f"nu{NU:g}, ARS343")
        t0 = time.perf_counter()
        m = Model(cfg, tc, device=dev)
        setup_s = time.perf_counter() - t0
        area = m.geom_dev.area3d.double()

        def masses():
            if "Tracers" not in m.state:
                return None
            t = m.state["Tracers"].double()
            return [float((t[i] * area).sum()) for i in range(t.shape[0])]

        mass0 = masses()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.reset_launch_counts()
        t0 = time.perf_counter()
        m.go(nsteps=IMEX_WIDE_STEPS)
        sync(dev)
        first_go_s = time.perf_counter() - t0
        launches[f"imex_wide_{name}"] = got = dict(counts.launch_counts)
        per = imex_wide_per_step(name)
        want = {k: (IMEX_WIDE_STEPS + 1) * v for k, v in per.items()}
        if got != want:
            raise RuntimeError(f"5m {name}: launch counts {got} != "
                               f"expected {want}")
        check_finite(m.state, f"5m {name}", cfg.dtype)
        w10 = float(m.state["W"].abs().max())
        mass10 = masses()
        if mass0 is not None:
            if not abs(mass10[0] - mass0[0]) <= 1e-4 * abs(mass0[0]):
                raise RuntimeError(f"5m {name}: the mass of species 0 moved "
                                   f"from {mass0[0]} to {mass10[0]}")
            if float(m.state["Tracers"].min()) < 0.0:
                raise RuntimeError(f"5m {name}: negative tracer values")
        m.go(nsteps=IMEX_WIDE_STEPS)        # a replay, untimed
        sync(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        m.go(nsteps=IMEX_WIDE_STEPS)        # a replay, timed
        ev1.record()
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / IMEX_WIDE_STEPS
        ms = ev0.elapsed_time(ev1) / IMEX_WIDE_STEPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.go(nsteps=IMEX_WIDE_STEPS)    # a profiled replay
            sync(dev)
        busy = {"all": 0.0, "banded": 0.0, "dss": 0.0, "nu4": 0.0,
                "fused_implicit": 0.0}
        by_name, nkern = {}, 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            busy["all"] += us
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + us
            nkern += 1
            if "solve_ring_kernel" in e.name or "multi_" in e.name \
                    or "wide_kernel" in e.name:
                busy["banded"] += us
            elif "band_kernel" in e.name:
                busy["dss"] += us
            elif "nu4_kernel" in e.name:
                busy["nu4"] += us
            elif "fused_implicit" in e.name:
                busy["fused_implicit"] += us
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        w40 = float(m.state["W"].abs().max())
        finite40 = all(bool(torch.isfinite(v).all())
                       for v in m.state.values())
        mass40 = masses()
        neg40 = (None if mass40 is None
                 else float(m.state["Tracers"].min()) < 0.0)
        emit({"phase": "imex_wide", "path": name, "config": config,
              "dt": cfg.dt, "ms_per_step": ms,
              "ms_per_model_second": ms / cfg.dt,
              "timed_as": "graph replay through Model.go "
                          f"({IMEX_WIDE_STEPS}-step graph), CUDA events",
              "wall_ms_per_step": wall_ms,
              "device_busy_ms_per_step": busy["all"] / 1e3 / IMEX_WIDE_STEPS,
              "device_launches_per_step": nkern / IMEX_WIDE_STEPS,
              "share_of_busy": {k: v / max(busy["all"], 1e-30)
                                for k, v in busy.items() if k != "all"},
              "top_kernels_ms_per_step": {
                  k: v / 1e3 / IMEX_WIDE_STEPS for k, v in sorted(
                      by_name.items(), key=lambda kv: -kv[1])[:8]},
              "kernel_launches_per_step": {k: v for k, v in per.items()
                                           if v},
              "launches": got, "launches_counted":
                  f"1 warm-up step + {IMEX_WIDE_STEPS} captured steps",
              "first_go_s": first_go_s, "model_setup_s": setup_s,
              "peak_device_GiB": peak, "max_abs_W_after_10": w10,
              "max_abs_W_after_40": w40, "finite_after_40_steps": finite40,
              "species_mass_before": mass0,
              "species_mass_after_10": mass10,
              "species_mass_after_40": mass40,
              "negative_tracer_after_40": neg40, "card": smi})
        del m, prof, area
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the device mesh: the z-first engine sharded over a ShardMesh on the card
# ---------------------------------------------------------------------------

# the flagship's element-aligned meshes (A = 120, p = 4: 1 x 4 splits an
# element, b = 30) and the small check's
MESH_SHAPES = ((2, 2), (1, 3))
MESH_SMALL = ((2, 2), (1, 4))
MESH_TURNS = 3              # timed replays of each graph, in turns
MESH_KERNELS = ("fused_stage", "fused_implicit_update", "nu4_pass1",
                "nu4_pass2")


def mesh_per_step(mx, my):
    """Launches of one sharded Strang step on the fused path: each shard
    launches the single-device step's stage, implicit and nu4 kernels at
    its block's extents; no DSS kernel runs (the exchange is tensor
    code)."""
    n = mx * my
    out = {k: 0 for k in KERNELS}
    out.update(fused_stage=5 * n, fused_implicit_update=n, nu4_pass1=n,
               nu4_pass2=n)
    return out


def mesh_counts(mx, my, nsteps):
    """``nsteps`` steps and one ``first_step`` (one more implicit solve a
    shard)."""
    want = {k: v * (nsteps + 1) for k, v in mesh_per_step(mx, my).items()}
    want["fused_implicit_update"] += mx * my
    return want


def check_mesh_kernels(geom, state, rows, dev):
    """Phase 3, the mesh's shapes: ``fused_stage`` (one base and two),
    ``nu4_pass1``, ``nu4_pass2`` and ``fused_implicit_update`` on the block
    of shard 0 of each mesh of ``MESH_SHAPES`` (the flagship's geometry
    sliced by ``mesh_engine.local_geometry``, with a terrain-like metric),
    against their plain versions, float32 and float64; the float32 times,
    plain times and bounds go to ``rows["mesh_shapes"]``.  The stage and
    nu4 inputs are random; the implicit update starts from the block of the
    balanced flagship state with per-mille noise, as in phase 3."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import (hyper_cuda, implicit_cuda,
                                             implicit as fimp, mesh_engine,
                                             stage_cuda)
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.kernels.timing import time_cuda
    from tempestmodel_tpu_torch.models import nonhydro
    out = rows.setdefault("mesh_shapes", {})
    consts = tm.ModelConfig().constants
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        f32 = dtype == torch.float32
        esize = 4 if f32 else 8
        full = fast.build_fast_geometry(geom, dtype=dtype, device=dev)
        q = nonhydro.estimate_bandwidth(geom, consts)
        statics = fimp.statics_to_device(
            nonhydro.band_assembly_statics(geom, q), dtype, dev)
        for mx, my in MESH_SHAPES:
            loc = mesh_engine.local_geometry(full, mx, my, 0, 0)
            fgt = synthetic.terrain_like(loc, seed=SEED)
            fgj = synthetic.terrain_like(loc, seed=SEED, vary_jac=True)
            K, P, a, b = fgt.nz, 6, fgt.A, fgt.B
            shape = f"{mx}x{my}"
            nlev, nint, n2d = K * P * a * b, (K + 1) * P * a * b, P * a * b
            ue = synthetic.random_state(fgt, seed=1)
            b1 = synthetic.random_state(fgt, seed=2)
            b2 = synthetic.random_state(fgt, seed=3)
            two = ((0.3, b1), (0.7, b2))
            sst = stage_cuda.stage_statics(fgt)
            tol = 1e-4 if f32 else 1e-11
            err = 0.0
            for base in (b1, two):
                got, gwf = stage_cuda.fused_stage(base, ue, 12.5, fgt, consts,
                                                  defer_w=True, statics=sst)
                sync(dev)
                want, wwf = stage_cuda.fused_stage_plain(
                    base, ue, 12.5, fgt, consts, defer_w=True)
                err = max(err, max_rel_err(
                    [got[k] for k in stage_cuda.STATE4] + [gwf["dW"]],
                    [want[k] for k in stage_cuda.STATE4] + [wwf["dW"]]))
            if not err <= tol:
                raise RuntimeError(f"fused_stage {tag} at {shape} "
                                   f"{[K, P, a, b]}: rel err {err} > {tol}")
            res = {"fused_stage": {"shape": [K, P, a, b],
                                   "max_abs_err": err}}
            if f32:
                tb, c1, x1, c2, x2 = stage_cuda._split_base(b1)
                ms = time_cuda(lambda: stage_cuda._fused_stage_cuda(
                    tb, c1, x1, c2, x2, ue, 12.5, fgt, consts, sst), [()],
                    reps=20, queued=True)
                plain_ms = time_cuda(lambda: stage_cuda.fused_stage_plain(
                    b1, ue, 12.5, fgt, consts, defer_w=True), [()], reps=3,
                    warmup=1)
                nb = ((4 + 4 + 5) * nlev + nint + 12 * n2d
                      + sst.tab.numel()) * esize
                bnd, by = bound_ms(nb, 400 * nlev, dtype)
                res["fused_stage"].update(ms=ms, plain_ms=plain_ms,
                                          bound_ms=bnd, bound_by=by)
            # nu4 passes
            hst = hyper_cuda.hyper_statics(fgj)
            d = synthetic.random_state(fgj, seed=4)
            w = synthetic.random_state(fgj, seed=5)
            nu = (1.0e-3, 1.0e-2, 0.7e-2, 1.0)
            g1 = hyper_cuda.nu4_pass1(d, fgj, hst)
            sync(dev)
            e1 = max(rel_err(g1[k], v) for k, v in hyper_cuda.nu4_pass1_plain(
                d, fgj, hst).items())
            g2 = hyper_cuda.nu4_pass2(d, w, *nu, fgj, hst)
            sync(dev)
            w2 = hyper_cuda.nu4_pass2_plain(d, w, *nu, fgj, hst)
            e2 = max(max(rel_err(g2[k], w2[k]),
                         rel_err(g2[k] - d[k], w2[k] - d[k])) for k in w2)
            for name, e in (("nu4_pass1", e1), ("nu4_pass2", e2)):
                if not e <= tol:
                    raise RuntimeError(f"{name} {tag} at {shape}: rel err "
                                       f"{e} > {tol}")
                res[name] = {"shape": [K, P, a, b], "max_abs_err": e}
            if f32:
                scal2 = (nu[1], nu[2], nu[3], nu[3] * nu[0])
                for name, launch, plain, nfields in (
                        ("nu4_pass1",
                         lambda: hyper_cuda._launch(
                             "nu4_pass1", d, None, (1.0, 1.0, 0.0, 0.0), hst),
                         lambda: hyper_cuda.nu4_pass1_plain(d, fgj, hst), 2),
                        ("nu4_pass2",
                         lambda: hyper_cuda._launch("nu4_pass2", w, d, scal2,
                                                    hst),
                         lambda: hyper_cuda.nu4_pass2_plain(d, w, *nu, fgj,
                                                            hst), 3)):
                    ms = time_cuda(launch, [()], reps=20, queued=True)
                    plain_ms = time_cuda(plain, [()], reps=3, warmup=1)
                    nb = (nfields * (4 * nlev + nint) + 8 * n2d
                          + hst.ds.numel()) * esize
                    bnd, by = bound_ms(nb, 220 * nint, dtype)
                    res[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                                     bound_by=by)
            # the implicit update on the block's columns
            ist = implicit_cuda.implicit_statics(statics, fgt)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            s = {k: v[..., :a, :b].to(dtype).contiguous()
                 for k, v in fast.pack_state(state, device=dev).items()}
            for k in ("U", "V", "Rt", "Rho"):
                s[k] = s[k] * (1.0 + 1e-3 * randn(s[k].shape, dtype, gen,
                                                  dev))
            s["W"] = 0.01 * randn(s["W"].shape, dtype, gen, dev)
            x0, aux = fimp._prep_aux(s, fgt, None, interfaces=False)
            got = implicit_cuda.fused_implicit_update(x0, x0, aux, ist,
                                                      0.5 * DT, consts)
            sync(dev)
            want = implicit_cuda.fused_implicit_update_plain(
                x0, x0, aux, ist, 0.5 * DT, consts)
            e = max_rel_err(got, want)
            itol = 2e-3 if f32 else 1e-10
            if not e <= itol:
                raise RuntimeError(f"fused_implicit_update {tag} at {shape}: "
                                   f"rel err {e} > {itol}")
            ncol = x0[0].shape[1]
            res["fused_implicit_update"] = {"shape": [K, ncol],
                                            "max_abs_err": e}
            if f32:
                ms = time_cuda(lambda: implicit_cuda.fused_implicit_update(
                    x0, x0, aux, ist, 0.5 * DT, consts), [()], reps=10,
                    queued=True)
                plain_ms = time_cuda(
                    lambda: implicit_cuda.fused_implicit_update_plain(
                        x0, x0, aux, ist, 0.5 * DT, consts), [()], reps=2,
                    warmup=1)
                nb = ((4 + 4 + 2) * K * ncol + (1 + 5 + 1) * (K + 1) * ncol
                      + 4 * ncol + ist.tab.numel()) * esize
                n = 3 * K + 1
                flops = ncol * (n * (q * (2 * q + 3) + 2 * q + 1)
                                + (K + 1) * 400)
                bnd, by = bound_ms(nb, flops, dtype)
                res["fused_implicit_update"].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by)
            emit({"phase": "mesh_kernel", "dtype": tag, "mesh": [mx, my],
                  "kernels": res})
            if f32:
                for name, r in res.items():
                    out.setdefault(name, {})[shape] = r
            del ue, b1, b2, d, w, g1, g2, w2, got, want, x0, aux, s
        del full
        torch.cuda.empty_cache()


def mesh_config(dtype, ne, nz):
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = tm.ModelConfig(
        grid_kind=tm.GridKind.CUBED_SPHERE,
        equation_set=tm.EquationSet.PRIMITIVE_NONHYDRO, ne=ne, order=ORDER,
        nz=nz, ztop=tc.ztop, dt=DT, hyperdiffusion=True, nu_scalar=NU,
        nu_div=NU, nu_vort=NU, vertical_solver="pallas", dtype=dtype)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    return tc, cfg, geom


def check_mesh_slice(dev):
    """Phase 4, the mesh: UMJS ne4 p4 nz6 float64 on a ``ShardMesh`` of the
    card at 2 x 2 and 1 x 4, 2 steps (``first_step`` and one step), inline
    and overlap, against the single-device step to 1e-11 per field; the
    exchange tally exactly 14 DSS calls of ``expected_exchange_bytes``,
    point-to-point only; the launches exact; a 2-step graph of the sharded
    step against its eager steps, bit for bit.  Returns the launches of each
    run."""
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import mesh_dss
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.parallel.mesh import ShardMesh
    tc, cfg, geom = mesh_config(torch.float64, 4, 6)
    X0 = fast.pack_state(tc.initial_state(geom, cfg.constants,
                                          dtype=cfg.dtype, device=dev),
                         device=dev)
    first, step = fast.make_fast_step(cfg, geom, device=dev)
    X, c = step(*first(X0))
    A, nz = 4 * ORDER, cfg.nz
    launched = {}
    for mx, my in MESH_SMALL:
        got = {}
        for overlap in (False, True):
            mesh = ShardMesh(mx, my, device=dev)
            mc = cfg.with_(halo_overlap=overlap)
            fm, sm = fast.make_fast_step(mc, geom, mesh=mesh)
            counts.reset_launch_counts()
            mesh.tally.reset()
            Xm, cm = sm(*fm(mesh.shard(X0)))
            sync(dev)
            launches = dict(counts.launch_counts)
            if launches != mesh_counts(mx, my, 1):
                raise RuntimeError(f"mesh {mx}x{my}: launches {launches} != "
                                   f"{mesh_counts(mx, my, 1)}")
            per_call = mesh_dss.expected_exchange_bytes(
                geom.edge_meta, mx, my, A, 5 * nz + 1, 8)
            t = mesh.tally
            if set(t.counts) != {"collective-permute"} or \
                    sum(t.bytes_.values()) != 14 * per_call:
                raise RuntimeError(f"mesh {mx}x{my}: tally {t.counts} "
                                   f"{t.bytes_} != 14 x {per_call}")
            G = mesh.gather(Xm)
            err = max(rel_err(G[k], X[k]) for k in X)
            if not err <= 1e-11:
                raise RuntimeError(f"mesh {mx}x{my} overlap={overlap}: rel "
                                   f"err {err} against one device")
            got[overlap] = G
            launched[f"{mx}x{my}" + ("_overlap" if overlap else "")] = \
                launches
            emit({"phase": "mesh_slice", "mesh": [mx, my],
                  "config": "UMJS ne4 p4 nz6 f64 dt100", "steps": 2,
                  "overlap": overlap, "rel_err_vs_one_device": err,
                  "bitwise_vs_one_device": all(torch.equal(G[k], X[k])
                                               for k in X),
                  "exchange_ops": t.counts, "exchange_bytes": t.bytes_,
                  "expected_bytes": 14 * per_call, "moved_bytes": t.moved,
                  "launches": launches})
        if not all(torch.equal(got[False][k], got[True][k]) for k in X):
            raise RuntimeError(f"mesh {mx}x{my}: the overlap schedule is not "
                               f"the inline one bit for bit")
        # a graph of 2 sharded steps against the eager steps
        mesh = ShardMesh(mx, my, device=dev)
        fm, multi = fast.make_fast_multistep(cfg, geom, 2, mesh=mesh)
        _, sm = fast.make_fast_step(cfg, geom, mesh=mesh)
        Xa, ca = fm(mesh.shard(X0))
        Xg, cg = multi(Xa, ca)
        Xe, ce = sm(*sm(Xa, ca))
        sync(dev)
        if not all(torch.equal(g[k], e[k]) for g, e in zip(Xg, Xe)
                   for k in g):
            raise RuntimeError(f"mesh {mx}x{my}: the replayed graph is not "
                               f"the eager steps bit for bit")
    return launched


def mesh_line(dev, smi, launches, geom, state):
    """Phase 5n, the mesh at full width: the flagship (f32) on a
    ``ShardMesh`` of the card at each of ``MESH_SHAPES``: ``first_step`` and
    a 10-step graph of the sharded step (its launches, from counts at 0,
    held to ``mesh_counts``), the replay within 1e-4 relative per field of
    the single-device replay from the same start; the replays of both timed
    in turns (one device, mesh, mesh, one device, ...); one eager sharded
    step with its exchange tally (7 DSS calls of ``expected_exchange_bytes``)
    and its wall time.  Then ``Model.profile_phases`` of the flagship on
    one device and on the 2 x 2 mesh.  ``DistMesh`` over NCCL is not run:
    NCCL puts one rank on each GPU and this machine has one."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import mesh_dss
    from tempestmodel_tpu_torch.kernels import counts
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.parallel.mesh import ShardMesh
    tc, cfg, _ = mesh_config(torch.float32, NE, NZ)
    X0 = fast.pack_state(state, device=dev)
    A = NE * ORDER
    first1, multi1 = fast.make_fast_multistep(cfg, geom, INNER_STEPS,
                                              device=dev)
    X1, c1 = first1(X0)
    S1, _ = multi1(X1, c1)
    sync(dev)
    runs = {}
    for mx, my in MESH_SHAPES:
        name = f"{mx}x{my}"
        mesh = ShardMesh(mx, my, device=dev)
        t0 = time.perf_counter()
        fm, mm = fast.make_fast_multistep(cfg, geom, INNER_STEPS, mesh=mesh)
        make_s = time.perf_counter() - t0
        counts.reset_launch_counts()
        Xa, ca = fm(mesh.shard(X0))
        t0 = time.perf_counter()
        Sm, _ = mm(Xa, ca)                    # warm-up, capture, replay
        sync(dev)
        capture_s = time.perf_counter() - t0
        got = dict(counts.launch_counts)
        launches[f"mesh_{name}"] = got
        want = mesh_counts(mx, my, INNER_STEPS + 1)
        if got != want:
            raise RuntimeError(f"mesh {name}: launches {got} != {want}")
        for k in MESH_KERNELS:
            if got[k] < 1:
                raise RuntimeError(f"{k} was not launched on the mesh {name}")
        G = mesh.gather(Sm)
        err = {k: rel_err(G[k], S1[k]) for k in S1}
        if not (max(err.values()) <= 1e-4
                and all(bool(torch.isfinite(v).all()) for v in G.values())):
            raise RuntimeError(f"mesh {name}: replay against one device "
                               f"{err}")
        # one eager sharded step: its exchange tally and wall time
        _, sm = fast.make_fast_step(cfg, geom, mesh=mesh)
        sm(Xa, ca)
        sync(dev)
        mesh.tally.reset()
        t0 = time.perf_counter()
        sm(Xa, ca)
        sync(dev)
        eager_s = time.perf_counter() - t0
        per_call = mesh_dss.expected_exchange_bytes(
            geom.edge_meta, mx, my, A, 5 * NZ + 1, 4)
        t = mesh.tally
        if sum(t.bytes_.values()) != 7 * per_call or \
                set(t.counts) != {"collective-permute"}:
            raise RuntimeError(f"mesh {name}: tally {t.counts} {t.bytes_} "
                               f"!= 7 x {per_call}")
        runs[name] = {"multi": mm, "state": (Xa, ca), "ms": [],
                      "report": {
                          "phase": "mesh", "mesh": [mx, my],
                          "config": f"UMJS ne{NE} p{ORDER} nz{NZ} f32 "
                                    f"dt{DT:g} nu{NU:g}",
                          "shard_block": [NZ, 6, A // mx, A // my],
                          "rel_err_vs_one_device_replay": err,
                          "bitwise_vs_one_device": all(
                              torch.equal(G[k], S1[k]) for k in S1),
                          "launches": got,
                          "launches_per_step": mesh_per_step(mx, my),
                          "launches_counted": "at capture (first_step + 1 "
                          f"warm-up step + {INNER_STEPS} captured steps)",
                          "exchange_ops_per_step": t.counts,
                          "exchange_bytes_per_step": t.bytes_,
                          "expected_bytes_per_step": 7 * per_call,
                          "moved_bytes_per_step": t.moved,
                          "eager_step_wall_ms": 1e3 * eager_s,
                          "make_fast_multistep_s": make_s,
                          "warmup_capture_first_replay_s": capture_s}}
        del G, Sm
    single = {"multi": multi1, "state": (X1, c1), "ms": []}

    def replay_ms(v):
        sync(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        v["multi"](*v["state"])
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / INNER_STEPS

    order = []
    for name in runs:
        order += [single, runs[name], runs[name], single]
    for v in order:
        v["ms"].append(replay_ms(v))
    for name, v in runs.items():
        emit(dict(v["report"], ms_per_step_each_replay=v["ms"],
                  ms_per_step=sorted(v["ms"])[len(v["ms"]) // 2],
                  one_device_ms_per_step_each_replay=single["ms"],
                  order="one device, mesh, mesh, one device; per mesh",
                  card=smi))
    del runs, single, first1, multi1
    torch.cuda.empty_cache()
    # the phases of the flagship Model, on one device and on the 2 x 2 mesh
    for mesh in (None, ShardMesh(2, 2, device=dev)):
        m = Model(cfg, tc, device=dev, mesh=mesh)
        m.go(nsteps=1)
        ph = m.profile_phases(reps=5)
        emit({"phase": "profile_phases", "mesh": mesh and [2, 2],
              "config": f"UMJS ne{NE} p{ORDER} nz{NZ} f32 dt{DT:g}",
              "ms": ph, "timed_by": "CUDA events, 5 calls after 1",
              "card": smi})
        del m
    torch.cuda.empty_cache()
    emit({"phase": "mesh_dist", "run": False,
          "why": "DistMesh over NCCL puts one rank on each GPU and this "
                 "machine has one; its gloo transport is held to ShardMesh "
                 "bit for bit on the CPU (tests/test_torch_mesh_dist.py)"})


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
    if len(nu4_resources) != 32:
        raise RuntimeError(f"the build reported {len(nu4_resources)} of the "
                           f"nu4 kernel's 32 instantiations (dtype x p 4 "
                           f"or any p x pass x the Lorenz, Charney-"
                           f"Phillips, LEV/INT and shallow-water field "
                           f"sets)")
    dss_resources = dss_cuda.kernel_resources()
    if len(dss_resources) != 40:
        raise RuntimeError(f"the build reported {len(dss_resources)} of the "
                           f"band DSS kernel's 40 instantiations")
    multi_resources = cuda_banded.kernel_resources()
    if len(multi_resources) != 62:
        raise RuntimeError(f"the build reported {len(multi_resources)} of "
                           f"the banded solve's 62 instantiations (tile, "
                           f"stream and ring forms at q 1..8, 10, 16, the "
                           f"wide form)")
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
    check_noflux_dss(dev, rows)
    check_wide_banded(dev, rows)
    check_sw_kernels(dev, rows)
    check_stagger_kernels(geom, rows, dev)
    check_split_kernels(geom, rows, dev)
    check_mesh_kernels(geom, state, rows, dev)

    # 4. the slice at small size, three ways, dry and with tracers --------
    check_slice(dev)
    check_slice(dev, with_tracers=True)
    cart_launches = check_cartesian_slice(dev)
    check_imex_slice(dev)
    check_terrain_slice(dev)
    check_noflux_slice(dev)
    check_sw_slice(dev)
    vert_launches = check_vertical_slice(dev)
    stag_launches = check_stagger_slice(dev)
    split_launches = check_split_slice(dev)
    imex_wide_launches = check_imex_wide_slice(dev)
    mesh_launches = check_mesh_slice(dev)

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

    # 5h. this slice's path: no-flux walls and uniform nu2 at full width
    t0 = time.perf_counter()
    noflux_line(dev, smi, launches)
    emit({"phase": "noflux", "seconds": time.perf_counter() - t0})

    # 5i. this slice's path: the shallow-water set at full width
    t0 = time.perf_counter()
    sw_line(dev, smi, launches)
    emit({"phase": "shallow_water", "seconds": time.perf_counter() - t0})

    # 5j. this slice's path: the vertical options on the flagship grid
    t0 = time.perf_counter()
    vertical_line(dev, smi, launches)
    emit({"phase": "vertical", "seconds": time.perf_counter() - t0})

    # 5k. this slice's path: CPH, LEV and INT on the flagship grid
    t0 = time.perf_counter()
    stagger_line(dev, smi, launches)
    emit({"phase": "stagger", "seconds": time.perf_counter() - t0})

    # 5l. this slice's path: SPEX and HS on the flagship grid
    t0 = time.perf_counter()
    split_line(dev, smi, launches)
    emit({"phase": "split", "seconds": time.perf_counter() - t0})

    # 5m. this slice's path: IMEX outside the z-first envelope at full width
    t0 = time.perf_counter()
    imex_wide_line(dev, smi, launches)
    emit({"phase": "imex_wide", "seconds": time.perf_counter() - t0})

    # 5n. this slice's path: the device mesh (ShardMesh on the card)
    t0 = time.perf_counter()
    mesh_line(dev, smi, launches, geom, state)
    emit({"phase": "mesh", "seconds": time.perf_counter() - t0})

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
        # the shallow-water path of phase 5i (its graph's capture, from
        # counts at 0)
        row["launches_shallow_water_path"] = launches["sw"][name]
        if SW_PER_STEP.get(name) and row["launches_shallow_water_path"] < 1:
            raise RuntimeError(f"{name} was not launched on the "
                               f"shallow-water path")
        # the no-flux paths of phase 5h (each run from counts at 0)
        row["launches_density_current_path"] = launches["noflux_dc"][name]
        row["launches_channel_path"] = launches["noflux_channel"][name]
        if name in rows["noflux_dss_times"]["dc_swapped"]:
            row["noflux_ms_with_and_without_walls"] = {
                where: t[name]
                for where, t in rows["noflux_dss_times"].items()}
        # this slice's paths: phase 5j's Model runs (each from counts at
        # 0) and phase 4's kernel runs at ne4
        row["launches_vertical_paths"] = {
            run: launches[f"vertical_{run}"][name]
            for run in ("dense", "schur", "jfnk", "explicit",
                        "jw_upwind_off")}
        row["launches_vertical_slice"] = {
            path: v[name] for path, v in vert_launches.items()}
        for path in VERT_PATHS:
            run = "jw_upwind_off" if path == "upwind_off" else path
            if vertical_per_step(path)[name] and \
                    launches[f"vertical_{run}"][name] < 1:
                raise RuntimeError(f"{name} was not launched on the "
                                   f"{path} path")
        # the staggerings: phase 5k's Model runs (each from counts at 0) and
        # phase 4's kernel runs at ne4 and on the x-z slice
        row["launches_stagger_paths"] = {
            stag: launches[f"stagger_{stag}"][name] for stag in STAGGERS}
        row["launches_stagger_slice"] = {
            path: v[name] for path, v in stag_launches.items()}
        for stag in STAGGERS:
            if stagger_per_step()[name] and \
                    launches[f"stagger_{stag}"][name] < 1:
                raise RuntimeError(f"{name} was not launched on the "
                                   f"{stag} path")
        # SPEX and HS: phase 5l's Model runs (each from counts at 0) and
        # phase 4's kernel runs at ne4
        row["launches_split_paths"] = {
            scheme: launches[f"split_{scheme}"][name] for scheme in SPLITS}
        row["launches_split_slice"] = {
            scheme: v[name] for scheme, v in split_launches.items()}
        for scheme in SPLITS:
            if split_per_step(scheme)[name] and \
                    launches[f"split_{scheme}"][name] < 1:
                raise RuntimeError(f"{name} was not launched on the "
                                   f"{scheme} path")
        # IMEX outside the z-first envelope: phase 5m's Model runs (each
        # from counts at 0) and phase 4's kernel runs at small size
        row["launches_imex_wide_paths"] = {
            run: launches[f"imex_wide_{run}"][name] for run in IMEX_WIDE}
        row["launches_imex_wide_slice"] = {
            run: v[name] for run, v in imex_wide_launches.items()}
        for run in IMEX_WIDE:
            if imex_wide_per_step(run)[name] and \
                    launches[f"imex_wide_{run}"][name] < 1:
                raise RuntimeError(f"{name} was not launched on the IMEX "
                                   f"{run} path")
        # the device mesh: phase 5n's sharded runs (each from counts at 0)
        # and phase 4's at ne4; the kernel at a shard's block (phase 3)
        row["launches_mesh_paths"] = {
            f"{mx}x{my}": launches[f"mesh_{mx}x{my}"][name]
            for mx, my in MESH_SHAPES}
        row["launches_mesh_slice"] = {
            run: v[name] for run, v in mesh_launches.items()}
        if name in rows["mesh_shapes"]:
            row["mesh_shapes"] = rows["mesh_shapes"][name]
        if name in ("banded_solve", "banded_solve_multi"):
            row["q_above_8"] = {k: v for k, v in rows["banded_wide"].items()
                                if k.split()[0] == name}
        if name == "fused_stage":
            two = rows["fused_stage_two_base"]
            row.update(ms_two_base=two["ms"], bound_ms_two_base=two["bound_ms"],
                       plain_ms_two_base=two["plain_ms"])
        if name in ("nu4_pass1", "nu4_pass2"):
            row.pop("staggered", None)
        kernels.append(row)
        if name in ("nu4_pass1", "nu4_pass2"):
            # the instantiations of the staggered field sets, each with its
            # phase 3 figures and its launches on its 5k run (INT takes
            # LEV's field set)
            for stag in NU4_SETS:
                srow = dict(rows[name]["staggered"][stag])
                srow["name"] = f"{name}[{stag}]"
                srow["launches"] = launches[f"stagger_{stag}"][name]
                if stag == "LEV":
                    srow["launches_int_path"] = \
                        launches["stagger_INT"][name]
                else:       # phase 5m's CPH run under ARS343
                    srow["launches_imex_cph_path"] = \
                        launches["imex_wide_cph"][name]
                kernels.append(srow)
    for path in ("noflux_dc", "noflux_channel"):
        for name, v in noflux_per_step(path.split("_")[1]).items():
            if v and launches[path][name] < 1:
                raise RuntimeError(f"{name} was not launched on {path}")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
