#!/usr/bin/env python3
"""Sweep the DSS kernels' launch shapes on a GPU.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 -m tempestmodel_tpu_torch.kernels.tune_dss [band] \
        [scalar | vector | uvw | scalar2 | state ...] [-DNAME=VALUE ...]

``band`` (the five modes of the band kernel, ``dss_scalar``,
``dss_vector``, ``dss_uvw``, ``dss_scalar2`` and ``dss_state``, whose
launch shape is taken at run time, no rebuild; mode names after it sweep
those modes only; ``dss_state`` is swept without and with its Rayleigh
finish):
every band (rows),
levels a block and ring depth of
``BAND_ROWS`` x ``BAND_LEVELS`` x ``BAND_RINGS`` that fits, at the flagship
shapes (ne30 p4: (30, 6, 120, 120), eight input copies that cycle through
more than the 50 MB L2), float32 and float64, and at the Schar slice's
shapes (40 levels, swapped (K, 1, 4, 400) and natural (K, 1, 400, 4)) and
the 3-D bubble's plane (40, 1, 128, 128), float32 and float64; each held
against the plain version and timed beside the rule's shape
(``dss_cuda.dss_launch_shape``), every shape printed per kernel and grid,
fastest first.  ``-D`` arguments build a variant of ``csrc/dss.cu`` with those
flags (``BAND_MIN_BLOCKS``, the scalar and scalar2 modes',
``BAND_MIN_BLOCKS_VECTOR``, ``BAND_MIN_BLOCKS_UVW``, the uvw and state
modes': blocks an SM must hold, which caps the registers)
and sweep it in place of the default build, with its registers.  Times are
taken as in ``chip_smoke.py``: launches queued behind a busy device.  The
first line holds the card's name and power limit.
"""

import ctypes
import json
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

BAND_ROWS = (4, 8, 12, 16, 20, 24, 40)
BAND_LEVELS = (1, 2, 3, 4, 5, 6, 8, 10, 15, 31)
BAND_RINGS = (1, 2, 3, 4)
K, P, A, ORDER = 30, 6, 120, 4


def main(argv=()):
    if not torch.cuda.is_available():
        print("tune_dss: no CUDA device", file=sys.stderr)
        return 1
    defines = [a for a in argv if a.startswith("-D")]
    words = [a for a in argv if not a.startswith("-D")]
    if words[:1] not in ([], ["band"]) or not set(words[1:]) <= set(
            dss_cuda.MODES):
        print(f"tune_dss: unknown arguments {words}", file=sys.stderr)
        return 2
    modes = words[1:] or list(dss_cuda.MODES)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    build.build_all()
    dev = torch.device("cuda")
    if not defines:
        sweep_band(dev, modes)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        so = str(pathlib.Path(tmp) / "dss_variant.so")
        report = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, *defines, "-Xptxas",
             "-v", "-o", so, str(build.CSRC / "dss.cu")], check=True,
            capture_output=True, text=True)
        regs = {k: v for k, v in build.parse_ptxas(
            report.stdout + report.stderr).items() if "band" in k}
        print(json.dumps({"defines": defines, "ptxas": regs}), flush=True)
        lib = ctypes.CDLL(so)
        for name, argtypes in build.SIGNATURES["dss"].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        default = build._libs["dss"]
        build._libs["dss"] = lib
        try:
            sweep_band(dev, modes)
        finally:
            build._libs["dss"] = default
    return 0


def _grids(dev):
    """(label, fast geometry, levels, input copies, dtype) to sweep."""
    import chip_smoke
    for dtype in (torch.float32, torch.float64):
        cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=A // ORDER,
                             order=ORDER, nz=K, ztop=30000.0, dtype=dtype)
        yield ("flagship", fast.build_fast_geometry(
            nh_model.build_nh_sphere_geometry(cfg), dtype=dtype,
            device=dev), K, 8)
    for dtype in (torch.float32, torch.float64):
        _, _, sgeom = chip_smoke.cartesian_setup(
            "schar", dtype, chip_smoke.SCHAR_NEX, 1, chip_smoke.SCHAR_NZ)
        for layout in ("swapped", "natural"):
            yield (f"schar_{layout}", fast.build_fast_geometry_cartesian(
                sgeom, dtype=dtype, device=dev,
                swap_ab=(layout == "swapped")), chip_smoke.SCHAR_NZ, 1)
        _, _, pgeom = chip_smoke.cartesian_setup(
            "bubble3d", dtype, chip_smoke.PLANE_NE, chip_smoke.PLANE_NE,
            chip_smoke.SCHAR_NZ)
        yield ("plane", fast.build_fast_geometry_cartesian(
            pgeom, dtype=dtype, device=dev), chip_smoke.SCHAR_NZ, 1)


def sweep_band(dev, modes):
    for label, fg, nz, ncopies in _grids(dev):
        dtype = fg.inv_mult.dtype
        (_, Pn, An, Bn), p = (nz,) + tuple(fg.inv_mult.shape), fg.p
        links, im = fg.dss_links, fg.inv_mult
        flags = int(fg.wrap[0]) | 2 * int(fg.wrap[1])
        gen = torch.Generator(device=dev).manual_seed(0)

        def rnd(*shape):
            return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

        xs = [(rnd(nz, Pn, An, Bn),) for _ in range(ncopies)]
        pairs = [(rnd(nz, Pn, An, Bn), rnd(nz, Pn, An, Bn))
                 for _ in range(max(1, ncopies // 2))]
        sets = []
        for _ in range(max(1, ncopies // 4)):
            wf = {"bw1": rnd(nz + 1, Pn, An, Bn),
                  "bw2": rnd(nz + 1, Pn, An, Bn),
                  "dW": rnd(nz + 1, Pn, An, Bn), "cax0": rnd(Pn, An, Bn),
                  "cbx0": rnd(Pn, An, Bn),
                  "cxx0": 1.0 + rnd(Pn, An, Bn).abs(), "cb1": 0.3,
                  "cb2": 0.7, "dt_s": 12.5, "c00": 0.6, "c01": 0.4}
            sets.append((rnd(nz, Pn, An, Bn), rnd(nz, Pn, An, Bn), wf))

        def state():
            return {k: rnd(nz + (k == "W"), Pn, An, Bn)
                    for k in dss_cuda.STATE_FIELDS}

        states = [(state(), ({k: v.abs() for k, v in state().items()},
                             state())) for _ in range(max(1, ncopies // 4))]

        def state_kernel(ray):
            def make(sh):
                def fn(d, r):
                    out = dss_cuda._dss_state_cuda(
                        d, im, fg.e_rot, links, p, flags, r if ray else None,
                        sh)
                    return [out[k] for k in dss_cuda.STATE_FIELDS]
                return fn

            def plain():
                d, r = states[0]
                out = dss_cuda.dss_state_plain(d, im, fg.e_rot, links, p,
                                               r if ray else None, fg.wrap)
                return [out[k] for k in dss_cuda.STATE_FIELDS]
            return make, states, plain

        kernels = {
            "dss_scalar": (lambda sh: lambda x: dss_cuda._dss_scalar_cuda(
                x, im, links, p, flags, sh), xs,
                lambda: [dss_cuda.dss_scalar_plain(xs[0][0], im, links, p,
                                                   fg.wrap)]),
            "dss_vector": (lambda sh: lambda u, v: dss_cuda
                           ._dss_vector_cuda(u, v, im, fg.e_rot, links, p,
                                             flags, sh),
                           pairs, lambda: list(dss_cuda.dss_vector_plain(
                               *pairs[0], im, fg.e_rot, links, p,
                               fg.wrap))),
            "dss_uvw": (lambda sh: lambda u, v, w: dss_cuda._dss_uvw_cuda(
                u, v, im, fg.e_rot, links, p, flags, w, sh),
                sets, lambda: list(dss_cuda.dss_uvw_plain(
                    *sets[0][:2], im, fg.e_rot, links, p, sets[0][2],
                    fg.wrap))),
            "dss_scalar2": (lambda sh: lambda x1, x2: dss_cuda
                            ._dss_scalar2_cuda(x1, x2, im, links, p, flags,
                                               sh),
                            pairs, lambda: list(dss_cuda.dss_scalar2_plain(
                                *pairs[0], im, links, p, fg.wrap))),
            "dss_state": state_kernel(False),
            "dss_state_rayleigh": state_kernel(True)}
        for name, (make, args, plain) in kernels.items():
            mode = name[4:].replace("_rayleigh", "")
            if mode not in modes:
                continue
            want = plain()
            rule = dss_cuda.dss_launch_shape(nz, Pn, An, Bn, p, dtype, mode,
                                             links=bool(links))
            shapes = {rule}
            for rows in BAND_ROWS:
                for lv in BAND_LEVELS:
                    for ring in BAND_RINGS:
                        try:
                            shapes.add(dss_cuda.dss_launch_shape(
                                nz, Pn, An, Bn, p, dtype, mode, rows=rows,
                                levels=lv, ring=ring, links=bool(links)))
                        except ValueError:
                            pass
            rows = []
            for sh in shapes:
                fn = make(sh)
                got = fn(*args[0])
                got = [got] if isinstance(got, torch.Tensor) else list(got)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"{label} {name} {sh}: differs from "
                                       f"the plain version")
                rows.append((time_cuda(fn, args, 20, queued=True), sh))
            rows.sort(key=lambda r: r[0])
            rule_ms = next(ms for ms, sh in rows if sh == rule)
            print(json.dumps({"grid": label, "dtype": str(dtype)[6:],
                              "kernel": name, "rule": rule._asdict(),
                              "rule_ms": rule_ms, "shapes": len(rows)}),
                  flush=True)
            for ms, sh in rows:
                print(f"  {ms:.5f} ms rows {sh.rows:3d} levels {sh.levels:2d}"
                      f" ring {sh.ring} threads {sh.threads} blocks "
                      f"{sh.blocks}", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
