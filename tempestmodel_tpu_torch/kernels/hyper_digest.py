#!/usr/bin/env python3
"""SHA-256 digests of what the nu4 kernels compute for the nonhydrostatic
field set at the flagship shape, float32 and float64: a check that a change
to ``csrc/hyper.cu`` leaves those instantiations bit for bit as they were.

Run from the repository root on a machine with an NVIDIA Hopper card and
nvcc:

    python3 tempestmodel_tpu_torch/kernels/hyper_digest.py [--root DIR]

``DIR`` (default: the repository this file lies in) is the checkout whose
package is imported and built: an unpacked earlier commit (``git archive``)
under a git-ignored directory gives the digests the current tree must
match.  Run as a file, not with ``-m``, so that the package is imported
from ``DIR``.  ``chip_smoke.py`` phase 3 calls ``digests`` and holds the
result to the digests of the commit before the shallow-water field set was
added (``chip_smoke.NU4_DIGESTS``).

The inputs: the UMJS flagship grid (ne30 p4, 30 levels) with a seeded
terrain-like metric whose 3-D Jacobian is no multiple of the 2-D one
(``synthetic.terrain_like``), two seeded random states
(``synthetic.random_state``: numpy, so the same bits on every machine) and
fixed viscosities that make pass 2's increment of the order of the state.
The digest covers pass 1's five outputs, then pass 2's, in ``FIELDS``
order, as raw bytes.  ``sw_digests`` does the same for the shallow-water
field set (U, V, H) on the ne60 grid.  Prints one JSON line.
"""

import argparse
import hashlib
import json
import pathlib
import sys

# nu_s, nu_d, nu_v, dt of pass 2 (a second Laplacian of the random fields
# on this grid is ~1e-20 a metre^4)
NU = (3.0e19, 2.0e19, 1.4e19, 1.0)


def digests(dev) -> dict:
    """{"f32": hex, "f64": hex} of the nonhydrostatic nu4 kernels' outputs
    on ``dev``."""
    import torch
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import hyper_cuda
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.models import nh_model

    cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=30, order=4,
                         nz=30, ztop=30000.0, dtype=torch.float32)
    geom = nh_model.build_nh_sphere_geometry(cfg)
    out = {}
    for dtype in (torch.float32, torch.float64):
        fg = synthetic.terrain_like(
            fast.build_fast_geometry(geom, dtype=dtype, device=dev), seed=0,
            vary_jac=True)
        st = hyper_cuda.hyper_statics(fg)
        d = synthetic.random_state(fg, seed=1)
        w = synthetic.random_state(fg, seed=11)
        o1 = hyper_cuda.nu4_pass1(d, fg, st)
        o2 = hyper_cuda.nu4_pass2(d, w, *NU, fg, st)
        h = hashlib.sha256()
        for o in (o1, o2):
            for k in hyper_cuda.FIELDS:
                h.update(o[k].cpu().numpy().tobytes())
        out["f32" if dtype == torch.float32 else "f64"] = h.hexdigest()
        del fg, st, d, w, o1, o2
    return out


def sw_digests(dev) -> dict:
    """{"f32": hex, "f64": hex} of the shallow-water field set's nu4
    outputs (U, V, H; the 2-D Jacobian) on ``dev``: the ne60 p4 grid of
    ``chip_smoke.py``'s Galewsky run, two seeded random states, the
    viscosities of ``NU``."""
    import numpy as np
    import torch
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch.fast import hyper_cuda
    from tempestmodel_tpu_torch.models import sw_model

    out = {}
    for dtype in (torch.float32, torch.float64):
        geom = sw_model.build_sw_geometry(tm.ModelConfig(
            ne=60, order=4, dtype=dtype))
        st = sw_model.sw_statics(geom, dev).hyper
        A = geom.ne * geom.p

        def state(seed):
            rng = np.random.default_rng(seed)
            f = rng.standard_normal((3, 1, 6, A, A))
            return {k: torch.as_tensor(v * s, dtype=dtype, device=dev)
                    for k, v, s in zip(hyper_cuda.SW_FIELDS, f,
                                       (1e8, 1e8, 1e3))}
        d, w = state(1), state(11)
        o1 = hyper_cuda.nu4_pass1(d, None, st)
        o2 = hyper_cuda.nu4_pass2(d, w, *NU, None, st)
        h = hashlib.sha256()
        for o in (o1, o2):
            for k in hyper_cuda.SW_FIELDS:
                h.update(o[k].cpu().numpy().tobytes())
        out["f32" if dtype == torch.float32 else "f64"] = h.hexdigest()
        del st, d, w, o1, o2
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
    import os
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("hyper_digest: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(json.dumps({"root": root, "nu4_digests": digests(dev),
                      "nu4_sw_digests": sw_digests(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
