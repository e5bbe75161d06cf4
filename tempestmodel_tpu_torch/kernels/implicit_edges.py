"""Edge shapes of the implicit kernel (``fast/implicit_cuda.py``,
``csrc/implicit.cu``), each held against the plain version.

The flagship's shapes leave parts of the kernel unrun: two levels (where
the staged inputs outgrow the level rows they lie in), one column and seven
(a tile of one partial block), a column count that is no multiple of the
tile (a partial last block behind full ones), and pointers one or two values
off an aligned address (one-value and 8-byte copies).  Each case builds a
cubed-sphere geometry with a terrain-like metric in the dtype under test,
the UMJS balanced state with per-mille noise, takes the first ``ncol``
columns, and runs both Jacobian modes with and without the time term.
Used by ``chip_smoke.py`` and the ``gpu`` tests; nothing on the model's
path imports this module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# name -> (levels, cubed-sphere ne, columns, launch shape overrides of
# ``implicit_launch_shape``, values the inputs start past an aligned address)
CASES = {
    "nz2_ncol1": (2, 2, 1, {}, 0),
    "nz2_ncol7": (2, 2, 7, {}, 0),
    "nz8_ncol7": (8, 2, 7, {}, 0),
    "nz8_partial_tile": (8, 4, 1532, dict(cols=8), 0),
    "nz8_offset1": (8, 4, 1536, {}, 1),
    "nz8_offset2": (8, 4, 1536, {}, 2),
    "nz40_ncol1600": (40, 5, 1600, {}, 0),
}
DT = 100.0


def _cut(t, ncol, offset):
    """The first ``ncol`` columns of ``t`` as a contiguous tensor that
    starts ``offset`` values past an aligned address."""
    buf = torch.empty(t.shape[0] * ncol + offset, dtype=t.dtype,
                      device=t.device)
    out = buf[offset:].view(t.shape[0], ncol)
    out.copy_(t[:, :ncol])
    return out


def _rel(got, want):
    e = float((got - want).abs().max() / (want.abs().max() + 1e-300))
    return e if e == e else float("inf")         # NaN is the worst error


def case_inputs(name: str, dtype, device):
    """(x_parts, x1_parts, aux, ist, constants, launch) of case ``name``:
    the state, the state times 1.001 (the iterate of a later Newton
    iteration), the aux fields, the statics, and the launch shape (None:
    the rule's)."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import implicit as fimp, implicit_cuda
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.models import nh_model, nonhydro
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)

    nz, ne, ncol, lover, offset = CASES[name]
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=ne, order=4,
                         nz=nz, ztop=tc.ztop, dt=2 * DT,
                         vertical_solver="pallas", dtype=dtype)
    consts = cfg.constants
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    fg = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device=device), seed=6)
    q = nonhydro.estimate_bandwidth(geom, consts)
    ist = implicit_cuda.implicit_statics(fimp.statics_to_device(
        nonhydro.band_assembly_statics(geom, q), dtype, device), fg)
    if not implicit_cuda.fused_supported(ist):
        raise RuntimeError(f"{name}: outside the fused implicit envelope")
    d = fast.pack_state(tc.initial_state(geom, consts, dtype=dtype,
                                         device=device), device=device)
    rng = np.random.default_rng(sum(map(ord, name)))
    for k in ("U", "V", "Rt", "Rho"):
        d[k] = d[k] * (1.0 + 1e-3 * torch.as_tensor(
            rng.standard_normal(tuple(d[k].shape)), dtype=dtype,
            device=device))
    d["W"] = 0.01 * torch.as_tensor(rng.standard_normal(tuple(d["W"].shape)),
                                    dtype=dtype, device=device)
    x0, aux = fimp._prep_aux(d, fg, None, interfaces=False)
    x0 = tuple(_cut(p, ncol, offset) for p in x0)
    x1 = tuple(_cut(p * 1.001, ncol, offset) for p in x0)
    aux = {k: _cut(v, ncol, offset) for k, v in aux.items()}
    # the plain residual reads c2 from the geometry: give it the cut one
    c2 = aux["c2"]
    ist = dataclasses.replace(ist, fg=dataclasses.replace(
        fg, c2_aa=c2[0], c2_ab=c2[1], c2_ba=c2[2], c2_bb=c2[3]))
    launch = (implicit_cuda.implicit_launch_shape(nz, ncol, dtype, **lover)
              if lover else None)
    return x0, x1, aux, ist, consts, launch


def run_case(name: str, dtype, device) -> dict:
    """Kernel against plain for case ``name`` on ``device`` (a CUDA
    device): ``{"max_err": worst relative error over every output, mode
    and time term, "err_by_output": ..., "shape": [nz, ncol], "launch":
    implicit_cuda.launch_config of the time-term launch}``."""
    from tempestmodel_tpu_torch.fast import implicit_cuda
    x0, x1, aux, ist, consts, launch = case_inputs(name, dtype, device)
    errs = {}
    for ref_jacobian in (False, True):
        for time_term in (False, True):
            xs = x1 if time_term else x0
            got = implicit_cuda._fused_implicit_cuda(
                xs, x0, aux, ist, DT, consts, ref_jacobian, time_term,
                launch)
            torch.cuda.synchronize()
            want = implicit_cuda.fused_implicit_update_plain(
                xs, x0, aux, ist, DT, consts, ref_jacobian, time_term)
            for g, w, k in zip(got, want, ("d_rt", "d_w", "d_rho")):
                errs[k] = max(errs.get(k, 0.0), _rel(g, w))
    return {"max_err": max(errs.values()), "err_by_output": errs,
            "shape": list(x0[0].shape),
            "launch": implicit_cuda.launch_config(x1, x0, aux, ist, True,
                                                  launch)}
