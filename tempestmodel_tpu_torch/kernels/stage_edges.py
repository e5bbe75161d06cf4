"""Edge shapes of the stage kernel (``fast/stage_cuda.py``,
``csrc/stage.cu``), each held against the plain version.

The flagship's shapes leave parts of the kernel unrun: two levels (the
window's halo rows and the ring's rows past the top), a level count that is
no multiple of the chunk or the ring, a row too short or a pointer too
unaligned for 16-byte copies, one species and two groups of species.  Each
case builds a small cubed-sphere geometry with a terrain-like metric (a
z-constant 3-D Jacobian that varies against the 2-D one) in the dtype under
test, seeded states and tracers, and runs one and two bases at the stage's
step and at steps that make each field's increment as large as the field.
Used by ``chip_smoke.py`` and the ``gpu`` tests; nothing on the model's path
imports this module.
"""

from __future__ import annotations

import dataclasses

import torch

# name -> (configuration overrides of ne4 p4 nz8, species, launch shape
# overrides of ``stage_launch_shape``, metric form, pointers one value off
# an aligned address)
CASES = {
    "nz2": (dict(nz=2), 1, {}, "separable", False),
    "nz7_levels3": (dict(nz=7), 0, dict(levels=3), "full3d", False),
    "nz7_ring6_6species": (dict(nz=7), 6, dict(ring=6), "separable",
                           False),
    "p3_one_value_copies": (dict(ne=3, order=3), 1, {}, "full3d", False),
    "p5": (dict(ne=2, order=5), 6, {}, "separable", False),
    "unaligned_pointers": (dict(), 1, dict(ring=3), "separable", True),
}
BASE_CONFIG = dict(ne=4, order=4, nz=8, ztop=30000.0, dt=200.0)
DT_S = 12.5


def _unaligned(t):
    """A contiguous copy of ``t`` that starts one value past an aligned
    address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _rel(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1e-300))


def run_case(name: str, dtype, device) -> dict:
    """Kernel against plain for case ``name`` on ``device`` (a CUDA
    device): ``{"max_err": worst relative error over every output, launch
    and step, "err_by_output": ..., "launch": stage_cuda.launch_config of
    the two-base launch}``."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.fast import stage_cuda
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.models import nh_model

    over, ntr, lover, form, unaligned = CASES[name]
    cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE,
                         vertical_solver="pallas", dtype=dtype,
                         **{**BASE_CONFIG, **over})
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=cfg.ztop)
    fg = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device=device), seed=4,
        vary_jac=True)
    fg = dataclasses.replace(fg, sep_ok=(form == "separable"))
    st = stage_cuda.stage_statics(fg)
    states = []
    for seed in (1, 2, 3):
        d = synthetic.random_state(fg, seed)
        if ntr:
            d["Tracers"] = synthetic.random_tracers(fg, ntr, seed + 6)
        if unaligned:
            d = {k: _unaligned(v) for k, v in d.items()}
        states.append(d)
    ue, b1, b2 = states
    nz, P, A, B = ue["U"].shape
    launch = None
    if lover:
        launch = stage_cuda.stage_launch_shape(
            nz, A, B, fg.p, ntr, dtype, True, form == "separable", P,
            **lover)
    # a step per field that makes its increment as large as the field
    zero = {k: torch.zeros_like(v) for k, v in ue.items()}
    tend = stage_cuda.fused_stage_plain(zero, ue, 1.0, fg, cfg.constants,
                                        defer_w=True)[0]
    keys = stage_cuda.STATE4 + (("Tracers",) if ntr else ())
    dts = [DT_S] + [float(ue[k].abs().max() / tend[k].abs().max())
                    for k in keys]
    errs = {}
    for dt_s in dts:
        for base in (b1, ((0.3, b1), (0.7, b2))):
            tb, c1, x1, c2, x2 = stage_cuda._split_base(base)
            outs = stage_cuda._fused_stage_cuda(
                tb, c1, x1, c2, x2, ue, dt_s, fg, cfg.constants, st, launch)
            torch.cuda.synchronize()
            want, wwf = stage_cuda.fused_stage_plain(
                base, ue, dt_s, fg, cfg.constants, defer_w=True)
            e = {k: _rel(outs[i], want[k])
                 for i, k in enumerate(stage_cuda.STATE4)}
            e["dW"] = _rel(stage_cuda.colop(fg.interp_n2i, outs[4]),
                           wwf["dW"])
            for s in range(ntr):
                rows = slice(s * nz, (s + 1) * nz)
                e[f"species{s}"] = _rel(outs[5][rows],
                                        want["Tracers"][rows])
            # NaN counts as the worst error
            errs = {k: max(v if v == v else float("inf"), errs.get(k, 0.0))
                    for k, v in e.items()}
    return {"max_err": max(errs.values()), "err_by_output": errs,
            "shape": [nz, P, A, B], "p": fg.p, "species": ntr,
            "launch": stage_cuda.launch_config(((0.3, b1), (0.7, b2)), ue, fg,
                                               st, launch)}
