"""Edge shapes of the nu4 kernels ``nu4_pass1`` and ``nu4_pass2``
(``fast/hyper_cuda.py``, ``csrc/hyper.cu``), each held against the plain
version.

The flagship's shapes leave parts of the kernels unrun: the generic
instantiation (p = 2, 3, 5 and 8; at p = 3 a segment is no 16-byte
multiple and the copies go by 8 or 4 bytes), a cube of one element a panel
(A = p), one level (W has two interfaces), inputs one or two values past an
aligned address (8- and 4-byte copies), rings of two to four stages with
runs that end on the top interface alone or part way, bands narrower than
the panel (their rows copied one by one), and on periodic Cartesian planes
element widths along a and b that differ, in both layouts, and a panel too
wide for one band of whole rows.  Every case has a metric whose z-constant
3-D Jacobian is no multiple of the 2-D one: the cubed sphere's from
``synthetic.terrain_like(vary_jac=True)``, a plane's a seeded perturbation
of its own.  Inputs are seeded with numpy; pass 2's viscosities make its
increment as large as the state.  Used by ``chip_smoke.py``, the ``gpu``
tests, and the CPU tests that hold each case's plain result against the JAX
package; nothing on the model's path imports this module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SEED = 7
# name -> grid (("sphere", ne, p) or ("cart", nex, ney, p, swap_ab)), levels
# nz, values the inputs start past an aligned address, overrides of
# ``hyper_launch_shape`` (both passes)
CASES = {
    "sphere_ne4": (("sphere", 4, 4), 8, 0, {}),
    "sphere_ne4_ring2": (("sphere", 4, 4), 7, 0, dict(levels=3, ring=2)),
    "sphere_ne4_ring3": (("sphere", 4, 4), 8, 0, dict(levels=5, ring=3)),
    "sphere_ne4_ring4": (("sphere", 4, 4), 9, 0, dict(levels=10, ring=4)),
    "sphere_ne4_columns": (("sphere", 4, 4), 5, 0,
                           dict(rows=8, cols=8, levels=3, ring=2)),
    "sphere_ne4_offset1": (("sphere", 4, 4), 6, 1, dict(levels=4, ring=2)),
    "sphere_ne4_offset2": (("sphere", 4, 4), 6, 2, dict(levels=4, ring=2)),
    "sphere_ne1": (("sphere", 1, 4), 3, 0, {}),
    "sphere_ne4_p2": (("sphere", 4, 2), 4, 0, dict(levels=3, ring=2)),
    "sphere_ne2_p3": (("sphere", 2, 3), 3, 0, {}),
    "sphere_ne1_p3": (("sphere", 1, 3), 2, 0, {}),
    "sphere_ne2_p5": (("sphere", 2, 5), 2, 0, {}),
    "sphere_ne1_p8": (("sphere", 1, 8), 2, 0, {}),
    "sphere_nz1": (("sphere", 2, 4), 1, 0, {}),
    "cart_plane": (("cart", 4, 2, 4, False), 6, 0, {}),
    "cart_plane_swapped": (("cart", 4, 2, 4, True), 6, 0,
                           dict(levels=3, ring=2)),
    "cart_p3": (("cart", 3, 2, 3, False), 3, 0, {}),
    "cart_wide": (("cart", 2, 80, 4, False), 2, 0, {}),
}
METRIC = ("c2_aa", "c2_ab", "c2_ba", "c2_bb", "jac2d", "jac3d", "jac3d_int")


def _cut(t, offset):
    """``t`` as a contiguous tensor that starts ``offset`` values past an
    aligned address."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _rel(got, want):
    e = float((got - want).abs().max() / (want.abs().max() + 1e-300))
    return e if e == e else float("inf")         # NaN is the worst error


def seeded_metric(fg, seed: int):
    """A copy of the ``FastGeometry`` ``fg`` with a seeded metric in place
    of its own: the contravariant terms and the 2-D Jacobian perturbed by a
    tenth, the cross term made nonzero, and a z-constant 3-D Jacobian (equal
    on levels and interfaces) that varies against the 2-D one from node to
    node."""
    rng = np.random.default_rng(seed)
    dtype, dev = fg.inv_mult.dtype, fg.inv_mult.device

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    aa, bb, j2 = host(fg.c2_aa), host(fg.c2_bb), host(fg.jac2d)
    jl = host(fg.jac3d)[0]

    def noise():
        return rng.uniform(-1.0, 1.0, aa.shape)

    ab = 0.2 * np.sqrt(aa * bb) * noise()
    new = {"c2_aa": aa * (1.0 + 0.1 * noise()), "c2_ab": ab, "c2_ba": ab,
           "c2_bb": bb * (1.0 + 0.1 * noise()),
           "jac2d": j2 * (1.0 + 0.1 * noise())}
    jl = jl * (1.0 + 0.2 * noise())
    new["jac3d"] = np.broadcast_to(jl, fg.jac3d.shape)
    new["jac3d_int"] = np.broadcast_to(jl, fg.jac3d_int.shape)
    return dataclasses.replace(fg, **{
        k: torch.as_tensor(np.ascontiguousarray(v), dtype=dtype, device=dev)
        for k, v in new.items()})


def geometry(name: str, dtype, device):
    """The ``FastGeometry`` of case ``name`` in ``dtype`` on ``device``,
    with the case's metric."""
    import tempestmodel_tpu_torch as tm
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.kernels import synthetic
    from tempestmodel_tpu_torch.models import nh_model
    spec, nz = CASES[name][:2]
    if spec[0] == "sphere":
        _, ne, p = spec
        cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=ne,
                             order=p, nz=nz, ztop=30000.0, dtype=dtype)
        fg = fast.build_fast_geometry(nh_model.build_nh_sphere_geometry(cfg),
                                      dtype=dtype, device=device)
        return synthetic.terrain_like(fg, seed=SEED, vary_jac=True)
    from tempestmodel_tpu_torch.testcases.nonhydro_xz import ThermalBubble3D
    _, nex, ney, p, swap = spec
    tc = ThermalBubble3D()
    cfg = tm.ModelConfig(grid_kind=tm.GridKind.CARTESIAN_3D, nex=nex,
                         ney=ney, order=p, nz=nz, x_extent=tc.x_extent,
                         y_extent=tc.y_extent, ztop=tc.ztop, dtype=dtype)
    geom = nh_model.build_nh_cartesian_geometry(cfg, ztop=tc.ztop)
    fg = fast.build_fast_geometry_cartesian(geom, dtype=dtype, device=device,
                                            swap_ab=swap)
    return seeded_metric(fg, SEED)


def case_inputs(name: str, fg, stagger: str = "LOR"):
    """(d, w, nu) of case ``name`` on the geometry ``fg`` (its dtype and
    device) in the shapes of ``stagger`` (``synthetic.ON_INTERFACES``): the
    state ``d`` and pass 2's work fields ``w``, each field starting the
    case's offset past an aligned address, and ``nu = (nu_s, nu_d, nu_v,
    dt)`` that make pass 2's increment as large as the state."""
    from tempestmodel_tpu_torch.fast import hyper_cuda
    from tempestmodel_tpu_torch.kernels import synthetic
    offset = CASES[name][2]
    P, A, B = fg.inv_mult.shape
    seed = sum(map(ord, name))
    d, w = ({k: _cut(torch.as_tensor(v, dtype=fg.inv_mult.dtype,
                                     device=fg.inv_mult.device), offset)
             for k, v in synthetic.random_state_numpy(
                 fg.nz, P, A, B, seed + s, stagger).items()}
            for s in (0, 1))
    st = hyper_cuda.hyper_statics(fg)
    unit = hyper_cuda.nu4_pass1_plain(w, fg, st)
    nu_s = float(d["Rho"].abs().max() / unit["Rho"].abs().max())
    nu_v = float(d["U"].abs().max() / unit["U"].abs().max())
    return d, w, (nu_s, nu_v, 0.7 * nu_v, 1.0)


def launch_shapes(name: str, fg, stagger: str = "LOR"):
    """The case's launch shapes of pass 1 and pass 2 (the field set of
    ``stagger``)."""
    from tempestmodel_tpu_torch.fast import hyper_cuda
    P, A, B = fg.inv_mult.shape
    ov = CASES[name][3]
    return tuple(hyper_cuda.hyper_launch_shape(
        fg.nz, P, A, B, fg.p, fg.inv_mult.dtype, pass2,
        top=hyper_cuda.TOP_MASKS[stagger], **ov)
        for pass2 in (False, True))


def run_case(name: str, dtype, device, stagger: str = "LOR") -> dict:
    """Kernels against plain for case ``name`` on ``device`` (a CUDA
    device) in the field set of ``stagger``: ``{"max_err": the worst
    relative error, "err_by_output": ..., "shape", "launch": {pass:
    launch_config}}``.  Pass 2 is held as a whole and by its increment on
    its own."""
    from tempestmodel_tpu_torch.fast import hyper_cuda
    fg = geometry(name, dtype, device)
    st = hyper_cuda.hyper_statics(fg)
    d, w, nu = case_inputs(name, fg, stagger)
    l1, l2 = launch_shapes(name, fg, stagger)
    scal2 = (nu[1], nu[2], nu[3], nu[3] * nu[0])
    got1 = hyper_cuda._launch("nu4_pass1", d, None, (1.0, 1.0, 0.0, 0.0),
                              st, l1)
    got2 = hyper_cuda._launch("nu4_pass2", w, d, scal2, st, l2)
    if device.type == "cuda":
        torch.cuda.synchronize()
    want1 = hyper_cuda.nu4_pass1_plain(d, fg, st)
    want2 = hyper_cuda.nu4_pass2_plain(d, w, *nu, fg, st)
    errs = {}
    for k in want1:
        errs[f"nu4_pass1_{k}"] = _rel(got1[k], want1[k])
        errs[f"nu4_pass2_{k}"] = _rel(got2[k], want2[k])
        errs[f"nu4_pass2_increment_{k}"] = _rel(got2[k] - d[k],
                                                want2[k] - d[k])
    return {"max_err": max(errs.values()), "err_by_output": errs,
            "shape": list(d["U"].shape),
            "launch": {"nu4_pass1": hyper_cuda.launch_config(d, None, st, l1),
                       "nu4_pass2": hyper_cuda.launch_config(w, d, st, l2)}}
