"""Edge shapes of the band kernel's five modes ``dss_scalar``,
``dss_vector``, ``dss_uvw``, ``dss_scalar2`` and ``dss_state``
(``fast/dss_cuda.py``, ``csrc/dss.cu``), each held against the plain
version.

The flagship's shapes leave parts of the kernels unrun: p = 2 and 3 (rows of
6 or 3 values, whose spans are no 16-byte multiple: 8- and 4-byte copies), a
cube of one element a panel (a segment on both column edges), inputs one or
two values past an aligned address, a band of several blocks' worth of
segments, rings of one and three stages, the smallest ``dss_uvw`` (two
levels, runs of one step: the bottom interface's block walks two), and on
periodic Cartesian grids the wrap along one axis or both, with the halo rows
of the first and last band copied alone.  Each case builds its grid in the
dtype under test: a cubed sphere from the geometry (inverse multiplicity,
links, rotations), a Cartesian panel from the multiplicity that the plain
DSS of ones gives.  Inputs are seeded with numpy.  Used by
``chip_smoke.py``, the ``gpu`` tests, and the CPU tests that hold each
case's plain result against the JAX package's Pallas kernels; nothing on the
model's path imports this module.
"""

from __future__ import annotations

import numpy as np
import torch

# name -> grid (("sphere", ne, p) or ("cart", A, B, p, wrap)), levels K,
# values the inputs start past an aligned address, overrides of
# ``dss_launch_shape`` for dss_scalar, for dss_vector and for dss_uvw
# (dss_scalar2 and dss_state, which sum the (U, V) pair or two fields a
# stage as dss_vector does, take dss_vector's)
CASES = {
    "sphere_ne4": (("sphere", 4, 4), 8, 0, {}, {}, {}),
    "sphere_ne4_bands": (("sphere", 4, 4), 7, 0,
                         dict(rows=4, threads=32, levels=3),
                         dict(rows=4, threads=32, levels=3),
                         dict(rows=4, threads=32, levels=3)),
    "sphere_ne4_ring3": (("sphere", 4, 4), 8, 0, dict(ring=3, levels=5),
                         dict(ring=3, levels=5), dict(ring=3, levels=5)),
    "sphere_ne4_ring1": (("sphere", 4, 4), 5, 0, dict(ring=1, levels=3),
                         dict(ring=1, levels=2), dict(levels=1)),
    "sphere_ne4_offset1": (("sphere", 4, 4), 6, 1, {}, {}, {}),
    "sphere_ne4_offset2": (("sphere", 4, 4), 6, 2, {}, {}, {}),
    "sphere_ne1": (("sphere", 1, 4), 3, 0, {}, {}, {}),
    "sphere_ne2_p3": (("sphere", 2, 3), 3, 0, {}, {}, {}),
    "sphere_ne1_p3": (("sphere", 1, 3), 2, 0, {}, {}, {}),
    "sphere_ne3_p2": (("sphere", 3, 2), 4, 0, {}, {}, {}),
    "sphere_nz2": (("sphere", 2, 4), 2, 0, {}, dict(levels=1),
                   dict(levels=1)),
    "cart_swapped": (("cart", 4, 32, 4, (True, True)), 8, 0, {}, {}, {}),
    "cart_natural": (("cart", 32, 4, 4, (True, True)), 8, 0, dict(rows=8),
                     dict(rows=8), dict(rows=8)),
    "cart_plane": (("cart", 16, 16, 4, (True, True)), 6, 0, dict(rows=4),
                   dict(rows=4, ring=1), dict(rows=4)),
    "cart_wrap_a": (("cart", 16, 8, 4, (True, False)), 4, 1,
                    dict(rows=8, threads=32), dict(rows=8, threads=32),
                    dict(rows=8, threads=32)),
    "cart_wrap_b": (("cart", 8, 16, 4, (False, True)), 4, 2, {}, {}, {}),
    "cart_p3": (("cart", 9, 6, 3, (True, True)), 3, 0, dict(rows=3),
                dict(rows=3), dict(rows=3)),
    "cart_one_element": (("cart", 4, 4, 4, (True, True)), 2, 0, {}, {},
                         {}),
}
KERNELS = ("dss_scalar", "dss_vector", "dss_uvw", "dss_scalar2", "dss_state")


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


def grid(name: str, dtype, device):
    """(inv_mult, links, rot, wrap, p) of case ``name``."""
    from tempestmodel_tpu_torch.fast import dss_cuda
    spec = CASES[name][0]
    if spec[0] == "sphere":
        import tempestmodel_tpu_torch as tm
        from tempestmodel_tpu_torch import fast
        from tempestmodel_tpu_torch.models import nh_model
        _, ne, p = spec
        cfg = tm.ModelConfig(grid_kind=tm.GridKind.CUBED_SPHERE, ne=ne,
                             order=p, nz=4, ztop=30000.0, dtype=dtype)
        fg = fast.build_fast_geometry(nh_model.build_nh_sphere_geometry(cfg),
                                      dtype=dtype, device=device)
        return (fg.inv_mult, fg.dss_links, fg.e_rot.contiguous(),
                (False, False), p)
    _, A, B, p, wrap = spec
    ones = torch.ones((1, 1, A, B), dtype=dtype, device=device)
    mult = dss_cuda.dss_scalar_plain(ones, ones[0], (), p, wrap)[0]
    return ((1.0 / mult).contiguous(), (),
            torch.zeros((4, 1, A), dtype=dtype, device=device), wrap, p)


def case_inputs(name: str, dtype, device):
    """(grid, x, u, v, w_finish) of case ``name``: ``grid`` as ``grid``
    returns it, the scalar field ``x`` and the ``dss_uvw`` inputs (U and V
    also those of ``dss_vector``), each starting the case's offset past an
    aligned address."""
    g = grid(name, dtype, device)
    P, A, B = g[0].shape
    K, offset = CASES[name][1], CASES[name][2]
    rng = np.random.default_rng(sum(map(ord, name)))

    def rnd(*shape, positive=False):
        a = rng.standard_normal(shape)
        a = 1.0 + np.abs(a) if positive else a
        return _cut(torch.as_tensor(a, dtype=dtype, device=device), offset)

    wf = {"bw1": rnd(K + 1, P, A, B), "bw2": rnd(K + 1, P, A, B),
          "dW": rnd(K + 1, P, A, B), "cax0": rnd(P, A, B),
          "cbx0": rnd(P, A, B), "cxx0": rnd(P, A, B, positive=True),
          "cb1": 0.3, "cb2": 0.7, "dt_s": 12.5, "c00": 0.6, "c01": 0.4}
    return g, rnd(K, P, A, B), rnd(K, P, A, B), rnd(K, P, A, B), wf


def state_inputs(name: str, dtype, device, P, A, B):
    """(state, (fac, ref)) of case ``name``: the five fields of a state (W
    with one level more) and a Rayleigh finish of the model's form (Rho's
    factor one, ref = (1 - fac) x_ref), each starting the case's offset past
    an aligned address."""
    from tempestmodel_tpu_torch.fast import dss_cuda
    K, offset = CASES[name][1], CASES[name][2]
    rng = np.random.default_rng(sum(map(ord, name)) + 1)

    def cut(a):
        return _cut(torch.as_tensor(a, dtype=dtype, device=device), offset)

    shapes = {k: (K + (k == "W"), P, A, B) for k in dss_cuda.STATE_FIELDS}
    d = {k: cut(rng.standard_normal(s)) for k, s in shapes.items()}
    fac = {k: rng.random(s) for k, s in shapes.items()}
    fac["Rho"] = np.ones(shapes["Rho"])
    ref = {k: (1.0 - fac[k]) * rng.standard_normal(s)
           for k, s in shapes.items()}
    return d, ({k: cut(v) for k, v in fac.items()},
               {k: cut(v) for k, v in ref.items()})


def _edge_masks(A, B):
    edge = np.zeros((A, B), bool)
    edge[0, :] = edge[-1, :] = edge[:, 0] = edge[:, -1] = True
    corner = np.zeros((A, B), bool)
    corner[[0, 0, -1, -1], [0, -1, 0, -1]] = True
    return edge, corner


def launch_shapes(name: str, dtype) -> dict:
    """{kernel: the ``DssLaunch`` of case ``name``} (the rule's shape with
    the case's overrides)."""
    from tempestmodel_tpu_torch.fast import dss_cuda
    spec, K = CASES[name][:2]
    if spec[0] == "sphere":
        P, A, B, p, links = 6, spec[1] * spec[2], spec[1] * spec[2], \
            spec[2], True
    else:
        P, (A, B, p), links = 1, spec[1:4], False
    over = CASES[name][3:]
    return {k: dss_cuda.dss_launch_shape(K, P, A, B, p, dtype, k[4:],
                                         links=links, **ov)
            for k, ov in zip(KERNELS, over + over[1:2] + over[1:2])}


def run_case(name: str, dtype, device) -> dict:
    """Kernels against plain for case ``name`` on ``device`` (a CUDA
    device): ``{"max_err": the worst relative error, "err_by_output": ...,
    "bitwise": whether every output equals the plain one bit for bit,
    "shape", "launch": {kernel: launch_config}}``.  ``dss_uvw`` runs with
    two bases and one; its bottom W row is also held alone, on the panel
    edges and at the corners.  ``dss_scalar2`` runs on x and U, and is also
    held bit for bit against two ``dss_scalar`` launches
    (``"scalar2_equals_two_launches"``).  ``dss_state`` runs without and
    with the Rayleigh finish, and is also held bit for bit against the
    separate launches followed by the plain finish
    (``"state_equals_separate_launches"``)."""
    from tempestmodel_tpu_torch.fast import dss_cuda
    (im, links, rot, wrap, p), x, u, v, wf = case_inputs(
        name, dtype, device)
    K, P, A, B = x.shape
    flags = int(wrap[0]) | 2 * int(wrap[1])
    shapes = launch_shapes(name, dtype)
    ls, lv, lu, l2, lst = (shapes[k] for k in KERNELS)
    errs, bitwise = {}, True
    got = dss_cuda._dss_scalar_cuda(x, im, links, p, flags, ls)
    torch.cuda.synchronize()
    want = dss_cuda.dss_scalar_plain(x, im, links, p, wrap)
    errs["dss_scalar"] = _rel(got, want)
    bitwise &= torch.equal(got, want)
    got = dss_cuda._dss_vector_cuda(u, v, im, rot, links, p, flags, lv)
    torch.cuda.synchronize()
    want = dss_cuda.dss_vector_plain(u, v, im, rot, links, p, wrap)
    for k, g_, w_ in zip(("U", "V"), got, want):
        errs[f"dss_vector_{k}"] = _rel(g_, w_)
        bitwise &= torch.equal(g_, w_)
    edge, corner = (torch.as_tensor(m, device=device)
                    for m in _edge_masks(A, B))
    for tag, w in (("two_base", wf), ("one_base", dict(wf, bw2=None))):
        got = dss_cuda._dss_uvw_cuda(u, v, im, rot, links, p, flags, w, lu)
        torch.cuda.synchronize()
        want = dss_cuda.dss_uvw_plain(u, v, im, rot, links, p, w, wrap)
        for k, g_, w_ in zip(("U", "V", "W"), got, want):
            errs[f"dss_uvw_{tag}_{k}"] = _rel(g_, w_)
            bitwise &= torch.equal(g_, w_)
        errs[f"dss_uvw_{tag}_W_bottom"] = _rel(got[2][0], want[2][0])
        errs[f"dss_uvw_{tag}_W_bottom_edges"] = _rel(got[2][0][:, edge],
                                                     want[2][0][:, edge])
        errs[f"dss_uvw_{tag}_W_bottom_corners"] = _rel(
            got[2][0][:, corner], want[2][0][:, corner])
    got = dss_cuda._dss_scalar2_cuda(x, u, im, links, p, flags, l2)
    torch.cuda.synchronize()
    want = dss_cuda.dss_scalar2_plain(x, u, im, links, p, wrap)
    two = [dss_cuda._dss_scalar_cuda(f, im, links, p, flags, ls)
           for f in (x, u)]
    torch.cuda.synchronize()
    equal = True
    for k, g_, w_, t_ in zip(("x", "U"), got, want, two):
        errs[f"dss_scalar2_{k}"] = _rel(g_, w_)
        bitwise &= torch.equal(g_, w_)
        equal &= torch.equal(g_, t_)
    d, ray = state_inputs(name, dtype, device, P, A, B)
    sep_equal = True
    for tag, r in (("", None), ("_rayleigh", ray)):
        got = dss_cuda._dss_state_cuda(d, im, rot, links, p, flags, r, lst)
        torch.cuda.synchronize()
        want = dss_cuda.dss_state_plain(d, im, rot, links, p, r, wrap)
        sep = dict(zip(("U", "V"), dss_cuda._dss_vector_cuda(
            d["U"], d["V"], im, rot, links, p, flags, lv)))
        sep["Rt"], sep["Rho"] = dss_cuda._dss_scalar2_cuda(
            d["Rt"], d["Rho"], im, links, p, flags, l2)
        sep["W"] = dss_cuda._dss_scalar_cuda(d["W"], im, links, p, flags, ls)
        torch.cuda.synchronize()
        if r is not None:
            sep = {k: r[0][k] * sep[k] + r[1][k] for k in sep}
        for k in dss_cuda.STATE_FIELDS:
            errs[f"dss_state{tag}_{k}"] = _rel(got[k], want[k])
            bitwise &= torch.equal(got[k], want[k])
            sep_equal &= torch.equal(got[k], sep[k])
    return {"max_err": max(errs.values()), "err_by_output": errs,
            "bitwise": bool(bitwise),
            "scalar2_equals_two_launches": bool(equal),
            "state_equals_separate_launches": bool(sep_equal),
            "shape": [K, P, A, B],
            "launch": {
                "dss_scalar": dss_cuda.launch_config(
                    x, p, "scalar", dss_cuda._scalar_ptrs(x, im),
                    bool(links), ls),
                "dss_vector": dss_cuda.launch_config(
                    u, p, "vector", dss_cuda._vector_ptrs(u, v, im),
                    bool(links), lv),
                "dss_uvw": dss_cuda.launch_config(
                    u, p, "uvw", dss_cuda._uvw_ptrs(u, v, wf, im),
                    bool(links), lu),
                "dss_scalar2": dss_cuda.launch_config(
                    x, p, "scalar2", dss_cuda._scalar2_ptrs(x, u, im),
                    bool(links), l2),
                "dss_state": dss_cuda.launch_config(
                    d["U"], p, "state", dss_cuda._state_ptrs(d, im),
                    bool(links), lst)}}
