"""Seeded synthetic inputs for holding a kernel against its plain version.

The flagship test case has flat terrain, so every terrain term of the metric
vanishes and a kernel could drop one unnoticed.  ``terrain_like`` gives a
geometry whose separable metric has all its terms, at magnitudes a real
mountain would give; ``random_state`` a state with positive density and
potential temperature; ``random_tracers`` tracer species that tell a mix-up
of species or levels and reach every branch of the positivity filters (two
of the moist baroclinic wave's three species are all zeros, which would hide
both).  All are made with numpy from a seed, so the same
numbers can be handed to another implementation.  Used by ``chip_smoke.py``
and the tests; nothing on the model's path imports this module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FIELDS = ("U", "V", "Rt", "Rho", "W")


def terrain_fields(nz: int, P: int, A: int, B: int, sep_e, seed: int = 0,
                   jacl=None):
    """Numpy fields (float64) of a separable terrain-following metric with
    every term present, keyed as ``FastGeometry`` names them: the profiles,
    the 2-D factors and the 3-D tensors built from them.  ``sep_e``: the
    (P, A, B) flat-terrain ``con_xi_xi`` to build on.  ``jacl``: the (P, A,
    B) flat-terrain 3-D Jacobian, a constant multiple of the 2-D one; when
    given, the result also has a z-constant 3-D Jacobian (``jac3d``,
    ``jac3d_int``, ``sep_jacl``) that varies against the 2-D one from node
    to node, as over a mountain, so that a mix-up of the two shows."""
    rng = np.random.default_rng(seed)

    def r2(scale):
        return scale * rng.standard_normal((P, A, B))

    e = np.asarray(sep_e, np.float64)
    sl = rng.random((nz, 1))
    si = rng.random((nz + 1, 1))
    ca, cb = r2(1e-12), r2(1e-12)
    f = np.abs(r2(0.1)) * e
    dza, dzb = r2(0.05), r2(0.05)

    def lev(s, x):
        return s[:, :, None, None] * x[None]

    def quad(s):
        return e[None] + s[:, :, None, None] ** 2 * f[None]

    out = dict(
        s_lev=sl, s_int=si, sep_ca=ca, sep_cb=cb, sep_f=f, sep_da=dza,
        sep_db=dzb, con_a_xi=lev(sl, ca), con_b_xi=lev(sl, cb),
        con_xi_xi=quad(sl), con_a_xi_int=lev(si, ca),
        con_b_xi_int=lev(si, cb), con_xi_xi_int=quad(si),
        deriv_r_a=lev(sl, dza), deriv_r_b=lev(sl, dzb))
    if jacl is not None:
        jl = np.asarray(jacl, np.float64) * (0.8 + 0.4 * rng.random((P, A, B)))
        out.update(sep_jacl=jl,
                   jac3d=np.broadcast_to(jl, (nz, P, A, B)).copy(),
                   jac3d_int=np.broadcast_to(jl, (nz + 1, P, A, B)).copy())
    return out


def terrain_like(fg, seed: int = 0, vary_jac: bool = False):
    """A copy of the ``FastGeometry`` ``fg`` (which must have a separable
    metric) with the fields of ``terrain_fields`` in place of its own;
    ``vary_jac`` also replaces the 3-D Jacobian (see ``terrain_fields``)."""
    if not fg.sep_ok:
        raise ValueError("terrain_like needs a separable metric")
    dtype, dev = fg.inv_mult.dtype, fg.inv_mult.device
    P, A, B = fg.inv_mult.shape
    fields = terrain_fields(
        fg.nz, P, A, B, fg.sep_e.cpu().numpy(), seed,
        jacl=fg.sep_jacl.cpu().numpy() if vary_jac else None)
    return dataclasses.replace(fg, **{
        k: torch.as_tensor(np.ascontiguousarray(v), dtype=dtype, device=dev)
        for k, v in fields.items()})


# the fields on the nz + 1 interfaces, by staggering (LEV: none; INT
# states have LEV's shapes)
ON_INTERFACES = {"LOR": ("W",), "CPH": ("Rt", "W"), "LEV": ()}


def random_state_numpy(nz: int, P: int, A: int, B: int, seed: int = 0,
                       stagger: str = "LOR"):
    """Seeded z-first state (numpy float64) in the shapes of ``stagger``:
    winds of ~10 m/s, W of ~1 cm/s, density near 1 and rho*theta near 300
    with percent noise."""
    rng = np.random.default_rng(seed)
    top = ON_INTERFACES[stagger]
    d = {k: rng.standard_normal((nz + (1 if k in top else 0), P, A, B))
         for k in FIELDS}
    d["U"] *= 10.0
    d["V"] *= 10.0
    d["W"] *= 0.01
    d["Rho"] = 1.0 + 0.1 * np.abs(d["Rho"])
    rho = d["Rho"] if "Rt" not in top else np.concatenate(
        [d["Rho"], d["Rho"][-1:]])
    d["Rt"] = 300.0 * rho * (1.0 + 0.01 * d["Rt"])
    return d


def random_state(fg, seed: int = 0, stagger: str = "LOR"):
    """``random_state_numpy`` as tensors on the device and in the dtype of
    ``fg``."""
    dtype, dev = fg.inv_mult.dtype, fg.inv_mult.device
    P, A, B = fg.inv_mult.shape
    return {k: torch.as_tensor(v, dtype=dtype, device=dev)
            for k, v in random_state_numpy(fg.nz, P, A, B, seed,
                                           stagger).items()}


def random_tracers_numpy(nz: int, P: int, A: int, B: int, ntr: int = 3,
                         p: int = 4, seed: int = 0):
    """Seeded flat species-major tracer field ``(ntr * nz, P, A, B)`` (numpy
    float64): species s of magnitude 1e-2 * 10^-s, positive with a tenth of
    the values small and NEGATIVE (so that the positivity filters act), and
    per species one whole column and one whole element (``p`` x ``p`` nodes
    of one level) non-positive (the filters' zero-mass branch)."""
    rng = np.random.default_rng(seed)
    t = np.abs(rng.standard_normal((ntr, nz, P, A, B)))
    t *= 1e-2 * 10.0 ** -np.arange(ntr).reshape(ntr, 1, 1, 1, 1)
    t[rng.random(t.shape) < 0.1] *= -0.05
    for s in range(ntr):
        pn, a, b = rng.integers(P), rng.integers(A), rng.integers(B)
        t[s, :, pn, a, b] = -np.abs(t[s, :, pn, a, b])
        k, pn = rng.integers(nz), rng.integers(P)
        ea, eb = p * rng.integers(A // p), p * rng.integers(B // p)
        t[s, k, pn, ea:ea + p, eb:eb + p] = 0.0
    return t.reshape(ntr * nz, P, A, B)


def random_tracers(fg, ntr: int = 3, seed: int = 0):
    """``random_tracers_numpy`` as a tensor on the device and in the dtype of
    ``fg``."""
    P, A, B = fg.inv_mult.shape
    return torch.as_tensor(
        random_tracers_numpy(fg.nz, P, A, B, ntr, fg.p, seed),
        dtype=fg.inv_mult.dtype, device=fg.inv_mult.device)
