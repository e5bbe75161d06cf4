"""The two Laplacian passes of the nu4 hyperdiffusion tail, one kernel each:
the CUDA kernels' wrappers and their plain versions.

Counterpart of the JAX package's ``fast/hyper_pallas.py`` (``nu4_pass1``,
``nu4_pass2``).  The Strang tail is two horizontal Laplacian passes with a
DSS between them and one after: pass 1 produces the unscaled Laplacian
"work" fields of the five state fields, pass 2 applies the scaled second
Laplacian to the DSSed work fields and adds the result onto the state.  The
DSS calls stay outside (``engine.apply_dss``).

Restriction, as in the JAX package: order-4 hyperviscosity with a 3-D
Jacobian that is constant in z and the same on levels and interfaces (true
for the Gal-Chen vertical of ``grid/geometry.py``: jac3d = (ztop - zs) *
jac2d on every level), so that the Laplacian's 1/J needs (6, A, B) metric
reads only.  ``supported()`` says whether a configuration is inside;
others take the plain tensor code of ``engine.step_after_subcycle``.

The kernels (``csrc/hyper.cu``) are not shaped like the TPU ones; see the
note there for their design and their bound on the card.  ``nu4_pass1`` and
``nu4_pass2`` launch them for CUDA tensors — or raise — and run the plain
versions only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import np_dtype
from ..kernels import build, stencils
from ..kernels.counts import launch_counts

FIELDS = ("U", "V", "Rt", "Rho", "W")
MAX_P = 8        # nodes per element edge the kernels' tiles are sized for


def supported(fg, cfg) -> bool:
    """Whether the two kernels cover this configuration.  A statement about
    the configuration only.  Order-4 hyperviscosity; the level and the
    interface Jacobian each constant in z AND equal to each other (the
    kernels use ``jac3d[0]`` for W's Laplacian where the plain tail uses
    ``jac3d_int``); whole elements of at most ``MAX_P`` nodes an edge.  Any
    grid the engine takes: the passes read neither the x-z switch, nor the
    layout, nor the wrap (the DSS between them does).  (The TPU kernels'
    further conditions on ``A`` and ``p`` are about their tiles and are not
    carried over.)"""
    jac, jac_i = fg.jac3d, fg.jac3d_int
    # equal up to the rounding of the geometry's dtype (1e-12 in float64)
    rtol = max(1e-12, 2.0 * torch.finfo(jac.dtype).eps)
    return (cfg.hypervis_order == 4 and fg.vo >= 1 and fg.p <= MAX_P
            and fg.A % fg.p == 0 and fg.B % fg.p == 0
            and bool((jac == jac[0:1]).all())
            and bool((jac_i == jac_i[0:1]).all())
            and bool(torch.allclose(jac[0], jac_i[0], rtol=rtol, atol=0.0)))


@dataclasses.dataclass
class HyperStatics:
    """What the two passes need beside the fields, built once per
    configuration (``hyper_statics``)."""
    m2d: Any      # (8, P, A, B): c2aa, c2ab, c2ba, c2bb, j2, 1/j2, jl, 1/jl
    #             # with j2 = jac2d and jl = jac3d[0]
    ds: Any       # 1-D tensor: D[s, i] / delta, then S[i, s] / delta, along
    #             # a, then along b (``stencils.element_matrices``)
    p: int


def hyper_statics(fg) -> HyperStatics:
    """The metric stack and the element matrices on the device and in the
    dtype of ``fg``."""
    dtype, dev = fg.inv_mult.dtype, fg.inv_mult.device
    j2 = fg.jac2d
    jl = fg.jac3d[0]
    m2d = torch.stack([fg.c2_aa, fg.c2_ab, fg.c2_ba, fg.c2_bb,
                       j2, 1.0 / j2, jl, 1.0 / jl]).contiguous()
    ds = torch.as_tensor(np.concatenate(
        [m.ravel() for m in stencils.element_matrices(fg)]).astype(
            np_dtype(dtype)), device=dev)
    return HyperStatics(m2d=m2d, ds=ds, p=fg.p)


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic: element-local p-point sums, the
# z-constant metric, the multiply by 1/J)
# ---------------------------------------------------------------------------

def _mats(st: HyperStatics):
    """((Dd, Wd) along a, (Dd, Wd) along b): ``Dd[s, i] = D[s, i] / delta``
    for the strong derivative, ``Wd[s, i] = S[i, s] / delta`` for the weak
    one."""
    p = st.p
    m = st.ds.reshape(4, p, p)
    return (m[0], m[1].T), (m[2], m[3].T)


def _da(x, M):
    """Element-local sum along a: ``out_i = sum_s M[s, i] * x_s``."""
    K, P, A, B = x.shape
    p = M.shape[0]
    return torch.matmul(M.T, x.reshape(K, P, A // p, p, B)).reshape(x.shape)


def _db(x, M):
    """The same along b."""
    K, P, A, B = x.shape
    p = M.shape[0]
    return torch.matmul(x.reshape(K, P, A, B // p, p), M).reshape(x.shape)


def _scalar_lap(f, m, mats):
    c2aa, c2ab, c2ba, c2bb, _, _, jl, jlinv = m
    (Dd, Wd), (Ddb, Wdb) = mats
    da = _da(f, Dd)
    db = _db(f, Ddb)
    ga = jl * (c2aa * da + c2ab * db)
    gb = jl * (c2ba * da + c2bb * db)
    return -(_da(ga, Wd) + _db(gb, Wdb)) * jlinv


def _vector_upd(u, v, nu_div, nu_vort, m, mats):
    c2aa, c2ab, c2ba, c2bb, j2, j2inv, _, _ = m
    (Dd, Wd), (Ddb, Wdb) = mats
    con_u = c2aa * u + c2ab * v
    con_v = c2ba * u + c2bb * v
    div = (_da(j2 * con_u, Dd) + _db(j2 * con_v, Ddb)) * j2inv
    curl = (_da(v, Dd) - _db(u, Ddb)) * j2inv
    wda_div = -_da(div, Wd)
    wdb_div = -_db(div, Wdb)
    wda_curl = -_da(curl, Wd)
    wdb_curl = -_db(curl, Wdb)
    du = nu_div * wda_div - nu_vort * j2 * (
        c2ba * wda_curl + c2bb * wdb_curl)
    dv = nu_div * wdb_div + nu_vort * j2 * (
        c2aa * wda_curl + c2ab * wdb_curl)
    return du, dv


def nu4_pass1_plain(d, fg, statics: HyperStatics = None):
    """Plain PyTorch version of ``nu4_pass1``."""
    st = hyper_statics(fg) if statics is None else statics
    mats = _mats(st)
    m = [st.m2d[i][None] for i in range(8)]
    wu, wv = _vector_upd(d["U"], d["V"], 1.0, 1.0, m, mats)
    out = {"U": -wu, "V": -wv}
    for k in ("Rt", "Rho", "W"):
        out[k] = _scalar_lap(d[k], m, mats)
    return out


def nu4_pass2_plain(d, work, nu_s, nu_d, nu_v, dt, fg,
                    statics: HyperStatics = None):
    """Plain PyTorch version of ``nu4_pass2``."""
    st = hyper_statics(fg) if statics is None else statics
    mats = _mats(st)
    m = [st.m2d[i][None] for i in range(8)]
    du, dv = _vector_upd(work["U"], work["V"], float(nu_d), float(nu_v), m,
                         mats)
    out = {"U": d["U"] + float(dt) * du, "V": d["V"] + float(dt) * dv}
    for k in ("Rt", "Rho", "W"):
        out[k] = d[k] - float(dt) * float(nu_s) * _scalar_lap(
            work[k], m, mats)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, d, st: HyperStatics, ref=None):
    """Raises on what the kernels do not take; returns (nz, P, A, B)."""
    u = d["U"] if ref is None else ref
    if u.dim() != 4 or u.dtype not in (torch.float32, torch.float64):
        raise ValueError("state fields must be float32/float64 "
                         "(K, P, A, B) tensors")
    nz, P, A, B = u.shape
    for k in FIELDS:
        f = d[k]
        rows = nz + 1 if k == "W" else nz
        if tuple(f.shape) != (rows, P, A, B) or f.dtype != u.dtype \
                or f.device != u.device or not f.is_contiguous():
            raise ValueError(
                f"{name}[{k!r}] must be a contiguous ({rows}, {P}, {A}, "
                f"{B}) tensor of the state's dtype and device")
    p = st.p
    if p > MAX_P or A % p != 0 or B % p != 0:
        raise ValueError(f"panels must hold whole elements of at most "
                         f"{MAX_P} nodes an edge, got A={A} B={B} p={p}")
    if tuple(st.m2d.shape) != (8, P, A, B) or st.m2d.dtype != u.dtype \
            or st.m2d.device != u.device or not st.m2d.is_contiguous():
        raise ValueError("the metric stack must be a contiguous (8, P, A, "
                         "B) tensor of the state's dtype and device")
    if st.ds.numel() != 4 * p * p or st.ds.dtype != u.dtype \
            or st.ds.device != u.device:
        raise ValueError("the element matrices do not match the state")
    return nz, P, A, B


def _launch(name, x, base, scal, st: HyperStatics):
    u = x["U"]
    nz, P, A, B = u.shape
    lib = build.library("hyper")
    fn = lib.nu4_f32 if u.dtype == torch.float32 else lib.nu4_f64
    with torch.cuda.device(u.device):
        outs = [torch.empty_like(x[k]) for k in FIELDS]
        tensors = ([x[k] for k in FIELDS]
                   + [None if base is None else base[k] for k in FIELDS]
                   + [st.m2d, st.ds] + outs)
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if t is None else t.data_ptr() for t in tensors])
        scal = (ctypes.c_double * 4)(*scal)
        ints = (ctypes.c_int * 6)(nz, P, A, B, st.p, int(base is not None))
        err = fn(ptrs, scal, ints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed "
                           f"(cudaGetLastError = {err})")
    launch_counts[name] += 1
    return dict(zip(FIELDS, outs))


def nu4_pass1(d, fg, statics: HyperStatics = None):
    """Work fields ``{-wu, -wv, lap(Rt), lap(Rho), lap(W)}`` with ``(wu,
    wv) = vector_upd(U, V, 1, 1)``; one kernel launch.  Returns fresh
    tensors.  ``statics``: ``hyper_statics(fg)`` (built on the fly when
    absent)."""
    st = hyper_statics(fg) if statics is None else statics
    _check("d", d, st)
    dev = d["U"].device.type
    if dev == "cpu":
        return nu4_pass1_plain(d, fg, st)
    if dev != "cuda":
        raise ValueError(f"unsupported device {d['U'].device}")
    return _launch("nu4_pass1", d, None, (1.0, 1.0, 0.0, 0.0), st)


def nu4_pass2(d, work, nu_s, nu_d, nu_v, dt, fg,
              statics: HyperStatics = None):
    """``U + dt * du``, ``V + dt * dv`` with ``(du, dv) = vector_upd(wU, wV,
    nu_d, nu_v)`` and ``X - dt * nu_s * lap(wX)`` for Rt, Rho, W, where
    ``w*`` are the DSSed work fields; one kernel launch.  Returns fresh
    tensors: ``d`` is not written."""
    st = hyper_statics(fg) if statics is None else statics
    _check("d", d, st)
    _check("work", work, st, ref=d["U"])
    dev = d["U"].device.type
    if dev == "cpu":
        return nu4_pass2_plain(d, work, nu_s, nu_d, nu_v, dt, fg, st)
    if dev != "cuda":
        raise ValueError(f"unsupported device {d['U'].device}")
    return _launch("nu4_pass2", work, d,
                   (float(nu_d), float(nu_v), float(dt),
                    float(dt) * float(nu_s)), st)
