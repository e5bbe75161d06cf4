"""Tracer transport for the z-first engine.

Counterpart of the JAX package's ``fast/tracers.py``.  Tracers ride the fast
state as ONE flat field ``Tracers`` of shape ``(ntr * nz, 6, A, B)``
(species-major), so the per-stage DSS is a single ``dss_scalar`` launch for
all species and every elementwise update is one pass.

What is here is plain tensor code, as it is in the JAX package: the
advective update of the unfused path (the fused stage kernel advects the
tracers itself, ``fast/stage_cuda``), the assembly of the linear implicit
column update, the two mass-conservative positivity filters and the
Laplacian of the nu4 tail.  The column update ends in the hand-written
multi-right-hand-side banded kernel (``ops/cuda_banded.banded_solve_multi``):
the species of a column share one band matrix, which is eliminated once.

Nothing here reads the device from the host (no ``.item()``, no ``.any()``):
the step must stay capturable into a CUDA graph.  Where the JAX code writes
an einsum, this one writes a matmul on a reshaped view and makes the result
contiguous where a kernel wrapper takes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import np_dtype
from ..models.vertical_banded import banded_solve_multi_t
from ..ops.cuda_banded import banded_solve_multi
from .engine import (FastGeometry, colop, hderiv_a, hderiv_b, hweak_div)


def _ntr(tr, nz):
    if tr.shape[0] % nz != 0:
        raise ValueError(f"a flat tracer field has ntr * nz rows, got "
                         f"{tr.shape[0]} rows for nz={nz}")
    return tr.shape[0] // nz


def _bcast_mul(f, tr, ntr):
    """f (nz, P, A, B) * tr (ntr*nz, P, A, B) without a species-tiled f: a
    5-D broadcast multiply, then a merge of the leading axes back to the flat
    layout (contiguous)."""
    t5 = tr.reshape((ntr,) + tuple(f.shape))
    return (f[None] * t5).reshape(tr.shape)


def horizontal_tendency_tr(ueval, fg: FastGeometry):
    """The advective tendency of the evaluation state's tracers (flat): the
    weak flux divergence of every species on the mass fluxes of the
    evaluation state, over the 3-D Jacobian."""
    u, v = ueval["U"], ueval["V"]
    tr = ueval["Tracers"]
    ntr = _ntr(tr, fg.nz)
    w_n = colop(fg.interp_i2n, ueval["W"])
    con_ua = fg.c2_aa[None] * u + fg.c2_ab[None] * v + fg.con_a_xi * w_n
    con_ub = fg.c2_ba[None] * u + fg.c2_bb[None] * v + fg.con_b_xi * w_n
    fa = _bcast_mul(fg.jac3d * con_ua, tr, ntr)
    fb = _bcast_mul(fg.jac3d * con_ub, tr, ntr)
    return _bcast_mul(1.0 / fg.jac3d, -hweak_div(fa, fb, fg), ntr)


def horizontal_update(base_tr, ueval, dt_s, fg: FastGeometry):
    """base + dt_s * advective tendency of the evaluation state's tracers
    (``horizontal_tendency_tr``).

    ``base_tr``: flat tracer field, or a two-term ((c1, t1), (c2, t2)) RK
    combination (as the fused stage kernel takes its base)."""
    dtr = horizontal_tendency_tr(ueval, fg)
    if isinstance(base_tr, tuple):
        (c1, t1), (c2, t2) = base_tr
        base = c1 * t1 + c2 * t2
    else:
        base = base_tr
    return base + dt_s * dtr


def _flat(f):
    return f.reshape(f.shape[0], -1)


def _host(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t, np.float64)


def _tracer_band_statics(fg: FastGeometry):
    """Static tables of the banded tracer Jacobian (host numpy, float64).

    The tracer system J = I/dt + (1/J_n) D_i2n diag(J_i u^xi) I_n2i - pen is
    BANDED with half-bandwidth q_tr (tridiagonal at vertical order 1): for
    offset o, J[k, k+o] = inv_jac[k] * sum_m S_o[k, m] * (J_i xid)[m]
    - Pl_d[o][k] wl[k] - Pr_d[o][k] wr[k] + [o == 0]/dt with the static
    convolution S_o[k, m] = D_i2n[k, m] * I_n2i[m, k+o].
    Returns ``{"q": q_tr, "S": {o: (nz, nz+1)}, "Pl_d": {o: (nz,)},
    "Pr_d": {o: (nz,)}}``."""
    nz = fg.nz
    D = _host(fg.diff_i2n)                        # (nz, nz+1)
    I = _host(fg.interp_n2i)                      # (nz+1, nz)
    Pl = (_host(fg.penalty_left) if fg.penalty_left is not None
          else np.zeros((nz, nz)))
    Pr = (_host(fg.penalty_right) if fg.penalty_right is not None
          else np.zeros((nz, nz)))
    dense_struct = (np.abs(D) @ np.abs(I)) + np.abs(Pl) + np.abs(Pr)
    kk, ll = np.nonzero(dense_struct)
    q_tr = int(np.abs(kk - ll).max()) if kk.size else 0
    S, Pl_d, Pr_d = {}, {}, {}
    for o in range(-q_tr, q_tr + 1):
        So = np.zeros((nz, nz + 1))
        pl = np.zeros(nz)
        pr = np.zeros(nz)
        k = np.arange(max(0, -o), min(nz, nz - o))     # rows with 0 <= k+o < nz
        So[k] = D[k] * I[:, k + o].T
        pl[k] = Pl[k, k + o]
        pr[k] = Pr[k, k + o]
        S[o], Pl_d[o], Pr_d[o] = So, pl, pr
    return {"q": q_tr, "S": S, "Pl_d": Pl_d, "Pr_d": Pr_d}


@dataclasses.dataclass
class TracerStatics:
    """``_tracer_band_statics`` on the device, stacked over the 2q+1 band
    slots, plus the interior-interface mask (``tracer_statics``)."""
    q: int
    S: Any          # (nz * (2q+1), nz+1): row k * (2q+1) + d is S_{d-q}[k]
    Pl_d: Any       # (nz, 2q+1, 1)
    Pr_d: Any
    mask: Any       # (nz+1, 1): 0 on the bottom and top interfaces, else 1


def tracer_statics(fg: FastGeometry) -> TracerStatics:
    """The column update's static tensors in the dtype and on the device of
    ``fg``; built once per step function."""
    st = _tracer_band_statics(fg)
    q, nz = st["q"], fg.nz
    dtype, dev = fg.inv_mult.dtype, fg.inv_mult.device
    offs = range(-q, q + 1)

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np_dtype(dtype)),
                               device=dev)

    mask = np.ones((nz + 1, 1))
    mask[0] = mask[-1] = 0.0
    return TracerStatics(
        q=q,
        S=dev_t(np.stack([st["S"][o] for o in offs], axis=1).reshape(
            nz * (2 * q + 1), nz + 1)),
        Pl_d=dev_t(np.stack([st["Pl_d"][o] for o in offs], axis=1)[..., None]),
        Pr_d=dev_t(np.stack([st["Pr_d"][o] for o in offs], axis=1)[..., None]),
        mask=dev_t(mask))


def update_column_tracers(d, w_new, fg: FastGeometry, dt,
                          statics: TracerStatics = None,
                          plain: bool = False):
    """Linear implicit vertical tracer update with one factorization per
    column shared by all species: the right-hand sides are stacked on a
    species axis and solved by ONE multi-right-hand-side banded kernel
    (``ops/cuda_banded.banded_solve_multi``).

    ``d``: the state before the implicit solve (its W gives the penalty
    weights); ``w_new``: the W after it (it gives the Jacobian and the
    flux).  ``statics``: ``tracer_statics(fg)`` (built on the fly when
    absent).  ``plain=True`` solves with the kernel's plain version whatever
    the device (a check of the kernel path, not a fallback)."""
    nz = fg.nz
    tr = d["Tracers"]
    ntr = _ntr(tr, nz)
    Q = tr[0].numel()
    if statics is None:
        statics = tracer_statics(fg)
    q_tr, mask = statics.q, statics.mask
    if q_tr < 1:
        raise NotImplementedError("a diagonal tracer system (one level) has "
                                  "no banded solve")
    nb = 2 * q_tr + 1

    u_i = fg.interp_n2i @ _flat(d["U"])
    v_i = fg.interp_n2i @ _flat(d["V"])
    cxx_i = _flat(fg.con_xi_xi_int)
    adv = _flat(fg.con_a_xi_int) * u_i + _flat(fg.con_b_xi_int) * v_i
    xid0 = (adv + cxx_i * _flat(d["W"])) * mask
    xid_new = (adv + cxx_i * _flat(w_new)) * mask

    inv_jac = 1.0 / _flat(fg.jac3d)
    jxid = _flat(fg.jac3d_int) * xid_new          # (nz+1, Q)

    vo = fg.vo
    has_pen = nz // vo > 1 and fg.penalty_left is not None
    if has_pen:
        wb = torch.abs(xid0[vo:nz:vo])
        wl = fg.wscat_left @ wb                   # (nz, Q)
        wr = fg.wscat_right @ wb

    # banded Jacobian (nz, 2q+1, Q): every slot in one matrix product
    bands = (statics.S @ jxid).reshape(nz, nb, Q) * inv_jac[:, None]
    if has_pen:
        bands = bands - (statics.Pl_d * wl[:, None] + statics.Pr_d * wr[:, None])
    bands[:, q_tr] += 1.0 / dt                    # a fresh tensor, in place

    # right-hand sides, species axis in the middle: (nz, ntr, Q)
    tr_f = tr.reshape(ntr, nz, Q)
    mf = jxid[None] * torch.matmul(fg.interp_n2i, tr_f) * mask[None]
    F = torch.matmul(fg.diff_i2n, mf).transpose(0, 1) * inv_jac[:, None]
    if has_pen:
        F = F - (torch.matmul(fg.penalty_left, tr_f).transpose(0, 1)
                 * wl[:, None]
                 + torch.matmul(fg.penalty_right, tr_f).transpose(0, 1)
                 * wr[:, None])

    solve = banded_solve_multi_t if plain else banded_solve_multi
    sol = solve(bands.contiguous(), F.contiguous(), q_tr)
    return (tr_f - sol.transpose(0, 1)).contiguous().reshape(tr.shape)


def _rescale_positive(t, area, dims):
    """Clip to the positive part and rescale it so that the area-weighted
    sum over ``dims`` is kept; a group without positive mass becomes zero."""
    total = torch.sum(t * area, dim=dims, keepdim=True)
    pos = torch.clamp_min(t, 0.0)
    pos_mass = torch.sum(pos * area, dim=dims, keepdim=True)
    ratio = torch.where(pos_mass > 0.0, total / pos_mass,
                        torch.zeros_like(total))
    return pos * torch.clamp_min(ratio, 0.0)


def filter_column(tr, fg: FastGeometry):
    """Mass-conservative column positivity filter (z-first)."""
    nz = fg.nz
    ntr = _ntr(tr, nz)
    t4 = tr.reshape((ntr, nz) + tuple(tr.shape[1:]))
    return _rescale_positive(t4, fg.area3d[None], 1).reshape(tr.shape)


def filter_horizontal(tr, fg: FastGeometry):
    """Per-element horizontal positivity filter (z-first)."""
    ne_a = fg.A // fg.p
    ne_b = fg.B // fg.p
    ntr = _ntr(tr, fg.nz)
    shape = (fg.nz, fg.npanels, ne_a, fg.p, ne_b, fg.p)
    return _rescale_positive(tr.reshape((ntr,) + shape),
                             fg.area3d.reshape((1,) + shape),
                             (4, 6)).reshape(tr.shape)


def scalar_laplacian_tr(tr, fg: FastGeometry):
    """Horizontal Laplacian of the flat tracer field (the nu4 work pass);
    the Jacobian broadcasts over species instead of being tiled."""
    ntr = _ntr(tr, fg.nz)
    da = hderiv_a(tr, fg)
    db = hderiv_b(tr, fg)
    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    ga = _bcast_mul(fg.jac3d, c_aa * da + c_ab * db, ntr)
    gb = _bcast_mul(fg.jac3d, c_ba * da + c_bb * db, ntr)
    return _bcast_mul(1.0 / fg.jac3d, hweak_div(ga, gb, fg), ntr)
