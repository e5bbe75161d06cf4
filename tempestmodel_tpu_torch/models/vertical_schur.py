"""Schur-complement vertical implicit solve.

Counterpart of the JAX package's ``models/vertical_schur.py``, an analog
of the reference's ``VerticalDynamicsSchur`` (``--vmethod SCHUR``,
``VerticalDynamicsSchur.cpp:1395-1770``): the W unknowns are eliminated
through the DIAGONAL of the W-W Jacobian block (the reference divides by
``dDG[MatFIx(FWIx,i,FWIx,i)]`` only, ``:1640-1660``: the off-diagonal W-W
couplings are dropped by construction), which leaves a 2-variable
(Rt_k, Rho_k)-interleaved banded Schur system of size 2 nz, solved with
the batched no-pivot banded LU of the full system; then W is
back-substituted.  With the W-W off-diagonals dropped the step is a
quasi-Newton update: it converges to the exact-Jacobian solution with
Newton iterations, as the reference's does.

The inputs are this package's: the exact banded Jacobian of the column
system in the interleaved row order (``fast/implicit.assemble_bands``,
``(n, 2q+1, ncol)``) and the residual per variable, each ``(rows, ncol)``
with the column axis last.  The index tables that cut the per-variable
sub-bands out of the full bands are built once per configuration on the
host (``schur_statics``) and live on the device, so a step reads nothing
from the host and can be captured in a CUDA graph.  The reduced system's
solve is a caller's argument: ``ops/cuda_banded.banded_solve`` (the
hand-written kernel; its wide form at the reduced half-bandwidth
``4 vo + 5``, 9 at vertical order 1) or its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .vertical_banded import interleave_perm

VARS = ("rt", "w", "rho")


def _subblock_maps(nz: int, q: int, qlev: int):
    """Host-side index maps from full interleaved bands to per-variable
    sub-bands in level space.

    Full bands: (n, 2q+1, ncol) interleaved (Rt_k, W_k, Rho_k).
    Sub-band J_ab: (rows_a, 2qlev+1) with J_ab[k, d] = J[a_k, b_{k+d-qlev}].
    Returns {(a, b): (row_idx, diag_idx, valid)} arrays shaped
    (rows_a, 2qlev+1).
    """
    perm = interleave_perm(nz)              # block -> interleaved position
    pos = np.argsort(perm)                  # block index -> interleaved row
    blocks = {"rt": np.arange(nz), "w": np.arange(nz, 2 * nz + 1),
              "rho": np.arange(2 * nz + 1, 3 * nz + 1)}
    maps = {}
    for a, arows in blocks.items():
        for b, bcols in blocks.items():
            nb = len(bcols)
            k = np.arange(len(arows))[:, None]
            d = np.arange(2 * qlev + 1)[None, :]
            l = k + d - qlev
            valid = (l >= 0) & (l < nb)
            lc = np.clip(l, 0, nb - 1)
            ri = pos[arows][:, None] * np.ones_like(d)      # interleaved row
            ci = pos[bcols[lc]]                             # interleaved col
            off = ci - ri + q
            inband = valid & (off >= 0) & (off <= 2 * q)
            maps[(a, b)] = (ri.astype(np.int64),
                            np.clip(off, 0, 2 * q).astype(np.int64),
                            inband)
    return maps


@dataclasses.dataclass
class SchurStatics:
    """The sub-band index tables of ``_subblock_maps`` as device tensors
    (built once per configuration, ``schur_statics``)."""
    nz: int
    q: int
    vo: int
    qlev: int
    maps: Any      # {(a, b): (row_idx, diag_idx, valid mask in the dtype)}


def schur_statics(nz: int, q: int, vo: int, dtype, device) -> SchurStatics:
    """``_subblock_maps(nz, q, vo + 1)`` on ``device``, the masks in
    ``dtype``."""
    qlev = vo + 1
    maps = {}
    for key, (ri, off, ok) in _subblock_maps(nz, q, qlev).items():
        maps[key] = (torch.as_tensor(ri, device=device),
                     torch.as_tensor(off, device=device),
                     torch.as_tensor(ok, dtype=dtype, device=device))
    return SchurStatics(nz=nz, q=q, vo=vo, qlev=qlev, maps=maps)


def _extract_sub(bands, mp):
    """(rows_a, 2qlev+1, ncol) sub-band from full (n, 2q+1, ncol) bands."""
    ri, off, ok = mp
    return bands[ri, off] * ok[..., None]


def _band_matvec(sub, x, qlev):
    """y[k] = sum_d sub[k, d] * x[k + d - qlev] (x: (rows_b, ncol))."""
    rows = sub.shape[0]
    nb = x.shape[0]
    out = sub.new_zeros((rows, sub.shape[2]))
    for d in range(sub.shape[1]):
        s = d - qlev
        lo, hi = max(0, -s), min(rows, nb - s)
        if lo < hi:
            out[lo:hi] += sub[lo:hi, d] * x[lo + s:hi + s]
    return out


def _band_product(A, B, qa, qb, rows_b, rows_out):
    """Banded product C = A @ B in level space.

    A: (rows_out, 2qa+1, ncol) mapping rows_b-space -> rows_out-space;
    B: (rows_b, 2qb+1, ncol) mapping cols-space -> rows_b-space.
    Returns C: (rows_out, 2(qa+qb)+1, ncol).
    """
    qc = qa + qb
    C = A.new_zeros((rows_out, 2 * qc + 1, A.shape[2]))
    for da in range(2 * qa + 1):
        sa = da - qa
        for db in range(2 * qb + 1):
            sb = db - qb
            dc = sa + sb + qc
            # C[k, dc] += A[k, da] * B[k+sa, db]; m = k+sa within rows_b
            lo, hi = max(0, -sa), min(rows_out, rows_b - sa)
            if lo < hi:
                C[lo:hi, dc] += A[lo:hi, da] * B[lo + sa:hi + sa, db]
    return C


def schur_newton_update(f_parts, bands, st: SchurStatics, solve):
    """The quasi-Newton increment ``(d_rt, d_w, d_rho)`` of one step by
    Schur elimination of W (the new iterate is x - dx).

    ``f_parts``: the residual ``(f_rt, f_w, f_rho)``, each ``(rows,
    ncol)``; ``bands``: the exact Jacobian ``(n, 2q+1, ncol)`` in the
    interleaved row order at ``st.q``; ``solve(bands, rhs, q)``: the banded
    solve of the reduced ``(2 nz, 2 qs + 1, ncol)`` system, ``qs = 4 qlev
    + 1``.
    """
    nz, qlev = st.nz, st.qlev
    b_rt, b_w, b_rho = f_parts
    ncol = b_rt.shape[1]
    sub = {k: _extract_sub(bands, mp) for k, mp in st.maps.items()}

    d_w = sub[("w", "w")][:, qlev]                      # (nz+1, ncol) diag
    inv_dw = 1.0 / d_w

    # Schur sub-bands: S_ab = J_ab - J_aw D^-1 J_wb
    qc = 2 * qlev
    S = {}
    for a in ("rt", "rho"):
        for b in ("rt", "rho"):
            # scale J_wb rows by 1/D before the product
            Jwb = sub[("w", b)] * inv_dw[:, None, :]
            prod = _band_product(sub[(a, "w")], Jwb, qlev, qlev, nz + 1, nz)
            # embed J_ab (2qlev+1) into the wider (2qc+1) band
            base = b_rt.new_zeros((nz, 2 * qc + 1, ncol))
            base[:, qc - qlev:qc + qlev + 1] = sub[(a, b)]
            S[(a, b)] = base - prod

    # rhs_schur = b_a - J_aw D^-1 b_w
    dwbw = inv_dw * b_w
    r_rt = b_rt - _band_matvec(sub[("rt", "w")], dwbw, qlev)
    r_rho = b_rho - _band_matvec(sub[("rho", "w")], dwbw, qlev)

    # the 2-variable interleaved banded system (Rt_k, Rho_k): row 2k + ai,
    # column 2(k + s) + bi at band offset 2 s + (bi - ai) + qs; the rows of
    # one (a, b, s) are every other row from 2 k0 + ai
    qs = 2 * qc + 1
    n2 = 2 * nz
    bands_s = b_rt.new_zeros((n2, 2 * qs + 1, ncol))
    for ai, a in enumerate(("rt", "rho")):
        for bi, b in enumerate(("rt", "rho")):
            for d in range(2 * qc + 1):
                s_lev = d - qc
                off = 2 * s_lev + (bi - ai) + qs
                k0, k1 = max(0, -s_lev), min(nz, nz - s_lev)
                if k0 < k1:
                    bands_s[2 * k0 + ai:2 * k1 + ai:2, off] = \
                        S[(a, b)][k0:k1, d]
    rhs_s = torch.stack([r_rt, r_rho], dim=1).reshape(n2, ncol)

    sol = solve(bands_s.contiguous(), rhs_s, qs)        # (2nz, ncol)
    dx_rt, dx_rho = sol[0::2], sol[1::2]

    # back out W: dx_w = D^-1 (b_w - J_w,rt dx_rt - J_w,rho dx_rho)
    dx_w = inv_dw * (b_w
                     - _band_matvec(sub[("w", "rt")], dx_rt, qlev)
                     - _band_matvec(sub[("w", "rho")], dx_rho, qlev))
    return dx_rt, dx_w, dx_rho
