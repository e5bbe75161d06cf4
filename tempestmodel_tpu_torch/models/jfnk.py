"""Batched Jacobian-free Newton-Krylov for the HEVI column system.

Counterpart of the JAX package's ``models/jfnk.py``, an analog of the
reference's hand-rolled JFNK (``JacobianFreeNewtonKrylov.h:31-120``:
restarted GMRES with Givens rotations and finite-difference directional
derivatives, selected by the ``USE_JFNK_GMRES`` compile flag in
``Defines.h:25-35``).

As in the JAX package:
- every column is solved at once: a vector is ``(n, ncol)``, the column
  axis last, and every dot product and norm is one per column;
- the directional derivative J·v is the caller's: exact (the engine passes
  a band product with the analytic exact Jacobian), or the reference's
  finite-difference probe when none is given;
- the iteration counts are static: Python loops of fixed length over
  tensors, with no value read back to the host, so a step that runs the
  solver can be captured in a CUDA graph.  Where the JAX code masks the
  terms of its fixed-length scans that do nothing (the Gram-Schmidt
  products with basis vectors not yet made, the rotations not yet formed),
  these loops skip them.

The GMRES least-squares problem is solved per column with Givens
rotations applied incrementally to the Hessenberg columns, the reference's
update scheme, vectorized over columns.
"""

from __future__ import annotations

import torch


def _givens(a, b):
    """Batched Givens rotation zeroing b: returns (c, s) with
    c*a + s*b = r, -s*a + c*b = 0.  Safe at a=b=0."""
    r = torch.sqrt(a * a + b * b)
    safe = r > 0.0
    rs = torch.where(safe, r, torch.ones_like(r))
    c = torch.where(safe, a / rs, torch.ones_like(r))
    s = torch.where(safe, b / rs, torch.zeros_like(r))
    return c, s


def gmres_batched(matvec, rhs, m: int, restarts: int = 1):
    """Restarted GMRES(m) on a batch of linear systems.

    ``matvec``: (n, ncol) -> (n, ncol), applying each column's matrix to
    its own vector;  ``rhs``: (n, ncol).  Returns x ≈ A^-1 rhs.

    All reductions (dot products, norms) are per column (over axis 0).
    """
    eps = 1e-300 if rhs.dtype == torch.float64 else 1e-30

    def cycle(x0):
        r = rhs - matvec(x0)
        beta = torch.sqrt(torch.sum(r * r, dim=0))          # (ncol,)
        V = [r / (beta + eps)]
        Hcols = []                 # column j of H: (m+1, ncol)
        cs, sn = [], []
        g = [beta] + [torch.zeros_like(beta)] * m
        for j in range(m):
            w = matvec(V[j])
            # modified Gram-Schmidt against the basis made so far
            hcol = [None] * (m + 1)
            for i in range(j + 1):
                h = torch.linalg.vecdot(w, V[i], dim=0)
                w = torch.addcmul(w, h[None, :], V[i], value=-1.0)
                hcol[i] = h
            hlast = torch.sqrt(torch.sum(w * w, dim=0))
            V.append(w / (hlast + eps))
            hcol[j + 1] = hlast
            for i in range(j + 2, m + 1):
                hcol[i] = torch.zeros_like(hlast)
            # apply the accumulated Givens rotations to this column
            for i in range(j):
                hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hi1 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i], hcol[i + 1] = hi, hi1
            c, s = _givens(hcol[j], hcol[j + 1])
            hcol[j] = c * hcol[j] + s * hcol[j + 1]
            hcol[j + 1] = torch.zeros_like(hlast)
            cs.append(c)
            sn.append(s)
            gj = g[j]
            g[j] = c * gj
            g[j + 1] = -s * gj
            Hcols.append(hcol)

        # back-substitute the m x m triangular system per column
        y = [None] * m
        for j in range(m - 1, -1, -1):
            acc = g[j]
            for k in range(j + 1, m):
                acc = acc - Hcols[k][j] * y[k]
            hjj = Hcols[j][j]
            y[j] = acc / torch.where(torch.abs(hjj) > 0, hjj,
                                     torch.ones_like(hjj))
        x = x0
        for k in range(m):
            x = x + V[k] * y[k][None, :]
        return x

    x = torch.zeros_like(rhs)
    for _ in range(restarts):
        x = cycle(x)
    return x


def jfnk_newton_update(batched_resid, x0, jv=None, m: int = 48,
                       restarts: int = 2, fd_eps: float = 1e-7, f0=None):
    """One Newton step x0 - J^-1 F(x0) via batched GMRES.

    ``batched_resid``: (n, ncol) -> (n, ncol) (None when ``jv`` and
    ``f0`` are given);  ``x0``: (n, ncol), the column axis last.  ``jv``: exact directional derivative, (n, ncol)
    tangent -> (n, ncol); if None, the reference's finite-difference probe
    (``JacobianFreeNewtonKrylov.h:95-110``): J·v ≈ (F(x + e v) - F(x)) / e
    with e scaled per column.  ``f0``: F(x0) when the caller has it.

    The column systems are stiff and unpreconditioned; accuracy depends on
    m against the column size n = 3 nz + 1.  The JAX package measured at
    nz = 24 (n = 73): m = 48, restarts = 2 reaches roundoff against the
    dense solve; m = 32 leaves ~1e-4 relative error in W.
    """
    if f0 is None:
        f0 = batched_resid(x0)

    if jv is None:
        xnorm = torch.sqrt(torch.sum(x0 * x0, dim=0, keepdim=True))

        def jv(t):
            vnorm = torch.sqrt(torch.sum(t * t, dim=0, keepdim=True))
            e = fd_eps * (1.0 + xnorm) / (vnorm + 1e-300)
            return (batched_resid(x0 + e * t) - f0) / e

    return x0 - gmres_batched(jv, f0, m=m, restarts=restarts)
