"""Batched banded solve for the HEVI vertical implicit system: the plain
PyTorch form.

Replacement of the reference's per-column LAPACK ``DGBSV`` path
(``VerticalDynamicsFEM.cpp:1437-1464``, bandwidth table ``:165-200``):

- the column unknowns are permuted to the interleaved ordering
  (Rt_k, W_k, Rho_k per level) under which the Jacobian is banded with
  half-bandwidth q (q = 4 at vertical order 1, matching the reference's
  ``m_nJacobianFOffD``);
- the banded systems are solved by a no-pivot banded LU over rows,
  vectorized across all columns.

All banded tensors keep the huge column axis LAST (contiguous), the
row/diagonal axes major: every row operation is then one coalesced sweep
over columns, for this plain form and for the CUDA kernel
(``ops/cuda_banded``) alike.
"""

from __future__ import annotations

import numpy as np
import torch


def interleave_perm(nz: int) -> np.ndarray:
    """Permutation from block layout [Rt(nz), W(nz+1), Rho(nz)] to
    interleaved [Rt_0, W_0, Rho_0, Rt_1, ..., W_nz]."""
    perm = []
    for k in range(nz + 1):
        if k < nz:
            perm.append(k)                   # Rt_k
        perm.append(nz + k)                  # W_k
        if k < nz:
            perm.append(2 * nz + 1 + k)      # Rho_k
    return np.asarray(perm, dtype=np.int64)


def compute_bandwidth(resid_one, x_sample) -> int:
    """Half-bandwidth q of the interleaved Jacobian (host-side, once).

    ``resid_one``: residual of ONE column, a function of the flat
    unknown vector (a float64 CPU tensor); its dense Jacobian comes from
    reverse-mode autograd."""
    n = x_sample.shape[-1]
    nz = (n - 1) // 3
    perm = interleave_perm(nz)
    J = torch.autograd.functional.jacobian(resid_one, x_sample)
    J = J.detach().cpu().numpy()
    Jp = J[np.ix_(perm, perm)]
    mask = np.abs(Jp) > 1e-30
    ii, jj = np.nonzero(mask)
    return int(max(np.max(ii - jj), np.max(jj - ii)))


def banded_solve_t(bands, rhs, q: int):
    """Solve banded systems A x = rhs for every column (no pivoting).

    ``bands``: (n, 2q+1, ncol) with band[i, d] = A[i, i+d-q];
    ``rhs``: (n, ncol).  Returns (n, ncol).
    The systems carry a strong I/dt diagonal (Newton of backward Euler),
    so pivot-free elimination is stable here.

    A Python loop over the n rows on (2q+1, ncol) slabs: the plain version
    of the kernel in ``ops/cuda_banded``.  Out-of-range band entries must
    be zero (the assembly guarantees it).
    """
    n, b, ncol = bands.shape
    if b != 2 * q + 1 or rhs.shape != (n, ncol):
        raise ValueError(f"bands {tuple(bands.shape)} / rhs "
                         f"{tuple(rhs.shape)} do not match q={q}")
    # last q U-rows, each (q+1, ncol), and last q y values; dummy identity
    # rows stand in before row 0 (their multipliers are zero band entries)
    u_prev = [None] * q
    y_prev = [None] * q
    ident = bands.new_zeros((q + 1, ncol))
    ident[0] = 1.0
    zero = bands.new_zeros((ncol,))
    for t in range(q):
        u_prev[t] = ident
        y_prev[t] = zero

    U = bands.new_empty((n, q + 1, ncol))
    Y = bands.new_empty((n, ncol))
    for i in range(n):
        w = bands[i].clone()                          # (2q+1, ncol)
        y_i = rhs[i]
        for t in range(q):
            f = w[t] / u_prev[t][0]
            w[t + 1:t + q + 1] -= f[None, :] * u_prev[t][1:]   # in place
            y_i = y_i - f * y_prev[t]
        U[i] = w[q:]
        Y[i] = y_i
        u_prev = u_prev[1:] + [U[i]]
        y_prev = y_prev[1:] + [Y[i]]

    X = bands.new_empty((n, ncol))
    x_next = [zero] * q
    for i in range(n - 1, -1, -1):
        acc = Y[i]
        for d in range(q):
            acc = acc - U[i, d + 1] * x_next[d]
        X[i] = acc / U[i, 0]
        x_next = [X[i]] + x_next[:-1]
    return X


def banded_solve_multi_t(bands, rhs, q: int):
    """Shared-matrix multi-RHS banded solve: ``bands`` (n, 2q+1, ncol),
    ``rhs`` (n, R, ncol) -> (n, R, ncol).  One elimination per column, R
    substitutions (the tracer update: every species of a column shares one
    band matrix).  The plain version of the kernel behind
    ``ops/cuda_banded.banded_solve_multi``; same layout contract as
    ``banded_solve_t``."""
    n, b, ncol = bands.shape
    if b != 2 * q + 1 or rhs.dim() != 3 or rhs.shape[0] != n \
            or rhs.shape[2] != ncol:
        raise ValueError(f"bands {tuple(bands.shape)} / rhs "
                         f"{tuple(rhs.shape)} do not match q={q}")
    R = rhs.shape[1]
    ident = bands.new_zeros((q + 1, ncol))
    ident[0] = 1.0
    u_prev = [ident] * q
    y_prev = [bands.new_zeros((R, ncol))] * q

    U = bands.new_empty((n, q + 1, ncol))
    Y = bands.new_empty((n, R, ncol))
    for i in range(n):
        w = bands[i].clone()                          # (2q+1, ncol)
        y_i = rhs[i]                                  # (R, ncol)
        for t in range(q):
            f = w[t] / u_prev[t][0]
            w[t + 1:t + q + 1] -= f[None, :] * u_prev[t][1:]   # in place
            y_i = y_i - f[None, :] * y_prev[t]
        U[i] = w[q:]
        Y[i] = y_i
        u_prev = u_prev[1:] + [U[i]]
        y_prev = y_prev[1:] + [Y[i]]

    X = bands.new_empty((n, R, ncol))
    x_next = [bands.new_zeros((R, ncol))] * q
    for i in range(n - 1, -1, -1):
        acc = Y[i]
        for d in range(q):
            acc = acc - U[i, d + 1][None, :] * x_next[d]
        X[i] = acc / U[i, 0][None, :]
        x_next = [X[i]] + x_next[:-1]
    return X
