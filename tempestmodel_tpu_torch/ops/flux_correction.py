"""DG flux-correction (flux reconstruction) derivative weights.

Counterpart of the JAX package's ``ops/flux_correction.py``, an analog of
``FluxCorrectionFunction::GetDerivatives``
(``src/atm/FluxCorrectionFunction.{h,cpp}``): computes the derivative of
the order-``itype`` flux-correction function g(x) on [0, 1] at given nodes.

g is the degree-``order`` polynomial with g(0)=1 and (per the reference's
Vandermonde construction, ``FluxCorrectionFunction.cpp:21-60``):

- its first ``itype`` derivatives vanish at x=1 (right-boundary condition);
- it is L2-orthogonal on [-1, 1] (in the mapped variable 2x-1) to
  polynomials of degree < order - itype.

``ops/column_ops.flux_correction_derivatives`` keeps its own copy, as the
JAX package's ``column_ops`` does.

``itype=2`` recovers the "g2" correction function of Huynh (2007) used for
flux reconstruction schemes; ``itype=3`` the higher-continuity variant.
"""

from __future__ import annotations

import numpy as np


def flux_correction_derivatives(itype: int, order: int, nodes):
    """dg/dx at ``nodes`` in [0, 1] for the order-``order`` correction.

    Mirrors the reference's linear system: unknowns are the coefficients
    b_i of g in the monomial basis of t = 2x - 1 (descending-degree with
    alternating signs absorbed), with rows enforcing g(0)=1, the ``itype``
    derivative conditions at x=1, and order-itype orthogonality moments.
    """
    if itype < 1:
        raise ValueError("itype must be at least 1")
    if order < 1:
        raise ValueError("order must be at least 1")
    n = order
    van = np.zeros((n + 1, n + 1))
    b = np.zeros(n + 1)

    # column 0: g(0) = 1 in the alternating-sign monomial basis
    sign = 1.0
    for i in range(n, -1, -1):
        van[i, 0] = sign
        sign = -sign
    b[0] = 1.0

    # columns 1..itype: g^{(k)}(1) = 0, k = 0..itype-1
    coeff = np.ones(n + 1)
    for k in range(itype):
        van[:, k + 1] = coeff
        new = coeff.copy()
        for i in range(n - k):
            new[i] = (n - k - i) * coeff[i]
        new[n - k:] = 0.0
        coeff = new

    # remaining columns: orthogonality moments on [-1, 1]
    for k in range(n - itype):
        for m in range(n + 1):
            s = n - m + k
            if s % 2 == 0:
                van[m, itype + 1 + k] = 2.0 / (s + 1.0)

    # solve van^T is how the reference feeds DGESV (row-major A with
    # column-major LAPACK means it solves A^T x = b)
    bsol = np.linalg.solve(van.T, b)

    # undo alternating signs, then differentiate the monomial series
    sign = 1.0
    for i in range(n, -1, -1):
        bsol[i] *= sign
        sign = -sign
    for i in range(n):
        bsol[n - i] = (i + 1) * bsol[n - i - 1]
    bsol[0] = 0.0

    nodes = np.asarray(nodes, dtype=np.float64)
    deriv = np.zeros(nodes.shape)
    t = np.ones(nodes.shape)
    for i in range(n):
        deriv += bsol[n - i] * t
        t = t * (2.0 * nodes - 1.0)
    return 2.0 * deriv
