"""Gauss and Gauss-Lobatto quadrature + Lagrange interpolation utilities.

Analog of the reference Tempest numerics substrate
(``src/base/GaussQuadrature.cpp``, ``src/base/GaussLobattoQuadrature.cpp``,
``src/base/PolynomialInterp.cpp``, ``src/base/LegendrePolynomial.cpp``).

All of this runs host-side at model-construction time in float64 numpy — the
results are small static operator matrices that the step function holds
as constant tensors.
"""

from __future__ import annotations

import numpy as np


def legendre(n: int, x: np.ndarray) -> np.ndarray:
    """Evaluate Legendre polynomial P_n at x via the three-term recurrence."""
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.ones_like(x)
    if n == 1:
        return x.copy()
    pm1 = np.ones_like(x)
    p = x.copy()
    for k in range(2, n + 1):
        pm1, p = p, ((2 * k - 1) * x * p - (k - 1) * pm1) / k
    return p


def legendre_deriv(n: int, x: np.ndarray) -> np.ndarray:
    """Evaluate P_n'(x) using the standard recurrence."""
    x = np.asarray(x, dtype=np.float64)
    p = legendre(n, x)
    pm1 = legendre(n - 1, x)
    denom = x * x - 1.0
    # P_n'(x) = n*(x*P_n - P_{n-1})/(x^2-1); safe away from +-1
    return n * (x * p - pm1) / denom


def gauss_lobatto(npts: int, a: float = -1.0, b: float = 1.0):
    """Gauss-Lobatto-Legendre nodes and weights on [a, b].

    Nodes are the endpoints plus the roots of P'_{n-1}; weights are
    w_i = 2 / (n (n-1) P_{n-1}(x_i)^2), scaled to the interval.  Computed by
    Newton iteration from Chebyshev initial guesses in float64.
    """
    n = npts
    if n < 2:
        raise ValueError("Gauss-Lobatto requires at least 2 points")
    # Chebyshev-Gauss-Lobatto initial guess
    x = np.cos(np.pi * np.arange(n, dtype=np.float64) / (n - 1))[::-1].copy()
    for _ in range(100 if n > 2 else 0):
        # Newton on q(x) = (1-x^2) P'_{n-1}(x); interior points only
        xi = x[1:-1]
        dp = legendre_deriv(n - 1, xi)
        p = legendre(n - 1, xi)
        # q = (1-x^2) P'_{n-1};  q' = -2x P' + (1-x^2) P''
        # Use Legendre ODE: (1-x^2) P'' = 2x P' - n(n-1) P
        q = (1.0 - xi * xi) * dp
        dq = -2.0 * xi * dp + (2.0 * xi * dp - (n - 1) * n * p)
        step = q / dq
        x[1:-1] = xi - step
        if np.max(np.abs(step)) < 1e-15:
            break
    x[0], x[-1] = -1.0, 1.0
    pn = legendre(n - 1, x)
    w = 2.0 / (n * (n - 1) * pn * pn)
    # Affine map to [a, b]
    xm = 0.5 * (a + b) + 0.5 * (b - a) * x
    wm = 0.5 * (b - a) * w
    return xm, wm


def gauss(npts: int, a: float = -1.0, b: float = 1.0):
    """Gauss-Legendre nodes and weights on [a, b]."""
    x, w = np.polynomial.legendre.leggauss(npts)
    xm = 0.5 * (a + b) + 0.5 * (b - a) * x
    wm = 0.5 * (b - a) * w
    return xm, wm


def lagrange_interp_coeffs(nodes: np.ndarray, x: float) -> np.ndarray:
    """Coefficients c_m with f(x) = sum_m c_m f(nodes_m) (barycentric form).

    Analog of ``PolynomialInterp::LagrangianPolynomialCoeffs``.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    n = len(nodes)
    # normalize to O(1) scale: interpolation coefficients are invariant
    # under affine maps, and the raw products overflow for large domains
    c0 = nodes.mean()
    s0 = max(np.abs(nodes - c0).max(), 1.0e-300)
    nodes = (nodes - c0) / s0
    x = (x - c0) / s0
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    with np.errstate(over="ignore"):
        prod = np.prod(diff, axis=1)
    # for very large n even normalized products can overflow: log-space
    if not np.isfinite(prod).all() or (prod == 0).any():
        logs = np.log(np.abs(diff))
        np.fill_diagonal(logs, 0.0)
        signs = np.prod(np.sign(diff), axis=1)
        logsum = logs.sum(axis=1)
        logsum -= logsum.min()
        prod = signs * np.exp(logsum)
    bary_w = 1.0 / prod
    dx = x - nodes
    exact = np.isclose(dx, 0.0, atol=1e-14)
    if exact.any():
        c = np.zeros(n)
        c[np.argmax(exact)] = 1.0
        return c
    terms = bary_w / dx
    return terms / terms.sum()


def lagrange_diff_coeffs(nodes: np.ndarray, x: float) -> np.ndarray:
    """Coefficients c_m with f'(x) = sum_m c_m f(nodes_m).

    Analog of ``PolynomialInterp::DiffLagrangianPolynomialCoeffs``.
    Computed exactly from the product-rule expansion of each Lagrange basis
    polynomial derivative (O(n^3), fine for the small n used here).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    n = len(nodes)
    # normalize scale (coefficients scale as 1/s under an affine map)
    c0 = nodes.mean()
    s0 = max(np.abs(nodes - c0).max(), 1.0e-300)
    nodes = (nodes - c0) / s0
    x = (x - c0) / s0
    c = np.zeros(n)
    for m in range(n):
        others = np.delete(np.arange(n), m)
        denom = np.prod(nodes[m] - nodes[others])
        total = 0.0
        for j in others:
            rest = others[others != j]
            total += np.prod(x - nodes[rest])
        c[m] = total / denom
    return c / s0


def derivative_matrix(nodes: np.ndarray) -> np.ndarray:
    """D[m, i] = L_m'(x_i): derivative of Lagrange basis m at node i.

    Matches the reference's ``GridGLL::Initialize`` convention
    (``src/atm/GridGLL.cpp:86-183``): a nodal derivative at node i is
    ``sum_m f[m] * D[m, i]``.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    n = len(nodes)
    D = np.zeros((n, n))
    for i in range(n):
        D[:, i] = lagrange_diff_coeffs(nodes, nodes[i])
    return D


def stiffness_matrix(nodes: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """S[m, i] = D[m, i] * w_i / w_m (reference ``GridGLL.cpp:180``).

    Used for the weak-form (variational) flux divergence:
    ``div_i = -(1/w_i) sum_s w_s flux_s L_i'(x_s) = -sum_s flux_s S[i, s]``
    -- note the transposed application relative to D.
    """
    D = derivative_matrix(nodes)
    w = np.asarray(weights, dtype=np.float64)
    return D * (w[None, :] / w[:, None])


def interpolation_matrix(src_nodes: np.ndarray, dst_points: np.ndarray) -> np.ndarray:
    """M[i, m] such that f(dst_i) = sum_m M[i, m] f(src_m)."""
    dst_points = np.atleast_1d(np.asarray(dst_points, dtype=np.float64))
    return np.stack([lagrange_interp_coeffs(src_nodes, x) for x in dst_points])
