"""1-D grid spacing generators.

Counterpart of the JAX package's ``ops/spacing.py``, on the port's
``ops/quadrature``; an analog of the reference ``GridSpacing`` hierarchy
(``src/atm/GridSpacing.{h,cpp}``): vectorized generators for the node/edge
coordinates and normalized areas of the four spacing families used by the
vertical (and horizontal) discretizations:

- uniform             (``GridSpacingUniform``, GridSpacing.h:27-78)
- Gauss-Lobatto       (``GridSpacingGaussLobatto``: continuous FE — element
                      boundaries shared, node index stride order-1)
- repeated G-Lobatto  (``GridSpacingGaussLobattoRepeated``: discontinuous
                      FE — duplicated element-boundary nodes, stride order)
- mixed G-L / G       (``GridSpacingMixedGaussLobattoAndGauss``: edges at
                      Lobatto points, nodes at Gauss points)

All functions return numpy float64 arrays (host-side precompute, like the
rest of the geometry pipeline).
"""

from __future__ import annotations

import numpy as np

from . import quadrature as quad


def uniform_nodes(n: int, delta: float, zero: float = 0.0):
    """Cell-centered nodes of a uniform spacing (``GetNode``)."""
    return zero + (np.arange(n) + 0.5) * delta


def uniform_edges(n: int, delta: float, zero: float = 0.0):
    """Edges of a uniform spacing (n+1 values)."""
    return zero + np.arange(n + 1) * delta


def uniform_norm_areas(n: int, delta: float):
    return np.full(n, delta)


def gll_nodes(n_elem: int, order: int, delta: float, zero: float = 0.0):
    """Continuous-GLL node coordinates: n_elem*(order-1)+1 unique nodes.

    Element-boundary nodes are shared (stride order-1 per element), as in
    ``GridSpacingGaussLobatto::GetNode``.
    """
    if order < 2:
        raise ValueError("order must be >= 2")
    g, _ = quad.gauss_lobatto(order, 0.0, delta)
    offs = zero + delta * np.arange(n_elem)[:, None]
    pts = (offs + g[None, :-1]).ravel()
    return np.concatenate([pts, [zero + delta * n_elem]])


def gll_norm_areas(n_elem: int, order: int, delta: float):
    """Quadrature weight per unique GLL node (boundary nodes get 2*w0)."""
    _, w = quad.gauss_lobatto(order, 0.0, delta)
    areas = np.tile(w[:-1], n_elem)
    areas = np.concatenate([areas, [w[-1]]])
    # interior element boundaries accumulate both elements' w0
    for e in range(1, n_elem):
        areas[e * (order - 1)] = 2.0 * w[0]
    return areas


def gll_repeated_nodes(n_elem: int, order: int, delta: float,
                       zero: float = 0.0):
    """Discontinuous-GLL nodes: n_elem*order values, boundaries duplicated
    (``GridSpacingGaussLobattoRepeated::GetNode``)."""
    if order < 2:
        raise ValueError("order must be >= 2")
    g, _ = quad.gauss_lobatto(order, 0.0, delta)
    offs = zero + delta * np.arange(n_elem)[:, None]
    return (offs + g[None, :]).ravel()


def gll_repeated_norm_areas(n_elem: int, order: int, delta: float):
    _, w = quad.gauss_lobatto(order, 0.0, delta)
    return np.tile(w, n_elem)


def mixed_gll_gauss_nodes(n_elem: int, order: int, delta: float,
                          zero: float = 0.0):
    """Mixed spacing: nodes at Gauss points, edges at Gauss-Lobatto points
    (``GridSpacingMixedGaussLobattoAndGauss``).

    Returns (nodes, edges): n_elem*(order-1) Gauss nodes and
    n_elem*(order-1)+1 unique Lobatto edges.
    """
    if order < 2:
        raise ValueError("order must be >= 2")
    gn, _ = quad.gauss(order - 1, 0.0, delta)
    offs = zero + delta * np.arange(n_elem)[:, None]
    nodes = (offs + gn[None, :]).ravel()
    edges = gll_nodes(n_elem, order, delta, zero)
    return nodes, edges


def mixed_gll_gauss_norm_areas(n_elem: int, order: int, delta: float):
    """(node_areas, edge_areas) for the mixed spacing."""
    _, wn = quad.gauss(order - 1, 0.0, delta)
    node_areas = np.tile(wn, n_elem)
    edge_areas = gll_norm_areas(n_elem, order, delta)
    return node_areas, edge_areas
