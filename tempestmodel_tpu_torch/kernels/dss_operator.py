"""The DSS as one sparse matrix: the library yardstick of the DSS kernels.

DSS is linear.  On a field viewed as (nodes, levels), the scalar DSS is one
sparse (n, n) operator S = diag(inv_mult) (Pp + E Pp), n = P A B: Pp sums
every node with its element-boundary copies in its panel (along a, along b
and the diagonal one; the periodic wrap on a Cartesian grid), E adds the
neighbour panel's node at each panel-edge node along the link list.  The
covariant pair (U, V) stacked as (2 n, levels) takes the (2 n, 2 n) operator
whose off-diagonal and edge blocks carry the links' 2x2 rotations.  One
``torch.sparse.mm`` with such a CSR matrix computes what ``dss_scalar`` /
``dss_vector`` compute; ``chip_smoke.py`` times that call beside the kernels
(``library_ms``).  The port never calls it; nothing on the model's path
imports this module.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from ..grid.geometry import EDGE_LEFT, EDGE_RIGHT, EDGE_BOTTOM


def _partner(idx, n, p, wrap):
    """The element-boundary partner of each index along an axis of n nodes
    (-1: none)."""
    r = idx % p
    out = np.full(idx.shape, -1)
    hi = (r == p - 1) & (idx < n - 1)
    lo = (r == 0) & (idx > 0)
    out[hi] = idx[hi] + 1
    out[lo] = idx[lo] - 1
    if wrap:
        out[idx == 0] = n - 1
        out[idx == n - 1] = 0
    return out


def _coo(rows, cols, vals, n, m):
    return torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([rows, cols])),
        torch.as_tensor(vals, dtype=torch.float64), (n, m),
        check_invariants=True).coalesce()


def _pair_matrix(P, A, B, p, wrap):
    pa, a, b = (x.ravel() for x in np.meshgrid(
        np.arange(P), np.arange(A), np.arange(B), indexing="ij"))
    node = (pa * A + a) * B + b
    a2 = _partner(a, A, p, wrap[0])
    b2 = _partner(b, B, p, wrap[1])
    rows, cols = [node], [node]
    for ok, aa, bb in ((a2 >= 0, a2, b), (b2 >= 0, a, b2),
                       ((a2 >= 0) & (b2 >= 0), a2, b2)):
        rows.append(node[ok])
        cols.append(((pa * A + aa) * B + bb)[ok])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    n = P * A * B
    return _coo(rows, cols, np.ones(rows.shape), n, n)


def _edge_nodes(panel, edge, pos, A, B):
    if edge == EDGE_LEFT:
        a, b = np.zeros_like(pos), pos
    elif edge == EDGE_RIGHT:
        a, b = np.full_like(pos, A - 1), pos
    elif edge == EDGE_BOTTOM:
        a, b = pos, np.zeros_like(pos)
    else:
        a, b = pos, np.full_like(pos, B - 1)
    return (panel * A + a) * B + b


def _edge_matrix(links, P, A, B, weight=None):
    """E (weighted per link and destination position by ``weight``, a
    (nlinks, A) array, or 1)."""
    rows, cols, vals = [], [], []
    pos = np.arange(A)
    for i, (pa, e, qa, qe, flip) in enumerate(links):
        rows.append(_edge_nodes(pa, e, pos, A, B))
        cols.append(_edge_nodes(qa, qe, pos[::-1] if flip else pos, A, B))
        vals.append(np.ones(A) if weight is None else weight[i])
    n = P * A * B
    if not rows:
        return _coo(np.zeros(0, int), np.zeros(0, int), np.zeros(0), n, n)
    return _coo(np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals), n, n)


def _scaled(m, w):
    """diag(w) m for a coalesced COO matrix."""
    i = m.indices()
    return torch.sparse_coo_tensor(i, m.values() * w[i[0]], m.shape,
                                   check_invariants=True)


def _quiet(fn):
    """``fn`` without PyTorch's warning that its sparse CSR support is in
    beta (this is a yardstick, not part of the port)."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return fn(*args, **kw)
    return wrapped


def _csr(m, like):
    """``m`` as a CSR matrix on the device and in the dtype of ``like``."""
    return m.to_sparse_csr().to(device=like.device, dtype=like.dtype)


@_quiet
def scalar_operator(imult, links, p: int, wrap=(False, False)):
    """The (n, n) CSR operator of ``dss_scalar`` on the device and in the
    dtype of ``imult`` ((P, A, B))."""
    P, A, B = imult.shape
    pp = _pair_matrix(P, A, B, p, wrap)
    c = (pp + torch.sparse.mm(_edge_matrix(links, P, A, B), pp)).coalesce()
    w = imult.detach().cpu().double().reshape(-1)
    return _csr(_scaled(c, w).coalesce(), imult)


@_quiet
def vector_operator(imult, rot, links, p: int, wrap=(False, False)):
    """The (2 n, 2 n) CSR operator of ``dss_vector`` on (U, V) stacked along
    the nodes; ``rot`` (4, nlinks, A) as the kernels take it."""
    P, A, B = imult.shape
    n = P * A * B
    pp = _pair_matrix(P, A, B, p, wrap)
    r = rot.detach().cpu().double().numpy()
    blocks = []
    for c in range(4):
        ep = torch.sparse.mm(_edge_matrix(links, P, A, B, r[c]), pp)
        blocks.append((ep + pp).coalesce() if c in (0, 3) else ep.coalesce())
    w = imult.detach().cpu().double().reshape(-1)
    rows, cols, vals = [], [], []
    for c, m in enumerate(blocks):
        m = _scaled(m, w).coalesce()
        i = m.indices()
        rows.append(i[0] + n * (c // 2))
        cols.append(i[1] + n * (c % 2))
        vals.append(m.values())
    op = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (2 * n, 2 * n), check_invariants=True).coalesce()
    return _csr(op, imult)


@_quiet
def apply(op, x):
    """``op`` on the (K, ...) field ``x`` viewed as (nodes, levels): one
    ``torch.sparse.mm``; returns the (nodes, K) result."""
    return torch.sparse.mm(op, x.reshape(x.shape[0], -1).t())
