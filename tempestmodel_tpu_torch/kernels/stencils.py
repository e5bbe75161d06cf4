"""Operator tables for the fused kernels: the vertical operators as
fixed-width stencil tables, and the element-local horizontal matrices.

At vertical order 1 every column operator (interpolation, derivative,
penalty, ...) has two or three diagonals.  The fused CUDA kernels apply
them as short stencils whose WINDOW is fixed at compile time — a thread
then knows which neighbouring levels it touches — while the COEFFICIENTS
come from a table built here from the operator matrices.  A matrix with a
nonzero outside its window cannot be packed: ``pack`` returns ``None`` and
the caller's predicate sends that configuration to the unfused path.

Host-side numpy only (``element_matrices`` reads four small blocks of the
geometry's tensors).
"""

from __future__ import annotations

import numpy as np


def extract_diags(M, max_offsets: int = 6):
    """Diagonal representation of an operator matrix:
    ``[(offset, value_vector (rows,))]`` with ``vec[r] = M[r, r + offset]``
    (zero where the column is out of range), or ``None`` if ``M`` has more
    than ``max_offsets`` nonzero diagonals."""
    M = np.asarray(M, np.float64)
    R, C = M.shape
    rr, cc = np.nonzero(M)
    offs = sorted(set(int(c) - int(r) for r, c in zip(rr, cc)))
    if len(offs) > max_offsets:
        return None
    out = []
    for o in offs:
        vec = np.zeros(R)
        r = np.arange(max(0, -o), min(R, C - o))
        vec[r] = M[r, r + o]
        out.append((o, vec))
    return out


def pack(layout, diags, nrows: int):
    """One ``(nrows, width)`` float64 table from per-operator diagonals.

    ``layout``: ``[(name, offsets)]`` — the columns of operator ``name`` hold
    its diagonals at ``offsets``, in that order; ``diags``: ``{name:
    [(offset, vec)]}`` (vectors shorter than ``nrows`` are zero-padded).
    Returns the table, or ``None`` if a diagonal lies outside its
    operator's offsets."""
    width = sum(len(offs) for _, offs in layout)
    table = np.zeros((nrows, width))
    col = 0
    for name, offs in layout:
        for o, vec in diags[name]:
            if not np.any(vec):
                continue
            if o not in offs:
                return None
            table[:len(vec), col + offs.index(o)] = vec
        col += len(offs)
    return table


def element_matrices(fg):
    """``(Da, Sa, Db, Sb)``, float64 ``(p, p)`` arrays: the strong derivative
    ``D[s, i] / delta`` and the stiffness ``S[i, s] / delta`` of one element
    along a and along b, taken from the first diagonal block of the
    geometry's block-diagonal operators ``DA``, ``Sd``, ``DA_b``, ``Sd_b``
    (their values are those of ``D / delta`` in the geometry's dtype).  The
    element widths along a and b are equal on the cubed sphere and differ on
    a Cartesian grid."""
    p = fg.p

    def block(M):
        return np.asarray(M[:p, :p].detach().cpu().numpy(), np.float64)

    return block(fg.DA).T, block(fg.Sd), block(fg.DA_b).T, block(fg.Sd_b)
