"""Spectral-element tensor-product derivative operators.

Counterpart of the JAX package's ``ops/sem.py`` (the z-first engine has
its own element operators, ``fast/engine.hderiv_a``).  Fields with the
element-stacked layout (npanel, A, B, ...) are reshaped to expose the
per-element (p, p) block, and a derivative is a small batched contraction;
the dense forms contract against one block-diagonal (A, A) operator
instead.  The element matrices may be numpy arrays or tensors of the
field's dtype.

Conventions (matching ``GridGLL::Initialize``, ``GridGLL.cpp:86-183``):
  deriv  D[m, i] = L_m'(x_i) on the unit element [0, 1]
  stiff  S[m, i] = D[m, i] * w_i / w_m
  strong derivative at node i:  (df)_i = sum_s f_s D[s, i] / delta
  weak (variational) flux div:  (div f)_i = -sum_s f_s S[i, s] / delta

Grids may be rectangular: nea/neb elements and delta_a/delta_b spacings per
axis (cubed-sphere panels are square; Cartesian planes are not).
"""

from __future__ import annotations

import numpy as np
import torch


def _mat(M, f):
    """The element matrix ``M`` as a tensor on ``f``'s device."""
    return torch.as_tensor(M, device=f.device)


def _split(f, nea: int, neb: int, p: int):
    """(P, A, B, ...) -> (P, nea, p, neb, p, ...)."""
    rest = tuple(f.shape[3:])
    return f.reshape(f.shape[0], nea, p, neb, p, *rest)


def _merge(f):
    """(P, nea, p, neb, p, ...) -> (P, A, B, ...)."""
    rest = tuple(f.shape[5:])
    return f.reshape(f.shape[0], f.shape[1] * f.shape[2],
                     f.shape[3] * f.shape[4], *rest)


def deriv_a(f, D, nea: int, neb: int, p: int, delta_a: float):
    """Strong-form alpha derivative of an element-stacked field."""
    fe = _split(f, nea, neb, p)
    out = torch.einsum("si,Pasb...->Paib...", _mat(D, f), fe)
    return _merge(out) / delta_a


def deriv_b(f, D, nea: int, neb: int, p: int, delta_b: float):
    """Strong-form beta derivative."""
    fe = _split(f, nea, neb, p)
    ft = torch.movedim(fe, 4, -1)            # beta-node axis last
    out = torch.einsum("si,P...s->P...i", _mat(D, f), ft)
    out = torch.movedim(out, -1, 4)
    return _merge(out) / delta_b


def deriv_both(f, D, nea: int, neb: int, p: int,
               delta_a: float, delta_b: float):
    """(df/da, df/db) in one call."""
    fe = _split(f, nea, neb, p)
    Dm = _mat(D, f)
    da = torch.einsum("si,Pasb...->Paib...", Dm, fe)
    ft = torch.movedim(fe, 4, -1)
    db = torch.movedim(torch.einsum("si,P...s->P...i", Dm, ft), -1, 4)
    return _merge(da) / delta_a, _merge(db) / delta_b


def weak_div(fa, fb, Smat, nea: int, neb: int, p: int,
             delta_a: float, delta_b: float):
    """Variational flux divergence (positive = divergence).

    Matches the reference's stiffness-matrix update
    (``HorizontalDynamicsFEM.cpp:519-560``) up to overall sign: here
    ``weak_div ~ +div F`` in the weak sense, so tendencies subtract it.
    """
    Sm = _mat(Smat, fa)
    da = torch.einsum("is,Pasb...->Paib...", Sm, _split(fa, nea, neb, p))
    fbt = torch.movedim(_split(fb, nea, neb, p), 4, -1)
    db = torch.movedim(torch.einsum("is,P...s->P...i", Sm, fbt), -1, 4)
    return -(_merge(da) / delta_a + _merge(db) / delta_b)


# ---------------------------------------------------------------------------
# Block-diagonal GEMM formulation: the per-element (p, p) contractions as one
# dense matmul against a block-diagonal (A, A) operator (blocks = the p x p
# element matrix).
# ---------------------------------------------------------------------------

def block_diag_operator(M, ne: int):
    """(A, A) block-diagonal expansion of a (p, p) element operator, as a
    numpy array of ``M``'s dtype."""
    M = np.asarray(M.detach().cpu() if torch.is_tensor(M) else M)
    p = M.shape[0]
    out = np.zeros((ne * p, ne * p), dtype=M.dtype)
    for e in range(ne):
        out[e * p:(e + 1) * p, e * p:(e + 1) * p] = M
    return out


def deriv_a_dense(f, Dfull_a, delta_a: float):
    """Strong alpha derivative via the (A, A) block-diagonal operator.

    ``Dfull_a[s, i] = D[s%p, i%p]`` within diagonal blocks: the derivative
    at node i is sum_s f[s] Dfull[s, i].
    """
    return torch.einsum("si,Psb...->Pib...", _mat(Dfull_a, f), f) / delta_a


def deriv_b_dense(f, Dfull_b, delta_b: float):
    """Strong beta derivative: contract axis 2 against the operator."""
    out = torch.tensordot(f, _mat(Dfull_b, f), dims=([2], [0]))
    # tensordot appends the result axis; restore (P, A, B, ...) order
    return torch.movedim(out, -1, 2) / delta_b


def weak_div_dense(fa, fb, Sfull_a, Sfull_b, delta_a: float, delta_b: float):
    """Variational divergence via block-diagonal stiffness operators."""
    da = torch.einsum("is,Psb...->Pib...", _mat(Sfull_a, fa), fa)
    db = torch.movedim(torch.tensordot(fb, _mat(Sfull_b, fb).T,
                                       dims=([2], [0])), -1, 2)
    return -(da / delta_a + db / delta_b)


def weak_grad_a(f, Smat, nea: int, neb: int, p: int, delta_a: float):
    """-sum_s f_s S[i, s] / delta along alpha (reference dDaDiv loops)."""
    out = torch.einsum("is,Pasb...->Paib...", _mat(Smat, f),
                       _split(f, nea, neb, p))
    return -_merge(out) / delta_a


def weak_grad_b(f, Smat, nea: int, neb: int, p: int, delta_b: float):
    """The same along beta."""
    ft = torch.movedim(_split(f, nea, neb, p), 4, -1)
    out = torch.einsum("is,P...s->P...i", _mat(Smat, f), ft)
    return -torch.movedim(out, -1, 4).reshape(f.shape) / delta_b
