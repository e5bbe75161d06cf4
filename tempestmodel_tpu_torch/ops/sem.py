"""Spectral-element tensor-product derivative operators.

Counterpart of the JAX package's ``ops/sem.py``; only the strong-form
derivatives that ``models/hyperdiff.curl_and_div`` takes are ported (the
engine has its own element operators, ``fast/engine.hderiv_a``).  Fields
with the element-stacked layout (npanel, A, B, ...) are reshaped to expose
the per-element (p, p) block, and a derivative is a small batched
contraction.

Conventions (matching ``GridGLL::Initialize``, ``GridGLL.cpp:86-183``):
  deriv  D[m, i] = L_m'(x_i) on the unit element [0, 1]
  strong derivative at node i:  (df)_i = sum_s f_s D[s, i] / delta
"""

from __future__ import annotations

import torch


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
    out = torch.einsum("si,Pasb...->Paib...",
                       torch.as_tensor(D, device=f.device), fe)
    return _merge(out) / delta_a


def deriv_b(f, D, nea: int, neb: int, p: int, delta_b: float):
    """Strong-form beta derivative."""
    fe = _split(f, nea, neb, p)
    ft = torch.movedim(fe, 4, -1)            # beta-node axis last
    out = torch.einsum("si,P...s->P...i",
                       torch.as_tensor(D, device=f.device), ft)
    out = torch.movedim(out, -1, 4)
    return _merge(out) / delta_b
