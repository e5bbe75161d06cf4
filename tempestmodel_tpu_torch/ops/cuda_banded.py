"""Batched no-pivot banded LU solve: the CUDA kernel's wrapper and its
plain version.

Counterpart of the JAX package's ``ops/pallas_banded.py``
(``banded_solve_pallas``).  The kernel (``csrc/banded.cu``) runs one thread
per column with the half-bandwidth as a template parameter; see the note
there for its design and its bound on the card.

Layout contract (that of ``models/vertical_banded.banded_solve_t``):
``bands (n, 2q+1, ncol)`` with ``band[i, d] = A[i, i+d-q]``, ``rhs
(n, ncol)``; out-of-range band entries must be zero.

``banded_solve`` launches the kernel for CUDA tensors — or raises — and
runs the plain version only for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..kernels.counts import launch_counts
from ..models.vertical_banded import banded_solve_t

MAX_Q = 8      # the kernel is instantiated for q = 1..8

banded_solve_plain = banded_solve_t


def _check(bands, rhs, q):
    if not isinstance(q, int) or not 1 <= q <= MAX_Q:
        raise ValueError(f"half-bandwidth q={q!r} outside 1..{MAX_Q}")
    if bands.dim() != 3 or rhs.dim() != 2:
        raise ValueError("bands must be (n, 2q+1, ncol) and rhs (n, ncol)")
    n, b, ncol = bands.shape
    if b != 2 * q + 1 or tuple(rhs.shape) != (n, ncol):
        raise ValueError(f"bands {tuple(bands.shape)} / rhs "
                         f"{tuple(rhs.shape)} do not match q={q}")
    if bands.dtype not in (torch.float32, torch.float64) \
            or rhs.dtype != bands.dtype:
        raise TypeError(f"bands {bands.dtype} / rhs {rhs.dtype}: both must "
                        f"be float32 or both float64")
    if rhs.device != bands.device:
        raise ValueError(f"bands on {bands.device}, rhs on {rhs.device}")
    if not (bands.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("bands and rhs must be contiguous")


def banded_solve(bands, rhs, q: int):
    """Solve ``A x = rhs`` for every column; returns ``x (n, ncol)``."""
    _check(bands, rhs, q)
    if bands.device.type == "cpu":
        return banded_solve_plain(bands, rhs, q)
    if bands.device.type != "cuda":
        raise ValueError(f"unsupported device {bands.device}")
    return _banded_solve_cuda(bands, rhs, q)


def _banded_solve_cuda(bands, rhs, q):
    n, _, ncol = bands.shape
    lib = build.library("banded")
    fn = lib.banded_solve_f32 if bands.dtype == torch.float32 \
        else lib.banded_solve_f64
    with torch.cuda.device(bands.device):
        x = torch.empty_like(rhs)
        # scratch of the kernel: the U-factor rows and the forward solution
        ufac = torch.empty((n, q + 1, ncol), dtype=bands.dtype,
                           device=bands.device)
        yfwd = torch.empty_like(rhs)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(bands.data_ptr(), rhs.data_ptr(), x.data_ptr(),
                 ufac.data_ptr(), yfwd.data_ptr(), n, ncol, q, stream)
    if err != 0:
        raise RuntimeError(f"banded_solve kernel launch failed "
                           f"(cudaGetLastError = {err})")
    launch_counts["banded_solve"] += 1
    return x
