"""Batched no-pivot banded LU solve: the CUDA kernel's wrapper and its
plain version.

Counterpart of the JAX package's ``ops/pallas_banded.py``
(``banded_solve_pallas``, ``banded_solve_multi_pallas``).  The kernels
(``csrc/banded.cu``, ``csrc/banded_multi.cu``) run one thread per column with
the half-bandwidth as a template parameter; see the notes there for their
design and their bounds on the card.

Layout contract (that of ``models/vertical_banded.banded_solve_t``):
``bands (n, 2q+1, ncol)`` with ``band[i, d] = A[i, i+d-q]``, ``rhs
(n, ncol)``; out-of-range band entries must be zero.
``banded_solve_multi`` takes ``rhs (n, R, ncol)``: R right-hand sides that
share the band matrix of their column, eliminated once.

Either wrapper launches its kernel for CUDA tensors — or raises — and runs
the plain version only for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..kernels.counts import launch_counts
from ..models.vertical_banded import banded_solve_t, banded_solve_multi_t

MAX_Q = 8      # the kernel is instantiated for q = 1..8

banded_solve_plain = banded_solve_t
banded_solve_multi_plain = banded_solve_multi_t


def _check(bands, rhs, q, multi=False):
    if not isinstance(q, int) or not 1 <= q <= MAX_Q:
        raise ValueError(f"half-bandwidth q={q!r} outside 1..{MAX_Q}")
    if bands.dim() != 3 or rhs.dim() != (3 if multi else 2):
        raise ValueError("bands must be (n, 2q+1, ncol) and rhs "
                         + ("(n, R, ncol)" if multi else "(n, ncol)"))
    n, b, ncol = bands.shape
    if b != 2 * q + 1 or (rhs.shape[0], rhs.shape[-1]) != (n, ncol) \
            or rhs.shape[1] < 1:
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


def banded_solve_multi(bands, rhs, q: int):
    """Solve ``A x_r = rhs[:, r]`` for every column and each of the R
    right-hand sides of ``rhs (n, R, ncol)``, which share the column's band
    matrix: one kernel launch, one elimination per column.  Returns
    ``x (n, R, ncol)``."""
    _check(bands, rhs, q, multi=True)
    if bands.device.type == "cpu":
        return banded_solve_multi_plain(bands, rhs, q)
    if bands.device.type != "cuda":
        raise ValueError(f"unsupported device {bands.device}")
    return _banded_solve_multi_cuda(bands, rhs, q)


def _banded_solve_multi_cuda(bands, rhs, q, window: bool = True):
    """Launch the kernel.  ``window=False`` forces the form that reads its
    sliding windows back from the output (what any R above 4 or q above 4
    takes anyway); ``kernels/tune_fused.py`` times both."""
    n, R, ncol = rhs.shape
    lib = build.library("banded_multi")
    fn = lib.banded_solve_multi_f32 if bands.dtype == torch.float32 \
        else lib.banded_solve_multi_f64
    with torch.cuda.device(bands.device):
        x = torch.empty_like(rhs)
        # scratch of the kernel: the U-factor rows (the forward solutions
        # are parked in ``x``)
        ufac = torch.empty((n, q + 1, ncol), dtype=bands.dtype,
                           device=bands.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(bands.data_ptr(), rhs.data_ptr(), x.data_ptr(),
                 ufac.data_ptr(), n, R, ncol, q, int(window), stream)
    if err != 0:
        raise RuntimeError(f"banded_solve_multi kernel launch failed "
                           f"(cudaGetLastError = {err})")
    launch_counts["banded_solve_multi"] += 1
    return x
