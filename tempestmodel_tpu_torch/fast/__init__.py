"""Fast execution engine for the nonhydrostatic core on one CUDA device.

The z-first re-expression of the Strang-HEVI step.  The state is a DICT of
per-field z-first tensors

    {U, V, Rt, Rho: (nz, 6, A, B), W: (nz+1, 6, A, B)}

on the 6 cubed-sphere panels.  Execution shape:

- **vertical column operators** contract the LEADING level axis — clean
  ``(K, nz) @ (nz, 6*A*B)`` GEMMs, no layout churn;
- **horizontal derivatives** are dense block-diagonal ``(A, A)`` GEMMs over
  the whole field (``engine.horizontal_tendency``, plain tensor code);
- **DSS as hand-written CUDA kernels** (``dss_cuda``): a gather with one
  thread per node, one launch per field (the (U, V) pair in one launch
  with the covariant rotation);
- **the implicit solve** (``implicit``): column aux -> residual -> analytic
  banded Jacobian in plain tensor code, then the hand-written banded LU
  kernel (``ops/cuda_banded``), one thread per column.

The fused stage, nu4 and implicit kernels of the JAX package, tracers,
Cartesian grids and the device-mesh engine are not ported yet.
"""

from .engine import (FastGeometry, build_fast_geometry, pack_state,
                     unpack_state, make_fast_step)
from . import engine
