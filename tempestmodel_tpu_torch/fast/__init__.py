"""Fast execution engine for the nonhydrostatic core on one CUDA device.

The z-first re-expression of the Strang-HEVI step.  The state is a DICT of
per-field z-first tensors

    {U, V, Rt, Rho: (nz, P, A, B), W: (nz+1, P, A, B)}

on the P = 6 cubed-sphere panels or the P = 1 panel of a periodic Cartesian
grid (x-z slice or 3-D plane, ``build_fast_geometry_cartesian``), optionally
with ``Tracers``: all species as one flat species-major field ``(ntr * nz, P,
A, B)``.  Execution shape:

- **vertical column operators** contract the LEADING level axis — clean
  ``(K, nz) @ (nz, 6*A*B)`` GEMMs, no layout churn;
- **the explicit stage** as one hand-written CUDA kernel (``stage_cuda``):
  vertical stencils, element-local horizontal derivatives from
  shared-memory tiles, the tendencies, the RK base combination and the axpy;
  on the unfused path the same stage is plain tensor code with dense
  block-diagonal ``(A, A)`` GEMMs (``engine.horizontal_tendency``);
- **DSS as hand-written CUDA kernels** (``dss_cuda``), one launch per
  field: ``dss_scalar``, ``dss_vector`` (the (U, V) pair with the covariant
  rotation), ``dss_uvw`` (on the fused path W joins the pair with the
  stage's W finish folded in) and the one-launch groupings ``dss_scalar2``
  (Rt and Rho) and ``dss_state`` (all five fields, with an optional
  Rayleigh finish) are the five modes of one band kernel, which stages bands
  of whole element rows and the neighbour panels' edge lines in shared
  memory by asynchronous copies and sums there, a thread an element-row
  segment;
- **the implicit solve** (``implicit``): on the fused path each Newton
  iteration is one hand-written kernel (``implicit_cuda``: a tile of
  columns staged in shared memory, the residual and the analytic banded
  Jacobian assembled there level-parallel, then the banded LU one thread a
  column on chip); on the unfused path the residual and the Jacobian are
  plain tensor code and the solve is the hand-written banded LU kernel
  (``ops/cuda_banded.banded_solve``: the band rows stream through a ring
  in shared memory, the U rows stay on chip, no scratch).

- **the nu4 hyperdiffusion tail** as two hand-written kernels
  (``hyper_cuda``), one per Laplacian pass, around the full-state DSS; plain
  tensor code on the unfused path;
- **tracers** (``tracers``): advected inside the stage kernel on the mass
  fluxes that carry Rho, DSSed as one flat field in one ``dss_scalar`` launch,
  updated in the implicit half step by one hand-written
  multi-right-hand-side banded kernel (``ops/cuda_banded``: a tile of
  columns staged in shared memory, one elimination per column for all
  species, the U-factor and the forward solutions kept on chip); their
  Laplacian, the two positivity filters and the assembly of the column
  systems are plain tensor code.

``make_fast_step`` chooses between the two paths by predicates on the
configuration (``fused=False`` forces the unfused one) and runs eagerly;
``make_fast_multistep`` replays K steps as one CUDA graph.
``make_fast_imex_step`` runs the IMEX-ARK family (``IMEX_SCHEMES``, where
``fast_imex_supported`` holds) on the same pieces: the horizontal tendency
as tensor code, the full-state DSS and the implicit kernels a stage, the
nu4 kernels in the tail.  The device-mesh engine is not ported yet.
"""

from .engine import (FastGeometry, build_fast_geometry,
                     build_fast_geometry_cartesian, pack_state, unpack_state,
                     make_fast_step, make_fast_multistep, IMEX_SCHEMES,
                     fast_imex_supported, make_fast_imex_step)
from . import engine
