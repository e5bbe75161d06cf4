"""tempestmodel_tpu_torch: the PyTorch/CUDA port of the dynamical core.

The counterpart of the JAX package ``tempestmodel_tpu``, module for module
(same sub-package layout and function names), written for one NVIDIA
Hopper card.  Plain tensor code is PyTorch; the kernels are hand-written
CUDA C++ under ``csrc/``, built at first use by ``kernels/build.py``.

The package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``tempestmodel_tpu``.  Entry points take an explicit
``device`` (default ``cuda``; they raise when it is absent) and there is
no global default device.
"""

import torch as _torch

# A float32 matrix product must be a true float32 multiply-accumulate:
# TF32 keeps ~3 decimal digits, and the spectral-element derivative and
# stiffness products then drift off the float32 trajectory within a few
# steps.  Both switches are pinned off here; every einsum/matmul of the
# package reads them.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import (ModelConfig, EquationSet, GridKind, TimestepSchemeType,
                     ExplicitSubScheme, VerticalStaggering)
from .constants import PhysicalConstants, DEFAULT_CONSTANTS

__version__ = "0.1.0"
