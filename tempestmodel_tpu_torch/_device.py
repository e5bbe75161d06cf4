"""Device and dtype helpers shared by the entry points."""

from __future__ import annotations

import numpy as np
import torch

_NP_OF = {torch.float32: np.float32, torch.float64: np.float64}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when a CUDA device is asked for and none is present —
    nothing carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def np_dtype(dtype: torch.dtype):
    """numpy counterpart of a supported torch floating dtype."""
    try:
        return _NP_OF[dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype}; use torch.float32 or "
                        f"torch.float64") from None
