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


class OnDevice:
    """A view of a host object (a geometry) whose numpy arrays come out as
    tensors on one device, each copied at its first read and kept; every
    other attribute passes through.  Functions that take a geometry accept
    the host object or this view alike (``torch.as_tensor`` of a tensor on
    its own device is the tensor)."""

    def __init__(self, obj, device):
        self._obj = obj
        self.device = torch.device(device)
        self._cache = {}

    def __getattr__(self, name):
        value = getattr(self._obj, name)
        if not isinstance(value, np.ndarray):
            return value
        if name not in self._cache:
            if not value.flags.writeable:      # a tensor may not alias it
                value = value.copy()
            self._cache[name] = torch.as_tensor(value, device=self.device)
        return self._cache[name]
