"""Carry a state and a precomputed geometry across from numpy.

The system has no weights; what crosses between the JAX package and this
one is the state and the precomputed z-first geometry.  Both functions
take plain numpy arrays (and Python scalars), so two implementations can
step from bit-identical inputs without either importing the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device, np_dtype
from .fast import dss_cuda
from .fast.engine import FIELDS, FastGeometry, pack_state


def state_from_numpy(state_np, device=None, dtype=torch.float64):
    """Reference-layout state dict ``(P, A, B, nz[+1])`` of numpy arrays (P
    = 6 on the cubed sphere, 1 on a Cartesian grid) -> the z-first state of
    the engine, tensors of ``dtype`` on ``device`` (default ``cuda``; raises
    when absent), in the natural layout that ``make_fast_step`` takes on
    either grid.  ``"Tracers"`` ``(ntr, P, A, B, nz)`` comes across when the
    state has it (as the flat species-major field of ``pack_state``)."""
    npdt = np_dtype(dtype)
    missing = [k for k in FIELDS if k not in state_np]
    if missing:
        raise KeyError(f"state lacks the fields {missing}")
    keys = FIELDS + (("Tracers",) if "Tracers" in state_np else ())
    return pack_state(
        {k: np.array(state_np[k], dtype=npdt, order="C") for k in keys},
        device=resolve_device(device))


def fast_geometry_from_numpy(fields_np, device=None, dtype=torch.float64):
    """The fields of a z-first ``FastGeometry`` as numpy arrays and Python
    scalars (keyed by field name) -> a ``FastGeometry`` with every array a
    tensor of ``dtype`` on ``device``.  ``DA_elem`` / ``S_elem`` stay host
    numpy (they are host-side tables); the device link table of the DSS
    kernels is rebuilt from ``dss_links`` (empty for a Cartesian geometry:
    ``npanels=1``, ``dss_links=()``, with its ``wrap``, ``xz_zero``,
    ``ab_swapped``, ``nu_delta`` and one-link dummy ``e_rot``).  Unknown keys
    raise."""
    dev = resolve_device(device)
    npdt = np_dtype(dtype)
    names = {f.name for f in dataclasses.fields(FastGeometry)}
    unknown = set(fields_np) - names
    if unknown:
        raise KeyError(f"not FastGeometry fields: {sorted(unknown)}")
    host_only = ("DA_elem", "S_elem")
    out = {}
    for k, v in fields_np.items():
        if isinstance(v, np.ndarray) and k not in host_only:
            # np.array copies: the tensor never aliases a read-only input
            out[k] = torch.as_tensor(np.array(v, dtype=npdt, order="C"),
                                     device=dev)
        elif k == "dss_links":
            out[k] = tuple(tuple(int(x) if not isinstance(x, (bool, np.bool_))
                                 else bool(x) for x in link) for link in v)
        elif k == "wrap":
            out[k] = tuple(bool(x) for x in v)
        else:
            out[k] = v
    out["dss_table"] = torch.as_tensor(
        dss_cuda.link_table(out["dss_links"], out.get("npanels", 6)),
        device=dev)
    return FastGeometry(**out)
