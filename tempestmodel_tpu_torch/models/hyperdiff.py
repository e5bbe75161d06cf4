"""Vorticity and divergence of the covariant velocity field.

Counterpart of the JAX package's ``models/hyperdiff.py``; only
``curl_and_div`` is ported, for the lat-lon output's vorticity and
divergence fields (the engine's nu4 tail is ``fast/engine``'s).
"""

from __future__ import annotations

import torch

from ..ops import sem


def curl_and_div(u, v, geom):
    """Relative vorticity and divergence of the covariant velocity field.

    Reference: ``GridPatchCSGLL::ComputeCurlAndDiv``
    (``src/atm/GridPatchCSGLL.cpp:1132-1305``):
      div  = (d_a(J u^a) + d_b(J u^b)) / J     (strong form)
      curl = (d_a u_b - d_b u_a) / J
    ``u``, ``v``: (6, A, B[, nz]) tensors; ``geom``: a geometry or its
    ``_device.OnDevice`` view.
    """
    nea, neb, p = geom.nea, geom.neb, geom.p
    da_, db_ = geom.delta_a, geom.delta_b
    extra = u.ndim - 3
    con2d = torch.as_tensor(geom.con2d, device=u.device)
    jac2d = torch.as_tensor(geom.jac2d, device=u.device)
    con = con2d.reshape(tuple(con2d.shape[:3]) + (1,) * extra + (2, 2))
    j2 = jac2d.reshape(tuple(jac2d.shape) + (1,) * extra)
    con_u = con[..., 0, 0] * u + con[..., 0, 1] * v
    con_v = con[..., 1, 0] * u + con[..., 1, 1] * v
    d_ju_a = sem.deriv_a(j2 * con_u, geom.deriv, nea, neb, p, da_)
    d_jv_b = sem.deriv_b(j2 * con_v, geom.deriv, nea, neb, p, db_)
    dv_a = sem.deriv_a(v, geom.deriv, nea, neb, p, da_)
    du_b = sem.deriv_b(u, geom.deriv, nea, neb, p, db_)
    div = (d_ju_a + d_jv_b) / j2
    curl = (dv_a - du_b) / j2
    return curl, div
