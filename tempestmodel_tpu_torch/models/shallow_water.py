"""Shallow-water spectral-element dynamics on the cubed sphere.

Counterpart of the JAX package's ``models/shallow_water.py``, a re-design
of the reference ``HorizontalDynamicsFEM::StepShallowWater``
(``src/atm/HorizontalDynamicsFEM.cpp:321-640``): the vector-invariant
shallow-water equations in covariant equiangular components,

    d(u_a)/dt = -d_a(K + g H) + (f J + zeta) u^b
    d(u_b)/dt = -d_b(K + g H) - (f J + zeta) u^a
    dH/dt     = -(1/J) [weak_div of J u^i (H - Zs)]

where zeta = d_a u_b - d_b u_a (= J times relative vorticity), K is the
specific kinetic energy, and the mass flux uses the variational
(stiffness-matrix) form.  The per-element loops become batched
tensor-product contractions over the element-stacked (6, A, B) layout
(``ops/sem.py``); there is no kernel of its own here, as in the JAX package.

State dict: {"U": covariant alpha velocity, "V": covariant beta velocity,
"H": free-surface height}, each (6, A, B), plus optional "Tracers"
(ntracer, 6, A, B).  ``geom``: for ``sw_tendency`` the step's
``models/sw_model.SWStatics``; for the integrals also a geometry or its
``_device.OnDevice`` view.
"""

from __future__ import annotations

import torch

from ..ops import sem


def _g(geom, name, like):
    return torch.as_tensor(getattr(geom, name), device=like.device)


def _contra(u, v, con2d):
    """Contravariant (u^a, u^b) of the covariant pair."""
    return (con2d[..., 0, 0] * u + con2d[..., 0, 1] * v,
            con2d[..., 1, 0] * u + con2d[..., 1, 1] * v)


def sw_tendency(state, geom, constants):
    """Element-local shallow-water tendencies (no DSS, no dt).

    Returns a dict of the same structure as ``state``.  The tracers'
    tendency is the flux form of ``models/advection.advection_tendency``
    with the stage's wind (the JAX package's ``sw_tendency`` states the
    same sum over the species axis, which its contraction cannot take).
    """
    ne, p, delta = geom.ne, geom.p, geom.delta_a
    D, S = geom.deriv, geom.stiff
    u, v, h = state["U"], state["V"], state["H"]
    jac2d = _g(geom, "jac2d", u)

    # contravariant velocities (reference :429-441)
    con_u, con_v = _contra(u, v, _g(geom, "con2d", u))

    # specific kinetic energy + geopotential (reference :443-449)
    ke = 0.5 * (con_u * u + con_v * v) + constants.g * h

    # mass fluxes (reference :455-476): J * u^i * (H - Zs)
    depth = h - _g(geom, "topo", u)
    flux_a = jac2d * con_u * depth
    flux_b = jac2d * con_v * depth

    # derivatives
    dke_a, dke_b = sem.deriv_both(ke, D, ne, ne, p, delta, delta)
    dv_a = sem.deriv_a(v, D, ne, ne, p, delta)   # d(u_b)/da
    du_b = sem.deriv_b(u, D, ne, ne, p, delta)   # d(u_a)/db
    zeta = dv_a - du_b                           # J * relative vorticity

    div_mass = sem.weak_div(flux_a, flux_b, S, ne, ne, p, delta, delta)

    # absolute vorticity rotation + pressure-gradient terms (reference
    # :583-607)
    fJ = geom.fj                                 # coriolis * jac2d
    du = -dke_a + con_v * (zeta + fJ)
    dv = -dke_b - con_u * (zeta + fJ)
    dh = -div_mass / jac2d

    out = {"U": du, "V": dv, "H": dh}
    if "Tracers" in state:
        tr = torch.movedim(state["Tracers"], 0, -1)      # (P, A, B, ntr)
        ta = (jac2d * con_u)[..., None] * tr
        tb = (jac2d * con_v)[..., None] * tr
        out["Tracers"] = torch.movedim(
            -sem.weak_div(ta, tb, S, ne, ne, p, delta, delta)
            / jac2d[..., None], -1, 0)
    return out


def sw_energy(state, geom, constants):
    """Discrete total energy integral (reference ``Grid::ComputeTotalEnergy``),
    a 0-d tensor."""
    u, v, h = state["U"], state["V"], state["H"]
    con_u, con_v = _contra(u, v, _g(geom, "con2d", u))
    topo = _g(geom, "topo", u)
    depth = h - topo
    ke = 0.5 * depth * (con_u * u + con_v * v)
    pe = 0.5 * constants.g * (h * h - topo * topo)
    return torch.sum((ke + pe) * _g(geom, "area2d", u))


def sw_potential_enstrophy(state, zeta, geom):
    """Potential enstrophy 0.5 (f + zeta/J)^2 / depth integral, a 0-d
    tensor."""
    h = state["H"]
    depth = h - _g(geom, "topo", h)
    abs_vort = _g(geom, "coriolis", h) + zeta / _g(geom, "jac2d", h)
    return torch.sum(0.5 * abs_vort * abs_vort / depth
                     * _g(geom, "area2d", h))
