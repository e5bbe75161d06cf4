"""Scalar and vector (hyper)diffusion on the 2-D spectral-element grid.

Counterpart of the JAX package's ``models/hyperdiff.py``, the equivalent of
``HorizontalDynamicsFEM::ApplyScalarHyperdiffusion`` (reference
``src/atm/HorizontalDynamicsFEM.cpp:1867-2205``),
``ApplyVectorHyperdiffusion`` (``:2207-2420``) and the nu4 orchestration of
``StepAfterSubCycle`` (``:2637-2726``):

  order 2:  u += dt * nu * Lap(u)          (one weak Laplacian + DSS)
  order 4:  w = Lap(u); DSS(w); u -= dt * nu_local * Lap(w); DSS(u)

with nu_local = nu * (delta_alpha / reference_length)**3.2 applied on the
second pass only (fScaleNuLocally), reference_length = pi/2/30
(``GridCSGLL.cpp:87``).  Scalars diffuse with the weak scalar Laplacian;
velocities diffuse through separate divergence/vorticity damping.

``step_after_subcycle_sw`` is the shallow-water state's tail; its order-4
passes run on the hand-written kernels (``fast/hyper_cuda``).  The
nonhydrostatic tail of the JAX package (``step_after_subcycle_nh``,
``uniform_diffusion_update``) belongs to its reference-layout engine, which
is not ported: the z-first engine has its own tail
(``fast/engine.step_after_subcycle``).

A ``geom`` here is any object with the 2-D metric: a geometry, its
``_device.OnDevice`` view, or ``models/sw_model.SWStatics``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..fast import hyper_cuda
from ..ops import sem


def _t(x, like):
    """A geometry array as a tensor on ``like``'s device."""
    return torch.as_tensor(x, device=like.device)


def _metric(geom, like, extra: int):
    """(con2d, jac2d) as tensors shaped for fields with ``extra`` trailing
    axes past (P, A, B)."""
    con2d = _t(geom.con2d, like)
    jac2d = _t(geom.jac2d, like)
    con = con2d.reshape(tuple(con2d.shape[:3]) + (1,) * extra + (2, 2))
    return con, jac2d.reshape(tuple(jac2d.shape) + (1,) * extra)


def scalar_laplacian(f, geom, jac=None):
    """Weak-form scalar Laplacian: (1/J) weak_div(J g^{ij} d_j f).

    ``jac``: the 3D Jacobian stack for level/interface fields (defaults to
    the 2D Jacobian); the horizontal contravariant metric is always the 2D
    one, matching the reference (which feeds ContraMetric2DA/B).
    """
    nea, neb, p = geom.nea, geom.neb, geom.p
    da_, db_ = geom.delta_a, geom.delta_b
    con, j2 = _metric(geom, f, f.dim() - 3)
    if jac is None:
        j = j2
    else:
        jac = _t(jac, f)
        j = jac if jac.dim() == f.dim() else jac.reshape(
            tuple(jac.shape) + (1,) * (f.dim() - jac.dim()))
    da, db = sem.deriv_both(f, geom.deriv, nea, neb, p, da_, db_)
    ga = j * (con[..., 0, 0] * da + con[..., 0, 1] * db)
    gb = j * (con[..., 1, 0] * da + con[..., 1, 1] * db)
    return sem.weak_div(ga, gb, geom.stiff, nea, neb, p, da_, db_) / j


def curl_and_div(u, v, geom):
    """Relative vorticity and divergence of the covariant velocity field.

    Reference: ``GridPatchCSGLL::ComputeCurlAndDiv``
    (``src/atm/GridPatchCSGLL.cpp:1132-1305``):
      div  = (d_a(J u^a) + d_b(J u^b)) / J     (strong form)
      curl = (d_a u_b - d_b u_a) / J
    ``u``, ``v``: (6, A, B[, nz]) tensors.
    """
    nea, neb, p = geom.nea, geom.neb, geom.p
    da_, db_ = geom.delta_a, geom.delta_b
    con, j2 = _metric(geom, u, u.dim() - 3)
    con_u = con[..., 0, 0] * u + con[..., 0, 1] * v
    con_v = con[..., 1, 0] * u + con[..., 1, 1] * v
    d_ju_a = sem.deriv_a(j2 * con_u, geom.deriv, nea, neb, p, da_)
    d_jv_b = sem.deriv_b(j2 * con_v, geom.deriv, nea, neb, p, db_)
    dv_a = sem.deriv_a(v, geom.deriv, nea, neb, p, da_)
    du_b = sem.deriv_b(u, geom.deriv, nea, neb, p, db_)
    div = (d_ju_a + d_jv_b) / j2
    curl = (dv_a - du_b) / j2
    return curl, div


def vector_hyperdiff_update(u, v, nu_div, nu_vort, geom):
    """One application of the div/vort-split vector diffusion operator.

    Returns (Du, Dv) with the same sign convention as the reference's
    ``dataUpdate -= dDeltaT * dUpdate`` with positive dt: the caller applies
    ``u_new = u - dt * Du``.  Reference: ``ApplyVectorHyperdiffusion``.
    """
    curl, div = curl_and_div(u, v, geom)
    # weak gradient (stiffness transpose) of div and curl
    wda_div = _weak_grad_a(div, geom)
    wdb_div = _weak_grad_b(div, geom)
    wda_curl = _weak_grad_a(curl, geom)
    wdb_curl = _weak_grad_b(curl, geom)
    con, j2 = _metric(geom, u, u.dim() - 3)
    du = nu_div * wda_div - nu_vort * j2 * (
        con[..., 1, 0] * wda_curl + con[..., 1, 1] * wdb_curl)
    dv = nu_div * wdb_div + nu_vort * j2 * (
        con[..., 0, 0] * wda_curl + con[..., 0, 1] * wdb_curl)
    return du, dv


def _weak_grad_a(f, geom):
    return sem.weak_grad_a(f, geom.stiff, geom.nea, geom.neb, geom.p,
                           geom.delta_a)


def _weak_grad_b(f, geom):
    return sem.weak_grad_b(f, geom.stiff, geom.nea, geom.neb, geom.p,
                           geom.delta_b)


def nu_local_scale(geom) -> float:
    """(delta_a / reference_length)**3.2 (reference :1967-1975).

    reference_length = pi/60 on the cubed sphere (``GridCSGLL.cpp:87``);
    Cartesian tests set min(domain width, 110 km).
    """
    return float((geom.delta_a / geom.reference_length) ** 3.2)


def _tracer_laplacian(tr, geom):
    """Scalar Laplacian of each species of ``(ntr, 6, A, B)`` tracers."""
    return scalar_laplacian(tr.permute(1, 2, 3, 0), geom).permute(3, 0, 1, 2)


def step_after_subcycle_sw(state, dt, cfg, geom, dss_state: Callable,
                           hyper, plain: bool = False):
    """nu4 hyperviscosity for the shallow-water state (Strang tail).

    ``dss_state``: callable applying DSS to a full state dict.
    Mirrors StepAfterSubCycle's order-4 branch exactly: Laplacian pass,
    DSS, second Laplacian with locally-scaled nu, DSS.  ``hyper``: the nu4
    kernels' statics for this grid (``hyper_cuda.HyperStatics`` with the
    2-D Jacobian as ``jl``): the order-4 passes over U, V and H are
    ``hyper_cuda.nu4_pass1`` / ``nu4_pass2`` on (1, 6, A, B) views, which
    launch the kernels on CUDA tensors (``plain``: the kernels' plain
    versions).  The order-2 branch and the tracers' Laplacians are plain
    tensor code, as in the JAX package.
    """
    if not cfg.hyperdiffusion or (
            cfg.nu_scalar == 0 and cfg.nu_div == 0 and cfg.nu_vort == 0):
        return dss_state(state)

    scale = nu_local_scale(geom) if cfg.hypervis_order == 4 else 1.0
    nu_s = cfg.nu_scalar * scale
    nu_d = cfg.nu_div * scale
    nu_v = cfg.nu_vort * scale
    tracers = state.get("Tracers")
    pass1, pass2 = ((hyper_cuda.nu4_pass1_plain, hyper_cuda.nu4_pass2_plain)
                    if plain else (hyper_cuda.nu4_pass1, hyper_cuda.nu4_pass2))

    if cfg.hypervis_order == 2:
        h_new = state["H"] + dt * nu_s * scalar_laplacian(state["H"], geom)
        du, dv = vector_hyperdiff_update(
            state["U"], state["V"], cfg.nu_div, cfg.nu_vort, geom)
        out = {"U": state["U"] - dt * du, "V": state["V"] - dt * dv,
               "H": h_new}
        if tracers is not None:
            out["Tracers"] = tracers + dt * nu_s * _tracer_laplacian(
                tracers, geom)
        return dss_state(out)

    # ---- order 4 ----
    # first application (dt=1, nu=1; U and V store -(operator) exactly as
    # the reference), then DSS of the working state
    views = {k: state[k][None] for k in hyper_cuda.SW_FIELDS}
    work = {k: v[0] for k, v in pass1(views, None, hyper).items()}
    if tracers is not None:
        work["Tracers"] = _tracer_laplacian(tracers, geom)
    work = dss_state(work)

    # second application with -dt and locally-scaled nu
    out = {k: v[0] for k, v in pass2(
        views, {k: work[k][None] for k in hyper_cuda.SW_FIELDS},
        nu_s, nu_d, nu_v, dt, None, hyper).items()}
    if tracers is not None:
        out["Tracers"] = tracers - dt * nu_s * _tracer_laplacian(
            work["Tracers"], geom)
    return dss_state(out)
