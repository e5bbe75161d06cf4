"""Checksums, error norms, and conservation diagnostics.

Counterparts of the JAX package's ``io/diagnostics.py``, analogs of the
reference verification machinery:
  - ``GridPatch::Checksum`` (``src/atm/GridPatch.cpp:745-930``):
    area-weighted Sum / L1 / L2 / Linf over all stored nodes.
  - ``Model::ComputeErrorNorms`` (``src/atm/Model.cpp:695-782``):
    L1/L2/Linf error vs the test-case reference state.
  - ``OutputManagerChecksum`` periodic checksum stream.

They act on reference-layout (z-last) state tensors.  Quadrature weights
and metric terms may be host numpy arrays or tensors (a geometry or its
``_device.OnDevice`` view); they are used on the state's device.
"""

from __future__ import annotations

import torch


def _on(a, like):
    return torch.as_tensor(a, device=like.device)


def _colop(M, f):
    """Apply a (K_out, K_in) vertical operator over the last axis."""
    return torch.einsum("KL,...L->...K", _on(M, f), f)


def _infer_stagger(state, nz: int) -> str:
    """Staggering from state shapes: LOR (default), CPH, or LEV."""
    if state["W"].shape[-1] == nz:
        return "LEV"
    if state["Rt"].shape[-1] == nz + 1:
        return "CPH"
    return "LOR"


def checksum(field, area, kind: str = "l2"):
    """Area-weighted checksum of a (6, A, B[, nz]) field (a 0-d tensor).

    Matches the reference definitions: Sum = sum(f * dA); L1 = sum(|f| dA);
    L2 = sqrt(sum(f^2 dA)); Linf = max |f|.
    """
    area = _on(area, field)
    if kind == "sum":
        return torch.sum(field * area)
    if kind == "l1":
        return torch.sum(torch.abs(field) * area)
    if kind == "l2":
        return torch.sqrt(torch.sum(field * field * area))
    if kind == "linf":
        return torch.max(torch.abs(field))
    raise ValueError(kind)


def state_checksums(state: dict, area, kind: str = "l2", area_int=None):
    """Checksum of every component of a state dict.

    ``area``: level-field quadrature weights; ``area_int``: interface-field
    weights (for W on interfaces).  Tracer stacks use ``area`` per species.
    """
    out = {}
    for name, f in state.items():
        a = _on(area, f)
        if area_int is not None and f.ndim == area_int.ndim \
                and f.shape[-1] == area_int.shape[-1]:
            a = _on(area_int, f)
        if f.ndim > a.ndim:
            a = a.reshape((1,) * (f.ndim - a.ndim) + tuple(a.shape))
        elif f.ndim == a.ndim - 1:
            a = a[..., 0]
        if name == "Tracers":
            for i in range(f.shape[0]):
                out[f"Q{i}"] = checksum(f[i], area, kind)
            continue
        out[name] = checksum(f, a, kind)
    return out


def error_norms(state: dict, reference: dict, area, area_int=None):
    """L1/L2/Linf norms of (state - reference), absolute and normalized
    (0-d tensors).

    Matches ``Model::ComputeErrorNorms``: normalized norms divide by the
    same norm of the reference state.
    """
    out = {}
    for name in state:
        if name not in reference:
            continue
        f = state[name]
        r = _on(reference[name], f)
        a = _on(area, f)
        if area_int is not None and f.ndim == area_int.ndim \
                and f.shape[-1] == area_int.shape[-1]:
            a = _on(area_int, f)
        if f.ndim > a.ndim:
            a = a.reshape((1,) * (f.ndim - a.ndim) + tuple(a.shape))
        diff = f - r
        l1 = torch.sum(torch.abs(diff) * a)
        l2 = torch.sqrt(torch.sum(diff * diff * a))
        linf = torch.max(torch.abs(diff))
        r1 = torch.sum(torch.abs(r) * a)
        r2 = torch.sqrt(torch.sum(r * r * a))
        rinf = torch.max(torch.abs(r))
        out[name] = {
            "l1": l1, "l2": l2, "linf": linf,
            "l1_rel": torch.where(r1 > 0, l1 / r1, l1),
            "l2_rel": torch.where(r2 > 0, l2 / r2, l2),
            "linf_rel": torch.where(rinf > 0, linf / rinf, linf),
        }
    return out


# ---------------------------------------------------------------------------
# 3-D conservation integrals (reference Grid::ComputeTotalEnergy /
# ComputeTotalPotentialEnstrophy / ComputeTotalVerticalMomentum,
# ``src/atm/GridPatch.cpp:925-1290``, reduced over patches in
# ``Grid.cpp:968-1100``)
# ---------------------------------------------------------------------------

def nh_total_energy(state, geom, constants):
    """Total energy (kinetic + internal + potential) of the NH state, a
    Python float.

    Follows the reference split by vertical staggering
    (``GridPatch.cpp:1002-1135``): with W on interfaces (LOR/CPH), the
    level integral carries u.u WITHOUT the g^xixi W^2 term (cross terms
    g^xi_a u W + g^xi_b v W included, W interpolated to levels), and the
    g^xixi W^2 kinetic energy integrates on interfaces with the
    interpolated density; with W on levels (LEV/INT), everything
    integrates on levels.
    """
    u, v, w = state["U"], state["V"], state["W"]
    rho, rt = state["Rho"], state["Rt"]
    stagger = _infer_stagger(state, geom.nz)
    c2 = _on(geom.con2d, u)
    c_aa = c2[..., 0, 0, None]
    c_ab = c2[..., 0, 1, None]
    c_bb = c2[..., 1, 1, None]
    con_a_xi = _on(geom.con_a_xi, u)
    con_b_xi = _on(geom.con_b_xi, u)
    area3d = _on(geom.area3d, u)

    rt_n = _colop(geom.interp_i2n, rt) if stagger == "CPH" else rt
    pressure = constants.pressure_from_rhotheta(rt_n)
    internal = pressure / (constants.gamma - 1.0)
    potential = constants.g * rho * _on(geom.z_lev, u)

    if stagger in ("LEV", "INT"):
        con_xi_xi = _on(geom.con_xi_xi, u)
        con_ua = c_aa * u + c_ab * v + con_a_xi * w
        con_ub = c_ab * u + c_bb * v + con_b_xi * w
        con_ux = con_a_xi * u + con_b_xi * v + con_xi_xi * w
        udotu = con_ua * u + con_ub * v + con_ux * w
        ke = 0.5 * rho * udotu
        return float(torch.sum(area3d * (ke + internal + potential)))

    w_n = _colop(geom.interp_i2n, w)
    con_ua = c_aa * u + c_ab * v + con_a_xi * w_n
    con_ub = c_ab * u + c_bb * v + con_b_xi * w_n
    udotu = (con_ua * u + con_ub * v
             + (con_a_xi * u + con_b_xi * v) * w_n)
    ke_lev = 0.5 * rho * udotu
    lev = float(torch.sum(area3d * (ke_lev + internal + potential)))

    rho_i = _colop(geom.interp_n2i, rho)
    ke_int = 0.5 * rho_i * _on(geom.con_xi_xi_int, u) * w * w
    return lev + float(torch.sum(_on(geom.area3d_int, u) * ke_int))


def nh_zonal_momentum(state, geom):
    """Integral of rho * U_alpha, a Python float.

    NOTE: this is what the reference's 3-D
    ``ComputeTotalPotentialEnstrophy`` actually computes
    (``GridPatch.cpp:1203-1215`` — the non-SW branch integrates zonal
    momentum, not enstrophy); reproduced for parity and reported under
    its honest name.
    """
    rho = state["Rho"]
    return float(torch.sum(_on(geom.area3d, rho) * rho * state["U"]))


def nh_vertical_momentum(state, geom):
    """Integral of rho * W on model levels, a Python float
    (``GridPatch.cpp:1226-1290``; W interpolated to levels when on
    interfaces, matching the reference's node-copy semantics)."""
    w = state["W"]
    if w.shape[-1] == geom.nz + 1:
        w = _colop(geom.interp_i2n, w)
    rho = state["Rho"]
    return float(torch.sum(_on(geom.area3d, rho) * rho * w))
