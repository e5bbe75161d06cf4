"""Equiangular cubed-sphere coordinate and vector transforms.

Analog of the reference ``src/atm/CubedSphereTrans.{h,cpp}``.
Vectorized numpy implementations (the reference is pointwise scalar
C++).  Panel convention matches the reference: panels 0-3 equatorial
(centered at lon 0, pi/2, pi, 3pi/2), panel 4 north polar, panel 5 south
polar.  Gnomonic coords X = tan(alpha), Y = tan(beta) in [-1, 1] over
alpha, beta in [-pi/4, pi/4].

These functions run host-side at geometry-precompute / initial-condition
time in float64; nothing here runs inside the step function.
"""

from __future__ import annotations

import numpy as np

NPANEL = 6


def _local_from_global_xyz(xx, yy, zz, panel: int):
    """Global cartesian -> panel-local (sx, sy, sz) (ref CubedSphereTrans.cpp:146-183)."""
    if panel == 0:
        return yy, zz, xx
    if panel == 1:
        return -xx, zz, yy
    if panel == 2:
        return -yy, zz, -xx
    if panel == 3:
        return xx, zz, -yy
    if panel == 4:
        return yy, -xx, zz
    if panel == 5:
        return yy, xx, -zz
    raise ValueError(f"invalid panel {panel}")


def _global_from_local_xyz(sx, sy, sz, panel: int):
    """Panel-local -> global cartesian (ref CubedSphereTrans.cpp:42-80)."""
    if panel == 0:
        return sz, sx, sy
    if panel == 1:
        return -sx, sz, sy
    if panel == 2:
        return -sz, -sx, sy
    if panel == 3:
        return sx, -sz, sy
    if panel == 4:
        return -sy, sx, sz
    if panel == 5:
        return sy, sx, -sz
    raise ValueError(f"invalid panel {panel}")


def xyz_from_xyp(X, Y, panel: int):
    """Gnomonic (X, Y, panel) -> unit-sphere cartesian (x, y, z)."""
    sz = 1.0 / np.sqrt(1.0 + X * X + Y * Y)
    return _global_from_local_xyz(sz * X, sz * Y, sz, panel)


def xyp_from_xyp(X, Y, src_panel: int, dst_panel: int):
    """Re-express gnomonic coords of one panel on another panel."""
    xx, yy, zz = xyz_from_xyp(X, Y, src_panel)
    sx, sy, sz = _local_from_global_xyz(xx, yy, zz, dst_panel)
    return sx / sz, sy / sz


def rll_from_xyp(X, Y, panel: int):
    """Gnomonic (X, Y, panel) -> (lon in [0, 2pi), lat)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if panel <= 3:
        lon = np.arctan(X) + panel * 0.5 * np.pi
        lat = np.arctan(Y / np.sqrt(1.0 + X * X))
    elif panel == 4:
        lon = np.arctan2(X, -Y)
        lat = 0.5 * np.pi - np.arctan(np.sqrt(X * X + Y * Y))
    else:
        lon = np.arctan2(X, Y)
        lat = -0.5 * np.pi + np.arctan(np.sqrt(X * X + Y * Y))
    lon = np.where(lon < 0.0, lon + 2.0 * np.pi, lon)
    return lon, lat


def rll_from_abp(alpha, beta, panel: int):
    return rll_from_xyp(np.tan(alpha), np.tan(beta), panel)


def xyp_from_rll(lon, lat):
    """(lon, lat) -> gnomonic (X, Y, panel); fully vectorized.

    Panel choice by largest |coordinate| with the same tie-break priority
    as the reference (x checked first, then y, then z overrides).
    """
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    xx = np.cos(lon) * np.cos(lat)
    yy = np.sin(lon) * np.cos(lat)
    zz = np.sin(lat)
    pm = np.maximum(np.abs(xx), np.maximum(np.abs(yy), np.abs(zz)))
    panel = np.full(lon.shape, -1, dtype=np.int32)
    # Priority order matches the reference: x, then y, then z (later wins)
    panel = np.where(pm == np.abs(xx), np.where(xx > 0, 0, 2), panel)
    panel = np.where(pm == np.abs(yy), np.where(yy > 0, 1, 3), panel)
    panel = np.where(pm == np.abs(zz), np.where(zz > 0, 4, 5), panel)
    X = np.zeros_like(lon)
    Y = np.zeros_like(lon)
    for p in range(NPANEL):
        m = panel == p
        if not np.any(m):
            continue
        sx, sy, sz = _local_from_global_xyz(xx[m], yy[m], zz[m], p)
        X[m] = sx / sz
        Y[m] = sy / sz
    return X, Y, panel


def abp_from_rll(lon, lat):
    X, Y, panel = xyp_from_rll(lon, lat)
    return np.arctan(X), np.arctan(Y), panel


# ---------------------------------------------------------------------------
# Vector transforms.  "Spherical" components (ulon, ulat) are in the unit
# (geometric) basis -- actual m/s on the unit sphere.  (ualpha, ubeta) are
# contravariant (VecTrans*) or covariant (CoVecTrans*) equiangular
# components.  Reference: CubedSphereTrans.cpp:385-732.
# ---------------------------------------------------------------------------

def vec_con_from_sphere(X, Y, panel: int, ulon, ulat):
    """Contravariant (u^alpha, u^beta) from unit-basis (ulon, ulat)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    d2 = 1.0 + X * X + Y * Y
    if panel <= 3:
        # geometric basis: divide by cos(lat)
        g = ulon / np.cos(np.arctan(Y / np.sqrt(1.0 + X * X)))
        ua = g
        ub = X * Y / (1.0 + Y * Y) * g \
            + d2 / ((1.0 + Y * Y) * np.sqrt(1.0 + X * X)) * ulat
        return ua, ub
    r = np.sqrt(X * X + Y * Y)
    safe_r = np.where(r < 1e-13, 1.0, r)
    if panel == 4:
        lat = 0.5 * np.pi - np.arctan(r)
        g = ulon / np.cos(lat)
        ua = -Y / (1.0 + X * X) * g - d2 * X / ((1.0 + X * X) * safe_r) * ulat
        ub = X / (1.0 + Y * Y) * g - d2 * Y / ((1.0 + Y * Y) * safe_r) * ulat
        ua = np.where(r < 1e-13, ulon, ua)
        ub = np.where(r < 1e-13, ulat, ub)
        return ua, ub
    if panel == 5:
        lat = -0.5 * np.pi + np.arctan(r)
        g = ulon / np.cos(lat)
        ua = Y / (1.0 + X * X) * g + d2 * X / ((1.0 + X * X) * safe_r) * ulat
        ub = -X / (1.0 + Y * Y) * g + d2 * Y / ((1.0 + Y * Y) * safe_r) * ulat
        ua = np.where(r < 1e-13, -ulon, ua)
        ub = np.where(r < 1e-13, ulat, ub)
        return ua, ub
    raise ValueError(f"invalid panel {panel}")


def vec_sphere_from_con(X, Y, panel: int, ua, ub):
    """Unit-basis (ulon, ulat) from contravariant (u^alpha, u^beta)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    d2 = 1.0 + X * X + Y * Y
    if panel <= 3:
        ulon = ua
        ulat = -X * Y * np.sqrt(1.0 + X * X) / d2 * ua \
            + (1.0 + Y * Y) * np.sqrt(1.0 + X * X) / d2 * ub
        lat = np.arctan(Y / np.sqrt(1.0 + X * X))
        return ulon * np.cos(lat), ulat
    r2 = X * X + Y * Y
    r = np.sqrt(r2)
    safe_r2 = np.where(r2 < 1e-26, 1.0, r2)
    safe_r = np.sqrt(np.where(r2 < 1e-26, 1.0, r2))
    if panel == 4:
        ulon = -Y * (1.0 + X * X) / safe_r2 * ua + X * (1.0 + Y * Y) / safe_r2 * ub
        ulat = -X * (1.0 + X * X) / (d2 * safe_r) * ua \
            - Y * (1.0 + Y * Y) / (d2 * safe_r) * ub
        lat = 0.5 * np.pi - np.arctan(r)
        ulon = ulon * np.cos(lat)
        ulon = np.where(r2 < 1e-26, ua, ulon)
        ulat = np.where(r2 < 1e-26, ub, ulat)
        return ulon, ulat
    if panel == 5:
        ulon = Y * (1.0 + X * X) / safe_r2 * ua - X * (1.0 + Y * Y) / safe_r2 * ub
        ulat = X * (1.0 + X * X) / (d2 * safe_r) * ua \
            + Y * (1.0 + Y * Y) / (d2 * safe_r) * ub
        lat = -0.5 * np.pi + np.arctan(r)
        ulon = ulon * np.cos(lat)
        ulon = np.where(r2 < 1e-26, -ua, ulon)
        ulat = np.where(r2 < 1e-26, ub, ulat)
        return ulon, ulat
    raise ValueError(f"invalid panel {panel}")


def vec_cov_from_sphere(X, Y, panel: int, ulon, ulat):
    """Covariant (u_alpha, u_beta) from unit-basis (ulon, ulat).

    Reference: ``CoVecTransABPFromRLL`` (CubedSphereTrans.cpp:551-640).
    Note: on the unit sphere; multiply inputs by the Earth radius to get
    Tempest's prognostic covariant velocities (GridPatchCSGLL.cpp:744-752).
    """
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    d2 = 1.0 + X * X + Y * Y
    if panel <= 3:
        lat = np.arctan(Y / np.sqrt(1.0 + X * X))
        g = ulon / np.cos(lat)
        ua = (1.0 + X * X) / d2 * g - X * Y * np.sqrt(1.0 + X * X) / d2 * ulat
        ub = np.sqrt(1.0 + X * X) * (1.0 + Y * Y) / d2 * ulat
        return ua, ub
    r = np.sqrt(X * X + Y * Y)
    safe_r = np.where(r < 1e-13, 1.0, r)
    if panel == 4:
        lat = 0.5 * np.pi - np.arctan(r)
        g = ulon / np.cos(lat)
        ua = -Y * (1.0 + X * X) / d2 * g - X * (1.0 + X * X) / (d2 * safe_r) * ulat
        ub = X * (1.0 + Y * Y) / d2 * g - Y * (1.0 + Y * Y) / (d2 * safe_r) * ulat
        ua = np.where(r < 1e-13, ulon, ua)
        ub = np.where(r < 1e-13, ulat, ub)
        return ua, ub
    if panel == 5:
        lat = -0.5 * np.pi + np.arctan(r)
        g = ulon / np.cos(lat)
        ua = Y * (1.0 + X * X) / d2 * g + X * (1.0 + X * X) / (d2 * safe_r) * ulat
        ub = -X * (1.0 + Y * Y) / d2 * g + Y * (1.0 + Y * Y) / (d2 * safe_r) * ulat
        ua = np.where(r < 1e-13, -ulon, ua)
        ub = np.where(r < 1e-13, ulat, ub)
        return ua, ub
    raise ValueError(f"invalid panel {panel}")


def vec_sphere_from_cov(X, Y, panel: int, ua, ub):
    """Unit-basis (ulon, ulat) from covariant (u_alpha, u_beta).

    Reference: ``CoVecTransRLLFromABP`` (CubedSphereTrans.cpp:644-732).
    """
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    d2 = 1.0 + X * X + Y * Y
    if panel <= 3:
        ulon = d2 / (1.0 + X * X) * ua \
            + d2 * X * Y / ((1.0 + X * X) * (1.0 + Y * Y)) * ub
        ulat = d2 / (np.sqrt(1.0 + X * X) * (1.0 + Y * Y)) * ub
        lat = np.arctan(Y / np.sqrt(1.0 + X * X))
        return ulon * np.cos(lat), ulat
    r2 = X * X + Y * Y
    r = np.sqrt(r2)
    safe_r2 = np.where(r2 < 1e-26, 1.0, r2)
    safe_r = np.sqrt(safe_r2)
    sign = 1.0 if panel == 4 else -1.0
    ulon = sign * (-d2 * Y / ((1.0 + X * X) * safe_r2) * ua
                   + d2 * X / ((1.0 + Y * Y) * safe_r2) * ub)
    ulat = sign * (-d2 * X / ((1.0 + X * X) * safe_r) * ua
                   - d2 * Y / ((1.0 + Y * Y) * safe_r) * ub)
    lat_polar = 0.5 * np.pi - np.arctan(r)
    ulon = ulon * np.cos(lat_polar)
    ulon = np.where(r2 < 1e-26, (ua if panel == 4 else -ua), ulon)
    ulat = np.where(r2 < 1e-26, ub, ulat)
    return ulon, ulat
