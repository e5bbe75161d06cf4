"""DCMIP2016 test cases (moist idealized cases on the sphere).

Counterpart of the JAX package's ``testcases/dcmip2016.py``, ports of the
reference Fortran initializers (``test/dcmip2016/interface/*.f90`` wrapped
by ``test/dcmip2016/*Test.cpp``): analytic height-coordinate evaluations
vectorized over the whole grid (the Fortran per-point fixed-point
iterations are only needed in pressure coordinates, which are never used).
Fields are computed host-side in numpy float64; the last step builds
tensors on the requested device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device, np_dtype
from ..constants import PhysicalConstants
from ..grid.geometry import CubedSphereGeometry
from .nonhydro_sphere import BaroclinicWaveUMJS
from .shallow_water import sphere_velocity_to_covariant


def _tensors(fields, dtype, dev):
    npdt = np_dtype(dtype)
    return {k: torch.as_tensor(np.ascontiguousarray(f, dtype=npdt),
                               device=dev) for k, f in fields.items()}


@dataclasses.dataclass(frozen=True)
class TropicalCyclone:
    """Reed & Jablonowski (2011) idealized tropical cyclone.

    Reference: ``test/dcmip2016/interface/tropical_cyclone_test.f90``
    (z-coordinate branch) + ``TropicalCycloneTest.cpp:134-180``.
    State: virtual potential temperature as the thermodynamic variable,
    rho the moist density, tracer 0 = rho*q (specific humidity density).
    """
    rp: float = 282000.0
    dp: float = 1115.0
    zp: float = 7000.0
    q0: float = 0.021
    gamma: float = 0.007
    ts0: float = 302.15
    p00: float = 101500.0
    cen_lat: float = np.deg2rad(10.0)
    cen_lon: float = np.deg2rad(180.0)
    zq1: float = 3000.0
    zq2: float = 8000.0
    exppr: float = 1.5
    exppz: float = 2.0
    ztrop: float = 15000.0
    qtrop: float = 1.0e-11
    const_tv: float = 0.608
    ztop: float = 30000.0
    rayleigh: bool = False

    def _fields(self, lon, lat, z, constants: PhysicalConstants):
        c = constants
        expo = c.Rd * self.gamma / c.g
        t0 = self.ts0 * (1.0 + self.const_tv * self.q0)
        ttrop = t0 - self.gamma * self.ztrop
        ptrop = self.p00 * (ttrop / t0) ** (1.0 / expo)

        f = 2.0 * c.omega * np.sin(self.cen_lat)
        gr = c.earth_radius * np.arccos(np.clip(
            np.sin(self.cen_lat) * np.sin(lat)
            + np.cos(self.cen_lat) * np.cos(lat)
            * np.cos(lon - self.cen_lon), -1.0, 1.0))

        rad_term = np.exp(-((gr / self.rp) ** self.exppr))
        zfac = np.exp(-((z / self.zp) ** self.exppz))

        trop = z > self.ztrop
        p = np.where(
            trop,
            ptrop * np.exp(-(c.g * (z - self.ztrop)) / (c.Rd * ttrop)),
            (self.p00 - self.dp * rad_term * zfac)
            * ((t0 - self.gamma * z) / t0) ** (1.0 / expo))

        # gradient-wind tangential velocity
        d1 = (np.sin(self.cen_lat) * np.cos(lat)
              - np.cos(self.cen_lat) * np.sin(lat)
              * np.cos(lon - self.cen_lon))
        d2 = np.cos(self.cen_lat) * np.sin(lon - self.cen_lon)
        d = np.maximum(1e-25, np.sqrt(d1 * d1 + d2 * d2))
        tz = t0 - self.gamma * z
        denom = (self.exppz * z * c.Rd * tz / (c.g * self.zp ** self.exppz)
                 + (1.0 - self.p00 / self.dp / rad_term / zfac))
        disc = ((f * gr / 2.0) ** 2
                - self.exppr * (gr / self.rp) ** self.exppr * c.Rd * tz
                / denom)
        vt = -f * gr / 2.0 + np.sqrt(np.maximum(disc, 0.0))
        u = np.where(trop, 0.0, (d1 / d) * vt)
        v = np.where(trop, 0.0, (d2 / d) * vt)

        q = np.where(trop, self.qtrop,
                     self.q0 * np.exp(-z / self.zq1)
                     * np.exp(-((z / self.zq2) ** self.exppz)))
        t = np.where(
            trop, ttrop,
            tz / (1.0 + self.const_tv * q)
            / (1.0 + self.exppz * c.Rd * tz * z
               / (c.g * self.zp ** self.exppz
                  * (1.0 - self.p00 / self.dp / rad_term / zfac))))
        thetav = t * (1.0 + self.const_tv * q) * (c.P0 / p) ** (c.Rd / c.Cp)
        rho = p / (c.Rd * t * (1.0 + self.const_tv * q))
        return u, v, rho, thetav, q

    def initial_state(self, geom: CubedSphereGeometry,
                      constants: PhysicalConstants, dtype=torch.float64,
                      device=None):
        """Reference-layout state dict of tensors on ``device`` (default
        ``cuda``; raises when absent), with ``"Tracers"``."""
        dev = resolve_device(device)
        lon = np.asarray(geom.lon)[..., None]
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        u, v, rho, thetav, q = self._fields(lon, lat, z, constants)
        nz = geom.nz
        U = np.zeros(z.shape)
        V = np.zeros(z.shape)
        for k in range(nz):
            U[..., k], V[..., k] = sphere_velocity_to_covariant(
                u[..., k], v[..., k], geom, constants)
        return _tensors({
            "U": U, "V": V, "Rt": rho * thetav,
            "W": np.zeros(z.shape[:3] + (nz + 1,)), "Rho": rho,
            "Tracers": np.stack([rho * q, np.zeros_like(q),
                                 np.zeros_like(q)]),
        }, dtype, dev)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        """Environmental (vortex-free) profile: the far-field state."""
        dev = resolve_device(device)
        lon = np.asarray(geom.lon)[..., None]
        lat = np.asarray(geom.lat)[..., None] * 0.0 + np.pi / 2.0  # far field
        z = np.asarray(geom.z_lev)
        _, _, rho, thetav, q = self._fields(
            np.zeros_like(lon), lat, z, constants)
        nz = geom.nz
        return _tensors({
            "U": np.zeros(z.shape), "V": np.zeros(z.shape),
            "Rt": rho * thetav,
            "W": np.zeros(z.shape[:3] + (nz + 1,)), "Rho": rho,
            "Tracers": np.stack([rho * q, np.zeros_like(q),
                                 np.zeros_like(q)]),
        }, dtype, dev)


@dataclasses.dataclass(frozen=True)
class MoistBaroclinicWave:
    """UMJS baroclinic wave with moisture (DCMIP2016 test 1 analog).

    Reference: ``test/dcmip2016/interface/baroclinic_wave_test.f90`` moist
    branch: the dry UMJS dynamical state plus a latitude/pressure dependent
    specific humidity.  The state carries three tracers, species-first
    ``(3, 6, A, B, nz)``: rho * q, then two species that start at zero.
    """
    q0: float = 0.018
    lat_w: float = np.deg2rad(40.0)   # 2*pi/9
    p_w: float = 34000.0              # halfwidth pressure
    ztop: float = 30000.0
    rayleigh: bool = False
    pert: str = "exp"

    def _dry(self):
        return BaroclinicWaveUMJS(pert=self.pert, ztop=self.ztop)

    def _moisture(self, lat, pres):
        eta = pres / 1.0e5
        q = (self.q0 * np.exp(-((lat / self.lat_w) ** 4))
             * np.exp(-(((eta - 1.0) * 1.0e5 / self.p_w) ** 2)))
        return np.where(pres < 10000.0, 1.0e-12, q)

    def _with_tracers(self, s, geom, constants, dtype):
        """The dry state ``s`` plus the tracers; the pressure is taken from
        the state's Rt as stored (in ``dtype``)."""
        pres = constants.pressure_from_rhotheta(s["Rt"]).cpu().numpy()
        lat = np.asarray(geom.lat)[..., None]
        qr = self._moisture(lat, pres) * s["Rho"].cpu().numpy()
        tr = np.stack([qr, np.zeros_like(qr), np.zeros_like(qr)])
        s["Tracers"] = torch.as_tensor(
            np.ascontiguousarray(tr, dtype=np_dtype(dtype)),
            device=s["Rt"].device)
        return s

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        """Reference-layout state dict of tensors on ``device`` (default
        ``cuda``; raises when absent), with ``"Tracers"``."""
        s = dict(self._dry().initial_state(geom, constants, dtype, device))
        return self._with_tracers(s, geom, constants, dtype)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        s = dict(self._dry().reference_state(geom, constants, dtype, device))
        return self._with_tracers(s, geom, constants, dtype)


class Supercell:
    """Klemp et al. (2015) splitting supercell on a reduced-radius sphere.

    Reference: ``test/dcmip2016/interface/supercell_test.f90`` +
    ``SupercellTest.cpp``: thermal-wind-balanced background computed by a
    Chebyshev collocation solver (d/dphi, d/dz differentiation matrices,
    pseudoinverse integration, 12 fixed-point iterations), plus a warm
    thermal perturbation.  Earth radius / rotation scaled by X = 120.
    """

    # solver resolution (reference values)
    NZ_FIT = 100
    NPHI_FIT = 50
    Z2 = 50000.0

    def __init__(self, x_scaling=120.0, pert_dtheta=3.0,
                 pert_lonc=0.0, pert_latc=0.0, pert_zc=1500.0,
                 pert_rz=1500.0, ztop=20000.0, pert=True):
        self.x = x_scaling
        self.pert_dtheta = pert_dtheta
        self.pert_lonc = np.deg2rad(pert_lonc)
        self.pert_latc = np.deg2rad(pert_latc)
        self.pert_rh = 10000.0 * x_scaling
        self.pert_zc = pert_zc
        self.pert_rz = pert_rz
        self.ztop = ztop
        self.pert = pert
        self.rayleigh = False
        # supercell background parameters
        self.theta0, self.theta_tr, self.z_tr = 300.0, 343.0, 12000.0
        self.t_tr, self.pseq = 213.0, 100000.0
        self.us, self.uc, self.zs_v, self.zt_v = 30.0, 15.0, 5000.0, 1000.0
        self._tables = None

    def constants_override(self, constants):
        """Reduced-radius sphere: a/X, omega = 0 (SupercellTest.cpp:104)."""
        import dataclasses as _dc
        return _dc.replace(constants,
                           earth_radius=constants.earth_radius / self.x,
                           omega=0.0)

    # -- background profile pieces (f90 :574-680) --
    def _zonal_velocity(self, z, lat):
        u = np.where(
            z <= self.zs_v - self.zt_v, self.us * z / self.zs_v - self.uc,
            np.where(np.abs(z - self.zs_v) <= self.zt_v,
                     (-4.0 / 5.0 + 3.0 * z / self.zs_v
                      - 5.0 / 4.0 * z * z / self.zs_v ** 2) * self.us
                     - self.uc,
                     self.us - self.uc))
        return u * np.cos(lat)

    def _equator_theta(self, z):
        return np.where(
            z <= self.z_tr,
            self.theta0 + (self.theta_tr - self.theta0)
            * (z / self.z_tr) ** 1.25,
            self.theta_tr * np.exp(
                9.80616 / 1004.5 / self.t_tr * (z - self.z_tr)))

    def _equator_rh(self, z):
        return np.where(z <= self.z_tr,
                        1.0 - 0.75 * (z / self.z_tr) ** 1.25, 0.25)

    @staticmethod
    def _qsat(p, t):
        return 380.0 / p * np.exp(17.27 * (t - 273.0) / (t - 36.0))

    def _solve_background(self, constants):
        """Chebyshev collocation thermal-wind solver (f90 :111-347)."""
        from ..ops import quadrature as quad
        c = constants
        nz, nphi = self.NZ_FIT, self.NPHI_FIT
        g, cp, Rd, p0 = c.g, c.Cp, c.Rd, c.P0

        phi = 0.25 * np.pi * (1.0 - np.cos(np.arange(nphi) * np.pi
                                           / (nphi - 1)))
        zc = 0.5 * self.Z2 * (1.0 - np.cos(np.arange(nz) * np.pi
                                           / (nz - 1)))

        ddphi = np.zeros((nphi, nphi))
        for i in range(nphi):
            ddphi[:, i] = quad.lagrange_diff_coeffs(phi, phi[i])
        ddphi[:, -1] = 0.0                     # zero derivative at pole
        ddz = np.zeros((nz, nz))
        for k in range(nz):
            ddz[:, k] = quad.lagrange_diff_coeffs(zc, zc[k])

        intphi = np.linalg.pinv(ddphi.T, rcond=1e-12).T
        intz = np.linalg.pinv(ddz.T, rcond=1e-12).T

        ueq2 = self._zonal_velocity(zc, 0.0) ** 2          # (nz,)
        dueq2 = ddz.T @ ueq2
        thetaeq = self._equator_theta(zc)
        rh = self._equator_rh(zc)

        thetav = np.tile(thetaeq, (nphi, 1))               # (nphi, nz)
        qveq = np.zeros(nz)
        exnereqs = (self.pseq / p0) ** (Rd / cp)
        exnereq = np.zeros(nz)

        # equatorial column iteration
        for _ in range(12):
            rhs = -g / cp / thetav[0]
            exnereq = intz.T @ rhs
            exnereq[1:] += exnereqs - exnereq[0]
            exnereq[0] = exnereqs
            p = p0 * exnereq ** (cp / Rd)
            T = thetaeq * exnereq
            qveq = self._qsat(p, T) * rh
            qveq = np.where(zc <= 1000.0, 0.014, qveq)
            thetav[0] = thetaeq * (1.0 + 0.61 * qveq)

        # full-domain thermal wind iteration
        phimat = np.tile(phi[:, None], (1, nz))
        ueq2m = np.tile(ueq2, (nphi, 1))
        dueq2m = np.tile(dueq2, (nphi, 1))
        for _ in range(12):
            dztheta = thetav @ ddz                          # (nphi, nz)
            rhs = (np.sin(2.0 * phimat) / (2.0 * g)
                   * (ueq2m * dztheta - thetav * dueq2m))
            irhs = intphi.T @ rhs
            irhs[1:] += thetav[0] - irhs[0]
            irhs[0] = thetav[0]
            thetav = irhs

        rhs = -ueq2m * np.sin(phimat) * np.cos(phimat) / cp / thetav
        exner = intphi.T @ rhs
        exner[1:] += exnereq - exner[0]
        exner[0] = exnereq
        return phi, zc, thetav, exner, qveq

    def _sample(self, lon, lat, z, constants, pert):
        """Vectorized sampling of the fitted background (f90 :431-499)."""
        from ..ops import quadrature as quad
        c = constants
        if self._tables is None:
            self._tables = self._solve_background(constants)
        phi, zc, thetavyz, exneryz, qveq = self._tables
        nh_lat = np.abs(lat)

        # Lagrange fits: build coefficient matrices for each unique query
        def fit(nodes, x):
            xf = x.ravel()
            out = np.zeros((len(xf), len(nodes)))
            for i, xv in enumerate(xf):
                out[i] = quad.lagrange_interp_coeffs(nodes, xv)
            return out.reshape(x.shape + (len(nodes),))

        fz = fit(zc, np.broadcast_to(z, np.broadcast_shapes(
            z.shape, nh_lat.shape)).copy())
        fp = fit(phi, np.broadcast_to(nh_lat, fz.shape[:-1]).copy())

        exner = np.einsum("...i,...k,ik->...", fp, fz, exneryz)
        thetav = np.einsum("...i,...k,ik->...", fp, fz, thetavyz)
        q = np.einsum("...k,k->...", fz, qveq)
        p = c.P0 * exner ** (c.Cp / c.Rd)
        rho = p / (c.Rd * exner * thetav)
        if pert:
            gr = c.earth_radius * np.arccos(np.clip(
                np.sin(self.pert_latc) * np.sin(lat)
                + np.cos(self.pert_latc) * np.cos(lat)
                * np.cos(lon - self.pert_lonc), -1, 1))
            rt = np.sqrt((gr / self.pert_rh) ** 2
                         + ((z - self.pert_zc) / self.pert_rz) ** 2)
            dtheta = np.where(rt <= 1.0,
                              self.pert_dtheta
                              * np.cos(0.5 * np.pi * rt) ** 2, 0.0)
            thetav = thetav + dtheta * (1.0 + 0.61 * q)
        p = c.P0 * (rho * c.Rd * thetav / c.P0) ** (c.Cp / (c.Cp - c.Rd))
        return thetav, rho, q, p

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        """Reference-layout state dict of tensors on ``device`` (default
        ``cuda``; raises when absent), with ``"Tracers"``."""
        dev = resolve_device(device)
        lon = np.asarray(geom.lon)[..., None]
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        lonb = np.broadcast_to(lon, z.shape)
        latb = np.broadcast_to(lat, z.shape)
        thetav, rho, q, p = self._sample(lonb, latb, z, constants, self.pert)
        u = self._zonal_velocity(z, latb)
        nz = geom.nz
        U = np.zeros(z.shape)
        V = np.zeros(z.shape)
        vlat = np.zeros(z.shape[:3])
        for k in range(nz):
            U[..., k], V[..., k] = sphere_velocity_to_covariant(
                u[..., k], vlat, geom, constants)
        zq = np.zeros_like(q)
        return _tensors({
            "U": U, "V": V, "Rt": rho * thetav,
            "W": np.zeros(z.shape[:3] + (nz + 1,)), "Rho": rho,
            "Tracers": np.stack([rho * q, zq, zq]),
        }, dtype, dev)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        pert_save = self.pert
        self.pert = False
        try:
            out = self.initial_state(geom, constants, dtype, device)
        finally:
            self.pert = pert_save
        return out
