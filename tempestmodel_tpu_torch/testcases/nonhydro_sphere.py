"""Nonhydrostatic sphere test cases.

Counterpart of the JAX package's ``testcases/nonhydro_sphere.py``: the UMJS
baroclinic wave (with its ``apply_perturbation`` for ``--perturb_restart``),
the Jablonowski-Williamson wave, the Held-Suarez start, the DCMIP
inertia-gravity waves and Schar mountain on reduced planets, the
mountain-wave, stationary-mountain and mountain-Rossby cases and the
Baldauf gravity wave.  Fields are computed host-side in numpy float64; the
last step builds tensors on the requested device.

As in the JAX package, the cases on a reduced or non-rotating planet give
their constants through ``constants(base)``, which the caller passes to the
configuration (``ModelConfig(constants=tc.constants(PhysicalConstants()))``),
and a ``topography(lon, lat, c)`` that needs the constants is handed to the
geometry as ``lambda lon, lat: tc.topography(lon, lat, c)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device, np_dtype

from ..constants import PhysicalConstants
from ..grid.geometry import CubedSphereGeometry
from .shallow_water import sphere_velocity_to_covariant


@dataclasses.dataclass(frozen=True)
class BaroclinicWaveUMJS:
    """Ullrich-Melvin-Jablonowski-Staniforth moist-free baroclinic wave.

    Reference: ``test/nonhydro_sphere/BaroclinicWaveUMJSTest.cpp`` (shallow
    atmosphere, exponential zonal-wind perturbation ``--pert Exp``).
    """
    t0e: float = 310.0
    t0p: float = 240.0
    b: float = 2.0
    k: float = 3.0
    lapse: float = 0.005
    pert: str = "none"          # "none" | "exp"
    up: float = 1.0             # exp perturbation amplitude (m/s)
    pert_exp_r: float = 0.1     # great-circle radius (Earth radii)
    pert_lon: float = np.pi / 9.0
    pert_lat: float = 2.0 * np.pi / 9.0
    pert_z: float = 15000.0
    ztop: float = 30000.0
    rayleigh: bool = False

    def _background(self, z, lat, constants: PhysicalConstants):
        """(temperature, pressure, ulon) of the balanced background."""
        c = constants
        t0 = 0.5 * (self.t0e + self.t0p)
        ca = 1.0 / self.lapse
        cb = (t0 - self.t0p) / (t0 * self.t0p)
        cc = 0.5 * (self.k + 2.0) * (self.t0e - self.t0p) / (
            self.t0e * self.t0p)
        h = c.Rd * t0 / c.g
        sz = z / (self.b * h)
        e = np.exp(-sz * sz)
        tau1 = (ca * self.lapse / t0 * np.exp(self.lapse / t0 * z)
                + cb * (1.0 - 2.0 * sz * sz) * e)
        tau2 = cc * (1.0 - 2.0 * sz * sz) * e
        itau1 = ca * (np.exp(self.lapse / t0 * z) - 1.0) + cb * z * e
        itau2 = cc * z * e

        cl = np.cos(lat)
        interior = cl ** self.k - self.k / (self.k + 2.0) * cl ** (self.k + 2)
        temp = 1.0 / (tau1 - tau2 * interior)
        pres = c.P0 * np.exp(-c.g / c.Rd * (itau1 - itau2 * interior))

        interior_u = cl ** (self.k - 1.0) - cl ** (self.k + 1.0)
        big_u = c.g / c.earth_radius * self.k * itau2 * interior_u * temp
        rcl = c.earth_radius * cl
        orcl = c.omega * rcl
        ulon = -orcl + np.sqrt(np.maximum(orcl * orcl + rcl * big_u, 0.0))
        return temp, pres, ulon

    def _perturbation_ulon(self, z, lon, lat):
        if self.pert != "exp":
            return np.zeros_like(z)
        gcr = np.arccos(np.clip(
            np.sin(self.pert_lat) * np.sin(lat)
            + np.cos(self.pert_lat) * np.cos(lat) * np.cos(lon - self.pert_lon),
            -1.0, 1.0)) / self.pert_exp_r
        taper = np.where(
            z < self.pert_z,
            1.0 - 3.0 * (z / self.pert_z) ** 2 + 2.0 * (z / self.pert_z) ** 3,
            0.0)
        return np.where(gcr < 1.0, self.up * taper * np.exp(-gcr * gcr), 0.0)

    def _fields(self, geom: CubedSphereGeometry,
                constants: PhysicalConstants, with_pert: bool):
        c = constants
        lon = np.asarray(geom.lon)[..., None]
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        temp, pres, ulon = self._background(z, lat, c)
        if with_pert:
            ulon = ulon + self._perturbation_ulon(z, lon, lat)
        rho = pres / (c.Rd * temp)
        # host-side numpy rhotheta_from_pressure (PhysicalConstants.h:394)
        rt = np.exp(np.log(pres / c.pressure_scaling) / c.gamma)
        return ulon, rho, rt

    def initial_state(self, geom: CubedSphereGeometry,
                      constants: PhysicalConstants, dtype=torch.float64,
                      device=None):
        """Reference-layout state dict of tensors on ``device`` (default
        ``cuda``; raises when absent)."""
        return self._state(geom, constants, dtype, device, with_pert=True)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        return self._state(geom, constants, dtype, device, with_pert=False)

    def _state(self, geom, constants, dtype, device, with_pert):
        ulon, rho, rt = self._fields(geom, constants, with_pert=with_pert)
        return _sphere_state(geom, constants, ulon, rho, rt, dtype, device)

    def apply_perturbation(self, state, geom, constants):
        """Add the exp zonal-wind perturbation to an existing state (tensors;
        a new dict).

        Analog of ``EvaluatePointwisePerturbation`` +
        ``Grid::EvaluateTestCase_Perturbation`` (``Grid.cpp:426``,
        ``GridPatchCSGLL.cpp:924-1040``): the pointwise perturbation is
        *added* to the restored state (the ``--perturb_restart`` path,
        ``Model.cpp:250-257``).
        """
        lon = np.asarray(geom.lon)[..., None]
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        dulon = self._perturbation_ulon(z, lon, lat) \
            + np.zeros_like(z)                  # broadcast to full shape
        nz = geom.nz
        dU = np.zeros(dulon.shape)
        dV = np.zeros(dulon.shape)
        zeros = np.zeros(dulon.shape[:3])
        for kk in range(nz):
            dU[..., kk], dV[..., kk] = sphere_velocity_to_covariant(
                dulon[..., kk], zeros, geom, constants)
        out = dict(state)
        for k, dk in (("U", dU), ("V", dV)):
            f = state[k]
            out[k] = f + torch.as_tensor(dk, device=f.device).to(f.dtype)
        return out

    def rayleigh_strength(self, z):
        """Rayleigh damping profile (reference ``:205-221``):
        nu = 0.5 * strength * (1 + cos(pi * (ztop - z)/depth)) in the top
        ``depth`` meters."""
        strength = 5.0e-1
        depth = 8000.0
        normz = (self.ztop - z) / depth
        return np.where(z > self.ztop - depth,
                        0.5 * strength * (1.0 + np.cos(np.pi * normz)),
                        0.0)


# ---------------------------------------------------------------------------
# shared state assembly


def _sphere_state(geom, constants, ulon, rho, rt, dtype, device,
                  ulat=None):
    """Assemble the 5-component NH state dict from level fields, as tensors
    of ``dtype`` on ``device`` (default ``cuda``; raises when absent).

    ``ulon``/``rho``/``rt`` broadcastable to (6, A, B, nz); velocities in
    m/s are converted to prognostic covariant components per level
    (``GridPatchCSGLL.cpp:744-752``) in numpy float64 on the host.
    """
    dev = resolve_device(device)
    npdt = np_dtype(dtype)
    nz = geom.nz
    shape = np.broadcast_shapes(np.shape(rho), np.shape(rt))
    rho = np.broadcast_to(rho, shape)
    rt = np.broadcast_to(rt, shape)
    ulon = np.broadcast_to(ulon, shape)
    ulat = np.zeros(shape) if ulat is None else np.broadcast_to(ulat, shape)
    U = np.zeros(shape)
    V = np.zeros(shape)
    for kk in range(nz):
        U[..., kk], V[..., kk] = sphere_velocity_to_covariant(
            ulon[..., kk], ulat[..., kk], geom, constants)
    w = np.zeros(shape[:3] + (nz + 1,))
    fields = {"U": U, "V": V, "Rt": rt, "W": w, "Rho": rho}
    # np.array copies: a broadcast field is a read-only view
    return {k: torch.as_tensor(np.array(f, dtype=npdt), device=dev)
            for k, f in fields.items()}


def _gcd(lon, lat, lonc, latc):
    """Great-circle angular distance from (lonc, latc), radians."""
    return np.arccos(np.clip(
        np.sin(latc) * np.sin(lat)
        + np.cos(latc) * np.cos(lat) * np.cos(lon - lonc), -1.0, 1.0))


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BaroclinicWaveJW:
    """Jablonowski-Williamson (2006) baroclinic wave.

    Reference: ``test/nonhydro_sphere/BaroclinicWaveJWTest.cpp:20-240``
    (eta-coordinate balanced state inverted to z by Newton iteration,
    ``EtaFromRLL`` at ``:181-218``; exp zonal-wind perturbation).
    """
    eta0: float = 0.252
    etat: float = 0.2           # tropopause eta
    t0: float = 288.0
    delta_t: float = 4.8e5
    lapse: float = 0.005
    u0: float = 35.0
    up: float = 1.0
    pert_lon: float = np.pi / 9.0
    pert_lat: float = 2.0 * np.pi / 9.0
    pert_r: float = 0.1
    pert: str = "none"          # "none" | "exp"
    ztop: float = 10000.0

    def _profiles(self, eta, lat, c: PhysicalConstants):
        """(geopotential, temperature) at (eta, lat).

        Reference ``CalculateGeopotentialTemperature`` (:110-180).
        """
        aux = 0.5 * np.pi * (eta - self.eta0)
        ex = c.Rd * self.lapse / c.g
        avg_t = self.t0 * eta ** ex + np.where(
            eta < self.etat,
            self.delta_t * np.maximum(self.etat - eta, 0.0) ** 5, 0.0)
        s, cl = np.sin(lat), np.cos(lat)
        r1 = self.u0 * np.cos(aux) ** 1.5 * (
            -2.0 * s ** 6 * (cl ** 2 + 1.0 / 3.0) + 10.0 / 63.0)
        r2 = c.earth_radius * c.omega * (
            1.6 * cl ** 3 * (s ** 2 + 2.0 / 3.0) - 0.25 * np.pi)
        temp = avg_t + 0.75 * eta * np.pi * self.u0 / c.Rd * np.sin(aux) \
            * np.sqrt(np.cos(aux)) * (2.0 * r1 + r2)
        avg_g = self.t0 * c.g / self.lapse * (1.0 - eta ** ex)
        et = self.etat
        corr = c.Rd * self.delta_t * (
            (np.log(eta / et) + 137.0 / 60.0) * et ** 5
            - 5.0 * et ** 4 * eta + 5.0 * et ** 3 * eta ** 2
            - 10.0 / 3.0 * et ** 2 * eta ** 3
            + 1.25 * et * eta ** 4 - 0.2 * eta ** 5)
        avg_g = avg_g - np.where(eta < et, corr, 0.0)
        geo = avg_g + self.u0 * np.cos(aux) ** 1.5 * (r1 + r2)
        return geo, temp

    def topography(self, lon, lat, c: PhysicalConstants):
        """Surface geopotential / g (reference ``EvaluateTopography``)."""
        geo, _ = self._profiles(np.ones_like(lat), lat, c)
        return geo / c.g

    def _eta_from_z(self, z, lat, c: PhysicalConstants, iters: int = 30):
        eta = np.full(np.broadcast_shapes(np.shape(z), np.shape(lat)), 1e-7)
        for _ in range(iters):
            geo, temp = self._profiles(eta, lat, c)
            f = -c.g * z + geo
            eta = eta - f / (-c.Rd / eta * temp)
        return np.clip(eta, 1e-9, 1.2)

    def _fields(self, geom, c: PhysicalConstants, with_pert: bool):
        lon = np.asarray(geom.lon)[..., None]
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        eta = self._eta_from_z(z, lat, c)
        _, temp = self._profiles(eta, lat, c)
        ulon = self.u0 * np.cos(
            0.5 * np.pi * (eta - self.eta0)) ** 1.5 * np.sin(2.0 * lat) ** 2
        if with_pert and self.pert == "exp":
            gcr = _gcd(lon, lat, self.pert_lon, self.pert_lat) / self.pert_r
            ulon = ulon + np.where(
                gcr < 1.0, self.up * np.exp(-gcr ** 2), 0.0)
        pres = c.P0 * eta
        rho = pres / (c.Rd * temp)
        rt = np.exp(np.log(pres / c.pressure_scaling) / c.gamma)
        return ulon, rho, rt

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        ulon, rho, rt = self._fields(geom, constants, with_pert=True)
        return _sphere_state(geom, constants, ulon, rho, rt, dtype, device)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        ulon, rho, rt = self._fields(geom, constants, with_pert=False)
        return _sphere_state(geom, constants, ulon, rho, rt, dtype, device)


@dataclasses.dataclass(frozen=True)
class HeldSuarezIC:
    """Held-Suarez initial condition: isothermal rest + random U/V noise.

    Reference: ``test/nonhydro_sphere/HeldSuarezTest.cpp`` (T0=280,
    1e-3-amplitude random wind perturbation to break zonal symmetry).
    """
    t0: float = 280.0
    ztop: float = 30000.0
    seed: int = 0

    def _fields(self, geom, c: PhysicalConstants):
        z = np.asarray(geom.z_lev)
        h = c.Rd * self.t0 / c.g
        pres = c.P0 * np.exp(-z / h)
        rho = pres / (c.g * h)
        rt = np.exp(np.log(pres / c.pressure_scaling) / c.gamma)
        return rho, rt

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        rho, rt = self._fields(geom, constants)
        rng = np.random.default_rng(self.seed)
        ulon = 1.0e-3 * rng.random(rho.shape)
        ulat = 1.0e-3 * rng.random(rho.shape)
        return _sphere_state(geom, constants, ulon, rho, rt, dtype, device,
                             ulat=ulat)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        rho, rt = self._fields(geom, constants)
        return _sphere_state(geom, constants, 0.0, rho, rt, dtype, device)


@dataclasses.dataclass(frozen=True)
class InertiaGravityWaveSphere:
    """DCMIP 2012 test 3-0-0: non-hydrostatic inertia-gravity waves on a
    reduced-size planet.

    Reference: ``test/nonhydro_sphere/InertiaGravityWaveTest.cpp:24-238``
    (X=125 small planet, N=0.01 stratification, theta perturbation with
    vertical wavelength Lz).
    """
    x_scale: float = 125.0
    omega0: float = 0.0
    u0: float = 20.0
    n_freq: float = 0.01
    teq: float = 300.0
    pert_width: float = 5000.0
    pert_lon: float = 120.0 * np.pi / 180.0
    pert_lat: float = 0.0
    pert_mag: float = 1.0
    pert_lz: float = 20000.0
    ztop: float = 10000.0

    def constants(self, base: PhysicalConstants) -> PhysicalConstants:
        """Reduced-planet constants (``EvaluatePhysicalConstants``)."""
        return dataclasses.replace(
            base, omega=self.omega0 * self.x_scale,
            earth_radius=base.earth_radius / self.x_scale)

    def _fields(self, geom, c: PhysicalConstants, with_pert: bool):
        lon = np.asarray(geom.lon)[..., None]
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        n2 = self.n_freq ** 2
        big_g = c.g * c.g / (n2 * c.Cp)
        ts = big_g + (self.teq - big_g) * np.exp(
            -self.u0 * n2 / (4.0 * c.g * c.g)
            * (self.u0 + 2.0 * c.omega * c.earth_radius)
            * (np.cos(2.0 * lat) - 1.0))
        temp = big_g + (ts - big_g) * np.exp(n2 * z / c.g)
        ps = c.P0 * np.exp(
            self.u0 / (4.0 * big_g * c.Rd)
            * (self.u0 + 2.0 * c.omega * c.earth_radius)
            * (np.cos(2.0 * lat) - 1.0)) \
            * (ts / self.teq) ** (1.0 / c.kappa)
        pres = ps * (big_g / ts * np.exp(-n2 * z / c.g)
                     + 1.0 - big_g / ts) ** (1.0 / c.kappa)
        rho = pres / (c.Rd * temp)
        theta = np.exp(np.log(pres / c.pressure_scaling) / c.gamma) / rho
        if with_pert:
            s = self.pert_width ** 2 / (
                self.pert_width ** 2
                + (c.earth_radius * _gcd(lon, lat, self.pert_lon,
                                         self.pert_lat)) ** 2)
            theta = theta + self.pert_mag * s * np.sin(
                2.0 * np.pi * z / self.pert_lz)
        ulon = self.u0 * np.cos(lat) * np.ones_like(theta)
        return ulon, rho, rho * theta

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        ulon, rho, rt = self._fields(geom, constants, with_pert=True)
        return _sphere_state(geom, constants, ulon, rho, rt, dtype, device)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        ulon, rho, rt = self._fields(geom, constants, with_pert=False)
        return _sphere_state(geom, constants, ulon, rho, rt, dtype, device)


@dataclasses.dataclass(frozen=True)
class MountainWaveSphere:
    """Mountain waves on the sphere over a wavenumber-6 ridge.

    Reference: ``test/nonhydro_sphere/MountainWaveSphereTest.cpp:23-215``
    (isothermal balanced zonal flow; topography 10*sin(6*lon)*cos^2(lat)).
    """
    t0: float = 300.0
    u0: float = 20.0
    no_rotation: bool = False
    mountain: str = "wave6"     # "none" | "wave6"
    ztop: float = 10000.0

    def constants(self, base: PhysicalConstants) -> PhysicalConstants:
        return dataclasses.replace(base, omega=0.0) if self.no_rotation \
            else base

    def topography(self, lon, lat, c: PhysicalConstants = None):
        if self.mountain == "none":
            return np.zeros_like(lon)
        return 10.0 * np.sin(6.0 * lon) * np.cos(lat) ** 2

    def rayleigh_strength(self, z):
        strength, depth = 8.0e-3, 6000.0
        return np.where(z > self.ztop - depth,
                        0.5 * strength * (1.0 + np.cos(
                            np.pi * (self.ztop - z) / depth)), 0.0)

    def _fields(self, geom, c: PhysicalConstants):
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        h = c.Rd * self.t0 / c.g
        fr2 = self.u0 ** 2 / (c.g * h)
        inv_ro = 2.0 * c.earth_radius * c.omega / self.u0
        pres = c.P0 * np.exp(-z / h) * np.exp(
            -0.5 * fr2 * (1.0 + inv_ro) * np.sin(lat) ** 2)
        rho = pres / (c.g * h)
        rt = np.exp(np.log(pres / c.pressure_scaling) / c.gamma)
        ulon = self.u0 * np.cos(lat) * np.ones_like(rho)
        return ulon, rho, rt

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        ulon, rho, rt = self._fields(geom, constants)
        return _sphere_state(geom, constants, ulon, rho, rt, dtype, device)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class ScharMountainSphere:
    """DCMIP 2012 test 2-x: Schar-type mountain waves on a reduced planet.

    Reference: ``test/nonhydro_sphere/ScharMountainSphereTest.cpp:23-270``
    (X=500 small planet, optionally sheared flow cs=2.5e-4, Schar
    cos^2*Gaussian topography, sin^2 Rayleigh layer above zh).
    """
    x_scale: float = 500.0
    omega0: float = 0.0
    lonc: float = 45.0 * np.pi / 180.0
    latc: float = 0.0
    h0: float = 250.0
    d: float = 5000.0
    xi: float = 4000.0
    teq: float = 300.0
    ueq: float = 20.0
    cs: float = 0.0             # 2.5e-4 for sheared flow
    zh: float = 20000.0
    tau0: float = 25.0
    ztop: float = 30000.0

    def constants(self, base: PhysicalConstants) -> PhysicalConstants:
        return dataclasses.replace(
            base, omega=self.omega0 * self.x_scale,
            earth_radius=base.earth_radius / self.x_scale)

    def topography(self, lon, lat, c: PhysicalConstants):
        r = c.earth_radius * _gcd(lon, lat, self.lonc, self.latc)
        return (self.h0 * np.exp(-(r / self.d) ** 2)
                * np.cos(np.pi * r / self.xi) ** 2)

    def rayleigh_strength(self, z):
        nu = np.where(z > self.zh,
                      np.sin(0.5 * np.pi * (z - self.zh)
                             / (self.ztop - self.zh)) ** 2, 0.0)
        return nu / self.tau0

    def _fields(self, geom, c: PhysicalConstants):
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        s2 = np.sin(lat) ** 2
        temp = self.teq * (1.0 - self.cs * self.ueq ** 2 / c.g * s2)
        pres = c.P0 * np.exp(
            -self.ueq ** 2 / (2.0 * c.Rd * self.teq) * s2
            - c.g * z / (c.Rd * temp))
        rho = pres / (c.Rd * temp)
        ulon = self.ueq * np.cos(lat) * np.sqrt(
            2.0 * self.teq / temp * self.cs * z + temp / self.teq)
        rt = np.exp(np.log(pres / c.pressure_scaling) / c.gamma)
        return ulon, rho, rt

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        ulon, rho, rt = self._fields(geom, constants)
        return _sphere_state(geom, constants, ulon, rho, rt, dtype, device)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class StationaryMountainFlow:
    """Stationary atmosphere over a cos^2 bell mountain (discrete balance
    test: any motion is numerical error).

    Reference: ``test/nonhydro_sphere/StationaryMountainFlowTest.cpp``
    (constant-lapse-rate rest state, h0=2000 m mountain at 270E).
    """
    t0: float = 300.0
    gamma_lapse: float = 0.0065
    lonm: float = 270.0 * np.pi / 180.0
    latm: float = 0.0
    h0: float = 2000.0
    rm: float = 135.0 * np.pi / 180.0
    zetam: float = 11.25 * np.pi / 180.0
    omega0: float = 0.0
    ztop: float = 30000.0

    def constants(self, base: PhysicalConstants) -> PhysicalConstants:
        return dataclasses.replace(base, omega=self.omega0)

    def topography(self, lon, lat, c: PhysicalConstants = None):
        r = _gcd(lon, lat, self.lonm, self.latm)
        bell = np.where(r < self.rm,
                        0.5 * (1.0 + np.cos(np.pi * r / self.rm)), 0.0)
        return self.h0 * bell * np.cos(np.pi * r / self.zetam) ** 2

    def _fields(self, geom, c: PhysicalConstants):
        z = np.asarray(geom.z_lev)
        temp = self.t0 - self.gamma_lapse * z
        pres = c.P0 * (1.0 - self.gamma_lapse / self.t0 * z) ** (
            c.g / (c.Rd * self.gamma_lapse))
        rho = pres / (c.Rd * temp)
        rt = np.exp(np.log(pres / c.pressure_scaling) / c.gamma)
        shape = np.broadcast_shapes(rho.shape, geom.lat.shape + (geom.nz,))
        return np.broadcast_to(rho, shape), np.broadcast_to(rt, shape)

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        rho, rt = self._fields(geom, constants)
        return _sphere_state(geom, constants, 0.0, rho, rt, dtype, device)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class MountainRossby3D:
    """3-D mountain-induced Rossby wave train (isothermal flow over a
    Gaussian mountain at 30N).

    Reference: ``test/nonhydro_sphere/MountainRossby3DTest.cpp``
    (T0=288, u0=20, pp=93000 Pa, h0=2000 m, d=1.5e6 m).
    """
    lonc: float = 90.0 * np.pi / 180.0
    latc: float = 30.0 * np.pi / 180.0
    h0: float = 2000.0
    d: float = 1.5e6
    pp: float = 93000.0
    t0: float = 288.0
    u0: float = 20.0
    use_rayleigh: bool = True
    ztop: float = 30000.0

    def topography(self, lon, lat, c: PhysicalConstants):
        r = c.earth_radius * _gcd(lon, lat, self.lonc, self.latc)
        return self.h0 * np.exp(-(r / self.d) ** 2)

    def rayleigh_strength(self, z):
        if not self.use_rayleigh:
            return np.zeros_like(z)
        strength, depth = 4.0e-3, 10000.0
        return np.where(z > self.ztop - depth,
                        0.5 * strength * (1.0 + np.cos(
                            np.pi * (self.ztop - z) / depth)), 0.0)

    def _fields(self, geom, c: PhysicalConstants):
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        s2 = np.sin(lat) ** 2
        pres = self.pp * np.exp(
            -self.u0 / (2.0 * c.Rd * self.t0) * (s2 - 1.0)
            * (self.u0 + 2.0 * c.omega * c.earth_radius)
            - c.g * z / (c.Rd * self.t0))
        rho = pres / (c.Rd * self.t0)
        rt = np.exp(np.log(pres / c.pressure_scaling) / c.gamma)
        ulon = self.u0 * np.cos(lat) * np.ones_like(rho)
        return ulon, rho, rt

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        ulon, rho, rt = self._fields(geom, constants)
        return _sphere_state(geom, constants, ulon, rho, rt, dtype, device)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class BaldaufGravityWave:
    """Baldauf & Brdar (2013) inertia-gravity wave (modified), small planet.

    Reference: ``test/nonhydro_sphere/BaldaufGravityWaveTest.cpp:23-190``
    (isothermal rest state, T perturbation exp(-100*lat^2)*sin(pi z/H)).
    """
    t0: float = 300.0
    pert_mag: float = 1.0
    radius_scale: float = 1.0
    ztop: float = 10000.0

    def constants(self, base: PhysicalConstants) -> PhysicalConstants:
        return dataclasses.replace(
            base, omega=0.0,
            earth_radius=base.earth_radius / self.radius_scale)

    def _fields(self, geom, c: PhysicalConstants, with_pert: bool):
        lat = np.asarray(geom.lat)[..., None]
        z = np.asarray(geom.z_lev)
        pres = c.P0 * np.exp(-c.g * z / (c.Rd * self.t0))
        temp = self.t0 * np.ones(np.broadcast_shapes(
            pres.shape, lat.shape[:3] + (geom.nz,)))
        pres = np.broadcast_to(pres, temp.shape)
        if with_pert:
            temp = temp + self.pert_mag * np.exp(-100.0 * lat ** 2) \
                * np.sin(np.pi * z / self.ztop)
        rho = pres / (c.Rd * temp)
        rt = np.exp(np.log(pres / c.pressure_scaling) / c.gamma)
        return rho, np.broadcast_to(rt, temp.shape)

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        rho, rt = self._fields(geom, constants, with_pert=True)
        return _sphere_state(geom, constants, 0.0, rho, rt, dtype, device)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        rho, rt = self._fields(geom, constants, with_pert=False)
        return _sphere_state(geom, constants, 0.0, rho, rt, dtype, device)
