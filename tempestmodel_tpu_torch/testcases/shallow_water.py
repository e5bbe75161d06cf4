"""Shallow-water sphere test cases.

Counterpart of the JAX package's ``testcases/shallow_water.py``, ports of
the reference's shallow-water test battery (``test/shallowwater_sphere/``):
each case is a pointwise initial/reference state evaluator over (lon, lat)
arrays (host numpy, float64) that gets converted to covariant velocities on
the cubed-sphere grid (the analog of ``GridPatchCSGLL::EvaluateTestCase``,
``src/atm/GridPatchCSGLL.cpp:578+``); ``initial_state`` returns tensors on
an explicit device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..constants import PhysicalConstants
from ..grid import cubed_sphere as cst
from ..grid.geometry import CubedSphereGeometry


def sphere_velocity_to_covariant(ulon, ulat, geom: CubedSphereGeometry,
                                 constants: PhysicalConstants):
    """Convert (ulon, ulat) m/s fields to prognostic covariant components.

    Matches the reference conversion at ``GridPatchCSGLL.cpp:744-752``:
    multiply by the Earth radius, then CoVecTransABPFromRLL per panel.
    """
    alpha = np.asarray(geom.alpha, dtype=np.float64)
    Xn = np.tan(alpha)
    A = len(alpha)
    X = Xn[:, None] * np.ones((1, A))
    Y = np.ones((A, 1)) * Xn[None, :]
    a_r = constants.earth_radius
    U = np.zeros((6, A, A))
    V = np.zeros((6, A, A))
    ulon = np.asarray(ulon, dtype=np.float64)
    ulat = np.asarray(ulat, dtype=np.float64)
    for p in range(6):
        U[p], V[p] = cst.vec_cov_from_sphere(
            X, Y, p, a_r * ulon[p], a_r * ulat[p])
    return U, V


def _state(case, geom, constants, dtype, device):
    """The case's (U, V, H) as tensors of ``dtype`` on ``device``."""
    dev = resolve_device(device)
    ulon, ulat, h = case.evaluate(np.asarray(geom.lon), np.asarray(geom.lat),
                                  constants)
    U, V = sphere_velocity_to_covariant(ulon, ulat, geom, constants)
    return {k: torch.as_tensor(np.asarray(a, np.float64), device=dev)
            .to(dtype) for k, a in (("U", U), ("V", V), ("H", h))}


@dataclasses.dataclass(frozen=True)
class Williamson2:
    """Williamson et al. (1992) TC2: steady geostrophic flow.

    Reference: ``test/shallowwater_sphere/SWTest2.cpp`` (defaults
    u0=38.61068277 m/s, h0=2998.104995 m).
    """
    u0: float = 38.61068277
    h0: float = 2998.104995
    alpha: float = 0.0  # flow inclination (radians)

    def evaluate(self, lon, lat, constants: PhysicalConstants):
        lon = np.asarray(lon)
        lat = np.asarray(lat)
        a = self.alpha
        ulon = self.u0 * np.cos(lat) * (
            np.cos(a) + np.cos(lon) * np.tan(lat) * np.sin(a))
        ulat = -self.u0 * np.sin(lon) * np.sin(a)
        trig = (-np.cos(lon) * np.cos(lat) * np.sin(a)
                + np.sin(lat) * np.cos(a))
        h = self.h0 - (constants.earth_radius * constants.omega
                       + 0.5 * self.u0) * self.u0 * trig * trig / constants.g
        return ulon, ulat, h

    def initial_state(self, geom: CubedSphereGeometry,
                      constants: PhysicalConstants, dtype=torch.float64,
                      device=None):
        """State dict of (6, A, B) tensors on ``device`` (default ``cuda``;
        raises when absent)."""
        return _state(self, geom, constants, dtype, device)

    # TC2 is steady: reference state = initial state
    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class Williamson5:
    """Williamson TC5: zonal flow over an isolated mountain.

    Reference: ``test/shallowwater_sphere/MountainRossbyTest.cpp``.
    """
    u0: float = 20.0
    h0: float = 5960.0
    mountain_height: float = 2000.0
    lon_c: float = 1.5 * np.pi
    lat_c: float = np.pi / 6.0
    radius: float = np.pi / 9.0

    def topography(self, lon, lat):
        r = np.sqrt(np.minimum(
            self.radius ** 2,
            (lon - self.lon_c) ** 2 + (lat - self.lat_c) ** 2))
        return self.mountain_height * (1.0 - r / self.radius)

    def evaluate(self, lon, lat, constants: PhysicalConstants):
        ulon = self.u0 * np.cos(lat)
        ulat = np.zeros_like(lon)
        h = self.h0 - (constants.earth_radius * constants.omega
                       + 0.5 * self.u0) * self.u0 * np.sin(lat) ** 2 \
            / constants.g
        return ulon, ulat, h

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        return _state(self, geom, constants, dtype, device)


@dataclasses.dataclass(frozen=True)
class RossbyHaurwitz:
    """Rossby-Haurwitz wavenumber-4 wave.

    Reference: ``test/shallowwater_sphere/RossbyHaurwitzWaveTest.cpp``.
    """
    omega_w: float = 7.848e-6
    K: float = 7.848e-6
    h0: float = 8000.0
    R: int = 4

    def evaluate(self, lon, lat, constants: PhysicalConstants):
        a = constants.earth_radius
        Om = constants.omega
        w, K, R = self.omega_w, self.K, self.R
        cl = np.cos(lat)
        ulon = a * w * cl + a * K * cl ** (R - 1) * (
            R * np.sin(lat) ** 2 - cl ** 2) * np.cos(R * lon)
        ulat = -a * K * R * cl ** (R - 1) * np.sin(lat) * np.sin(R * lon)
        A = 0.5 * w * (2 * Om + w) * cl ** 2 \
            + 0.25 * K * K * cl ** (2 * R) * (
                (R + 1) * cl ** 2 + (2 * R * R - R - 2)
                - 2.0 * R * R * cl ** (-2))
        B = (2.0 * (Om + w) * K) / ((R + 1) * (R + 2)) * cl ** R * (
            (R * R + 2 * R + 2) - (R + 1) ** 2 * cl ** 2)
        C = 0.25 * K * K * cl ** (2 * R) * ((R + 1) * cl ** 2 - (R + 2))
        g = constants.g
        h = self.h0 + (a * a / g) * (
            A + B * np.cos(R * lon) + C * np.cos(2 * R * lon))
        return ulon, ulat, h

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        return _state(self, geom, constants, dtype, device)


@dataclasses.dataclass(frozen=True)
class ShallowWaterEddy:
    """Shallow-water eddy: rotated symmetric double jet + height bump.

    Reference: ``test/shallowwater_sphere/ShallowWaterEddyTest.cpp`` —
    a Galewsky-style jet evaluated at |lat'| in *rotated* coordinates
    (rotation angle ``alpha``, ``CalculateRLLPrime`` :109-136), so both
    hemispheres carry the jet, with the balanced height integrated
    numerically (:184-246) and a fixed Gaussian perturbation (:253-257).
    """
    u0: float = 80.0
    h0: float = 10158.18617045463179
    lat0: float = np.pi / 7.0
    lat1: float = 0.5 * np.pi - np.pi / 7.0
    alpha: float = 0.0
    h_hat: float = 120.0
    h_phi2: float = np.pi / 4.0
    h_alpha: float = 1.0 / 3.0
    h_beta: float = 1.0 / 15.0

    @staticmethod
    def physical_constants(constants: PhysicalConstants):
        """Coriolis disabled for this test (the reference's
        ``EvaluatePhysicalConstants`` calls ``phys.SetOmega(0.0)``,
        ``ShallowWaterEddyTest.cpp:107-114``); the balanced-height
        integral and the run itself must both use omega = 0."""
        return dataclasses.replace(constants, omega=0.0)

    def _u_jet(self, lat):
        lat = np.abs(lat)
        en = np.exp(-4.0 / (self.lat1 - self.lat0) ** 2)
        with np.errstate(divide="ignore", over="ignore"):
            u = self.u0 / en * np.exp(
                1.0 / ((lat - self.lat0) * (lat - self.lat1)))
        return np.where((lat > self.lat0) & (lat < self.lat1), u, 0.0)

    def _rotate(self, lon, lat):
        """Rotated-frame (lon', lat') (reference ``CalculateRLLPrime``)."""
        a = self.alpha
        if a == 0.0:
            return lon, lat
        latp = np.arcsin(np.sin(lat) * np.cos(a)
                         - np.cos(lat) * np.cos(lon) * np.sin(a))
        lonp = np.arcsin(np.clip(
            np.sin(lon) * np.cos(lat) / np.cos(latp), -1.0, 1.0))
        temp = (np.cos(a) * np.cos(lon) * np.cos(lat)
                + np.sin(a) * np.sin(lat))
        lonp = np.where(temp < 0.0, np.pi - lonp, lonp)
        lonp = np.where(lonp < 0.0, lonp + 2.0 * np.pi, lonp)
        return lonp, latp

    def evaluate(self, lon, lat, constants: PhysicalConstants):
        a_r = constants.earth_radius
        g = constants.g
        Om = constants.omega
        lonp, latp = self._rotate(lon, lat)
        # balanced height: g dh/dphi = -(2 a Om sin(phi) + u tan(phi)) u
        phi = np.linspace(-0.5 * np.pi + 1e-8, 0.5 * np.pi - 1e-8, 40001)
        u = self._u_jet(phi)
        integrand = u * (2.0 * a_r * Om * np.sin(phi) + u * np.tan(phi))
        dphi = phi[1] - phi[0]
        cum = np.concatenate([[0.0], np.cumsum(
            0.5 * (integrand[1:] + integrand[:-1]) * dphi)])
        h = self.h0 - np.interp(latp, phi, cum) / g
        # Gaussian perturbation in *unrotated* coordinates (:248-257)
        lonw = np.where(lon > np.pi, lon - 2.0 * np.pi, lon)
        h = h + self.h_hat * np.cos(lat) \
            * np.exp(-(lonw / self.h_alpha) ** 2) \
            * np.exp(-((self.h_phi2 - lat) / self.h_beta) ** 2)
        # velocity field rotated back to unrotated frame (:262-296)
        up = self._u_jet(latp)
        if self.alpha == 0.0:
            ulon, ulat = up, np.zeros_like(up)
        else:
            coslat = np.maximum(np.cos(lat), 1e-13)
            ulat = -up * np.sin(self.alpha) * np.sin(lonp) / coslat
            coslon = np.cos(lon)
            safe = np.abs(coslon) >= 1e-13
            ulon_reg = (ulat * np.sin(lat) * np.sin(lon)
                        + up * np.cos(lonp)) / np.where(safe, coslon, 1.0)
            ulon_sing = np.where(coslon > 0.0,
                                 -ulat * np.cos(lat) / np.tan(self.alpha),
                                 ulat * np.cos(lat) / np.tan(self.alpha))
            ulon = np.where(safe, ulon_reg, ulon_sing)
        shape = np.broadcast_arrays(lon, lat)[0].shape
        return (np.broadcast_to(ulon, shape).copy(),
                np.broadcast_to(ulat, shape).copy(),
                np.broadcast_to(h, shape).copy())

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        return _state(self, geom, constants, dtype, device)


@dataclasses.dataclass(frozen=True)
class BarotropicInstability:
    """Galewsky et al. (2004) barotropic instability.

    Reference: ``test/shallowwater_sphere/BarotropicInstabilityTest.cpp``.
    Zonal jet at 45N with balanced height + small height perturbation.
    """
    u_max: float = 80.0
    h0: float = 10158.18617045463179
    lat0: float = np.pi / 7.0
    lat1: float = 0.5 * np.pi - np.pi / 7.0
    perturb: bool = True
    h_hat: float = 120.0
    lon2: float = np.pi / 4.0
    beta_p: float = 1.0 / 15.0

    def _u_jet(self, lat):
        en = np.exp(-4.0 / (self.lat1 - self.lat0) ** 2)
        with np.errstate(divide="ignore", over="ignore"):
            u = self.u_max / en * np.exp(
                1.0 / ((lat - self.lat0) * (lat - self.lat1)))
        return np.where((lat > self.lat0) & (lat < self.lat1), u, 0.0)

    def evaluate(self, lon, lat, constants: PhysicalConstants):
        a = constants.earth_radius
        g = constants.g
        Om = constants.omega
        # balanced height by numerical integration of
        # g dh/dphi = -(a f + u tan(phi)) u
        phi = np.linspace(-0.5 * np.pi + 1e-8, 0.5 * np.pi - 1e-8, 20001)
        u = self._u_jet(phi)
        integrand = u * (2.0 * Om * np.sin(phi) + u * np.tan(phi) / a)
        dphi = phi[1] - phi[0]
        cum = np.concatenate([[0.0], np.cumsum(
            0.5 * (integrand[1:] + integrand[:-1]) * dphi)])
        h_prof = self.h0 - (a / g) * cum
        h = np.interp(lat, phi, h_prof)
        ulon = self._u_jet(lat)
        ulat = np.zeros_like(np.broadcast_arrays(lon, lat)[0])
        ulon = np.broadcast_to(ulon, ulat.shape).copy()
        h = np.broadcast_to(h, ulat.shape).copy()
        if self.perturb:
            lonp = np.where(lon > np.pi, lon - 2.0 * np.pi, lon)
            h = h + self.h_hat * np.cos(lat) \
                * np.exp(-((lonp / self.beta_p / np.pi) ** 2)) \
                * np.exp(-(((self.lat1 + self.lat0) / 2.0 - lat)
                           / (self.beta_p * np.pi / 2.0)) ** 2)
        return ulon, ulat, h

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        return _state(self, geom, constants, dtype, device)
