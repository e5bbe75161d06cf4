"""Cartesian nonhydrostatic test cases (x-z slices and the 3-D plane).

Counterpart of the JAX package's ``testcases/nonhydro_xz.py``: pointwise
initial and reference states over (x[, y], z) in numpy float64, turned into
the prognostic state dict (U, V, Rt, W, Rho) with Lorenz staggering; the last
step builds tensors on the requested device.  Ported: the periodic cases
(the thermal and Robert bubbles, the Schar, hydrostatic, non-hydrostatic
and shear-jet mountain waves, the inertia-gravity waves, the 3-D thermal
bubble); the density current and the baroclinic channel need no-flux
lateral boundaries and wait in the roadmap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device, np_dtype
from ..constants import PhysicalConstants
from ..grid.cartesian import CartesianGeometry


def _state_dict(geom: CartesianGeometry, theta_lev, rho_lev, u_lev=None,
                dtype=torch.float64, device=None, rt_int=None,
                w_on_levels=False):
    """Assemble the staggered state from level fields (W = 0), as tensors
    of ``dtype`` on ``device`` (default ``cuda``; raises when absent).

    ``rt_int``: Charney-Phillips initialization -- RhoTheta evaluated on
    interfaces replaces the level Rt (``--vstagger CPH``).
    ``w_on_levels``: LEV staggering -- W lives on the nz model levels.
    """
    dev = resolve_device(device)
    npdt = np_dtype(dtype)
    shape = np.asarray(geom.z_lev).shape
    zeros = np.zeros(shape)
    u = zeros if u_lev is None else np.broadcast_to(u_lev, shape)
    rt = rho_lev * theta_lev if rt_int is None else rt_int
    nw = geom.nz if w_on_levels else geom.nz + 1
    w = np.zeros(shape[:3] + (nw,))
    fields = {"U": u, "V": zeros, "Rt": rt, "W": w, "Rho": rho_lev}
    # np.array copies: a broadcast field is a read-only view
    return {k: torch.as_tensor(np.array(f, dtype=npdt), device=dev)
            for k, f in fields.items()}


@dataclasses.dataclass(frozen=True)
class ThermalBubble:
    """Giraldo et al. (2007) rising thermal bubble.

    Reference: ``test/nonhydro_xz/ThermalBubbleCartesianTest.cpp`` (defaults
    ThetaBar=300, ThetaC=0.5, rC=250, xC=500, zC=350; domain [0,1000]^2 m,
    36x1 elements, 72 levels).
    """
    theta_bar: float = 300.0
    theta_c: float = 0.5
    r_c: float = 250.0
    x_c: float = 500.0
    z_c: float = 350.0

    x_extent = (0.0, 1000.0)
    y_extent = (-500.0, 500.0)
    ztop = 1000.0

    def theta_perturbation(self, x, z):
        r = np.sqrt((x - self.x_c) ** 2 + (z - self.z_c) ** 2)
        return np.where(
            r <= self.r_c,
            0.5 * self.theta_c * (1.0 + np.cos(np.pi * r / self.r_c)),
            0.0)

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        exner = 1.0 - c.g / (c.Cp * self.theta_bar) * z
        rho = c.P0 / (c.Rd * self.theta_bar) * exner ** (c.Cv / c.Rd)
        return rho

    def initial_state(self, geom: CartesianGeometry,
                      constants: PhysicalConstants, dtype=torch.float64,
                      device=None):
        z = np.asarray(geom.z_lev)
        x = np.asarray(geom.x)[None, :, None, None]
        theta = self.theta_bar + self.theta_perturbation(
            np.broadcast_to(x, z.shape), z)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype,
                           device=device)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        z = np.asarray(geom.z_lev)
        theta = np.full(z.shape, self.theta_bar)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype,
                           device=device)


@dataclasses.dataclass(frozen=True)
class ScharMountain:
    """Schar et al. (2002) mountain waves over terrain.

    Reference: ``test/nonhydro_xz/ScharMountainCartesianTest.cpp``
    (u0=10, Nbar=0.01, Theta0=280, hC=250, aC=5000, lC=4000; domain
    [-25 km, 25 km] x [0, 21 km]).  Exercises the terrain-following metric.
    """
    u0: float = 10.0
    n_bar: float = 0.01
    theta_0: float = 280.0
    h_c: float = 250.0
    a_c: float = 5000.0
    l_c: float = 4000.0
    rayleigh: bool = True

    x_extent = (-25000.0, 25000.0)
    y_extent = (-200.0, 200.0)
    ztop = 21000.0

    def topography(self, x, y):
        return (self.h_c * np.exp(-(x / self.a_c) ** 2)
                * np.cos(np.pi * x / self.l_c) ** 2)

    def rayleigh_strength(self, z, x=None, y=None):
        strength = 5.0e-3
        depth, width = 5000.0, 5000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if x is not None:
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x - x0) / width)), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        n2 = self.n_bar ** 2
        theta = self.theta_0 * np.exp(n2 / c.g * z)
        exner = 1.0 + c.g * c.g / (c.Cp * self.theta_0 * n2) * (
            np.exp(-n2 / c.g * z) - 1.0)
        rho = c.P0 / (c.Rd * theta) * exner ** (c.Cv / c.Rd)
        return theta, rho

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        z = np.asarray(geom.z_lev, np.float64)
        theta, rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, u_lev=self.u0, dtype=dtype,
                           device=device)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class InertiaGravityWave:
    """Skamarock-Klemp (1994) inertia-gravity waves in a channel.

    Reference: ``test/nonhydro_xz/InertiaGravityCartesianXZTest.cpp``:
    isothermal-N background (N = 0.01 1/s), theta perturbation of width a,
    uniform U0 = 20 m/s; domain 300 km x 10 km.
    """
    n_bar: float = 0.01
    theta_0: float = 300.0
    theta_c: float = 1.0        # reference CLI default (ThetaC)
    h_c: float = 10000.0
    a_c: float = 5000.0
    x_c: float = 100000.0
    u0: float = 20.0

    x_extent = (0.0, 300000.0)
    y_extent = (-100000.0, 100000.0)
    ztop = 10000.0

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        n2 = self.n_bar ** 2
        theta = self.theta_0 * np.exp(n2 / c.g * z)
        exner = 1.0 + c.g * c.g / (c.Cp * self.theta_0 * n2) * (
            np.exp(-n2 / c.g * z) - 1.0)
        rho = c.P0 / (c.Rd * theta) * exner ** (c.Cv / c.Rd)
        return theta, rho

    def theta_perturbation(self, x, z):
        return self.theta_c * np.sin(np.pi * z / self.h_c) / (
            1.0 + ((x - self.x_c) / self.a_c) ** 2)

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None, stagger="LOR"):
        z = np.asarray(geom.z_lev, np.float64)
        x = np.broadcast_to(np.asarray(geom.x, np.float64)[None, :, None, None],
                            z.shape)
        theta_b, rho = self._background(z, constants)
        theta = theta_b + self.theta_perturbation(x, z)
        rt_int = None
        if stagger == "CPH":
            zi = np.asarray(geom.z_int, np.float64)
            xi = np.broadcast_to(
                np.asarray(geom.x, np.float64)[None, :, None, None], zi.shape)
            theta_bi, rho_i = self._background(zi, constants)
            rt_int = rho_i * (theta_bi + self.theta_perturbation(xi, zi))
        return _state_dict(geom, theta, rho, u_lev=self.u0, dtype=dtype,
                           device=device, rt_int=rt_int,
                           w_on_levels=(stagger in ("LEV", "INT")))

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        z = np.asarray(geom.z_lev, np.float64)
        theta_b, rho = self._background(z, constants)
        return _state_dict(geom, theta_b, rho, u_lev=self.u0, dtype=dtype,
                           device=device)


@dataclasses.dataclass(frozen=True)
class RobertBubble:
    """Robert (1993) rising thermal bubble.

    Reference: ``test/nonhydro_xz/RobertBubbleCartesianTest.cpp`` (defaults
    ThetaBar=300, ThetaC=0.5, rC=250, xC=500, zC=260; domain
    [0,1000] x [0,1500] m, all-periodic lateral BCs).
    """
    theta_bar: float = 300.0
    theta_c: float = 0.5
    r_c: float = 250.0
    x_c: float = 500.0
    z_c: float = 260.0

    x_extent = (0.0, 1000.0)
    y_extent = (-5.0, 5.0)
    ztop = 1500.0

    def theta_perturbation(self, x, z):
        r = np.sqrt((x - self.x_c) ** 2 + (z - self.z_c) ** 2)
        return np.where(
            r <= self.r_c,
            0.5 * self.theta_c * (1.0 + np.cos(np.pi * r / self.r_c)), 0.0)

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        exner = 1.0 - c.g / (c.Cp * self.theta_bar) * z
        return c.P0 / (c.Rd * self.theta_bar) * exner ** (c.Cv / c.Rd)

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        z = np.asarray(geom.z_lev)
        x = np.broadcast_to(np.asarray(geom.x)[None, :, None, None], z.shape)
        theta = self.theta_bar + self.theta_perturbation(x, z)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype,
                           device=device)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        z = np.asarray(geom.z_lev)
        theta = np.full(z.shape, self.theta_bar)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype,
                           device=device)


@dataclasses.dataclass(frozen=True)
class ThermalBubble3D:
    """3-D rising thermal bubble (spherical perturbation).

    Reference: ``test/nonhydro_xz/ThermalBubbleCartesian3DTest.cpp``
    (ThetaBar=300, ThetaC=0.5, rC=250, center (500,500,350); domain
    [0,1000]^3 m, all-periodic lateral BCs).
    """
    theta_bar: float = 300.0
    theta_c: float = 0.5
    r_c: float = 250.0
    x_c: float = 500.0
    y_c: float = 500.0
    z_c: float = 350.0

    x_extent = (0.0, 1000.0)
    y_extent = (0.0, 1000.0)
    ztop = 1000.0

    def theta_perturbation(self, x, y, z):
        r = np.sqrt((x - self.x_c) ** 2 + (y - self.y_c) ** 2
                    + (z - self.z_c) ** 2)
        return np.where(
            r <= self.r_c,
            0.5 * self.theta_c * (1.0 + np.cos(np.pi * r / self.r_c)), 0.0)

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        exner = 1.0 - c.g / (c.Cp * self.theta_bar) * z
        return c.P0 / (c.Rd * self.theta_bar) * exner ** (c.Cv / c.Rd)

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        z = np.asarray(geom.z_lev, np.float64)
        x = np.broadcast_to(np.asarray(geom.x, np.float64)[None, :, None, None],
                            z.shape)
        y = np.broadcast_to(np.asarray(geom.y, np.float64)[None, None, :, None],
                            z.shape)
        theta = self.theta_bar + self.theta_perturbation(x, y, z)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype, device=device)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        z = np.asarray(geom.z_lev, np.float64)
        theta = np.full(z.shape, self.theta_bar)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class HydrostaticMountain:
    """Hydrostatic mountain waves over an Agnesi profile (Giraldo case 6).

    Reference: ``test/nonhydro_xz/HydrostaticMountainCartesianTest.cpp``
    (u0=20, T0=250 isothermal, hC=1, aC=10000, xC=1.2e5; domain
    [0, 240 km] x [0, 30 km]; Rayleigh 8e-3 over 10 km depth / 20 km width).
    """
    u0: float = 20.0
    t0: float = 250.0
    h_c: float = 1.0
    a_c: float = 10000.0
    x_c: float = 1.2e5
    rayleigh: bool = True

    x_extent = (0.0, 240000.0)
    y_extent = (-1000.0, 1000.0)
    ztop = 30000.0

    def topography(self, x, y):
        return self.h_c / (1.0 + ((x - self.x_c) / self.a_c) ** 2)

    def rayleigh_strength(self, z, x=None, y=None):
        """Replicates the reference exactly, including its inverted left
        sponge (``HydrostaticMountainCartesianTest.cpp:194``: dNormX =
        1 - (x-x0)/width, i.e. zero at the left boundary and maximal at
        the inner sponge edge — kept verbatim for bit-level parity)."""
        strength = 8.0e-3
        depth, width = 10000.0, 20000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if x is not None:
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (1.0 - (x - x0) / width))), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def _background(self, z, constants: PhysicalConstants):
        """Isothermal T0 background: N = g / sqrt(Cp T0)."""
        c = constants
        # Nbar^2 / g = g / (Cp T0) for the isothermal background
        theta = self.t0 * np.exp(c.g / (c.Cp * self.t0) * z)
        exner = np.exp(-c.g / (c.Cp * self.t0) * z)
        rho = c.P0 / (c.Rd * theta) * exner ** (c.Cv / c.Rd)
        return theta, rho

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        z = np.asarray(geom.z_lev)
        theta, rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, u_lev=self.u0, dtype=dtype,
                           device=device)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class NonHydroMountain:
    """Non-hydrostatic mountain waves over a quartic witch profile.

    Reference: ``test/nonhydro_xz/NonHydroMountainCartesianTest.cpp``
    (u0=10, Nbar=0.01, Theta0=280, hC=1, aC=1000, xC=5e4; domain
    [0, 120 km] x [0, 30 km]; Rayleigh 1e-2 over 5 km depth / 5 km width;
    topography hC / (1 + ((x-xC)/aC)^4), :112-124 active overload).
    """
    u0: float = 10.0
    n_bar: float = 0.01
    theta_0: float = 280.0
    h_c: float = 1.0
    a_c: float = 1000.0
    x_c: float = 5.0e4
    rayleigh: bool = True

    x_extent = (0.0, 120000.0)
    y_extent = (-100.0, 100.0)
    ztop = 30000.0

    def topography(self, x, y):
        t = ((x - self.x_c) / self.a_c) ** 2
        return self.h_c / (1.0 + t * t)

    def rayleigh_strength(self, z, x=None, y=None):
        strength = 1.0e-2
        depth, width = 5000.0, 5000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if x is not None:
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x - x0) / width)), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        n2 = self.n_bar ** 2
        theta = self.theta_0 * np.exp(n2 / c.g * z)
        exner = 1.0 + c.g * c.g / (c.Cp * self.theta_0 * n2) * (
            np.exp(-n2 / c.g * z) - 1.0)
        rho = c.P0 / (c.Rd * theta) * exner ** (c.Cv / c.Rd)
        return theta, rho

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        z = np.asarray(geom.z_lev)
        theta, rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, u_lev=self.u0, dtype=dtype,
                           device=device)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class ShearJetMountainWave:
    """Shear jet over a Schar-profile mountain with a tropopause.

    Reference: ``test/nonhydro_xz/ShearJetMtnWave2DCartesianTest.cpp``
    (b=2, u0=10, uj=5, gamma=0.0065, gamma_str=-0.002, T0=280, hC=250,
    aC=5000, lC=4000; domain [-40 km, 40 km] x [0, 30 km], periodic,
    tropopause at 12 km with a 3 km isothermal mixed layer).  The state
    is hydrostatically balanced in the pressure coordinate eta solved
    pointwise by Newton iteration (``EtaFromRLL``), with zonal wind
    u(eta) = u0 - uj/2 ln(eta) exp(-(ln eta / b)^2).  Exercises the
    terrain-following metric with a realistic stratification.
    """
    b_c: float = 2.0
    u0: float = 10.0
    u_j: float = 5.0
    gamma: float = 0.0065
    gamma_str: float = -0.002
    t0: float = 280.0
    h_c: float = 250.0
    a_c: float = 5000.0
    l_c: float = 4000.0
    tp_height: float = 12000.0
    tp_mixed: float = 3000.0
    rayleigh: bool = True

    x_extent = (-40000.0, 40000.0)
    y_extent = (-500.0, 500.0)
    ztop = 30000.0

    def topography(self, x, y):
        return (self.h_c * np.exp(-(x / self.a_c) ** 2)
                * np.cos(np.pi * x / self.l_c) ** 2)

    def rayleigh_strength(self, z, x=None, y=None):
        strength = 1.0e-2
        depth, width = 5000.0, 5000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if x is not None:
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x - x0) / width)), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def _tp_constants(self, c):
        """Bootstrap tropopause constants (reference constructor
        ``:198-218``): Newton for eta at the tropopause (branch 1) and at
        the top of the mixed layer (branch 2)."""
        g, Rd = c.g, c.Rd

        def newton_b1(z):
            eta = 1.0e-5
            for _ in range(200):
                T = self.t0 * eta ** (Rd * self.gamma / g)
                phi = self.t0 * g / self.gamma * (
                    1.0 - eta ** (Rd * self.gamma / g))
                f = -g * z + phi
                df = -Rd / eta * T
                new = eta - f / df
                if abs(new - eta) < 1e-13:
                    return new, T, phi
                eta = new
            return eta, T, phi

        eta1, T1, phi1 = newton_b1(self.tp_height)

        def newton_b2(z):
            eta = 1.0e-5
            for _ in range(200):
                phi = (-Rd * T1 * np.log(eta) + Rd * T1 * np.log(eta1)
                       + phi1)
                f = -g * z + phi
                df = -Rd / eta * T1
                new = eta - f / df
                if abs(new - eta) < 1e-13:
                    return new, phi
                eta = new
            return eta, phi

        eta2, phi2 = newton_b2(self.tp_height + self.tp_mixed)
        return eta1, T1, phi1, eta2, phi2

    def _profiles(self, z, c):
        """(T, eta) at heights z via vectorized Newton (``EtaFromRLL``)."""
        g, Rd = c.g, c.Rd
        eta1, T1, phi1, eta2, phi2 = self._tp_constants(c)
        z = np.asarray(z, dtype=np.float64)
        b1 = z <= self.tp_height
        b2 = (z > self.tp_height) & (z <= self.tp_height + self.tp_mixed)
        b3 = z > self.tp_height + self.tp_mixed

        eta = np.full(z.shape, 1.0e-5)
        for _ in range(200):
            T = np.where(
                b1, self.t0 * eta ** (Rd * self.gamma / g),
                np.where(b2, T1,
                         T1 * (eta / eta2) ** (Rd * self.gamma_str / g)))
            phi = np.where(
                b1, self.t0 * g / self.gamma * (
                    1.0 - eta ** (Rd * self.gamma / g)),
                np.where(
                    b2, -Rd * T1 * np.log(eta) + Rd * T1 * np.log(eta1)
                    + phi1,
                    T1 * g / self.gamma_str * (
                        1.0 - (eta / eta2) ** (Rd * self.gamma_str / g))
                    + phi2))
            f = -g * z + phi
            df = -Rd / eta * T
            new = eta - f / df
            if np.max(np.abs(new - eta)) < 1e-14:
                eta = new
                break
            eta = new
        T = np.where(
            b1, self.t0 * eta ** (Rd * self.gamma / g),
            np.where(b2, T1,
                     T1 * (eta / eta2) ** (Rd * self.gamma_str / g)))
        return T, eta

    def _state(self, z, c):
        T, eta = self._profiles(z, c)
        lg = np.log(eta)
        u = self.u0 - self.u_j * 0.5 * lg * np.exp(-(lg / self.b_c) ** 2)
        p = c.P0 * eta
        rho = p / (c.Rd * T)
        theta = np.exp(np.log(p / c.pressure_scaling) / c.gamma) / rho
        return theta, rho, u

    def initial_state(self, geom, constants, dtype=torch.float64,
                      device=None):
        z = np.asarray(geom.z_lev)
        theta, rho, u = self._state(z, constants)
        return _state_dict(geom, theta, rho, u_lev=u, dtype=dtype,
                           device=device)

    def reference_state(self, geom, constants, dtype=torch.float64,
                        device=None):
        return self.initial_state(geom, constants, dtype=dtype,
                                  device=device)
