"""Cartesian nonhydrostatic test cases (x-z slices and the 3-D plane).

Counterpart of the JAX package's ``testcases/nonhydro_xz.py``: pointwise
initial and reference states over (x[, y], z) in numpy float64, turned into
the prognostic state dict (U, V, Rt, W, Rho) with Lorenz staggering; the last
step builds tensors on the requested device.  Ported so far: the Schar
mountain waves, the inertia-gravity waves and the 3-D thermal bubble; the
other cases wait in the roadmap.
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
    return {k: torch.as_tensor(np.ascontiguousarray(f, dtype=npdt),
                               device=dev) for k, f in fields.items()}


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
