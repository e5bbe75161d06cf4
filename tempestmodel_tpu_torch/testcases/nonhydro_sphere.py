"""Nonhydrostatic sphere test cases.

Counterpart of the JAX package's ``testcases/nonhydro_sphere.py``; only the
UMJS baroclinic wave is ported so far (with its ``apply_perturbation`` for
``--perturb_restart``).  Fields are computed host-side in
numpy float64; the last step builds tensors on the requested device.
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
        dev = resolve_device(device)
        npdt = np_dtype(dtype)
        ulon, rho, rt = self._fields(geom, constants, with_pert=with_pert)
        nz = geom.nz
        # covariant conversion per level
        U = np.zeros(ulon.shape)
        V = np.zeros(ulon.shape)
        ulat = np.zeros(ulon.shape[:3])
        for kk in range(nz):
            U[..., kk], V[..., kk] = sphere_velocity_to_covariant(
                ulon[..., kk], ulat, geom, constants)
        w = np.zeros(ulon.shape[:3] + (nz + 1,))
        fields = {"U": U, "V": V, "Rt": rt, "W": w, "Rho": rho}
        return {k: torch.as_tensor(np.ascontiguousarray(f, dtype=npdt),
                                   device=dev) for k, f in fields.items()}

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
