"""DCMIP2016 test cases (moist idealized cases on the sphere).

Counterpart of the JAX package's ``testcases/dcmip2016.py``; only the moist
baroclinic wave is ported so far (the tropical cyclone and the supercell wait
in the roadmap).  Fields are computed host-side in numpy float64; the last
step builds tensors on the requested device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import np_dtype
from .nonhydro_sphere import BaroclinicWaveUMJS


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
