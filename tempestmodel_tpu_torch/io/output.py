"""Output managers: scheduling, checksums, reference-grid output, restart.

Counterparts of the JAX package's ``io/output.py``, analogs of the
reference output stack:
- ``OutputManager`` scheduling (``src/atm/OutputManager.{h,cpp}``):
  fixed-interval triggering with ``IsOutputNeeded``-style logic.
- ``OutputManagerChecksum`` (``src/atm/OutputManagerChecksum.cpp``):
  periodic global per-component checksums (the regression signal).
- ``OutputManagerReference`` (``src/atm/OutputManagerReference.cpp``):
  state interpolated to a regular lat-lon grid with optional derived
  fields, written as .npz or NetCDF.
- ``OutputManagerComposite`` (``src/atm/OutputManagerComposite.cpp``):
  full-precision restart dump of the active state + time metadata.

Every manager reads ``model.state`` (reference layout, tensors on the
model's device) and the model's geometry on that device
(``model.geom_dev``); arrays come to the host (``.cpu().numpy()``) only
where a file is written or a float is recorded.  Checkpoints are
interchangeable with the JAX package's: the same keys, the same layouts.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import resolve_device
from .diagnostics import state_checksums


def _np(t):
    return t.detach().cpu().numpy()


class OutputManager:
    """Base: fires every ``interval`` seconds of model time."""

    def __init__(self, interval: float, initial_output: bool = True):
        self.interval = float(interval)
        self.initial = initial_output
        self._last = None

    def is_output_needed(self, t: float) -> bool:
        if self._last is None:
            if self.initial:
                return True
            self._last = t           # arm the timer at first query
            return False
        return t - self._last >= self.interval - 1e-9

    def first_due(self, times) -> int:
        """Index into ``times`` (the model times of the coming steps, in
        order) of the first at which ``is_output_needed`` would hold if it
        were asked at each in turn, without arming the timer; ``len(times)``
        when none.  A subclass that overrides ``is_output_needed`` is taken
        to be due at the first."""
        if type(self).is_output_needed is not OutputManager.is_output_needed:
            return 0
        last = self._last
        for i, t in enumerate(times):
            if last is None:
                if self.initial:
                    return i
                last = t
            elif t - last >= self.interval - 1e-9:
                return i
        return len(times)

    def manage_output(self, model, t: float):
        self._last = t
        self.output(model, t)

    def output(self, model, t: float):
        raise NotImplementedError


class ChecksumOutput(OutputManager):
    """Periodic per-component global checksums to a log list / printer."""

    def __init__(self, interval: float, kind: str = "l2", printer=None):
        super().__init__(interval)
        self.kind = kind
        self.printer = printer
        self.records = []

    def output(self, model, t: float):
        g = model.geom_dev
        if "Rho" in model.state:
            sums = state_checksums(model.state, g.area3d, self.kind,
                                   g.area3d_int)
        else:
            sums = state_checksums(model.state, g.area2d, self.kind)
        rec = {"time": t}
        rec.update({k: float(v) for k, v in sums.items()})
        self.records.append(rec)
        if self.printer:
            body = "  ".join(f"{k}: {v:.14e}" for k, v in rec.items()
                             if k != "time")
            self.printer(f"..Checksums t={t:.1f}s  {body}")


class EnergyOutput(OutputManager):
    """Conservation diagnostics: total mass, rho*theta, energy and the two
    momentum integrals of the nonhydrostatic state.

    Analog of ``Grid::ComputeTotalEnergy/PotentialEnstrophy``
    (``Grid.h:239-265``).  The shallow-water energy comes with the
    shallow-water engine (ROADMAP queue 1 item 2).
    """

    def __init__(self, interval: float, printer=None):
        super().__init__(interval)
        self.printer = printer
        self.records = []

    def output(self, model, t: float):
        if "Rho" not in model.state:
            raise NotImplementedError(
                "the shallow-water energy is not ported (ROADMAP queue 1 "
                "item 2)")
        from .diagnostics import (nh_total_energy, nh_zonal_momentum,
                                  nh_vertical_momentum)
        g = model.geom_dev
        s = model.state
        rec = {"time": t}
        rec["mass"] = float(torch.sum(s["Rho"] * g.area3d))
        rt = s["Rt"]
        area_rt = g.area3d if rt.shape[-1] == g.nz else g.area3d_int
        rec["rhotheta"] = float(torch.sum(rt * area_rt))
        rec["energy"] = nh_total_energy(s, g, model.cfg.constants)
        rec["zonal_momentum"] = nh_zonal_momentum(s, g)
        rec["vertical_momentum"] = nh_vertical_momentum(s, g)
        self.records.append(rec)
        if self.printer:
            body = "  ".join(f"{k}={v:.12e}" for k, v in rec.items()
                             if k != "time")
            self.printer(f"..Invariants t={t:.1f}s  {body}")


class ReferenceOutput(OutputManager):
    """Lat-lon interpolated scientific output (.npz or NetCDF files).

    Fields: native components converted to physical velocities, plus
    derived temperature/pressure for the nonhydro set (the reference's
    optional output fields, ``OutputManagerReference.cpp:119-178``).  The
    interpolation runs on the model's device in the model's dtype.
    """

    def __init__(self, interval: float, outdir: str, nlat: int = 91,
                 nlon: int = 180, prefix: str = "out", fmt: str = "npz",
                 output_vorticity: bool = False,
                 output_divergence: bool = False,
                 output_surface_pressure: bool = False,
                 output_richardson: bool = False):
        """``fmt``: "npz" or "nc" (CF NetCDF-3 classic, the reference's
        native output format — ``OutputManagerReference.cpp:304-760``)."""
        super().__init__(interval)
        self.outdir = outdir
        self.nlat = nlat
        self.nlon = nlon
        self.prefix = prefix
        self.fmt = fmt
        self.output_vorticity = output_vorticity
        self.output_divergence = output_divergence
        self.output_surface_pressure = output_surface_pressure
        self.output_richardson = output_richardson
        self.count = 0
        self._interp = None

    @staticmethod
    def _richardson(model, s, c):
        """Gradient Richardson number on model levels.

        Ri = (g/theta d(theta)/dz) / |d(u_h)/dz|^2, the reference's
        optional Richardson output (``OutputManagerReference.cpp``
        derived-field list).  The shear norm is coordinate-invariant:
        |d(u_h)/dz|^2 = g^{ij} (dz u_i)(dz u_j) with the 2-D
        contravariant metric raising the covariant z-derivatives.
        """
        g = model.geom_dev

        def colop(M, f):
            return torch.einsum("KL,...L->...K", M, f)

        dz = g.deriv_r[..., 2]                        # dz/dxi on levels
        theta = s["Rt"] / s["Rho"]
        dth = colop(g.diff_n2n, theta) / dz
        du = colop(g.diff_n2n, s["U"]) / dz
        dv = colop(g.diff_n2n, s["V"]) / dz
        con = g.con2d[..., None, :, :]                # (..., 1, 2, 2)
        shear2 = (con[..., 0, 0] * du * du
                  + 2.0 * con[..., 0, 1] * du * dv
                  + con[..., 1, 1] * dv * dv)
        n2 = c.g / theta * dth
        return n2 / torch.clamp(shear2, min=1e-12)

    def output(self, model, t: float):
        from .latlon import build_latlon_interp
        os.makedirs(self.outdir, exist_ok=True)
        if self._interp is None:
            self._interp = build_latlon_interp(
                model.geom, self.nlat, self.nlon, dtype=model.cfg.dtype,
                device=model.device)
        it = self._interp
        c = model.cfg.constants
        g = model.geom_dev
        s = model.state
        fields = {"lat": it.lat, "lon": it.lon, "time": t}
        ulon, ulat = it.vector(s["U"], s["V"], c.earth_radius)
        fields["U"] = _np(ulon)
        fields["V"] = _np(ulat)
        if "H" in s:
            fields["H"] = _np(it.scalar(s["H"]))
        else:
            rho = it.scalar(s["Rho"])
            rt = it.scalar(s["Rt"])
            fields["Rho"] = _np(rho)
            fields["Theta"] = _np(rt / rho)
            pres = c.pressure_from_rhotheta(rt)
            fields["P"] = _np(pres)
            fields["T"] = _np(pres / (c.Rd * rho))
            # w: covariant W -> physical w = W / (dz/dxi) on interfaces
            w_phys = s["W"] / g.deriv_r_int[..., 2]
            fields["W"] = _np(it.scalar(w_phys))
            if "Tracers" in s:
                fields["Tracers"] = np.stack(
                    [_np(it.scalar(s["Tracers"][i]))
                     for i in range(s["Tracers"].shape[0])])
            if self.output_surface_pressure:
                # hydrostatic extrapolation from the lowest model level
                # (OutputManagerReference.cpp surface-pressure field)
                z_low = g.z_lev[..., 0]
                z_srf = g.z_int[..., 0]
                p_low = c.pressure_from_rhotheta(s["Rt"][..., 0])
                t_low = p_low / (c.Rd * s["Rho"][..., 0])
                ps = p_low * torch.exp(c.g * (z_low - z_srf) / (c.Rd * t_low))
                fields["PS"] = _np(it.scalar(ps))
            if self.output_richardson:
                fields["Ri"] = _np(it.scalar(self._richardson(model, s, c)))
        for name, arr in getattr(model, "user_data", {}).items():
            fields[name] = _np(it.scalar(arr))
        if self.output_vorticity or self.output_divergence:
            from ..models.hyperdiff import curl_and_div
            vor, div = curl_and_div(s["U"], s["V"], g)
            if self.output_vorticity:
                fields["Vorticity"] = _np(it.scalar(vor))
            if self.output_divergence:
                fields["Divergence"] = _np(it.scalar(div))
        if self.fmt == "nc":
            from .netcdf import write_netcdf
            path = os.path.join(
                self.outdir, f"{self.prefix}.{self.count:06d}.nc")
            data = {k: v for k, v in fields.items()
                    if k not in ("lat", "lon", "time")}
            tracers = data.pop("Tracers", None)
            if tracers is not None:
                for i in range(tracers.shape[0]):
                    data[f"Q{i}"] = tracers[i]
            lev = None
            if "Rho" in s:
                # mean level height as the vertical coordinate
                lev = np.asarray(model.geom.z_lev).reshape(
                    -1, model.geom.nz).mean(axis=0)
            write_netcdf(path, data, np.degrees(it.lat),
                         np.degrees(it.lon), lev=lev, time=t)
        else:
            path = os.path.join(
                self.outdir, f"{self.prefix}.{self.count:06d}.npz")
            np.savez_compressed(path, **fields)
        self.count += 1
        return path


class CompositeCheckpoint(OutputManager):
    """Full-precision restart dump + restore.

    Analog of ``OutputManagerComposite`` (binary arena dump gathered to
    rank 0): here the state + carry + step/time metadata in one file;
    ``load`` restores bit-exact state for restart.  The state is written in
    the reference layout; the carry as the engine keeps it (z-first), as
    the JAX package writes it.
    """

    def __init__(self, interval: float, outdir: str,
                 prefix: str = "restart", fmt: str = "auto"):
        """``fmt``: "arena" (native C++ packer, .tarena), "npz", or "auto"
        (arena when the native library builds, else npz)."""
        super().__init__(interval, initial_output=False)
        self.outdir = outdir
        self.prefix = prefix
        if fmt == "auto":
            from . import arena
            fmt = "arena" if arena.available() else "npz"
        self.fmt = fmt

    def output(self, model, t: float):
        os.makedirs(self.outdir, exist_ok=True)
        payload = {f"state_{k}": _np(v) for k, v in model.state.items()}
        if model.carry is not None:
            payload.update({f"carry_{k}": _np(v)
                            for k, v in model.carry.items()})
        payload["time"] = np.float64(t).reshape(())
        payload["step"] = np.int64(model.step_count).reshape(())
        if self.fmt == "arena":
            from . import arena
            path = os.path.join(self.outdir,
                                f"{self.prefix}.{t:012.2f}.tarena")
            arena.save(path, payload)
        else:
            path = os.path.join(self.outdir, f"{self.prefix}.{t:012.2f}.npz")
            np.savez(path, **payload)
        return path

    @staticmethod
    def load(path, device=None):
        """(state, carry, time, step) from a restart file, the arrays as
        tensors on ``device`` (default ``cuda``; raises when absent)."""
        dev = resolve_device(device)
        if path.endswith(".tarena"):
            from . import arena
            data = arena.load(path)
        else:
            with np.load(path) as npz:
                data = dict(npz)
        state = {k[len("state_"):]: torch.as_tensor(v, device=dev)
                 for k, v in data.items() if k.startswith("state_")}
        carry = {k[len("carry_"):]: torch.as_tensor(v, device=dev)
                 for k, v in data.items() if k.startswith("carry_")}
        return (state, carry if carry else None,
                float(np.asarray(data["time"]).reshape(-1)[0]),
                int(np.asarray(data["step"]).reshape(-1)[0]))
