"""CF-style NetCDF output writer.

Counterpart of the JAX package's ``io/netcdf.py``.  The reference writes
all scientific output as NetCDF-3 through its vendored legacy C++
bindings (``src/base/netcdfcpp.h``,
``OutputManagerReference.cpp:304-760``).  Here the same capability —
files the community toolchain (ncdump/xarray/NCO) reads directly — is
provided through :func:`scipy.io.netcdf_file` (NetCDF-3 classic, the
exact format the reference emits), with CF attribute conventions from
``util/CFConverter/CFConverter.cpp``.
"""

from __future__ import annotations

import numpy as np

_UNITS = {
    "U": "m s-1", "V": "m s-1", "W": "m s-1", "H": "m",
    "Rho": "kg m-3", "Theta": "K", "T": "K", "P": "Pa", "PS": "Pa",
    "Vorticity": "s-1", "Divergence": "s-1", "Ri": "1",
}
_LONG_NAMES = {
    "U": "eastward_wind", "V": "northward_wind",
    "W": "upward_air_velocity", "H": "free_surface_height",
    "Rho": "air_density", "Theta": "air_potential_temperature",
    "T": "air_temperature", "P": "air_pressure",
    "PS": "surface_air_pressure",
    "Vorticity": "atmosphere_relative_vorticity",
    "Divergence": "divergence_of_wind",
    "Ri": "gradient_richardson_number",
}


def write_netcdf(path, fields: dict, lat, lon, lev=None, time=0.0,
                 title="tempestmodel_tpu_torch output"):
    """Write lat-lon(-z) fields to a CF-flavored NetCDF-3 classic file.

    ``fields``: name -> array of shape (nlat, nlon) or (nlat, nlon, nz*);
    fields whose trailing dimension differs from ``len(lev)`` get their
    own vertical dimension (e.g. interface-staggered W).
    """
    from scipy.io import netcdf_file

    f = netcdf_file(path, "w", version=2)   # 64-bit-offset classic
    try:
        f.history = "produced by tempestmodel_tpu_torch"
        f.Conventions = "CF-1.6"
        f.title = title

        f.createDimension("time", 1)
        v = f.createVariable("time", "d", ("time",))
        v[:] = np.asarray([time], dtype=np.float64)
        v.units = "seconds since simulation start"

        f.createDimension("lat", len(lat))
        v = f.createVariable("lat", "d", ("lat",))
        v[:] = np.asarray(lat, dtype=np.float64)
        v.units = "degrees_north"
        f.createDimension("lon", len(lon))
        v = f.createVariable("lon", "d", ("lon",))
        v[:] = np.asarray(lon, dtype=np.float64)
        v.units = "degrees_east"

        zdims = {}                       # nz -> dimension name

        def zdim(nz):
            if nz not in zdims:
                name = "lev" if not zdims else f"lev{len(zdims)}"
                f.createDimension(name, nz)
                zv = f.createVariable(name, "d", (name,))
                zv[:] = (np.asarray(lev, dtype=np.float64)
                         if lev is not None and len(lev) == nz
                         else np.arange(nz, dtype=np.float64))
                zv.units = "m" if lev is not None and len(lev) == nz else "1"
                zdims[nz] = name
            return zdims[nz]

        if lev is not None:
            zdim(len(lev))
        for name, arr in fields.items():
            arr = np.asarray(arr, dtype=np.float64)
            if arr.ndim == 2:
                v = f.createVariable(name, "d", ("time", "lat", "lon"))
                v[:] = arr[None]
            elif arr.ndim == 3:
                zd = zdim(arr.shape[2])
                v = f.createVariable(name, "d", ("time", zd, "lat", "lon"))
                v[:] = np.moveaxis(arr, 2, 0)[None]
            else:
                continue                 # tracers handled by the caller
            if name in _UNITS:
                v.units = _UNITS[name]
            if name in _LONG_NAMES:
                v.standard_name = _LONG_NAMES[name]
    finally:
        f.close()
    return path


def read_netcdf(path):
    """Read back a file written by :func:`write_netcdf` (dict of arrays)."""
    from scipy.io import netcdf_file
    out = {}
    with netcdf_file(path, "r", mmap=False) as f:
        for k, v in f.variables.items():
            out[k] = np.array(v[:])
    return out
