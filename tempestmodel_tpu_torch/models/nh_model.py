"""Nonhydrostatic model assembly: construction of the sphere and the
Cartesian geometries.

Counterpart of ``build_nh_sphere_geometry`` and
``build_nh_cartesian_geometry`` of the JAX package's ``models/nh_model.py``;
the reference-layout step factories of that module are not ported (the port
runs the z-first engine, ``fast/engine``).
"""

from __future__ import annotations

from ..config import ModelConfig, GridKind
from ..grid import cartesian as cart
from ..grid import geometry as sphere_geom
from ..grid.vertical_stretch import get_stretch


def _stretch(cfg: ModelConfig):
    return get_stretch(cfg.vertical_stretch)


def build_nh_sphere_geometry(cfg: ModelConfig, topography=None,
                             ztop: float = None, rayleigh=None):
    return sphere_geom.build_geometry(
        ne=cfg.ne, p=cfg.order, constants=cfg.constants, nz=cfg.nz,
        ztop=ztop if ztop is not None else cfg.ztop,
        topography=topography, vertical_order=cfg.vertical_order,
        staggering=cfg.vertical_staggering.value,
        vdisc=cfg.vertical_discretization,
        rayleigh=rayleigh, stretch=_stretch(cfg), dtype=cfg.dtype)


def build_nh_cartesian_geometry(cfg: ModelConfig, topography=None,
                                ztop: float = None, rayleigh=None,
                                bc_x: str = "periodic",
                                bc_y: str = "periodic",
                                reference_latitude: float = 0.0):
    return cart.build_cartesian_geometry(
        nex=cfg.nex, ney=cfg.ney, p=cfg.order, nz=cfg.nz,
        x_extent=cfg.x_extent, y_extent=cfg.y_extent,
        ztop=ztop if ztop is not None else cfg.ztop,
        constants=cfg.constants, vertical_order=cfg.vertical_order,
        topography=topography, rayleigh=rayleigh, bc_x=bc_x, bc_y=bc_y,
        is_xz=(cfg.grid_kind == GridKind.CARTESIAN_XZ),
        reference_latitude=reference_latitude,
        staggering=cfg.vertical_staggering.value,
        vdisc=cfg.vertical_discretization,
        stretch=_stretch(cfg), dtype=cfg.dtype)
