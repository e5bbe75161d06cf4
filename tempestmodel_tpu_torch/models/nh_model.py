"""Nonhydrostatic model assembly: construction of the sphere geometry.

Counterpart of ``build_nh_sphere_geometry`` of the JAX package's
``models/nh_model.py``; the reference-layout step factories of that module
are not ported (the port runs the z-first engine, ``fast/engine``).
"""

from __future__ import annotations

from ..config import ModelConfig
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
