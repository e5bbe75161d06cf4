"""Nonhydrostatic model assembly: construction of the sphere and the
Cartesian geometries, and the step of a configuration.

Counterpart of ``build_nh_sphere_geometry``, ``build_nh_cartesian_geometry``,
``make_nh_step`` and ``make_nh_imex_step`` of the JAX package's
``models/nh_model.py``.  The JAX package's reference-layout engine is not
ported: both steps run every scheme on the z-first engine (``fast/engine``;
SPEX and HS through ``models/split_explicit`` and ``models/highspeed``) and
pack the state at their boundary.
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


def _step_fns(cfg: ModelConfig, geom, ref_state=None, device=None,
              plain: bool = False):
    """(first_fn, step_fn, fg) on the engine's z-first layout for this
    configuration's scheme: SPEX (``split_explicit``), HS (``highspeed``)
    or Strang-HEVI / ERK (``fast/engine``).  A swapped Cartesian engine's
    functions take and return its swapped layout (``fg.ab_swapped``)."""
    from ..config import TimestepSchemeType
    from ..fast import engine
    if cfg.timescheme == TimestepSchemeType.SPEX:
        from .split_explicit import make_spex_step
        step, fg = make_spex_step(cfg, geom, ref_state, device, plain)
        return step, step, fg
    if cfg.timescheme == TimestepSchemeType.HS:
        from .highspeed import make_hs_step
        step, fg = make_hs_step(cfg, geom, ref_state, device, plain)
        return step, step, fg
    return engine._fast_fns(cfg, geom, ref_state, None, device, plain, None,
                            None, None)


def make_nh_step(cfg: ModelConfig, geom, ref_state=None, mesh=None,
                 device=None, plain: bool = False):
    """(first_step, step) on reference-layout (z-last) states, the JAX
    package's ``make_nh_step``: ``first_step(state) -> (state, carry)``,
    ``step(state, carry) -> (state, carry)``.  SPEX and HS (self-starting,
    carry ``{}``) run ``models/split_explicit`` and ``models/highspeed``;
    Strang-HEVI and ERK the z-first engine (``make_fast_step``; its carry
    stays in the engine's layout).  The state is packed onto ``device``
    (default ``cuda``; raises when absent) and unpacked on the way out.
    ``plain=True`` runs every kernel's plain version."""
    from ..fast import engine
    if mesh is not None:
        # the JAX package's make_nh_step runs its reference-layout mesh
        # path; the sharded z-first engine is make_fast_step(mesh=)
        raise NotImplementedError(
            "make_nh_step on a device mesh is not ported yet (ROADMAP queue "
            "1 item 1: mesh outside the z-first envelope; the z-first "
            "engine takes a mesh through fast.make_fast_step(mesh=) and "
            "Model(mesh=))")
    first_fn, step_fn, fg = _step_fns(cfg, geom, ref_state, device, plain)
    dev = fg.inv_mult.device

    def wrap(fn):
        def run(state, *carry):
            d = engine.pack_state(state, device=dev)
            if fg.ab_swapped:
                d = engine._swap_ab_state(d)
            d, c = fn(d, *carry)
            if fg.ab_swapped:
                d = engine._swap_ab_state(d)
            return engine.unpack_state(d), c
        return run

    return wrap(first_fn), wrap(step_fn)


def make_nh_imex_step(cfg: ModelConfig, geom, ref_state=None, mesh=None,
                      device=None, plain: bool = False, fused=None):
    """The IMEX-ARK step (self-starting, no carry) on reference-layout
    states, the JAX package's ``make_nh_imex_step``: ``step(state) ->
    state`` on the z-first engine's IMEX body for any configuration of
    ``engine.imex_supported`` (the JAX package's semantics, quirks included:
    see ``engine._imex_body``).  The state is packed onto ``device`` (default
    ``cuda``; raises when absent) and unpacked on the way out.
    ``fused=False`` runs the unfused path; ``plain=True`` every kernel's
    plain version."""
    from ..fast import engine
    if mesh is not None:
        raise NotImplementedError(
            "IMEX on a device mesh is not ported yet (ROADMAP queue 1 item "
            "1: mesh outside the z-first envelope)")
    return engine.imex_step(cfg, geom, ref_state, device, plain, fused=fused)
