"""Shallow-water model driver: config -> geometry + step function.

Counterpart of the JAX package's ``models/sw_model.py``, the analog of the
reference ``Model`` + ``TimestepSchemeStrang`` wiring for the 2D equation
set (vertical dynamics stubbed, so a Strang step reduces to: explicit RK
stages with DSS after each stage, then the nu4 hyperviscosity tail --
exactly ``TimestepSchemeStrang::Step``,
``src/atm/TimestepSchemeStrang.cpp:460-690``, with ``VerticalDynamicsStub``).

The step's DSS and its order-4 tail are the hand-written kernels: every DSS
is one ``dss_vector`` launch for (U, V) and one ``dss_scalar`` launch for H
on ``(1, 6, A, B)`` views (the tracers: one more ``dss_scalar`` launch at
``K = ntracers``), and the tail's two Laplacian passes are ``nu4_pass1`` /
``nu4_pass2`` in their shallow-water field set (``fast/hyper_cuda``).  The
tendency, the stage combinations and the order-2 tail are plain tensor
code, as in the JAX package.  The step closes over ``SWStatics``, the 2-D
metric on the device, built once per configuration (the z-first engine's
``FastGeometry`` carries vertical parts that mean nothing here: at
``ztop = 1`` its 3-D Jacobian is ``(1 - zs) * jac2d``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .._device import resolve_device
from ..config import ModelConfig
from ..fast import dss_cuda, hyper_cuda
from ..fast.engine import graph_runner
from ..grid.geometry import CubedSphereGeometry, build_geometry
from ..kernels import stencils
from ..timestep.explicit import erk_substep
from . import hyperdiff
from . import shallow_water as sw


def build_sw_geometry(cfg: ModelConfig,
                      topography=None) -> CubedSphereGeometry:
    return build_geometry(
        ne=cfg.ne, p=cfg.order, constants=cfg.constants,
        nz=1, ztop=1.0, topography=topography, dtype=cfg.dtype)


@dataclasses.dataclass
class SWStatics:
    """The 2-D grid on the device, in the geometry's dtype: what the
    shallow-water and advection steps read (the attribute names of the
    geometry, so that ``sw_tendency`` and ``models/hyperdiff`` take it in
    place of one)."""
    ne: int
    p: int
    delta: float
    reference_length: float
    links: tuple        # (panel, edge, nbr_panel, nbr_edge, flip) x 24
    dss_table: Any      # the device link table (``dss_cuda.link_table``)
    e_rot: Any          # (4, 24, A): the edge rotations of the vector DSS
    inv_mult: Any       # (6, A, B)
    con2d: Any          # (6, A, B, 2, 2)
    jac2d: Any
    coriolis: Any
    fj: Any             # coriolis * jac2d
    topo: Any
    area2d: Any
    deriv: Any          # (p, p) D[m, i] = L_m'(x_i)
    stiff: Any          # (p, p)
    hyper: Any          # the nu4 kernels' statics, jl = jac2d

    @property
    def nea(self):
        return self.ne

    @property
    def neb(self):
        return self.ne

    @property
    def delta_a(self):
        return self.delta

    @property
    def delta_b(self):
        return self.delta


def sw_statics(geom: CubedSphereGeometry, device=None) -> SWStatics:
    """``SWStatics`` of a cubed-sphere geometry on ``device`` (default
    ``cuda``; raises when absent)."""
    dev = resolve_device(device)
    npdt = np.asarray(geom.jac2d).dtype
    f64 = np.float64

    def c(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=npdt),
                               device=dev)

    con2d = c(geom.con2d)
    jac2d = c(geom.jac2d)
    cor = c(geom.coriolis)
    D = np.asarray(geom.deriv, f64)
    S = np.asarray(geom.stiff, f64)
    delta = float(geom.delta)
    hyper = hyper_cuda.make_statics(
        tuple(con2d[..., i, j].contiguous() for i in (0, 1) for j in (0, 1)),
        jac2d, jac2d, stencils.element_matrices_of(D, S, delta, delta, npdt),
        geom.p)
    return SWStatics(
        ne=geom.ne, p=geom.p, delta=delta,
        reference_length=float(geom.reference_length),
        links=tuple(geom.edge_meta),
        dss_table=torch.as_tensor(dss_cuda.link_table(geom.edge_meta),
                                  device=dev),
        e_rot=c(dss_cuda.edge_rotations(geom)), inv_mult=c(geom.inv_mult), con2d=con2d, jac2d=jac2d,
        coriolis=cor, fj=cor * jac2d, topo=c(geom.topo),
        area2d=c(geom.area2d), deriv=c(D), stiff=c(S), hyper=hyper)


def make_scalar_dss(st: SWStatics, plain: bool = False) -> Callable:
    """``dss(f) -> f``: the DSS of a scalar ``(K, 6, A, B)`` field, one
    ``dss_scalar`` launch on a CUDA tensor; ``plain``: its plain version."""
    links, p, imult = st.links, st.p, st.inv_mult

    def scalar(f):
        if plain:
            return dss_cuda.dss_scalar_plain(f, imult, links, p)
        return dss_cuda.dss_scalar(f, imult, links, p, table=st.dss_table)

    return scalar


def make_dss(st: SWStatics, plain: bool = False) -> Callable:
    """``dss_state(s) -> s``: the DSS of a shallow-water state dict: one
    ``dss_vector`` launch for (U, V) and one ``dss_scalar`` launch for H on
    CUDA tensors, one more for the tracers when present; ``plain``: the
    kernels' plain versions."""
    links, p, imult, rot = st.links, st.p, st.inv_mult, st.e_rot
    scalar = make_scalar_dss(st, plain)

    def vector(u, v):
        if plain:
            return dss_cuda.dss_vector_plain(u, v, imult, rot, links, p)
        return dss_cuda.dss_vector(u, v, imult, rot, links, p,
                                   table=st.dss_table)

    def dss_state(s):
        u, v = vector(s["U"][None], s["V"][None])
        out = dict(s, U=u[0], V=v[0], H=scalar(s["H"][None])[0])
        if "Tracers" in s:
            out["Tracers"] = scalar(s["Tracers"].contiguous())
        return out

    return dss_state


def make_sw_step(cfg: ModelConfig, geom: CubedSphereGeometry, device=None,
                 plain: bool = False) -> Callable:
    """Returns ``step(state) -> state`` advancing one dt: a dict of (6, A,
    B) tensors (and ``"Tracers"`` (ntr, 6, A, B)) on ``device`` (default
    ``cuda``; raises when absent) in, fresh tensors out.  ``plain``: every
    kernel swapped for its plain PyTorch version."""
    st = sw_statics(geom, resolve_device(device))
    dss_state = make_dss(st, plain)
    c = cfg.constants

    def stage(base, ueval, dt_s):
        tend = sw.sw_tendency(ueval, st, c)
        return dss_state({k: base[k] + dt_s * t for k, t in tend.items()})

    def step(state):
        u1 = erk_substep(cfg.explicit_scheme, state, cfg.dt, stage)
        return hyperdiff.step_after_subcycle_sw(
            u1, cfg.dt, cfg, st, dss_state, hyper=st.hyper, plain=plain)

    return step


def run(cfg: ModelConfig, state, nsteps: int, geom=None, device=None):
    """Convenience loop (host-side; ``make_sw_multistep`` for the card)."""
    if geom is None:
        geom = build_sw_geometry(cfg)
    step = make_sw_step(cfg, geom, device=device)
    for _ in range(nsteps):
        state = step(state)
    return state


def make_sw_multistep(cfg: ModelConfig, geom: CubedSphereGeometry,
                      inner_steps: int, device=None,
                      plain: bool = False) -> Callable:
    """``multi(state) -> state``: ``inner_steps`` steps of ``make_sw_step``
    as one CUDA graph (``engine.graph_runner`` with an empty carry; the
    counterpart of the JAX package's ``lax.scan``): captured at the first
    call on CUDA tensors, replayed after; a plain loop on the CPU."""
    step = make_sw_step(cfg, geom, device=device, plain=plain)
    runner = graph_runner(lambda d, carry: (step(d), carry), inner_steps)

    def multi(state):
        return runner(state, {})[0]

    return multi
