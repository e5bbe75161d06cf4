"""Z-first engine: geometry, DSS, tendencies, Strang stepper.

Counterpart of the JAX package's ``fast/engine.py``, for the cubed sphere
and the Cartesian grids (x-z slice, 3-D plane; periodic, or with no-flux
walls along one axis) on one device, or on each shard of a device mesh
(``fast/mesh_engine``).  The execution shape is that package's:

  state dict {U,V,Rt,W,Rho} of (6, A, B, nz[+1])
    ->  fast state dict of (nz[+1], 6, A, B)   ("z-first")
  optional Tracers (ntr, 6, A, B, nz)
    ->  one flat species-major field (ntr*nz, 6, A, B)

so that vertical column operators are clean leading-axis GEMMs and DSS is
one hand-written kernel per field (``fast/dss_cuda``).  ``make_fast_step``
has two paths, chosen by predicates on the configuration.  The fused path
(the flagship's) runs each explicit stage as one hand-written kernel
(``fast/stage_cuda``), folds the stage's W finish into the (U, V, W) DSS
launch, and does each Newton iteration of the implicit solve in one
hand-written kernel (``fast/implicit_cuda``).  The unfused path takes the
horizontal derivatives as dense block-diagonal (A, A) GEMMs over the whole
field, assembles the banded Jacobian in plain tensor code and ends in the
hand-written banded kernel (``ops/cuda_banded``).  On the fused path the
nu4 tail is two hand-written kernels (``fast/hyper_cuda``) around the
full-state DSS; on the unfused path it is plain tensor code.
With ``"Tracers"`` in the state, every species is advected inside the fused
stage kernel (plain tensor code on the unfused path), DSSed as one flat field
in one ``dss_scalar`` launch, and updated in the implicit half step by one
multi-right-hand-side banded kernel (``fast/tracers``,
``ops/cuda_banded.banded_solve_multi``).
``make_fast_step`` runs eagerly; ``make_fast_multistep`` captures K steps
into one CUDA graph and replays it, which is this package's counterpart of
K steps under one jit.

A Cartesian grid is one panel without edge links: the DSS kernels take the
periodic wrap-sum instead (``build_fast_geometry_cartesian``), and a grid
with a short y extent may run (a, b)-transposed (``_swap_ab_state``).  A
no-flux wall (the density current's x walls, the baroclinic channel's y
walls) is the JAX package's lagged halo: every DSS averages a wall node with
its halo, and the halo (the wall rows of a "shadow" state) goes through the
explicit stages' combinations as the JAX package's ``erk_substep(shadow0=)``
threads it, through the tail (``step_after_subcycle(halo=)``) and into the
carry (``halo_U``, ... beside the implicit increments).  Uniform (nu2)
diffusion against the reference state is added at every explicit stage.

``make_fast_imex_step`` runs the IMEX-ARK family (``IMEX_SCHEMES``) on the
same pieces: per stage the horizontal tendency, the full-state DSS and the
vertical implicit solve, then the nu4 tail.

The JAX package's vertical options outside its own z-first engine run here
too: the dense, Schur and JFNK column solvers (``fast/implicit.
vertical_implicit(solver=)``), the implicit solve without the Rt/Rho upwind
penalty (``upwind_thermo=False``), the fully explicit vertical path
(``explicit_vertical`` or ERK: the vertical tendency in every stage, no
implicit solve, an empty carry), and the CPH, LEV and INT staggerings (told
from the state's shapes: the stage as tensor code, the dense column solve
of ``implicit.stagger_newton``, each scalar's Jacobian and Rayleigh factor
by its row count).

Not ported yet (they wait in the roadmap, none is declared unnecessary):
a device mesh outside the JAX package's z-first mesh envelope, and under
Strang and ERK tracers on no-flux grids, tracers with uniform diffusion or
on the explicit vertical path, and under the CPH, LEV and INT staggerings
tracers, no-flux walls and uniform diffusion.

Where the JAX code writes ``x.at[i].set(v)``, this one writes in place on
a fresh tensor (a clone or a new result), never on an argument.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import resolve_device, np_dtype
from ..config import (ModelConfig, GridKind, VerticalStaggering,
                      ExplicitSubScheme)
from ..constants import PhysicalConstants
from ..grid.geometry import CubedSphereGeometry
from ..models import nonhydro
from . import dss_cuda

FIELDS = ("U", "V", "Rt", "Rho", "W")
# the JAX package's vertical_solver names (fast/implicit.vertical_implicit)
SOLVERS = ("banded", "pallas", "dense", "schur", "jfnk")


def pack_state(state, device=None):
    """Reference layout (6,A,B,nz[+1]) -> z-first (nz[+1],6,A,B), as
    contiguous tensors on ``device`` (default ``cuda``; raises when
    absent).  Values may be tensors or numpy arrays; the dtype is kept.

    Tracers (ntr, 6, A, B, nz) become ONE flat species-major field
    (ntr*nz, 6, A, B), so the per-stage DSS and updates are single
    launches."""
    dev = resolve_device(device)
    out = {k: torch.as_tensor(state[k]).to(dev).movedim(-1, 0).contiguous()
           for k in FIELDS}
    if "Tracers" in state:
        tr = torch.as_tensor(state["Tracers"]).to(dev)
        ntr, P, A, B, nz = tr.shape
        out["Tracers"] = tr.movedim(-1, 1).reshape(ntr * nz, P, A, B)
    return out


def unpack_state(d, nz: int = None):
    """Z-first fast state -> reference-layout state dict (same device).
    The tracers' level count is Rho's (Rt has one level more under CPH)."""
    out = {k: d[k].movedim(0, -1).contiguous() for k in FIELDS}
    if "Tracers" in d:
        t = d["Tracers"]
        nzz = d["Rho"].shape[0]
        out["Tracers"] = t.reshape((t.shape[0] // nzz, nzz)
                                   + tuple(t.shape[1:])).movedim(1, -1) \
            .contiguous()
    return out


def tree_map(f, *trees):
    return {k: f(*(t[k] for t in trees)) for k in trees[0]}


# ---------------------------------------------------------------------------
# Fast geometry (host-precomputed, z-first layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FastGeometry:
    """Precomputed tensors for the z-first engine, all on one device
    (plain object; closed over by the step functions)."""
    nz: int
    p: int
    ne: int
    A: int
    vo: int
    is_xz: bool
    delta: float
    reference_length: float
    dss_links: tuple     # (panel, edge, nbr_panel, nbr_edge, flip) x 24
    # dense (A, A) horizontal operators along the first (a) axis
    DA: Any          # strong derivative: out_i = sum_s DA[i,s] f_s
    Sd: Any          # stiffness/delta:   weak_div = -(Sd@fa + fb@Sd^T)
    DA_elem: Any     # (p, p) raw GLL derivative matrix D[s, i]
    S_elem: Any      # (p, p) raw stiffness matrix S[i, s]
    # vertical column operators (same matrices as CubedSphereGeometry)
    interp_n2i: Any
    interp_i2n: Any
    diff_n2n: Any
    diff_n2i: Any
    diff_i2n: Any
    diff_i2i: Any
    diffdiff_i2i: Any
    penalty_left: Any
    penalty_right: Any
    wscat_left: Any
    wscat_right: Any
    # metric terms, z-first
    c2_aa: Any       # (6, A, B)
    c2_ab: Any
    c2_ba: Any
    c2_bb: Any
    jac2d: Any       # (6, A, B)
    fj: Any          # coriolis * jac2d (6, A, B)
    inv_mult: Any    # (6, A, B)
    jac3d: Any       # (nz, 6, A, B)
    jac3d_int: Any   # (nz+1, 6, A, B)
    con_a_xi: Any    # (nz, 6, A, B)
    con_b_xi: Any
    con_xi_xi: Any
    con_a_xi_int: Any    # (nz+1, 6, A, B)
    con_b_xi_int: Any
    con_xi_xi_int: Any
    deriv_r_a: Any   # (nz, 6, A, B)   dDaR on levels
    deriv_r_b: Any
    deriv_r_xi_int: Any  # (nz+1, 6, A, B) dDxR on interfaces
    rayleigh_lev: Any
    rayleigh_int: Any
    e_rot: Any       # (4, 24, A): [r00, r01, r10, r11] covariant transform
    dss_table: Any = None   # int32 (24, 4) device lookup of dss_links
    #                       # (``dss_cuda.link_table``), read by the kernels;
    #                       # (0, 4) on a Cartesian grid
    area3d: Any = None   # (nz, 6, A, B) z-first (tracer positivity filters)
    # (B, B) operators along the second (b) axis -- equal to DA/Sd on a
    # cubed-sphere panel; they differ on a Cartesian grid (other element
    # count and width along b) and on the rectangular per-device block of a
    # sharded mesh (A, B are then LOCAL extents)
    B: int = 0
    DA_b: Any = None
    Sd_b: Any = None
    # Separable Gal-Chen metric factorization (``grid/geometry.py``
    # vert_metric): con_a_xi[k] = s_k * Ca, con_b_xi[k] = s_k * Cb,
    # con_xi_xi[k] = E + s_k^2 * F, deriv_r_a[k] = s_k * dZs/da,
    # jac3d[k] = jacl (z-constant), with s = 1 - reta.  Lets the hot
    # kernels read O(A*B) 2-D terrain fields + an O(nz) profile instead
    # of full (nz, 6, A, B) metric tensors (kept for the fused kernels
    # still to be ported; nothing on the current path reads them).
    # ``sep_ok`` is set only after numerical verification at build.
    sep_ok: bool = False
    s_lev: Any = None     # (nz, 1)
    s_int: Any = None     # (nz+1, 1)
    # stacked [interp_n2i; diff_n2i]: the implicit prep reads U/V once
    # for both operators
    n2i_stack: Any = None         # (2*(nz+1), nz)
    sep_ca: Any = None    # (6, A, B) each
    sep_cb: Any = None
    sep_e: Any = None
    sep_f: Any = None
    sep_da: Any = None
    sep_db: Any = None
    sep_jacl: Any = None
    # grid family: 6 cubed-sphere panels with edge links, or 1 Cartesian
    # panel with per-axis periodic wrap-sums in the DSS kernels
    npanels: int = 6
    wrap: tuple = (False, False)
    # xz slice: which ENGINE velocity slot carries the physical V whose
    # tendency is identically zero ("V" natural, "U" when ab_swapped)
    xz_zero: str = None
    # a Cartesian grid may run TRANSPOSED: engine (a, b) = physical (y, x),
    # engine U/V = physical V/U, fj negated -- an exact relabeling of the
    # equations (orientation flip); the step functions swap at their
    # boundary (``_swap_ab_state``)
    ab_swapped: bool = False
    # hyperviscosity local scale always uses the physical delta_a (reference
    # nu_local_scale), which differs from the engine's first-axis element
    # width when ab_swapped
    nu_delta: float = None

    @property
    def noflux(self) -> tuple:
        """The no-flux walls (along a, along b) in the engine's layout: on a
        Cartesian grid (one panel) an axis without the periodic wrap has
        walls (``fast_engine_supported`` takes no other lateral boundary);
        the cubed sphere has none."""
        if self.npanels != 1:
            return (False, False)
        return (not self.wrap[0], not self.wrap[1])


def _extract_separable_metric(geom):
    """(s_lev, s_int, {2-D fields}) if the Gal-Chen factorization holds
    numerically (relative residual < 1e-10 in fp64), else None."""
    f64 = np.float64
    jac = np.asarray(geom.jac3d, f64)          # (6, A, B, nz)
    jac_i = np.asarray(geom.jac3d_int, f64)
    if not (np.allclose(jac, jac[..., 0:1], rtol=1e-12, atol=0.0)
            and np.allclose(jac_i, jac_i[..., 0:1], rtol=1e-12, atol=0.0)
            and np.allclose(jac[..., 0], jac_i[..., 0], rtol=1e-12)):
        return None
    # s profiles from the deriv_r ratio at the point of max |dZs/da|;
    # flat terrain -> all terrain metrics vanish identically
    dr_a = np.asarray(geom.deriv_r, f64)[..., 0]       # (6, A, B, nz)
    dr_a_i = np.asarray(geom.deriv_r_int, f64)[..., 0]
    ca3 = np.asarray(geom.con_a_xi, f64)
    cb3 = np.asarray(geom.con_b_xi, f64)
    cx3 = np.asarray(geom.con_xi_xi, f64)
    ca3_i = np.asarray(geom.con_a_xi_int, f64)
    cb3_i = np.asarray(geom.con_b_xi_int, f64)
    cx3_i = np.asarray(geom.con_xi_xi_int, f64)
    dxr3 = np.asarray(geom.deriv_r_int, f64)[..., 2]   # (6, A, B, nz+1)
    if not np.allclose(dxr3, dxr3[..., 0:1], rtol=1e-12, atol=0.0):
        return None
    dxr2 = dxr3[..., 0]                                # (6, A, B)

    flat = np.argmax(np.abs(dr_a_i[..., 0]))
    ij = np.unravel_index(flat, dr_a_i[..., 0].shape)
    denom = dr_a_i[ij][0]
    if abs(denom) < 1e-14:
        # flat terrain: all terrain metrics vanish
        s_lev = np.zeros(ca3.shape[-1])
        s_int = np.zeros(ca3_i.shape[-1])
        if (np.abs(ca3).max() > 0 or np.abs(cb3).max() > 0
                or np.abs(dr_a).max() > 0):
            return None
        zero2 = np.zeros(dxr2.shape)
        two_d = dict(sep_ca=zero2, sep_cb=zero2,
                     sep_e=1.0 / (dxr2 * dxr2), sep_f=zero2,
                     sep_da=zero2, sep_db=zero2, sep_jacl=jac[..., 0])
        # con_xi_xi must then be exactly E on every level
        if not (np.allclose(cx3, (1.0 / (dxr2 * dxr2))[..., None],
                            rtol=1e-10)
                and np.allclose(cx3_i, (1.0 / (dxr2 * dxr2))[..., None],
                                rtol=1e-10)):
            return None
        return s_lev, s_int, two_d

    s_int = dr_a_i[ij] / denom                         # (nz+1,), s[0]-normed
    s_lev = dr_a[ij] / denom
    k0 = 0                                             # reference interface
    ca2 = ca3_i[..., k0] / s_int[k0]
    cb2 = cb3_i[..., k0] / s_int[k0]
    da2 = dr_a_i[..., k0] / s_int[k0]
    db2 = np.asarray(geom.deriv_r_int, f64)[..., 1][..., k0] / s_int[k0]
    e2 = 1.0 / (dxr2 * dxr2)
    f2 = -(ca2 * da2 + cb2 * db2) / dxr2

    def ok(full, recon):
        scale = np.abs(full).max() + 1e-300
        return np.abs(full - recon).max() <= 1e-10 * max(scale, 1e-30)

    sl = s_lev.reshape((1, 1, 1, -1))
    si = s_int.reshape((1, 1, 1, -1))
    if not (ok(ca3, sl * ca2[..., None]) and ok(ca3_i, si * ca2[..., None])
            and ok(cb3, sl * cb2[..., None])
            and ok(cb3_i, si * cb2[..., None])
            and ok(cx3, e2[..., None] + sl * sl * f2[..., None])
            and ok(cx3_i, e2[..., None] + si * si * f2[..., None])
            and ok(dr_a, sl * da2[..., None])
            and ok(np.asarray(geom.deriv_r, f64)[..., 1],
                   sl * db2[..., None])):
        return None
    two_d = dict(sep_ca=ca2, sep_cb=cb2, sep_e=e2, sep_f=f2,
                 sep_da=da2, sep_db=db2, sep_jacl=jac[..., 0])
    return s_lev, s_int, two_d


def build_fast_geometry(geom: CubedSphereGeometry,
                        dtype=torch.float32, device=None) -> FastGeometry:
    """Z-first engine geometry as tensors on ``device`` (default ``cuda``;
    raises when absent).  All arithmetic is host numpy float64; only the
    final cast builds tensors."""
    dev = resolve_device(device)
    npdt = np_dtype(dtype)
    nz, p, ne = geom.nz, geom.p, geom.ne
    A = ne * p
    f64 = np.float64

    D = np.asarray(geom.deriv, f64)
    S = np.asarray(geom.stiff, f64)
    delta = float(geom.delta)
    DA = np.kron(np.eye(ne), D.T) / delta
    Sd = np.kron(np.eye(ne), S) / delta

    def c(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=npdt),
                               device=dev)

    def zf(a):
        return c(np.moveaxis(np.asarray(a, f64), -1, 0))

    con2d = np.asarray(geom.con2d, f64)
    cor = np.asarray(geom.coriolis, f64)
    j2 = np.asarray(geom.jac2d, f64)

    n2i_stack = np.concatenate([np.asarray(geom.interp_n2i, f64),
                                np.asarray(geom.diff_n2i, f64)], axis=0)

    # --- separable-metric extraction (verified numerically) -----------
    sep = _extract_separable_metric(geom)
    sep_fields = {}
    if sep is not None:
        s_lev, s_int, two_d = sep
        sep_fields = dict(
            sep_ok=True,
            s_lev=c(s_lev.reshape(-1, 1)),
            s_int=c(s_int.reshape(-1, 1)),
            **{k: c(v) for k, v in two_d.items()})

    return FastGeometry(
        **sep_fields,
        n2i_stack=c(n2i_stack),
        nz=nz, p=p, ne=ne, A=A, B=A, vo=geom.vo, is_xz=False, delta=delta,
        reference_length=float(geom.reference_length),
        dss_links=tuple(geom.edge_meta),
        DA=c(DA), Sd=c(Sd), DA_b=c(DA), Sd_b=c(Sd), DA_elem=D, S_elem=S,
        interp_n2i=c(geom.interp_n2i), interp_i2n=c(geom.interp_i2n),
        diff_n2n=c(geom.diff_n2n), diff_n2i=c(geom.diff_n2i),
        diff_i2n=c(geom.diff_i2n), diff_i2i=c(geom.diff_i2i),
        diffdiff_i2i=c(geom.diffdiff_i2i),
        penalty_left=(None if geom.penalty_left is None
                      else c(geom.penalty_left)),
        penalty_right=(None if geom.penalty_right is None
                       else c(geom.penalty_right)),
        wscat_left=(None if geom.wscat_left is None
                    else c(geom.wscat_left)),
        wscat_right=(None if geom.wscat_right is None
                     else c(geom.wscat_right)),
        c2_aa=c(con2d[..., 0, 0]), c2_ab=c(con2d[..., 0, 1]),
        c2_ba=c(con2d[..., 1, 0]), c2_bb=c(con2d[..., 1, 1]),
        jac2d=c(j2), fj=c(cor * j2),
        inv_mult=c(geom.inv_mult),
        jac3d=zf(geom.jac3d), jac3d_int=zf(geom.jac3d_int),
        con_a_xi=zf(geom.con_a_xi), con_b_xi=zf(geom.con_b_xi),
        con_xi_xi=zf(geom.con_xi_xi),
        con_a_xi_int=zf(geom.con_a_xi_int),
        con_b_xi_int=zf(geom.con_b_xi_int),
        con_xi_xi_int=zf(geom.con_xi_xi_int),
        area3d=zf(geom.area3d),
        deriv_r_a=zf(np.asarray(geom.deriv_r, f64)[..., 0]),
        deriv_r_b=zf(np.asarray(geom.deriv_r, f64)[..., 1]),
        deriv_r_xi_int=zf(np.asarray(geom.deriv_r_int, f64)[..., 2]),
        rayleigh_lev=zf(geom.rayleigh_lev),
        rayleigh_int=zf(geom.rayleigh_int),
        e_rot=c(dss_cuda.edge_rotations(geom)),
        dss_table=torch.as_tensor(dss_cuda.link_table(geom.edge_meta),
                                  device=dev),
    )


def _swap_ab_state(d):
    """(a, b)-transpose a z-first state dict and relabel U <-> V (an
    involution; contiguous fresh tensors).  Together with ``fj -> -fj`` this
    is an EXACT relabeling of the equations (orientation flip): the engine
    runs in (b, a) coordinates, so the long Cartesian x axis becomes the
    kernels' contiguous b axis."""
    m = {"U": "V", "V": "U"}
    return {m.get(k, k): v.transpose(-2, -1).contiguous()
            for k, v in d.items()}


def swap_ab_default(geom) -> bool:
    """The JAX package's rule for the layout of a Cartesian grid: swapped
    when the y extent is shorter than the x extent and shorter than 32
    nodes (``chip_smoke.py`` times both layouts of the Schar case)."""
    B, A = geom.ney * geom.p, geom.nex * geom.p
    return B < A and B < 32


def build_fast_geometry_cartesian(geom, dtype=torch.float32, device=None,
                                  swap_ab=None) -> FastGeometry:
    """``FastGeometry`` from a ``grid/cartesian.CartesianGeometry`` (x-z
    slice or 3-D plane), as tensors on ``device`` (default ``cuda``; raises
    when absent).

    One panel, no edge links: the DSS kernels run pure pair sums with the
    per-axis periodic wrap-sum (``dss_cuda``, ``wrap``), the analog of
    ``GridCartesianGLL::ApplyDSS`` periodic averaging; an axis without the
    wrap has no-flux walls, whose nodes the DSS averages with their halo
    (``FastGeometry.noflux``).

    ``swap_ab`` (default ``swap_ab_default``): run the engine transposed --
    see ``_swap_ab_state``."""
    dev = resolve_device(device)
    npdt = np_dtype(dtype)
    nz, p = geom.nz, geom.p
    f64 = np.float64
    if swap_ab is None:
        swap_ab = swap_ab_default(geom)

    D = np.asarray(geom.deriv, f64)
    S = np.asarray(geom.stiff, f64)
    if swap_ab:
        ne_a, ne_b = geom.ney, geom.nex
        d_a, d_b = geom.delta_b, geom.delta_a
        wrap = (geom.bc_y == "periodic", geom.bc_x == "periodic")
        fj_sign = -1.0
    else:
        ne_a, ne_b = geom.nex, geom.ney
        d_a, d_b = geom.delta_a, geom.delta_b
        wrap = (geom.bc_x == "periodic", geom.bc_y == "periodic")
        fj_sign = 1.0
    A = ne_a * p

    def c(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=npdt),
                               device=dev)

    def zf(a):
        """(1, A, B, nz) -> z-first (nz, 1, A, B), (a, b)-transposed when
        swapped."""
        out = np.moveaxis(np.asarray(a, f64), -1, 0)
        return c(np.swapaxes(out, 2, 3) if swap_ab else out)

    def c2d(a):
        out = np.asarray(a, f64)
        return c(np.swapaxes(out, 1, 2) if swap_ab else out)

    con2d = np.asarray(geom.con2d, f64)
    cor = np.asarray(geom.coriolis, f64)
    j2 = np.asarray(geom.jac2d, f64)
    n2i_stack = np.concatenate([np.asarray(geom.interp_n2i, f64),
                                np.asarray(geom.diff_n2i, f64)], axis=0)
    dra = np.asarray(geom.deriv_r, f64)[..., 0]
    drb = np.asarray(geom.deriv_r, f64)[..., 1]
    if swap_ab:
        c2aa, c2bb = con2d[..., 1, 1], con2d[..., 0, 0]
        c2ab, c2ba = con2d[..., 1, 0], con2d[..., 0, 1]
        caxi, cbxi = geom.con_b_xi, geom.con_a_xi
        caxi_i, cbxi_i = geom.con_b_xi_int, geom.con_a_xi_int
        dra, drb = drb, dra
    else:
        c2aa, c2bb = con2d[..., 0, 0], con2d[..., 1, 1]
        c2ab, c2ba = con2d[..., 0, 1], con2d[..., 1, 0]
        caxi, cbxi = geom.con_a_xi, geom.con_b_xi
        caxi_i, cbxi_i = geom.con_a_xi_int, geom.con_b_xi_int

    def opt(a):
        return None if a is None else c(a)

    return FastGeometry(
        n2i_stack=c(n2i_stack),
        nz=nz, p=p, ne=ne_a, A=A, B=ne_b * p, vo=geom.vo,
        is_xz=bool(geom.is_xz), delta=float(d_a),
        nu_delta=float(geom.delta_a),
        reference_length=float(geom.reference_length),
        npanels=1, wrap=wrap, ab_swapped=bool(swap_ab),
        xz_zero=(("U" if swap_ab else "V") if geom.is_xz else None),
        dss_links=(),
        DA=c(np.kron(np.eye(ne_a), D.T) / d_a),
        Sd=c(np.kron(np.eye(ne_a), S) / d_a),
        DA_b=c(np.kron(np.eye(ne_b), D.T) / d_b),
        Sd_b=c(np.kron(np.eye(ne_b), S) / d_b),
        DA_elem=D, S_elem=S,
        interp_n2i=c(geom.interp_n2i), interp_i2n=c(geom.interp_i2n),
        diff_n2n=c(geom.diff_n2n), diff_n2i=c(geom.diff_n2i),
        diff_i2n=c(geom.diff_i2n), diff_i2i=c(geom.diff_i2i),
        diffdiff_i2i=c(geom.diffdiff_i2i),
        penalty_left=opt(geom.penalty_left),
        penalty_right=opt(geom.penalty_right),
        wscat_left=opt(geom.wscat_left), wscat_right=opt(geom.wscat_right),
        c2_aa=c2d(c2aa), c2_ab=c2d(c2ab), c2_ba=c2d(c2ba), c2_bb=c2d(c2bb),
        jac2d=c2d(j2), fj=c2d(fj_sign * cor * j2),
        inv_mult=c2d(geom.inv_mult),
        jac3d=zf(geom.jac3d), jac3d_int=zf(geom.jac3d_int),
        con_a_xi=zf(caxi), con_b_xi=zf(cbxi),
        con_xi_xi=zf(geom.con_xi_xi),
        con_a_xi_int=zf(caxi_i), con_b_xi_int=zf(cbxi_i),
        con_xi_xi_int=zf(geom.con_xi_xi_int),
        area3d=zf(geom.area3d),
        deriv_r_a=zf(dra), deriv_r_b=zf(drb),
        deriv_r_xi_int=zf(np.asarray(geom.deriv_r_int, f64)[..., 2]),
        rayleigh_lev=zf(geom.rayleigh_lev),
        rayleigh_int=zf(geom.rayleigh_int),
        # no panel links: the rotation table is never read; a one-link
        # dummy keeps every array dimension nonzero, as in the JAX package
        e_rot=c(np.zeros((4, 1, A))),
        dss_table=torch.as_tensor(dss_cuda.link_table(()), device=dev),
    )


# ---------------------------------------------------------------------------
# Horizontal operators (dense (A, A), z-batched)
# ---------------------------------------------------------------------------

# Written as broadcast matmuls, not einsums: ``DA @ f`` contracts the a axis
# and ``f @ DA_b^T`` the b axis, and both return CONTIGUOUS (K, P, A, B)
# results (an einsum may hand back a permuted view, which the DSS kernels
# refuse).

def hderiv_a(f, fg: FastGeometry):
    return torch.matmul(fg.DA, f)


def hderiv_b(f, fg: FastGeometry):
    return torch.matmul(f, fg.DA_b.T)


def hweak_div(fa, fb, fg: FastGeometry):
    """Variational divergence (positive = divergence)."""
    wa = torch.matmul(fg.Sd, fa)
    wb = torch.matmul(fb, fg.Sd_b.T)
    return -(wa + wb)


def hweak_grad(f, fg: FastGeometry):
    """(-Sd @ f, -f @ Sd^T): weak gradients along a and b."""
    return (-torch.matmul(fg.Sd, f), -torch.matmul(f, fg.Sd_b.T))


def colop(M, f):
    """Vertical column operator over the leading z axis: one
    ``(K, L) @ (L, rest)`` product on the flattened trailing axes (a view
    of a contiguous field)."""
    return (M @ f.reshape(f.shape[0], -1)).reshape(
        (M.shape[0],) + tuple(f.shape[1:]))


# ---------------------------------------------------------------------------
# DSS (hand-written kernels; see fast/dss_cuda.py)
# ---------------------------------------------------------------------------

def w_finish_xla(d, wf):
    """The W of an explicit stage from its deferred finish (the plain form
    of what ``dss_cuda.dss_uvw`` folds into its launch; the name is the JAX
    package's): see ``dss_cuda.w_finish_plain``."""
    return dss_cuda.w_finish_plain(d["U"], d["V"], wf)


# Which groups of fields ``apply_dss`` takes in one launch by default: names
# among "state" (a full state without a W finish -- the nu4 tail's two DSS --
# through ``dss_cuda.dss_state``, the Rayleigh finish folded in) and
# "scalar2" (Rt and Rho through ``dss_cuda.dss_scalar2`` wherever they are
# still scalars of their own).  Measured at the flagship (ne30 p4 L30
# float32) on an NVIDIA H100 80GB HBM3 at 700 W by ``chip_smoke.py`` phase
# 6 under graph replay: since ``dss_state`` became a mode of the band DSS
# kernel, ("state", "scalar2") is faster than ("scalar2",) in every turn of
# three calls (1.391-1.405 against 1.405-1.416 ms/step), which was faster
# than the separate launches.
DSS_MERGE_DEFAULT = ("state", "scalar2")


def walls_of(d, fg: FastGeometry):
    """The halo of a state on a no-flux grid: the wall rows of each of its
    five fields (``dss_cuda.wall_rows``)."""
    return {k: dss_cuda.wall_rows(d[k], fg.noflux) for k in FIELDS}


def apply_dss(d, fg: FastGeometry, rayleigh=None, plain: bool = False,
              w_finish=None, merge=DSS_MERGE_DEFAULT, halo=None,
              walls_out: bool = False):
    """DSS of the full fast state (U/V rotate as a covariant pair).

    Four launches (vector pair + 3 scalars) unless ``merge`` says otherwise:
    with ``"state"`` in it, a full five-field Lorenz state goes through the
    one-launch ``dss_cuda.dss_state`` (the Rayleigh finish inside the
    launch); with ``"scalar2"``, the two scalars of one row count share one
    launch (``dss_cuda.dss_scalar2``: Rt and Rho, or Rt and W under CPH).
    The results are the same bit for bit.  A CPH, LEV or INT state (told by
    its shapes) never takes ``dss_state``: its scalars go as
    ``"scalar2"`` says.
    ``DSS_MERGE_DEFAULT`` follows the measurement at the flagship on an H100
    under graph replay (``chip_smoke.py`` times all four combinations).

    ``w_finish``: the deferred W stage finish of
    ``stage_cuda.fused_stage(defer_w=True)``; ``d`` then has no W, which is
    assembled, bottom-bounded and DSSed inside the (U, V) launch
    (``dss_cuda.dss_uvw``): three launches, or two with ``"scalar2"``.

    ``"Tracers"`` in ``d``: all species as one flat field through one more
    ``dss_cuda.dss_scalar`` launch, whatever ``merge`` and ``w_finish`` say;
    tracers are never Rayleigh-damped.

    ``plain=True`` runs the kernels' plain PyTorch versions whatever the
    device: it exists so that a run can hold the kernel path against the
    plain path on the card.  The default launches the kernels for CUDA
    tensors (or raises) and runs the plain versions for CPU tensors.

    ``halo`` (a no-flux grid): None (no average), ``dss_cuda.ZERO_HALO`` or
    the wall rows of each of the five fields (``walls_of``), passed to
    every launch of every grouping; ``walls_out``: also return the wall
    rows of the result before the Rayleigh finish, ``(out, walls)``."""
    common = (fg.inv_mult, fg.dss_links, fg.p)
    kw = {"wrap": fg.wrap} if plain else {"wrap": fg.wrap,
                                          "table": fg.dss_table}
    hw = {}
    if halo is not None and any(fg.noflux):
        hw = {"noflux": fg.noflux}
    elif walls_out:
        raise ValueError("walls_out needs a no-flux grid and a halo")

    def h(*keys):
        """The halo keyword of the launch of fields ``keys``."""
        if not hw:
            return {}
        if halo is dss_cuda.ZERO_HALO:
            return dict(hw, halo=halo)
        part = tuple(halo[k] for k in keys)
        return dict(hw, halo=part[0] if len(keys) == 1 else part)

    # the scalars by shape: the two of one row count share the
    # ``"scalar2"`` launch, the odd one goes alone (Lorenz: Rt and Rho, W;
    # CPH: Rt and W, Rho; LEV and INT: Rt and Rho, W); ``dss_state`` and
    # the W fold take Lorenz shapes only
    lorenz = (w_finish is not None
              or (d["Rt"].shape == d["Rho"].shape
                  and d["W"].shape[0] == d["Rho"].shape[0] + 1))
    cph = w_finish is None and d["Rt"].shape[0] == d["Rho"].shape[0] + 1
    pair, alone = (("Rt", "W"), "Rho") if cph else (("Rt", "Rho"), "W")
    scalar = dss_cuda.dss_scalar_plain if plain else dss_cuda.dss_scalar
    if w_finish is None and "state" in merge and lorenz:
        fn = dss_cuda.dss_state_plain if plain else dss_cuda.dss_state
        hs = {}
        if hw:
            hs = dict(hw, halo=halo, walls_out=walls_out)
        out = fn(d, fg.inv_mult, fg.e_rot, fg.dss_links, fg.p,
                 rayleigh=rayleigh, **kw, **hs)
        if "Tracers" in d:
            (out[0] if walls_out else out)["Tracers"] = scalar(
                d["Tracers"], *common, **kw)
        return out
    if w_finish is not None:
        fn = dss_cuda.dss_uvw_plain if plain else dss_cuda.dss_uvw
        u, v, w = fn(d["U"], d["V"], fg.inv_mult, fg.e_rot, fg.dss_links,
                     fg.p, w_finish, **kw, **h("U", "V", "W"))
        out = {"U": u, "V": v, "W": w}
    else:
        fn = dss_cuda.dss_vector_plain if plain else dss_cuda.dss_vector
        u, v = fn(d["U"], d["V"], fg.inv_mult, fg.e_rot, fg.dss_links, fg.p,
                  **kw, **h("U", "V"))
        out = {"U": u, "V": v,
               alone: scalar(d[alone], *common, **kw, **h(alone))}
    if "scalar2" in merge:
        fn = dss_cuda.dss_scalar2_plain if plain else dss_cuda.dss_scalar2
        out[pair[0]], out[pair[1]] = fn(d[pair[0]], d[pair[1]], *common,
                                        **kw, **h(*pair))
    else:
        for k in pair:
            out[k] = scalar(d[k], *common, **kw, **h(k))
    walls = walls_of(out, fg) if walls_out else None
    if rayleigh is not None:
        out = apply_rayleigh(out, *rayleigh)
    if "Tracers" in d:
        out["Tracers"] = scalar(d["Tracers"], *common, **kw)
    return (out, walls) if walls_out else out


# ---------------------------------------------------------------------------
# Nonhydrostatic tendencies (every staggering: told by the state's shapes)
# ---------------------------------------------------------------------------

def horizontal_tendency(d, fg: FastGeometry, constants: PhysicalConstants,
                        mask_w: bool = True):
    """Horizontal tendencies of the five fields, with the vertical penalty
    upwinding of U/V folded into the U/V rows.  The staggering comes from
    the shapes (the JAX package's ``nonhydro.horizontal_tendency``): under
    CPH Rt lives on interfaces, is advected there with the interface
    Jacobian and enters the pressure gradient interpolated to levels; under
    LEV and INT W lives on levels, its tendency is not interpolated, and
    the U/V penalty reads it interpolated to interfaces.
    ``mask_w=False`` leaves the bottom and top rows of the W tendency as the
    interpolation gives them (the deferred W finish masks them later)."""
    nz = fg.nz
    u, v = d["U"], d["V"]
    rt, rho, w = d["Rt"], d["Rho"], d["W"]
    cph = rt.shape[0] == nz + 1
    lev = w.shape[0] == nz
    rt_n = colop(fg.interp_i2n, rt) if cph else rt
    w_n = w if lev else colop(fg.interp_i2n, w)

    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    con_ua = c_aa * u + c_ab * v + fg.con_a_xi * w_n
    con_ub = c_ba * u + c_bb * v + fg.con_b_xi * w_n
    con_ux = fg.con_a_xi * u + fg.con_b_xi * v + fg.con_xi_xi * w_n

    ke = 0.5 * (con_ua * u + con_ub * v + con_ux * w_n)
    exner = nonhydro.exner_from_rhotheta(rt_n, constants)

    du_dxi = colop(fg.diff_n2n, u)
    dv_dxi = colop(fg.diff_n2n, v)

    dv_da = hderiv_a(v, fg)
    du_db = hderiv_b(u, fg)
    dwn_da = hderiv_a(w_n, fg)
    dwn_db = hderiv_b(w_n, fg)

    jzeta_a = dwn_db - dv_dxi
    jzeta_b = du_dxi - dwn_da
    jzeta_x = dv_da - du_db

    ucz_a = con_ub * jzeta_x - con_ux * jzeta_b
    ucz_b = con_ux * jzeta_a - con_ua * jzeta_x
    ucz_x = -con_ua * dwn_da - con_ub * dwn_db

    base_a = fg.jac3d * con_ua
    base_b = fg.jac3d * con_ub
    div_rho = hweak_div(base_a * rho, base_b * rho, fg)

    # U and V on interfaces: the CPH Rt flux and the U/V penalty
    u_i = colop(fg.interp_n2i, u)
    v_i = colop(fg.interp_n2i, v)
    w_i = colop(fg.interp_n2i, w) if lev else w
    if cph:
        # Rt advects on interfaces (the reference's REdge branch,
        # HorizontalDynamicsFEM.cpp:1664+)
        ji = fg.jac3d_int
        con_ua_i = c_aa * u_i + c_ab * v_i + fg.con_a_xi_int * w
        con_ub_i = c_ba * u_i + c_bb * v_i + fg.con_b_xi_int * w
        dRt = -hweak_div(ji * con_ua_i * rt, ji * con_ub_i * rt, fg) / ji
    else:
        dRt = -hweak_div(base_a * rt, base_b * rt, fg) / fg.jac3d

    dke_a = hderiv_a(ke, fg)
    dke_b = hderiv_b(ke, fg)
    dpi_a = hderiv_a(exner, fg)
    dpi_b = hderiv_b(exner, fg)

    theta = rt_n / rho
    fj = fg.fj[None]

    # on an xz slice the slot of the physical V ("V", or "U" when (a, b)-
    # swapped) has no tendency; the vertical penalty below still applies
    if fg.xz_zero == "U":
        dU = torch.zeros_like(u)
    else:
        dU = (ucz_a + fj * con_ub
              - (dpi_a * theta + dke_a + constants.g * fg.deriv_r_a))
    if fg.xz_zero == "V":
        dV = torch.zeros_like(v)
    else:
        dV = (ucz_b - fj * con_ua
              - (dpi_b * theta + dke_b + constants.g * fg.deriv_r_b))
    dRho = -div_rho / fg.jac3d

    # W's tendency: U x zeta's xi component, on interfaces but under LEV
    dW = ucz_x.clone() if lev else colop(fg.interp_n2i, ucz_x)
    if mask_w:
        dW[0] = 0.0                       # written in place (a fresh tensor)
        dW[-1] = 0.0

    # --- vertical explicit penalty upwinding of U/V (per unit dt) --------
    xid = (fg.con_a_xi_int * u_i + fg.con_b_xi_int * v_i
           + fg.con_xi_xi_int * w_i)
    xid[0] = 0.0                          # xid is a fresh tensor
    xid[-1] = 0.0
    vo = fg.vo
    if fg.penalty_left is not None and nz // vo > 1:
        wb = torch.abs(xid[vo:nz:vo])                        # (nfe-1, ...)
        wl = colop(fg.wscat_left, wb)
        wr = colop(fg.wscat_right, wb)
        dU = dU + colop(fg.penalty_left, u) * wl \
            + colop(fg.penalty_right, u) * wr
        dV = dV + colop(fg.penalty_left, v) * wl \
            + colop(fg.penalty_right, v) * wr

    return {"U": dU, "V": dV, "Rt": dRt, "Rho": dRho, "W": dW}


def apply_w_boundary(d, fg: FastGeometry):
    """Diagnostic bottom W from u^xi(surface) = 0: at the bottom interface
    (U and V interpolated there), or at the bottom level where W lives on
    levels (LEV, INT).  Writes row 0 of ``d["W"]`` IN PLACE: the caller
    passes a state it has just made."""
    if d["W"].shape[0] == fg.nz:
        w0 = -(fg.con_a_xi[0] * d["U"][0] + fg.con_b_xi[0] * d["V"][0]) \
            / fg.con_xi_xi[0]
    else:
        u0 = colop(fg.interp_n2i[0:1], d["U"])[0]
        v0 = colop(fg.interp_n2i[0:1], d["V"])[0]
        w0 = -(fg.con_a_xi_int[0] * u0 + fg.con_b_xi_int[0] * v0) \
            / fg.con_xi_xi_int[0]
    d["W"][0] = w0
    return d


# ---------------------------------------------------------------------------
# Hyperdiffusion tail (nu4 / nu2)
# ---------------------------------------------------------------------------

def jac_of(f, fg: FastGeometry):
    """The 3-D Jacobian where the scalar ``f`` lives, by its row count: the
    level one for nz rows, the interface one for nz + 1 (the reference's
    choice, whatever the field's name: the JAX package compares Rt with W
    instead, ``hyperdiff.py:187-189``, and under LEV and INT, where they
    have nz rows each, takes the interface Jacobian for Rt and fails)."""
    return fg.jac3d if f.shape[0] == fg.nz else fg.jac3d_int


def scalar_laplacian(f, jac, fg: FastGeometry):
    da = hderiv_a(f, fg)
    db = hderiv_b(f, fg)
    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    ga = jac * (c_aa * da + c_ab * db)
    gb = jac * (c_ba * da + c_bb * db)
    return hweak_div(ga, gb, fg) / jac


def vector_hyperdiff_update(u, v, nu_div, nu_vort, fg: FastGeometry):
    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    j2 = fg.jac2d[None]
    con_u = c_aa * u + c_ab * v
    con_v = c_ba * u + c_bb * v
    div = (hderiv_a(j2 * con_u, fg) + hderiv_b(j2 * con_v, fg)) / j2
    curl = (hderiv_a(v, fg) - hderiv_b(u, fg)) / j2
    wda_div, wdb_div = hweak_grad(div, fg)
    wda_curl, wdb_curl = hweak_grad(curl, fg)
    du = nu_div * wda_div - nu_vort * j2 * (
        c_ba * wda_curl + c_bb * wdb_curl)
    dv = nu_div * wdb_div + nu_vort * j2 * (
        c_aa * wda_curl + c_ab * wdb_curl)
    return du, dv


def apply_rayleigh(d, fac, ref_term):
    """X <- fac * X + (1 - fac) * Xref with ref_term = (1 - fac) * Xref.
    fac has Rho rows = 1, so Rho is never damped."""
    return tree_map(lambda x, f, r: f * x + r, d, fac, ref_term)


def step_after_subcycle(d, dt, cfg: ModelConfig, fg: FastGeometry,
                        rayleigh=None, dss_fn=None,
                        use_fused_hyper: bool = False, hyper_fns=None,
                        halo=None):
    """nu4/nu2 hyperviscosity + DSS (+ optional Rayleigh) Strang tail.

    ``dss_fn(d, rayleigh=None, halo=None, walls_out=False)``: full-state DSS
    with an optional Rayleigh finish (``apply_dss``'s keywords).
    ``halo`` (a no-flux grid: the wall rows of ``d``, as the JAX package's
    ``step_after_subcycle_nh(halo=)``): the working DSS of nu4 takes the
    zero halo, the finishing DSS this one, and the call returns ``(out,
    walls)``: the wall rows after that DSS and before the Rayleigh finish,
    or ``halo`` itself where there is no hyperdiffusion.  ``use_fused_hyper``: run each nu4 Laplacian pass as one kernel
    (``fast/hyper_cuda``; the caller must check ``hyper_cuda.supported``).
    ``hyper_fns``: ``(pass1(d), pass2(d, work, nu_s, nu_d, nu_v, dt))`` bound
    to the geometry; ``hyper_cuda``'s wrappers when absent.

    Tracers (when the state has them) take the scalar viscosity through
    ``tracers.scalar_laplacian_tr`` in plain tensor code beside the kernels,
    and the per-element positivity filter before the last DSS (also when
    there is no hyperdiffusion at all)."""
    from . import tracers as ftr
    if dss_fn is None:
        def dss_fn(ds, rayleigh=None, **hk):
            return apply_dss(ds, fg, rayleigh, **hk)
    has_tr = "Tracers" in d
    walled = halo is not None
    # the halo keywords of the working DSS and of the finishing one
    work_kw = {"halo": dss_cuda.ZERO_HALO} if walled else {}
    fin_kw = {"halo": halo, "walls_out": True} if walled else {}

    def finish(ds):
        # order: tracer positivity filter -> DSS -> Rayleigh
        if has_tr:
            ds = dict(ds, Tracers=ftr.filter_horizontal(ds["Tracers"], fg))
        return dss_fn(ds, rayleigh=rayleigh, **fin_kw)

    if not cfg.hyperdiffusion or (
            cfg.nu_scalar == 0 and cfg.nu_div == 0 and cfg.nu_vort == 0):
        out = d
        if has_tr:
            out = dict(out, Tracers=ftr.filter_horizontal(out["Tracers"], fg))
        if rayleigh is not None:
            out = dict(out, **apply_rayleigh(
                {k: out[k] for k in FIELDS}, *rayleigh))
        return (out, halo) if walled else out

    scale = ((fg.nu_delta if fg.nu_delta is not None else fg.delta)
             / fg.reference_length) ** 3.2 \
        if cfg.hypervis_order == 4 else 1.0
    nu_s = cfg.nu_scalar * scale
    nu_d = cfg.nu_div * scale
    nu_v = cfg.nu_vort * scale

    if cfg.hypervis_order == 2:
        du, dv = vector_hyperdiff_update(
            d["U"], d["V"], cfg.nu_div, cfg.nu_vort, fg)
        out = {"U": d["U"] - dt * du, "V": d["V"] - dt * dv}
        for k in ("Rt", "Rho", "W"):
            out[k] = d[k] + dt * nu_s * scalar_laplacian(
                d[k], jac_of(d[k], fg), fg)
        if has_tr:
            out["Tracers"] = d["Tracers"] + dt * nu_s * \
                ftr.scalar_laplacian_tr(d["Tracers"], fg)
        return finish(out)

    # order 4: Lap pass -> DSS -> -dt * nu_local * Lap pass -> DSS
    if use_fused_hyper:
        if hyper_fns is None:
            from . import hyper_cuda
            hyper_fns = (
                lambda x: hyper_cuda.nu4_pass1(x, fg),
                lambda x, w, *nu_dt: hyper_cuda.nu4_pass2(x, w, *nu_dt, fg))
        pass1, pass2 = hyper_fns
        work = pass1(d)
        if has_tr:
            work["Tracers"] = ftr.scalar_laplacian_tr(d["Tracers"], fg)
        work = dss_fn(work, **work_kw)
        out = pass2(d, work, nu_s, nu_d, nu_v, dt)
        if has_tr:
            out["Tracers"] = d["Tracers"] - dt * nu_s * \
                ftr.scalar_laplacian_tr(work["Tracers"], fg)
        return finish(out)

    wu, wv = vector_hyperdiff_update(d["U"], d["V"], 1.0, 1.0, fg)
    work = {"U": -wu, "V": -wv}
    for k in ("Rt", "Rho", "W"):
        work[k] = scalar_laplacian(d[k], jac_of(d[k], fg), fg)
    if has_tr:
        work["Tracers"] = ftr.scalar_laplacian_tr(d["Tracers"], fg)
    work = dss_fn(work, **work_kw)

    du, dv = vector_hyperdiff_update(work["U"], work["V"], nu_d, nu_v, fg)
    out = {"U": d["U"] + dt * du, "V": d["V"] + dt * dv}
    for k in ("Rt", "Rho", "W"):
        out[k] = d[k] - dt * nu_s * scalar_laplacian(
            work[k], jac_of(work[k], fg), fg)
    if has_tr:
        out["Tracers"] = d["Tracers"] - dt * nu_s * \
            ftr.scalar_laplacian_tr(work["Tracers"], fg)
    return finish(out)


# ---------------------------------------------------------------------------
# Strang-HEVI stepper
# ---------------------------------------------------------------------------

def fast_engine_supported(cfg: ModelConfig, has_tracers: bool = False,
                          mesh=None, geom=None) -> bool:
    """The configurations this engine covers: one device, on the cubed
    sphere or on a Cartesian grid (x-z slice or 3-D plane) with periodic
    lateral boundaries or no-flux walls along ONE axis (pass ``geom`` so
    that they can be checked), with or without uniform (nu2) diffusion;
    Strang-HEVI with any of the JAX package's column solvers
    (``vertical_solver`` ``"banded"``, ``"pallas"``, ``"dense"``,
    ``"schur"``, ``"jfnk"``), with or without the implicit Rt/Rho upwind
    penalty (``upwind_thermo``), or the fully explicit vertical path
    (``explicit_vertical``, or ``timescheme`` ERK: the vertical tendency
    in every explicit stage, no implicit solve); with or without tracers;
    in the LOR staggering, or in CPH, LEV or INT (solved densely whatever
    the solver, as in the JAX package) on a periodic grid or the sphere
    without tracers and without uniform diffusion.
    Outside: tracers on a no-flux grid, with uniform diffusion or on the
    explicit vertical path; no-flux walls along both axes (no test case has
    them); and, under CPH, LEV and INT, tracers (the JAX package's column
    tracer update takes W on interfaces), no-flux walls and uniform
    diffusion (the roadmap's).  (The JAX package's engine leaves these
    vertical options, the other staggerings, no-flux grids and uniform
    diffusion to its reference-layout engine.)

    With a ``mesh`` (anything with ``shape = {"x": mx, "y": my}``) the
    answer is the JAX package's for its mesh engine: the cubed sphere, LOR,
    Strang, ``vertical_solver`` ``"banded"`` or ``"pallas"``, no uniform
    diffusion, ``upwind_thermo``, not ``explicit_vertical``, and blocks of
    whole elements (``mx`` and ``my`` divide ``ne * order`` into multiples
    of ``order``); tracers and the Rayleigh layer are in."""
    from ..config import TimestepSchemeType
    if mesh is not None:
        from .mesh_engine import mesh_supported
        return mesh_supported(cfg, mesh)
    uniform = cfg.nu_uniform_scalar != 0.0 or cfg.nu_uniform_vector != 0.0
    explicit = (cfg.explicit_vertical
                or cfg.timescheme == TimestepSchemeType.ERK)
    walls = 0
    if cfg.grid_kind == GridKind.CUBED_SPHERE:
        grid_ok = True
    elif cfg.grid_kind in (GridKind.CARTESIAN_XZ, GridKind.CARTESIAN_3D):
        bcs = (getattr(geom, "bc_x", None), getattr(geom, "bc_y", None))
        walls = bcs.count("noflux")
        grid_ok = (geom is not None
                   and set(bcs) <= {"periodic", "noflux"} and walls < 2
                   and not (walls and has_tracers))
    else:
        grid_ok = False
    lorenz = cfg.vertical_staggering == VerticalStaggering.LORENZ
    return (grid_ok
            and not (uniform and has_tracers)
            and not (explicit and has_tracers)
            and (lorenz or not (has_tracers or walls or uniform))
            and cfg.timescheme in (TimestepSchemeType.STRANG,
                                   TimestepSchemeType.ERK)
            and cfg.vertical_solver in SOLVERS)


def _ref_zf(cfg: ModelConfig, ref_state, fg):
    """The reference state z-first on the device of ``fg``, in the engine's
    layout."""
    ref = pack_state({k: torch.as_tensor(v).to(cfg.dtype)
                      for k, v in ref_state.items()},
                     device=fg.inv_mult.device)
    return _swap_ab_state(ref) if fg.ab_swapped else ref


def _rayleigh_terms(cfg: ModelConfig, geom, ref_state, fg):
    """(fac, ref_term) z-first damping tensors on the device of ``fg``, or
    None (host precompute; the reference's 10-cycle implicit Rayleigh
    factor).  ``ref_state``: reference-layout dict of tensors or arrays,
    in the configuration's staggering.
    ``fg`` also gives the xz exemption (the engine slot named by
    ``fg.xz_zero`` holds the physical V, never damped) and the
    (a, b)-transposed layout of a swapped Cartesian engine."""
    if not (cfg.rayleigh_damping and ref_state is not None):
        return None
    n_cycles = 10
    dt = cfg.dt
    dev = fg.inv_mult.device

    def fac_of(r):
        f = (1.0 / (1.0 + dt * np.asarray(r, np.float64)
                    / n_cycles)) ** n_cycles
        f = np.moveaxis(f, -1, 0)
        return np.swapaxes(f, 2, 3) if fg.ab_swapped else f

    fac_lev = fac_of(geom.rayleigh_lev)
    fac_int = fac_of(geom.rayleigh_int)
    # each field damped where it lives: Rt on interfaces under CPH, W on
    # levels under LEV and INT (the JAX package's ``apply_rayleigh`` takes
    # the Lorenz locations and fails on those shapes)
    stagger = cfg.vertical_staggering
    fac = {"U": fac_lev, "V": fac_lev,
           "Rt": fac_int if stagger == VerticalStaggering.CHARNEY_PHILLIPS
           else fac_lev,
           "Rho": np.ones_like(fac_lev),
           "W": fac_lev if stagger in (VerticalStaggering.LEVELS,
                                       VerticalStaggering.INTERFACES)
           else fac_int}
    if fg.xz_zero is not None:
        fac[fg.xz_zero] = np.ones_like(fac_lev)
    npdt = np_dtype(cfg.dtype)
    fac = {k: torch.as_tensor(np.ascontiguousarray(v, dtype=npdt), device=dev)
           for k, v in fac.items()}
    ref_zf = _ref_zf(cfg, ref_state, fg)
    ref_term = tree_map(lambda f, r: (1.0 - f) * r, fac, ref_zf)
    return (fac, ref_term)


def _strang_fns(cfg: ModelConfig, fg: FastGeometry, rayleigh, dss_fn,
                implicit_fn, stage_fn=None, use_wfold: bool = False,
                hyper_fns=None, uniform=None, vtend=None):
    """The Strang-HEVI step on z-first state, parameterized over the DSS
    and implicit-solve implementations.

    ``vtend(ueval)``: the fully explicit vertical path (the JAX package's
    ``explicit_vertical`` / ERK branch of ``make_strang_step``): every
    stage adds ``dt_s`` times these tendencies of (Rt, W, Rho) after the
    horizontal ones and before the uniform diffusion, the step is the
    explicit RK step and the nu4 tail, with no implicit solve, and its
    carry is empty.  On a no-flux grid this path threads no halo, as the
    JAX package's does: its DSS averages no wall.  ``use_wfold`` must then
    be False.

    ``stage_fn(base, ueval, dt_s, defer_w=False)``: the fused explicit stage
    (``stage_cuda.fused_stage`` bound to the geometry); None runs the stage
    as plain tensor code.  ``use_wfold``: hand the fused stage's W finish to
    ``dss_fn(..., w_finish=)``.  ``hyper_fns``: the two nu4 passes bound to
    the geometry (see ``step_after_subcycle``); None runs the tail as plain
    tensor code.  ``uniform(upd, ueval, dt_s)``: the uniform (nu2)
    diffusion added to every stage's update before its bottom W boundary,
    or None.  Tracers are detected from the state: the fused stage advects
    them in its launch, the plain stage through ``tracers.horizontal_update``.

    On a no-flux grid (``fg.noflux``) the halo goes with the state: every
    stage's DSS averages the walls with the shadow of its base (the JAX
    package's ``erk_substep(shadow0=)``: the shadow of the step's first
    state, combined as the bases are, a stage output its own shadow), the
    tail's with the ERK result's (``step_after_subcycle(halo=)``), and the
    carry holds the tail's wall rows (``halo_U``, ...) for the next step.
    The first step's halo is its state before the implicit half step.

    Returns (first_fn, step_fn): first_fn(d) -> (d, carry),
    step_fn(d, carry) -> (d, carry).  Neither changes its arguments.
    """
    from . import tracers as ftr
    constants = cfg.constants
    dt = cfg.dt
    oc = cfg.off_centering
    explicit = vtend is not None
    if explicit and use_wfold:
        raise ValueError("the explicit vertical path folds no W finish")
    walled = any(fg.noflux) and not explicit

    def axpy(base, tend, dt_s):
        return tree_map(lambda b, t: b + dt_s * t, base, tend)

    def comb(*coeff_states):
        coeffs, states = zip(*coeff_states)
        return tree_map(
            lambda *xs: sum(c * x for c, x in zip(coeffs, xs)), *states)

    def walls(d):
        return walls_of(d, fg) if walled else None

    def shadow_comb(*coeff_shadows):
        return comb(*coeff_shadows) if walled else None

    def stage(base, ueval, dt_s, shadow):
        """base: state dict or 2-term ((c1, d1), (c2, d2)) combination
        (combined inside the fused stage kernel on the fused path);
        ``shadow``: the wall rows of the base's halo (no-flux grids)."""
        hk = {"halo": shadow} if walled else {}
        if stage_fn is not None:
            if use_wfold:
                upd, wfin = stage_fn(base, ueval, dt_s, defer_w=True)
                return dss_fn(upd, w_finish=wfin, **hk)
            upd = stage_fn(base, ueval, dt_s)
            if explicit:
                # the vertical tendency vanishes on W's bottom and top rows:
                # the stage's bottom boundary stays as it is
                upd = dict(upd)
                for k, v in vtend(ueval).items():
                    upd[k] = upd[k] + dt_s * v
            if uniform is not None:
                # the stage came back with its bottom W; the nu2 increment
                # goes on top and the boundary row is written again
                upd = apply_w_boundary(uniform(upd, ueval, dt_s), fg)
            return dss_fn(upd, **hk)
        bb = comb(*base) if isinstance(base, tuple) else base
        tend = horizontal_tendency(ueval, fg, constants)
        if explicit:
            for k, v in vtend(ueval).items():
                tend[k] = tend[k] + v
        upd = axpy({k: bb[k] for k in FIELDS}, tend, dt_s)   # fresh tensors
        if uniform is not None:
            upd = uniform(upd, ueval, dt_s)
        upd = apply_w_boundary(upd, fg)
        if "Tracers" in ueval:
            base_tr = (tuple((c, b["Tracers"]) for c, b in base)
                       if isinstance(base, tuple) else base["Tracers"])
            upd["Tracers"] = ftr.horizontal_update(base_tr, ueval, dt_s, fg)
        return dss_fn(upd, **hk)

    def erk(X0, H0):
        """The explicit RK step from X0, whose halo's wall rows are H0 (None
        without walls); a stage output is its own shadow."""
        scheme = cfg.explicit_scheme
        if scheme == ExplicitSubScheme.FORWARD_EULER:
            return stage(X0, X0, dt, H0)
        if scheme == ExplicitSubScheme.RK4:
            u1 = stage(X0, X0, 0.5 * dt, H0)
            u2 = stage(X0, u1, 0.5 * dt, H0)
            u3 = stage(X0, u2, dt, H0)
            cs = ((1.0 / 3.0, u1), (2.0 / 3.0, u2), (1.0 / 3.0, u3))
            base = comb((-1.0 / 3.0, X0), *cs)
            sh = shadow_comb((-1.0 / 3.0, H0),
                             *((c, walls(u)) for c, u in cs))
            return stage(base, u3, dt / 6.0, sh)
        if scheme == ExplicitSubScheme.SSPRK3:
            u1 = stage(X0, X0, dt, H0)
            u2 = stage(((0.75, X0), (0.25, u1)), u1, 0.25 * dt,
                       shadow_comb((0.75, H0), (0.25, walls(u1))))
            return stage(((1.0 / 3.0, X0), (2.0 / 3.0, u2)),
                         u2, 2.0 * dt / 3.0,
                         shadow_comb((1.0 / 3.0, H0),
                                     (2.0 / 3.0, walls(u2))))
        if scheme == ExplicitSubScheme.KGU35:
            u1 = stage(X0, X0, dt / 5.0, H0)
            u2 = stage(X0, u1, dt / 5.0, H0)
            u3 = stage(X0, u2, dt / 3.0, H0)
            u2b = stage(X0, u3, 2.0 * dt / 3.0, H0)
            # the two-term base is formed in the stage kernel: its shadow
            # is the same combination of the shadows
            return stage(((-0.25, X0), (1.25, u1)), u2b, 0.75 * dt,
                         shadow_comb((-0.25, H0), (1.25, walls(u1))))
        if scheme == ExplicitSubScheme.SSPRK53:
            c1 = 0.377268915331368
            c3 = 0.242995220537396
            c4 = 0.238458932846290
            c5 = 0.287632146308408
            u1 = stage(X0, X0, c1 * dt, H0)
            u2 = stage(u1, u1, c1 * dt, walls(u1))
            a3, b3 = 0.355909775063327, 0.644090224936674
            u3 = stage(((a3, X0), (b3, u2)), u2, c3 * dt,
                       shadow_comb((a3, H0), (b3, walls(u2))))
            a4, b4 = 0.367933791638137, 0.632066208361863
            u0b = stage(((a4, X0), (b4, u3)), u3, c4 * dt,
                        shadow_comb((a4, H0), (b4, walls(u3))))
            a5, b5 = 0.762406163401431, 0.237593836598569
            return stage(((a5, u0b), (b5, u2)), u0b, c5 * dt,
                         shadow_comb((a5, walls(u0b)), (b5, walls(u2))))
        raise ValueError(f"unsupported explicit scheme {scheme}")

    def tail(X, H):
        if "Tracers" in X and (walled or uniform is not None):
            raise NotImplementedError(
                "tracers on a no-flux grid or with uniform diffusion are not "
                "ported yet (see fast_engine_supported)")
        u4 = erk(X, H)
        hk = {"halo": walls(u4)} if walled else {}
        u1 = step_after_subcycle(u4, dt, cfg, fg, rayleigh=rayleigh,
                                 dss_fn=dss_fn,
                                 use_fused_hyper=hyper_fns is not None,
                                 hyper_fns=hyper_fns, **hk)
        if walled:
            u1, hal = u1
        u0 = implicit_fn(u1, 0.5 * (1.0 + oc) * dt)
        if oc != 0.0:
            u0 = comb((0.5 * (2.0 - oc), u0), (0.5 * oc, u1))
        # the LOR implicit solve only updates (Rt, W, Rho) [+ Tracers]; U
        # and V pass through unchanged, so the Strang carryover is
        # identically zero there — carry only the updated fields (the
        # reference carries 5 instance buffers; two are provably no-ops)
        ck = ("Rt", "W", "Rho") + (("Tracers",) if "Tracers" in u0 else ())
        carry = {k: u0[k] - u1[k] for k in ck}
        if walled:
            carry.update({HALO + k: v for k, v in hal.items()})
        return u0, carry

    if explicit:
        def explicit_fn(d, carry=None):
            u4 = erk(d, None)
            return step_after_subcycle(
                u4, dt, cfg, fg, rayleigh=rayleigh, dss_fn=dss_fn,
                use_fused_hyper=hyper_fns is not None,
                hyper_fns=hyper_fns), {}
        return explicit_fn, explicit_fn

    def first_fn(d):
        return tail(implicit_fn(d, 0.5 * dt), walls(d))

    def step_fn(d, carry):
        X0 = dict(d)
        for k in carry:
            if not k.startswith(HALO):
                X0[k] = d[k] + carry[k]
        if "Tracers" in X0:
            X0["Tracers"] = ftr.filter_column(X0["Tracers"], fg)
        H0 = {k: carry[HALO + k] for k in FIELDS} if walled else None
        return tail(X0, H0)

    return first_fn, step_fn


HALO = "halo_"   # the carry's keys of the no-flux halo: halo_U, ...


def _uniform_fn(cfg: ModelConfig, fg: FastGeometry, ref_state, pass1=None):
    """``uniform(upd, ueval, dt_s)``: the uniform (nu2) diffusion of an
    explicit stage (the JAX package's ``uniform_diffusion_update``): the
    Laplacians of ``ueval`` minus the reference state added to the stage's
    update ``upd`` -- the vector one of (U, V) and W's scalar one with the
    vector coefficient, Rt's with the scalar one; Rho is not diffused.
    None where the configuration has none (or no reference state).
    ``pass1``: the ``nu4_pass1`` kernel bound to the geometry, whose work
    fields with coefficient 1 are exactly the Laplacians needed (-wu, -wv,
    lap Rt, lap W); None takes them in plain tensor code."""
    nu_s, nu_v = cfg.nu_uniform_scalar, cfg.nu_uniform_vector
    if (nu_s == 0.0 and nu_v == 0.0) or ref_state is None:
        return None
    ref = _ref_zf(cfg, ref_state, fg)

    def uniform(upd, ueval, dt_s):
        out = dict(upd)
        if pass1 is not None:
            work = pass1({k: ueval[k] - ref[k] for k in FIELDS})
            for k, nu in (("U", nu_v), ("V", nu_v), ("Rt", nu_s),
                          ("W", nu_v)):
                out[k] = upd[k] + (dt_s * nu) * work[k]
            return out
        du, dv = vector_hyperdiff_update(ueval["U"] - ref["U"],
                                         ueval["V"] - ref["V"], nu_v, nu_v,
                                         fg)
        out["U"] = upd["U"] - dt_s * du
        out["V"] = upd["V"] - dt_s * dv
        out["Rt"] = upd["Rt"] + dt_s * nu_s * scalar_laplacian(
            ueval["Rt"] - ref["Rt"], fg.jac3d, fg)
        out["W"] = upd["W"] + dt_s * nu_v * scalar_laplacian(
            ueval["W"] - ref["W"], fg.jac3d_int, fg)
        return out
    return uniform


def make_fast_step(cfg: ModelConfig, geom, ref_state=None, mesh=None,
                   ntracers: int = 0, device=None, plain: bool = False,
                   fused=None, dss_merge=None, swap_ab=None):
    """(first_step, step) on the fast state: step(d, carry) -> (d, carry).

    ``geom``: a ``CubedSphereGeometry`` or a ``CartesianGeometry``
    (periodic, or with no-flux walls along one axis).
    On a Cartesian grid ``swap_ab`` chooses the engine's layout (default
    ``swap_ab_default``); a swapped engine takes and returns the natural
    packed layout, swapping at the step boundary, and its carry stays in the
    engine's layout (opaque to callers).

    The state tensors must lie on ``device`` (default ``cuda``; raises when
    absent).  The step runs eagerly.  Tracers are detected from the state
    (``"Tracers"`` in the dict, as ``pack_state`` lays them out); on one
    device ``ntracers`` is accepted for the JAX package's signature and not
    read.

    ``mesh``: a ``parallel.mesh.ShardMesh`` or ``DistMesh`` of shape
    ``{"x": mx, "y": my}`` — the same per-shard step on every block
    ``(K, 6, A/mx, A/my)``, the routed exchange of ``fast/mesh_dss`` its
    only communication (``fast/mesh_engine``; the configuration must lie in
    ``fast_engine_supported(cfg, mesh=mesh)``).  The step then takes and
    returns sharded states and carries (``mesh.shard`` /
    ``mesh.gather``), ``ntracers`` is the number of species the state
    carries (0: none), and ``device`` is a ``DistMesh`` shard's (a
    ``ShardMesh`` names its own devices).

    ``fused=None`` chooses the path by predicates on the configuration, as
    the JAX package does: the fused stage kernel where
    ``stage_cuda.stage_supported`` holds, its W finish folded into the
    (U, V, W) DSS where the surface interpolant reads levels 0 and 1 only,
    the two nu4 kernels where ``hyper_cuda.supported`` holds, and — with
    ``cfg.vertical_solver == "pallas"`` — the fused implicit kernel where
    ``implicit_cuda.fused_supported`` holds.  ``fused=False`` forces the
    unfused path: the stage, the nu4 tail and the Jacobian assembly as plain
    tensor code, the implicit solve through the banded kernel.  Nothing
    chooses a path because a kernel failed to build or launch.  The DSS
    always goes through the hand-written DSS kernels.

    ``dss_merge``: which groups of fields the DSS takes in one launch (see
    ``apply_dss``); None is ``DSS_MERGE_DEFAULT`` on the fused path and the
    separate launches on the unfused one.

    ``plain=True`` swaps every kernel of the chosen path for its plain
    PyTorch version on the same device (a check of the kernel path, not a
    fallback: nothing selects it automatically).
    """
    first_fn, step_fn, fg = _fast_fns(cfg, geom, ref_state, mesh, device,
                                      plain, fused, dss_merge, swap_ab,
                                      ntracers)
    if not fg.ab_swapped:
        return first_fn, step_fn
    return _natural_layout(first_fn), _natural_layout(step_fn)


def _natural_layout(fn):
    """``fn(d, *carry) -> (d, carry)`` of a swapped engine as a function of
    the natural layout: the state is swapped on the way in and out, the
    carry is not."""
    def wrapped(d, *carry):
        s, c = fn(_swap_ab_state(d), *carry)
        return _swap_ab_state(s), c
    return wrapped


@dataclasses.dataclass
class _Setup:
    """What the steppers of one configuration share, built once
    (``_setup``)."""
    fg: FastGeometry
    fused: bool         # the fused path's kernels where they apply
    rayleigh: Any       # (fac, ref_term) z-first, or None
    dss_fn: Any         # dss_fn(d, rayleigh=None, w_finish=None, halo=None,
    #                   #        walls_out=False)
    implicit_fn: Any    # implicit_fn(d, dti): the vertical implicit solve
    hyper_fns: Any      # the two nu4 passes bound to the geometry, or None
    uniform: Any = None  # the stages' uniform diffusion (_uniform_fn)
    #                    # or None
    vtend: Any = None    # the explicit vertical path's tendencies of
    #                    # (Rt, W, Rho) (``implicit.vertical_explicit_
    #                    # tendency`` bound), or None
    saux: Any = None     # ``implicit.static_aux(fg)``


def _setup(cfg, geom, ref_state, device, plain, fused, dss_merge, swap_ab,
           column_filter: bool = True):
    """The set-up the Strang and the IMEX steppers share: the device, the
    fast geometry and the Rayleigh terms, then ``_setup_on``'s pieces on
    them.  The caller checks the configuration's envelope first."""
    dev = resolve_device(device)
    if isinstance(geom, CubedSphereGeometry):
        fg = build_fast_geometry(geom, dtype=cfg.dtype, device=dev)
    else:
        fg = build_fast_geometry_cartesian(geom, dtype=cfg.dtype, device=dev,
                                           swap_ab=swap_ab)
    return _setup_on(cfg, geom, fg, _rayleigh_terms(cfg, geom, ref_state, fg),
                     ref_state, plain, fused, dss_merge, column_filter)


def _setup_on(cfg, geom, fg, rayleigh, ref_state, plain, fused, dss_merge,
              column_filter: bool = True, hyper=None, dss_fn=None):
    """The pieces of a stepper on the engine geometry ``fg`` (the whole
    grid, or one shard's block of it): the implicit solve's bandwidth,
    statics and (with ``vertical_solver == "pallas"`` on the fused path) the
    fused kernel's statics (another staggering than LOR: the dense solve's
    statics, ``implicit.stagger_statics``, and no bandwidth), the nu4
    passes where ``hyper_cuda.supported`` holds on the fused path, the
    uniform diffusion (its Laplacians by ``nu4_pass1`` where
    ``hyper_cuda.laplacians_supported`` holds on the fused path), and the
    DSS closure.  ``column_filter``: the implicit solve ends the tracers'
    column update in the column positivity filter (Strang's; the IMEX
    family runs none).  ``hyper``: the pair (``laplacians_supported``,
    ``supported``) evaluated elsewhere (a mesh evaluates them once on the
    whole grid, not shard by shard); ``dss_fn``: the DSS closure to use
    instead of ``apply_dss`` (a mesh's exchange)."""
    from . import implicit as fimp
    from . import hyper_cuda, implicit_cuda
    from . import tracers as ftr

    constants = cfg.constants
    dev = fg.inv_mult.device
    solver = cfg.vertical_solver
    lorenz = cfg.vertical_staggering == VerticalStaggering.LORENZ
    if lorenz:
        q = nonhydro.estimate_bandwidth(geom, constants)
        statics = fimp.statics_to_device(
            nonhydro.band_assembly_statics(geom, q,
                                           upwind_thermo=cfg.upwind_thermo),
            cfg.dtype, dev)
    else:
        # CPH, LEV and INT solve densely whatever the solver: no band
        q, statics = 0, fimp.stagger_statics(fg, cfg.upwind_thermo)
    use_pallas = solver == "pallas" and lorenz
    schur = None
    if solver == "schur" and lorenz:
        from ..models.vertical_schur import schur_statics
        schur = schur_statics(fg.nz, q, fg.vo, cfg.dtype, dev)
    saux = fimp.static_aux(fg)

    fused = fused is None or bool(fused)
    if dss_merge is None:
        dss_merge = DSS_MERGE_DEFAULT if fused else ()
    dss_merge = tuple(dss_merge)
    if not set(dss_merge) <= {"state", "scalar2"}:
        raise ValueError(f"dss_merge names groups among 'state' and "
                         f"'scalar2', got {dss_merge}")
    ist = implicit_cuda.implicit_statics(statics, fg) \
        if fused and use_pallas else None

    if hyper is None:
        lap_ok = hyper_cuda.laplacians_supported(fg)
        hyper = (lap_ok, lap_ok and hyper_cuda.supported(fg, cfg))
    hyper_fns = None
    lap_kernel = fused and hyper[0]
    if lap_kernel:
        hst = hyper_cuda.hyper_statics(fg)
        pass1, pass2 = (
            (hyper_cuda.nu4_pass1_plain, hyper_cuda.nu4_pass2_plain) if plain
            else (hyper_cuda.nu4_pass1, hyper_cuda.nu4_pass2))
        if hyper[1]:
            hyper_fns = (lambda x: pass1(x, fg, hst),
                         lambda x, w, *nu_dt: pass2(x, w, *nu_dt, fg, hst))
    uniform = _uniform_fn(cfg, fg, ref_state,
                          (lambda x: pass1(x, fg, hst)) if lap_kernel
                          else None)

    tr_statics = ftr.tracer_statics(fg)

    def implicit_fn(d, dti):
        out = fimp.vertical_implicit(
            d, fg, constants, dti, q, statics,
            newton_iters=cfg.newton_iterations,
            ref_jacobian=(cfg.jacobian_mode == "reference"), saux=saux,
            plain=plain, ist=ist, solver=solver, schur=schur)
        if "Tracers" in d:
            tr = ftr.update_column_tracers(
                d, out["W"], fg, dti, statics=tr_statics, plain=plain)
            if column_filter:
                tr = ftr.filter_column(tr, fg)
            out = dict(out, Tracers=tr)
        return out

    if dss_fn is None:
        def dss_fn(d, rayleigh=None, w_finish=None, halo=None,
                   walls_out=False):
            return apply_dss(d, fg, rayleigh, plain=plain, w_finish=w_finish,
                             merge=dss_merge, halo=halo, walls_out=walls_out)

    vtend = None
    if cfg.explicit_vertical or cfg.timescheme.value == "erk":
        def vtend(d):
            return fimp.vertical_explicit_tendency(d, fg, constants, saux)

    return _Setup(fg=fg, fused=fused, rayleigh=rayleigh, dss_fn=dss_fn,
                  implicit_fn=implicit_fn, hyper_fns=hyper_fns,
                  uniform=uniform, vtend=vtend, saux=saux)


def _uvw_fits(fg: FastGeometry, dtype) -> bool:
    """Whether a launch shape of ``dss_uvw`` fits a block on this grid (its
    ring holds eleven staged fields: a swapped x-z slice of 512 nodes in
    float64 does not fit; the stage's W finish then goes unfolded)."""
    try:
        dss_cuda.dss_launch_shape(fg.nz, fg.npanels, fg.A, fg.B, fg.p, dtype,
                                  "uvw", links=bool(fg.dss_links))
    except ValueError:
        return False
    return True


def _fast_fns(cfg, geom, ref_state, mesh, device, plain, fused, dss_merge,
              swap_ab, ntracers: int = 0):
    """``make_fast_step``'s (first_fn, step_fn) in the engine's layout, and
    the engine geometry (under a mesh: the sharded steps, and the geometry
    of the whole grid)."""
    if mesh is not None:
        from .mesh_engine import mesh_fns
        return mesh_fns(cfg, geom, ref_state, mesh, device, plain, fused,
                        dss_merge, ntracers)
    if not fast_engine_supported(cfg, geom=geom):
        raise NotImplementedError(
            "configuration outside the z-first engine's envelope "
            "(see fast_engine_supported)")
    parts = strang_parts(cfg, geom, ref_state, device, plain, fused,
                         dss_merge, swap_ab)
    return parts.first_fn, parts.step_fn, parts.fg


@dataclasses.dataclass
class StrangParts:
    """One Strang stepper and the pieces it was made of (``strang_parts``):
    what ``Model.profile_phases`` times phase by phase."""
    fg: FastGeometry
    setup: _Setup
    stage_fn: Any       # the fused stage bound to the geometry, or None
    use_wfold: bool
    first_fn: Any
    step_fn: Any


def stage_path(cfg, fg: FastGeometry, fused: bool) -> bool:
    """Whether the step takes the fused stage kernel: the fused path,
    ``stage_cuda.stage_supported`` and the LOR staggering.  The JAX
    package's stage predicate also asks for p | 8 and 8 | A (8 | a under a
    mesh): those are the TPU kernel's tiles.  What is about the math stays
    (vertical order 1, the row test of the W fold); the rest is what the
    CUDA kernels take (stage_supported, hyper_cuda.supported,
    fused_supported).  The stage kernel takes Lorenz shapes: the other
    staggerings run the stage as tensor code (a staggered stage kernel is a
    roadmap item)."""
    from . import stage_cuda
    return (fused and stage_cuda.stage_supported(fg)
            and cfg.vertical_staggering == VerticalStaggering.LORENZ)


def wfold_rows(geom) -> bool:
    """The W fold's row test: the surface interpolant row reads the bottom
    two levels only."""
    In0 = np.asarray(geom.interp_n2i)[0]
    return len(In0) >= 2 and not np.any(In0[2:])


def bind_stage(fg: FastGeometry, constants, plain: bool):
    """``stage_fn(base, ueval, dt_s, defer_w=False)``: the fused stage bound
    to the geometry (its plain version with ``plain``)."""
    from . import stage_cuda
    sst = stage_cuda.stage_statics(fg)

    def stage_fn(base, ueval, dt_s, defer_w=False):
        if plain:
            return stage_cuda.fused_stage_plain(
                base, ueval, dt_s, fg, constants, defer_w=defer_w)
        return stage_cuda.fused_stage(base, ueval, dt_s, fg, constants,
                                      defer_w=defer_w, statics=sst)
    return stage_fn


def strang_parts(cfg, geom, ref_state, device, plain, fused, dss_merge,
                 swap_ab) -> StrangParts:
    """The Strang stepper of one device and its pieces; the caller checks
    the envelope."""
    s = _setup(cfg, geom, ref_state, device, plain, fused, dss_merge,
               swap_ab)
    fg = s.fg
    use_fused_stage = stage_path(cfg, fg, s.fused)
    # fold the W stage finish into the (U, V) DSS launch when the surface
    # interpolant row only reads the bottom two levels, and no uniform
    # diffusion comes between the stage and its DSS
    use_wfold = (use_fused_stage and wfold_rows(geom) and s.uniform is None
                 and s.vtend is None and _uvw_fits(fg, cfg.dtype))
    stage_fn = bind_stage(fg, cfg.constants, plain) \
        if use_fused_stage else None
    first_fn, step_fn = _strang_fns(
        cfg, fg, s.rayleigh, s.dss_fn, s.implicit_fn, stage_fn=stage_fn,
        use_wfold=use_wfold, hyper_fns=s.hyper_fns, uniform=s.uniform,
        vtend=s.vtend)
    return StrangParts(fg=fg, setup=s, stage_fn=stage_fn,
                       use_wfold=use_wfold, first_fn=first_fn,
                       step_fn=step_fn)


def _leaves(tree):
    """The tensors of a state or carry: a dict of tensors, or (a sharded
    state of a ``ShardMesh``) a list of such dicts."""
    if isinstance(tree, dict):
        return list(tree.values())
    return [v for t in tree for v in _leaves(t)]


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: v.clone() for k, v in tree.items()}
    return [_clone_tree(t) for t in tree]


def _copy_tree(dst, src):
    if isinstance(dst, dict):
        for k, v in dst.items():
            v.copy_(src[k])
    else:
        for d, s in zip(dst, src):
            _copy_tree(d, s)


def graph_runner(step, inner_steps: int, graph: bool = True):
    """``run(d, carry) -> (d, carry)``: ``inner_steps`` calls of ``step(d,
    carry) -> (d, carry)`` one after the other.

    For CUDA tensors ``run`` is one CUDA graph: at its first call it runs
    ``step`` once on a side stream (which builds the kernels and uploads
    every lazily made table), captures ``inner_steps`` steps from static
    input buffers into a ``torch.cuda.CUDAGraph``, and from then on each call
    copies its arguments into those buffers, replays the graph and returns
    clones of the static outputs.  The step sizes are constants of the
    captured launches, the same on every step.  The kernels' launch counts
    (``kernels/counts``) rise while the graph is captured, not when it is
    replayed.  For CPU tensors ``run`` is a plain loop over ``step``; the
    choice follows the tensors' device, and on a CUDA tensor ``run``
    captures or raises.  ``run`` keeps ``step`` (and what it closes over)
    alive as long as the graph: a graph must not outlive the tensors its
    launches read.

    ``d`` and ``carry`` are dicts of tensors, or the sharded state of a
    ``parallel.mesh.ShardMesh`` (a list of the shards' dicts on one
    device): its graph holds every shard's launches and the copies between
    shards, captured from the shards' threads on the capturing stream.
    ``graph=False`` (a ``DistMesh``, whose exchanges are not captured): a
    plain loop on every device."""
    inner_steps = int(inner_steps)
    if inner_steps < 1:
        raise ValueError("inner_steps must be at least 1")
    captured = {}

    def loop(d, carry):
        for _ in range(inner_steps):
            d, carry = step(d, carry)
        return d, carry

    def capture(d, carry, dev):
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(d, carry)
        torch.cuda.current_stream(dev).wait_stream(side)
        ins = (_clone_tree(d), _clone_tree(carry))
        g = torch.cuda.CUDAGraph()
        # a sharded step launches from the shards' threads: only this
        # thread's own calls are held to the capture's rules
        mode = "global" if isinstance(d, dict) else "thread_local"
        with torch.cuda.graph(g, capture_error_mode=mode):
            outs = loop(*ins)
        return g, ins, outs

    def run(d, carry):
        dev = _leaves(d)[0].device
        if dev.type == "cpu" or not graph:
            return loop(d, carry)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        with torch.cuda.device(dev):
            if "graph" not in captured:
                captured["graph"] = capture(d, carry, dev)
            g, ins, outs = captured["graph"]
            for static, given in zip(ins, (d, carry)):
                _copy_tree(static, given)
            g.replay()
            return tuple(_clone_tree(o) for o in outs)

    return run


def make_fast_multistep(cfg: ModelConfig, geom, inner_steps: int,
                        ref_state=None, mesh=None, ntracers: int = 0,
                        device=None, plain: bool = False, fused=None,
                        dss_merge=None, swap_ab=None):
    """(first_step, multi): ``multi(d, carry) -> (d, carry)`` after
    ``inner_steps`` steps of ``make_fast_step``'s ``step``, one CUDA graph
    for CUDA tensors and a plain loop for CPU tensors (``graph_runner``).
    ``first_step`` stays eager.  A swapped Cartesian engine swaps once
    around the ``inner_steps`` steps, not around each.  On a ``ShardMesh``
    whose shards share a device the graph holds every shard's steps and the
    copies between them; on a ``DistMesh`` ``multi`` stays an eager loop (its
    exchanges are not captured).  The other arguments are
    ``make_fast_step``'s."""
    first_step, step, fg = _fast_fns(cfg, geom, ref_state, mesh, device,
                                     plain, fused, dss_merge, swap_ab,
                                     ntracers)
    run = graph_runner(step, inner_steps,
                       graph=getattr(mesh, "graphs", True))
    if not fg.ab_swapped:
        return first_step, run
    return _natural_layout(first_step), _natural_layout(run)


# ---------------------------------------------------------------------------
# IMEX-ARK family on the z-first engine
# ---------------------------------------------------------------------------

IMEX_SCHEMES = ("ars222", "ars232", "ark232", "gark2", "ars343",
                "ars343b", "ars443", "ssp3332")


def fast_imex_supported(cfg: ModelConfig, has_tracers: bool = False,
                        geom=None) -> bool:
    """Whether the IMEX-ARK family can run on the z-first engine: the Strang
    engine's envelope (grid, staggering, solver; pass ``geom`` for a
    Cartesian grid), any scheme of ``IMEX_SCHEMES``, one device, no tracers
    (the IMEX steps carry tendencies as whole states of the five fields;
    the JAX package's z-first IMEX refuses tracers the same way, although
    the reference and the JAX package's reference-layout IMEX advance
    them)."""
    from ..config import TimestepSchemeType
    if cfg.timescheme.value not in IMEX_SCHEMES or has_tracers:
        return False
    # the staggerings other than LOR, no-flux walls, uniform diffusion, the
    # explicit vertical path, the solvers other than the banded ones and
    # upwind_thermo=False are the Strang engine's only (the JAX package's
    # IMEX takes none of them)
    if cfg.vertical_staggering != VerticalStaggering.LORENZ \
            or cfg.nu_uniform_scalar != 0.0 or cfg.nu_uniform_vector != 0.0 \
            or "noflux" in (getattr(geom, "bc_x", None),
                            getattr(geom, "bc_y", None)) \
            or cfg.explicit_vertical or not cfg.upwind_thermo \
            or cfg.vertical_solver not in ("banded", "pallas"):
        return False
    return fast_engine_supported(
        cfg.with_(timescheme=TimestepSchemeType.STRANG), geom=geom)


def imex_supported(cfg: ModelConfig, has_tracers: bool = False,
                   geom=None) -> bool:
    """Whether the port's IMEX-ARK step runs this configuration: wherever
    the JAX package's ``Model`` runs an IMEX scheme on one device (its
    reference-layout ``make_nh_imex_step`` outside ``fast_imex_supported``).
    That is the Strang engine's grids (the sphere; Cartesian grids, periodic
    or with no-flux walls along one axis: pass ``geom``), every column
    solver and staggering, any ``upwind_thermo``, ``explicit_vertical`` and
    uniform diffusion (the JAX package's IMEX reads none of the three), and
    tracers in the LOR staggering, on any of those grids (no halo goes with
    an IMEX state).  Outside: a device mesh, walls along both axes, and
    tracers under CPH, LEV and INT, as in the Strang engine."""
    from ..config import TimestepSchemeType
    if cfg.timescheme.value not in IMEX_SCHEMES:
        return False
    if has_tracers and \
            cfg.vertical_staggering != VerticalStaggering.LORENZ:
        return False
    return fast_engine_supported(
        cfg.with_(timescheme=TimestepSchemeType.STRANG,
                  explicit_vertical=False, nu_uniform_scalar=0.0,
                  nu_uniform_vector=0.0), geom=geom)


def make_fast_imex_step(cfg: ModelConfig, geom, ref_state=None, device=None,
                        plain: bool = False, dss_merge=None, swap_ab=None):
    """IMEX-ARK step on the z-first engine: ``step(state) -> state`` on
    reference-layout (z-last) states, as the JAX package's
    ``make_fast_imex_step``.

    Each stage takes the horizontal tendency (``horizontal_tendency``, the
    penalty upwinding folded in), the bottom W boundary and the full-state
    DSS (``apply_dss``, no W finish: with ``"state"`` in ``dss_merge`` one
    ``dss_cuda.dss_state`` launch), and the vertical implicit solve
    (``fused_implicit_update`` with ``vertical_solver == "pallas"``, else the
    banded kernel); the stage combinations follow ``timestep/imex.py``'s
    tableaux, GARK2 its own two stages; then the nu4 / Rayleigh tail
    (``step_after_subcycle``, the nu4 kernels where ``hyper_cuda.supported``
    holds) over the full dt.  No fused stage kernel runs here.

    ``step`` packs the state onto ``device`` (default ``cuda``; raises when
    absent), swaps (a, b) on a swapped Cartesian engine, runs the stages,
    swaps back and unpacks.  ``plain``, ``dss_merge`` and ``swap_ab`` mean
    what they mean in ``make_fast_step``.  The configuration must lie in
    ``fast_imex_supported``, the JAX package's z-first envelope; the rest of
    ``imex_supported`` is ``models/nh_model.make_nh_imex_step``'s."""
    if not fast_imex_supported(cfg, geom=geom):
        raise NotImplementedError(
            "configuration outside the IMEX engine's envelope (see "
            "fast_imex_supported; models/nh_model.make_nh_imex_step takes "
            "the rest of imex_supported)")
    return imex_step(cfg, geom, ref_state, device, plain, dss_merge, swap_ab)


def imex_step(cfg, geom, ref_state=None, device=None, plain=False,
              dss_merge=None, swap_ab=None, fused=None):
    """``make_fast_imex_step``'s ``step(state) -> state`` on any
    configuration of ``imex_supported`` (``fused=False``: the unfused
    path)."""
    body, fg = _imex_body(cfg, geom, ref_state, device, plain, dss_merge,
                          swap_ab, fused)
    dev = fg.inv_mult.device

    def step(state):
        d = pack_state(state, device=dev)
        if fg.ab_swapped:
            d = _swap_ab_state(d)
        out = body(d)
        if fg.ab_swapped:
            out = _swap_ab_state(out)
        return unpack_state(out)

    return step


def _imex_body(cfg, geom, ref_state, device, plain, dss_merge, swap_ab,
               fused=None):
    """The IMEX step on the engine's z-first layout, ``body(d) -> d``, and
    the engine geometry, for any configuration of ``imex_supported``.

    The JAX package's IMEX (``timestep/imex.py``) is held to here, quirks
    included: the implicit Rt/Rho upwind penalty is on whatever
    ``upwind_thermo`` says, ``explicit_vertical`` and the uniform (nu2)
    diffusion do nothing, no halo goes with the state on a no-flux grid
    (its DSS averages no wall), the tracers' horizontal tendency joins the
    stage tendencies and their column update ends in no positivity filter
    (the tail's per-element filter still runs).  The Schur solver takes the
    estimated half-bandwidth, as in the Strang engine (the JAX package's
    IMEX hands it q = 0, ROADMAP's caveats).  ``fused=False``: no kernel
    of the fused path (the implicit solve through the banded kernel, the
    nu4 tail as tensor code, the DSS as separate launches by default)."""
    import math
    from ..config import TimestepSchemeType
    from ..timestep.imex import _tableaux
    from . import tracers as ftr

    if not imex_supported(cfg, geom=geom):
        raise NotImplementedError(
            "configuration outside the port's IMEX envelope (see "
            "imex_supported)")
    # what the JAX package's IMEX does not read, set as its step behaves
    icfg = cfg.with_(upwind_thermo=True, explicit_vertical=False,
                     nu_uniform_scalar=0.0, nu_uniform_vector=0.0)
    s = _setup(icfg, geom, ref_state, device, plain, fused, dss_merge,
               swap_ab, column_filter=False)
    fg, constants, dt = s.fg, cfg.constants, cfg.dt
    lorenz = cfg.vertical_staggering == VerticalStaggering.LORENZ

    def tend(u):
        out = horizontal_tendency(u, fg, constants)
        if "Tracers" in u:
            if not lorenz:
                raise NotImplementedError(
                    "tracers under the CPH, LEV and INT staggerings are not "
                    "ported yet (see imex_supported)")
            out["Tracers"] = ftr.horizontal_tendency_tr(u, fg)
        return out

    def post(u, fresh=True):
        # the bottom boundary writes W in place: a state that is not a
        # fresh combination (the stage's base itself) gets a W of its own
        if not fresh:
            u = dict(u, W=u["W"].clone())
        return s.dss_fn(apply_w_boundary(u, fg))

    def tail(u):
        return step_after_subcycle(u, dt, icfg, fg, rayleigh=s.rayleigh,
                                   dss_fn=s.dss_fn,
                                   use_fused_hyper=s.hyper_fns is not None,
                                   hyper_fns=s.hyper_fns)

    def axpy(b, t, c):
        return tree_map(lambda x, y: x + c * y, b, t)

    if cfg.timescheme == TimestepSchemeType.GARK2:
        g = 1.0 - 0.5 * math.sqrt(2.0)
        al = 0.5

        def body(u0):
            F0 = tend(u0)
            uf1 = post(axpy(u0, F0, g * dt))
            u1 = s.implicit_fn(uf1, g * dt)
            G1 = tree_map(lambda a, b: (a - b) / (g * dt), u1, uf1)
            uf2 = post(axpy(axpy(u0, F0, dt), G1, dt))
            F1 = tend(uf2)
            z2 = axpy(axpy(axpy(u0, F0, al * dt), G1, (1.0 - g) * dt),
                      F1, (1.0 - al) * dt)
            z2 = post(z2)
            u2 = s.implicit_fn(z2, g * dt)
            return tail(u2)
    else:
        aexp, aimp = _tableaux(cfg.timescheme)
        nst = len(aexp)

        def body(u0):
            u = u0
            F, G = [], []
            for i in range(nst):
                F.append(tend(u))
                uf, fresh = u0, False
                for j in range(i + 1):
                    if aexp[i][j] != 0.0:
                        uf, fresh = axpy(uf, F[j], aexp[i][j] * dt), True
                for j in range(i):
                    if aimp[i][j] != 0.0:
                        uf, fresh = axpy(uf, G[j], aimp[i][j] * dt), True
                uf = post(uf, fresh)
                if aimp[i][i] != 0.0:
                    u = s.implicit_fn(uf, aimp[i][i] * dt)
                    G.append(tree_map(
                        lambda a, b: (a - b) / (aimp[i][i] * dt), u, uf))
                else:
                    u = uf
                    G.append(tree_map(lambda a: a * 0.0, uf))
            return tail(u)

    return body, fg

