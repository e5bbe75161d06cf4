"""Z-first engine: geometry, DSS, tendencies, Strang stepper.

Counterpart of the JAX package's ``fast/engine.py``, for the cubed sphere
and the periodic Cartesian grids (x-z slice, 3-D plane) on one device.  The
execution shape is that package's:

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
with a short y extent may run (a, b)-transposed (``_swap_ab_state``).

``make_fast_imex_step`` runs the IMEX-ARK family (``IMEX_SCHEMES``) on the
same pieces: per stage the horizontal tendency, the full-state DSS and the
vertical implicit solve, then the nu4 tail.

Not ported yet (they wait in the roadmap, none is declared unnecessary):
the device-mesh engine and no-flux Cartesian boundaries.

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
    """Z-first fast state -> reference-layout state dict (same device)."""
    out = {k: d[k].movedim(0, -1).contiguous() for k in FIELDS}
    if "Tracers" in d:
        t = d["Tracers"]
        nzz = d["Rt"].shape[0]
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

    n_edges = len(geom.edge_meta)
    e_rot = np.zeros((4, n_edges, A), f64)
    mats = np.asarray(geom.edge_mats, f64)          # (6, 4, A, 2, 2)
    for i, (pa, e, qa, qe, flip) in enumerate(geom.edge_meta):
        M = mats[pa, e]                              # (A, 2, 2)
        e_rot[0, i] = M[:, 0, 0]
        e_rot[1, i] = M[:, 0, 1]
        e_rot[2, i] = M[:, 1, 0]
        e_rot[3, i] = M[:, 1, 1]

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
        e_rot=c(e_rot),
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
    ``GridCartesianGLL::ApplyDSS`` periodic averaging.  The engine takes
    periodic lateral boundaries only (``fast_engine_supported``).

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


def apply_dss(d, fg: FastGeometry, rayleigh=None, plain: bool = False,
              w_finish=None, merge=DSS_MERGE_DEFAULT):
    """DSS of the full fast state (U/V rotate as a covariant pair).

    Four launches (vector pair + 3 scalars) unless ``merge`` says otherwise:
    with ``"state"`` in it, a full five-field state goes through the
    one-launch ``dss_cuda.dss_state`` (the Rayleigh finish inside the
    launch); with ``"scalar2"``, Rt and Rho share one launch
    (``dss_cuda.dss_scalar2``).  The results are the same bit for bit.
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
    tensors (or raises) and runs the plain versions for CPU tensors."""
    common = (fg.inv_mult, fg.dss_links, fg.p)
    kw = {"wrap": fg.wrap} if plain else {"wrap": fg.wrap,
                                          "table": fg.dss_table}
    scalar = dss_cuda.dss_scalar_plain if plain else dss_cuda.dss_scalar
    if w_finish is None and "state" in merge:
        fn = dss_cuda.dss_state_plain if plain else dss_cuda.dss_state
        out = fn(d, fg.inv_mult, fg.e_rot, fg.dss_links, fg.p,
                 rayleigh=rayleigh, **kw)
        if "Tracers" in d:
            out["Tracers"] = scalar(d["Tracers"], *common, **kw)
        return out
    if w_finish is not None:
        fn = dss_cuda.dss_uvw_plain if plain else dss_cuda.dss_uvw
        u, v, w = fn(d["U"], d["V"], fg.inv_mult, fg.e_rot, fg.dss_links,
                     fg.p, w_finish, **kw)
        out = {"U": u, "V": v, "W": w}
    else:
        fn = dss_cuda.dss_vector_plain if plain else dss_cuda.dss_vector
        u, v = fn(d["U"], d["V"], fg.inv_mult, fg.e_rot, fg.dss_links, fg.p,
                  **kw)
        out = {"U": u, "V": v, "W": scalar(d["W"], *common, **kw)}
    if "scalar2" in merge:
        fn = dss_cuda.dss_scalar2_plain if plain else dss_cuda.dss_scalar2
        out["Rt"], out["Rho"] = fn(d["Rt"], d["Rho"], *common, **kw)
    else:
        for k in ("Rt", "Rho"):
            out[k] = scalar(d[k], *common, **kw)
    if rayleigh is not None:
        out = apply_rayleigh(out, *rayleigh)
    if "Tracers" in d:
        out["Tracers"] = scalar(d["Tracers"], *common, **kw)
    return out


# ---------------------------------------------------------------------------
# Nonhydrostatic tendencies (LOR staggering)
# ---------------------------------------------------------------------------

def horizontal_tendency(d, fg: FastGeometry, constants: PhysicalConstants,
                        mask_w: bool = True):
    """Horizontal tendencies of the five fields (LOR staggering), with the
    vertical penalty upwinding of U/V folded into the U/V rows.
    ``mask_w=False`` leaves the bottom and top rows of the W tendency as the
    interpolation gives them (the deferred W finish masks them later)."""
    nz = fg.nz
    u, v = d["U"], d["V"]
    rt, rho, w = d["Rt"], d["Rho"], d["W"]

    w_n = colop(fg.interp_i2n, w)

    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    con_ua = c_aa * u + c_ab * v + fg.con_a_xi * w_n
    con_ub = c_ba * u + c_bb * v + fg.con_b_xi * w_n
    con_ux = fg.con_a_xi * u + fg.con_b_xi * v + fg.con_xi_xi * w_n

    ke = 0.5 * (con_ua * u + con_ub * v + con_ux * w_n)
    exner = nonhydro.exner_from_rhotheta(rt, constants)

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
    div_rt = hweak_div(base_a * rt, base_b * rt, fg)

    dke_a = hderiv_a(ke, fg)
    dke_b = hderiv_b(ke, fg)
    dpi_a = hderiv_a(exner, fg)
    dpi_b = hderiv_b(exner, fg)

    theta = rt / rho
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
    dRt = -div_rt / fg.jac3d

    dW = colop(fg.interp_n2i, ucz_x)      # a fresh tensor
    if mask_w:
        dW[0] = 0.0                       # written in place
        dW[-1] = 0.0

    # --- vertical explicit penalty upwinding of U/V (per unit dt) --------
    u_i = colop(fg.interp_n2i, u)
    v_i = colop(fg.interp_n2i, v)
    xid = (fg.con_a_xi_int * u_i + fg.con_b_xi_int * v_i
           + fg.con_xi_xi_int * w)
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
    """Diagnostic bottom W from u^xi(surface) = 0.  Writes row 0 of
    ``d["W"]`` IN PLACE: the caller passes a state it has just made."""
    u0 = colop(fg.interp_n2i[0:1], d["U"])[0]
    v0 = colop(fg.interp_n2i[0:1], d["V"])[0]
    w0 = -(fg.con_a_xi_int[0] * u0 + fg.con_b_xi_int[0] * v0) \
        / fg.con_xi_xi_int[0]
    d["W"][0] = w0
    return d


# ---------------------------------------------------------------------------
# Hyperdiffusion tail (nu4 / nu2)
# ---------------------------------------------------------------------------

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
                        use_fused_hyper: bool = False, hyper_fns=None):
    """nu4/nu2 hyperviscosity + DSS (+ optional Rayleigh) Strang tail.

    ``dss_fn(d, rayleigh=None)``: full-state DSS with an optional Rayleigh
    finish.  ``use_fused_hyper``: run each nu4 Laplacian pass as one kernel
    (``fast/hyper_cuda``; the caller must check ``hyper_cuda.supported``).
    ``hyper_fns``: ``(pass1(d), pass2(d, work, nu_s, nu_d, nu_v, dt))`` bound
    to the geometry; ``hyper_cuda``'s wrappers when absent.

    Tracers (when the state has them) take the scalar viscosity through
    ``tracers.scalar_laplacian_tr`` in plain tensor code beside the kernels,
    and the per-element positivity filter before the last DSS (also when
    there is no hyperdiffusion at all)."""
    from . import tracers as ftr
    if dss_fn is None:
        dss_fn = lambda ds, rayleigh=None: apply_dss(ds, fg, rayleigh)
    has_tr = "Tracers" in d

    def finish(ds):
        # order: tracer positivity filter -> DSS -> Rayleigh
        if has_tr:
            ds = dict(ds, Tracers=ftr.filter_horizontal(ds["Tracers"], fg))
        return dss_fn(ds, rayleigh=rayleigh)

    if not cfg.hyperdiffusion or (
            cfg.nu_scalar == 0 and cfg.nu_div == 0 and cfg.nu_vort == 0):
        out = d
        if has_tr:
            out = dict(out, Tracers=ftr.filter_horizontal(out["Tracers"], fg))
        if rayleigh is not None:
            out = dict(out, **apply_rayleigh(
                {k: out[k] for k in FIELDS}, *rayleigh))
        return out

    scale = ((fg.nu_delta if fg.nu_delta is not None else fg.delta)
             / fg.reference_length) ** 3.2 \
        if cfg.hypervis_order == 4 else 1.0
    nu_s = cfg.nu_scalar * scale
    nu_d = cfg.nu_div * scale
    nu_v = cfg.nu_vort * scale

    if cfg.hypervis_order == 2:
        du, dv = vector_hyperdiff_update(
            d["U"], d["V"], cfg.nu_div, cfg.nu_vort, fg)
        out = {
            "U": d["U"] - dt * du, "V": d["V"] - dt * dv,
            "Rt": d["Rt"] + dt * nu_s * scalar_laplacian(
                d["Rt"], fg.jac3d, fg),
            "Rho": d["Rho"] + dt * nu_s * scalar_laplacian(
                d["Rho"], fg.jac3d, fg),
            "W": d["W"] + dt * nu_s * scalar_laplacian(
                d["W"], fg.jac3d_int, fg),
        }
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
        work = dss_fn(work)
        out = pass2(d, work, nu_s, nu_d, nu_v, dt)
        if has_tr:
            out["Tracers"] = d["Tracers"] - dt * nu_s * \
                ftr.scalar_laplacian_tr(work["Tracers"], fg)
        return finish(out)

    wu, wv = vector_hyperdiff_update(d["U"], d["V"], 1.0, 1.0, fg)
    work = {
        "U": -wu, "V": -wv,
        "Rt": scalar_laplacian(d["Rt"], fg.jac3d, fg),
        "Rho": scalar_laplacian(d["Rho"], fg.jac3d, fg),
        "W": scalar_laplacian(d["W"], fg.jac3d_int, fg),
    }
    if has_tr:
        work["Tracers"] = ftr.scalar_laplacian_tr(d["Tracers"], fg)
    work = dss_fn(work)

    du, dv = vector_hyperdiff_update(work["U"], work["V"], nu_d, nu_v, fg)
    out = {
        "U": d["U"] + dt * du, "V": d["V"] + dt * dv,
        "Rt": d["Rt"] - dt * nu_s * scalar_laplacian(
            work["Rt"], fg.jac3d, fg),
        "Rho": d["Rho"] - dt * nu_s * scalar_laplacian(
            work["Rho"], fg.jac3d, fg),
        "W": d["W"] - dt * nu_s * scalar_laplacian(
            work["W"], fg.jac3d_int, fg),
    }
    if has_tr:
        out["Tracers"] = d["Tracers"] - dt * nu_s * \
            ftr.scalar_laplacian_tr(work["Tracers"], fg)
    return finish(out)


# ---------------------------------------------------------------------------
# Strang-HEVI stepper
# ---------------------------------------------------------------------------

def fast_engine_supported(cfg: ModelConfig, has_tracers: bool = False,
                          mesh=None, geom=None) -> bool:
    """The configurations this engine covers: LOR staggering, Strang-HEVI,
    with or without tracers, on one device, on the cubed sphere or on a
    Cartesian grid (x-z slice or 3-D plane) with PERIODIC lateral
    boundaries -- pass ``geom`` so that they can be checked; no-flux grids
    are outside.  (The JAX package's engine also covers a device mesh; that
    waits in the roadmap.)"""
    from ..config import TimestepSchemeType
    if cfg.grid_kind == GridKind.CUBED_SPHERE:
        grid_ok = True
    elif cfg.grid_kind in (GridKind.CARTESIAN_XZ, GridKind.CARTESIAN_3D):
        grid_ok = (geom is not None
                   and getattr(geom, "bc_x", None) == "periodic"
                   and getattr(geom, "bc_y", None) == "periodic")
    else:
        grid_ok = False
    return (grid_ok
            and mesh is None
            and cfg.vertical_staggering == VerticalStaggering.LORENZ
            and cfg.timescheme == TimestepSchemeType.STRANG
            and not cfg.explicit_vertical
            and cfg.vertical_solver in ("banded", "pallas")
            and cfg.nu_uniform_scalar == 0.0
            and cfg.nu_uniform_vector == 0.0
            and cfg.upwind_thermo)


def _rayleigh_terms(cfg: ModelConfig, geom, ref_state, fg):
    """(fac, ref_term) z-first damping tensors on the device of ``fg``, or
    None (host precompute; the reference's 10-cycle implicit Rayleigh
    factor).  ``ref_state``: reference-layout dict of tensors or arrays.
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
    fac = {"U": fac_lev, "V": fac_lev, "Rt": fac_lev,
           "Rho": np.ones_like(fac_lev), "W": fac_int}
    if fg.xz_zero is not None:
        fac[fg.xz_zero] = np.ones_like(fac_lev)
    npdt = np_dtype(cfg.dtype)
    fac = {k: torch.as_tensor(np.ascontiguousarray(v, dtype=npdt), device=dev)
           for k, v in fac.items()}
    ref_zf = pack_state({k: torch.as_tensor(v).to(cfg.dtype)
                         for k, v in ref_state.items()}, device=dev)
    if fg.ab_swapped:
        ref_zf = _swap_ab_state(ref_zf)
    ref_term = tree_map(lambda f, r: (1.0 - f) * r, fac, ref_zf)
    return (fac, ref_term)


def _strang_fns(cfg: ModelConfig, fg: FastGeometry, rayleigh, dss_fn,
                implicit_fn, stage_fn=None, use_wfold: bool = False,
                hyper_fns=None):
    """The Strang-HEVI step on z-first state, parameterized over the DSS
    and implicit-solve implementations.

    ``stage_fn(base, ueval, dt_s, defer_w=False)``: the fused explicit stage
    (``stage_cuda.fused_stage`` bound to the geometry); None runs the stage
    as plain tensor code.  ``use_wfold``: hand the fused stage's W finish to
    ``dss_fn(..., w_finish=)``.  ``hyper_fns``: the two nu4 passes bound to
    the geometry (see ``step_after_subcycle``); None runs the tail as plain
    tensor code.  Tracers are detected from the state: the fused stage
    advects them in its launch, the plain stage through
    ``tracers.horizontal_update``.

    Returns (first_fn, step_fn): first_fn(d) -> (d, carry),
    step_fn(d, carry) -> (d, carry).  Neither changes its arguments.
    """
    from . import tracers as ftr
    constants = cfg.constants
    dt = cfg.dt
    oc = cfg.off_centering

    def axpy(base, tend, dt_s):
        return tree_map(lambda b, t: b + dt_s * t, base, tend)

    def comb(*coeff_states):
        coeffs, states = zip(*coeff_states)
        return tree_map(
            lambda *xs: sum(c * x for c, x in zip(coeffs, xs)), *states)

    def stage(base, ueval, dt_s):
        """base: state dict or 2-term ((c1, d1), (c2, d2)) combination
        (combined inside the fused stage kernel on the fused path)."""
        if stage_fn is not None:
            if use_wfold:
                upd, wfin = stage_fn(base, ueval, dt_s, defer_w=True)
                return dss_fn(upd, w_finish=wfin)
            return dss_fn(stage_fn(base, ueval, dt_s))
        bb = comb(*base) if isinstance(base, tuple) else base
        tend = horizontal_tendency(ueval, fg, constants)
        upd = axpy({k: bb[k] for k in FIELDS}, tend, dt_s)   # fresh tensors
        upd = apply_w_boundary(upd, fg)
        if "Tracers" in ueval:
            base_tr = (tuple((c, b["Tracers"]) for c, b in base)
                       if isinstance(base, tuple) else base["Tracers"])
            upd["Tracers"] = ftr.horizontal_update(base_tr, ueval, dt_s, fg)
        return dss_fn(upd)

    def erk(X0):
        scheme = cfg.explicit_scheme
        if scheme == ExplicitSubScheme.FORWARD_EULER:
            return stage(X0, X0, dt)
        if scheme == ExplicitSubScheme.RK4:
            u1 = stage(X0, X0, 0.5 * dt)
            u2 = stage(X0, u1, 0.5 * dt)
            u3 = stage(X0, u2, dt)
            base = comb((-1.0 / 3.0, X0), (1.0 / 3.0, u1),
                        (2.0 / 3.0, u2), (1.0 / 3.0, u3))
            return stage(base, u3, dt / 6.0)
        if scheme == ExplicitSubScheme.SSPRK3:
            u1 = stage(X0, X0, dt)
            u2 = stage(((0.75, X0), (0.25, u1)), u1, 0.25 * dt)
            return stage(((1.0 / 3.0, X0), (2.0 / 3.0, u2)),
                         u2, 2.0 * dt / 3.0)
        if scheme == ExplicitSubScheme.KGU35:
            u1 = stage(X0, X0, dt / 5.0)
            u2 = stage(X0, u1, dt / 5.0)
            u3 = stage(X0, u2, dt / 3.0)
            u2b = stage(X0, u3, 2.0 * dt / 3.0)
            return stage(((-0.25, X0), (1.25, u1)), u2b, 0.75 * dt)
        if scheme == ExplicitSubScheme.SSPRK53:
            c1 = 0.377268915331368
            c3 = 0.242995220537396
            c4 = 0.238458932846290
            c5 = 0.287632146308408
            u1 = stage(X0, X0, c1 * dt)
            u2 = stage(u1, u1, c1 * dt)
            u3 = stage(((0.355909775063327, X0),
                        (0.644090224936674, u2)), u2, c3 * dt)
            u0b = stage(((0.367933791638137, X0),
                         (0.632066208361863, u3)), u3, c4 * dt)
            return stage(((0.762406163401431, u0b),
                          (0.237593836598569, u2)), u0b, c5 * dt)
        raise ValueError(f"unsupported explicit scheme {scheme}")

    def tail(X):
        u4 = erk(X)
        u1 = step_after_subcycle(u4, dt, cfg, fg, rayleigh=rayleigh,
                                 dss_fn=dss_fn,
                                 use_fused_hyper=hyper_fns is not None,
                                 hyper_fns=hyper_fns)
        u0 = implicit_fn(u1, 0.5 * (1.0 + oc) * dt)
        if oc != 0.0:
            u0 = comb((0.5 * (2.0 - oc), u0), (0.5 * oc, u1))
        # the LOR implicit solve only updates (Rt, W, Rho) [+ Tracers]; U
        # and V pass through unchanged, so the Strang carryover is
        # identically zero there — carry only the updated fields (the
        # reference carries 5 instance buffers; two are provably no-ops)
        ck = ("Rt", "W", "Rho") + (("Tracers",) if "Tracers" in u0 else ())
        carry = {k: u0[k] - u1[k] for k in ck}
        return u0, carry

    def first_fn(d):
        return tail(implicit_fn(d, 0.5 * dt))

    def step_fn(d, carry):
        X0 = dict(d)
        for k in carry:
            X0[k] = d[k] + carry[k]
        if "Tracers" in X0:
            X0["Tracers"] = ftr.filter_column(X0["Tracers"], fg)
        return tail(X0)

    return first_fn, step_fn


def make_fast_step(cfg: ModelConfig, geom, ref_state=None, mesh=None,
                   ntracers: int = 0, device=None, plain: bool = False,
                   fused=None, dss_merge=None, swap_ab=None):
    """(first_step, step) on the fast state: step(d, carry) -> (d, carry).

    ``geom``: a ``CubedSphereGeometry`` or a periodic ``CartesianGeometry``.
    On a Cartesian grid ``swap_ab`` chooses the engine's layout (default
    ``swap_ab_default``); a swapped engine takes and returns the natural
    packed layout, swapping at the step boundary, and its carry stays in the
    engine's layout (opaque to callers).

    The state tensors must lie on ``device`` (default ``cuda``; raises when
    absent).  The step runs eagerly.  Tracers are detected from the state
    (``"Tracers"`` in the dict, as ``pack_state`` lays them out); ``ntracers``
    is accepted for the JAX package's signature and not read.

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
                                      plain, fused, dss_merge, swap_ab)
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
    dss_fn: Any         # dss_fn(d, rayleigh=None, w_finish=None)
    implicit_fn: Any    # implicit_fn(d, dti): the vertical implicit solve
    hyper_fns: Any      # the two nu4 passes bound to the geometry, or None


def _setup(cfg, geom, ref_state, device, plain, fused, dss_merge, swap_ab):
    """The set-up the Strang and the IMEX steppers share: the device, the
    fast geometry, the implicit solve's bandwidth, statics and (with
    ``vertical_solver == "pallas"`` on the fused path) the fused kernel's
    statics, the nu4 passes where ``hyper_cuda.supported`` holds on the
    fused path, the Rayleigh terms and the DSS closure.  The caller checks
    the configuration's envelope first."""
    from . import implicit as fimp
    from . import hyper_cuda, implicit_cuda
    from . import tracers as ftr

    dev = resolve_device(device)
    constants = cfg.constants
    if isinstance(geom, CubedSphereGeometry):
        fg = build_fast_geometry(geom, dtype=cfg.dtype, device=dev)
    else:
        fg = build_fast_geometry_cartesian(geom, dtype=cfg.dtype, device=dev,
                                           swap_ab=swap_ab)

    q = nonhydro.estimate_bandwidth(geom, constants)
    statics = fimp.statics_to_device(
        nonhydro.band_assembly_statics(geom, q), cfg.dtype, dev)
    use_pallas = cfg.vertical_solver == "pallas"
    rayleigh = _rayleigh_terms(cfg, geom, ref_state, fg)
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

    hyper_fns = None
    if fused and hyper_cuda.supported(fg, cfg):
        hst = hyper_cuda.hyper_statics(fg)
        pass1, pass2 = (
            (hyper_cuda.nu4_pass1_plain, hyper_cuda.nu4_pass2_plain) if plain
            else (hyper_cuda.nu4_pass1, hyper_cuda.nu4_pass2))
        hyper_fns = (lambda x: pass1(x, fg, hst),
                     lambda x, w, *nu_dt: pass2(x, w, *nu_dt, fg, hst))

    tr_statics = ftr.tracer_statics(fg)

    def implicit_fn(d, dti):
        out = fimp.vertical_implicit(
            d, fg, constants, dti, q, statics,
            newton_iters=cfg.newton_iterations, use_pallas=use_pallas,
            ref_jacobian=(cfg.jacobian_mode == "reference"), saux=saux,
            plain=plain, ist=ist)
        if "Tracers" in d:
            tr = ftr.update_column_tracers(
                d, out["W"], fg, dti, statics=tr_statics, plain=plain)
            out = dict(out, Tracers=ftr.filter_column(tr, fg))
        return out

    def dss_fn(d, rayleigh=None, w_finish=None):
        return apply_dss(d, fg, rayleigh, plain=plain, w_finish=w_finish,
                         merge=dss_merge)

    return _Setup(fg=fg, fused=fused, rayleigh=rayleigh, dss_fn=dss_fn,
                  implicit_fn=implicit_fn, hyper_fns=hyper_fns)


def _fast_fns(cfg, geom, ref_state, mesh, device, plain, fused, dss_merge,
              swap_ab):
    """``make_fast_step``'s (first_fn, step_fn) in the engine's layout, and
    the engine geometry."""
    from . import stage_cuda

    if mesh is not None:
        raise NotImplementedError("the device-mesh engine is not ported yet")
    if not fast_engine_supported(cfg, geom=geom):
        raise NotImplementedError(
            "configuration outside the z-first engine's envelope "
            "(see fast_engine_supported)")
    s = _setup(cfg, geom, ref_state, device, plain, fused, dss_merge,
               swap_ab)
    fg, constants = s.fg, cfg.constants

    # The path.  The JAX package's stage predicate also asks for p | 8 and
    # 8 | A: those are the TPU kernel's tiles.  What is about the math stays
    # (vertical order 1, the row test of the W fold); the rest is what the
    # CUDA kernels take (stage_supported, hyper_cuda.supported,
    # fused_supported).
    use_fused_stage = s.fused and stage_cuda.stage_supported(fg)
    # fold the W stage finish into the (U, V) DSS launch when the surface
    # interpolant row only reads the bottom two levels
    In0 = np.asarray(geom.interp_n2i)[0]
    use_wfold = (use_fused_stage and len(In0) >= 2
                 and not np.any(In0[2:]))

    stage_fn = None
    if use_fused_stage:
        sst = stage_cuda.stage_statics(fg)

        def stage_fn(base, ueval, dt_s, defer_w=False):
            if plain:
                return stage_cuda.fused_stage_plain(
                    base, ueval, dt_s, fg, constants, defer_w=defer_w)
            return stage_cuda.fused_stage(base, ueval, dt_s, fg, constants,
                                          defer_w=defer_w, statics=sst)

    first_fn, step_fn = _strang_fns(
        cfg, fg, s.rayleigh, s.dss_fn, s.implicit_fn, stage_fn=stage_fn,
        use_wfold=use_wfold, hyper_fns=s.hyper_fns)
    return first_fn, step_fn, fg


def graph_runner(step, inner_steps: int):
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
    launches read."""
    inner_steps = int(inner_steps)
    if inner_steps < 1:
        raise ValueError("inner_steps must be at least 1")
    captured = {}

    def loop(d, carry):
        for _ in range(inner_steps):
            d, carry = step(d, carry)
        return d, carry

    def capture(d, carry):
        dev = d["U"].device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(d, carry)
        torch.cuda.current_stream(dev).wait_stream(side)
        ins = ({k: v.clone() for k, v in d.items()},
               {k: v.clone() for k, v in carry.items()})
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = loop(*ins)
        return graph, ins, outs

    def run(d, carry):
        dev = d["U"].device
        if dev.type == "cpu":
            return loop(d, carry)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        with torch.cuda.device(dev):
            if "graph" not in captured:
                captured["graph"] = capture(d, carry)
            graph, ins, outs = captured["graph"]
            for static, given in zip(ins, (d, carry)):
                for k, v in static.items():
                    v.copy_(given[k])
            graph.replay()
            return tuple({k: v.clone() for k, v in o.items()} for o in outs)

    return run


def make_fast_multistep(cfg: ModelConfig, geom, inner_steps: int,
                        ref_state=None, mesh=None, ntracers: int = 0,
                        device=None, plain: bool = False, fused=None,
                        dss_merge=None, swap_ab=None):
    """(first_step, multi): ``multi(d, carry) -> (d, carry)`` after
    ``inner_steps`` steps of ``make_fast_step``'s ``step``, one CUDA graph
    for CUDA tensors and a plain loop for CPU tensors (``graph_runner``).
    ``first_step`` stays eager.  A swapped Cartesian engine swaps once
    around the ``inner_steps`` steps, not around each.  The other arguments
    are ``make_fast_step``'s."""
    first_step, step, fg = _fast_fns(cfg, geom, ref_state, mesh, device,
                                     plain, fused, dss_merge, swap_ab)
    run = graph_runner(step, inner_steps)
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
    return fast_engine_supported(
        cfg.with_(timescheme=TimestepSchemeType.STRANG), geom=geom)


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
    what they mean in ``make_fast_step``."""
    body, fg = _imex_body(cfg, geom, ref_state, device, plain, dss_merge,
                          swap_ab)
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


def _imex_body(cfg, geom, ref_state, device, plain, dss_merge, swap_ab):
    """``make_fast_imex_step``'s step on the engine's z-first layout,
    ``body(d) -> d``, and the engine geometry."""
    import math
    from ..config import TimestepSchemeType
    from ..timestep.imex import _tableaux

    if not fast_imex_supported(cfg, geom=geom):
        raise NotImplementedError(
            "configuration outside the IMEX engine's envelope (see "
            "fast_imex_supported)")
    s = _setup(cfg, geom, ref_state, device, plain, None, dss_merge, swap_ab)
    fg, constants, dt = s.fg, cfg.constants, cfg.dt

    def tend(u):
        return horizontal_tendency(u, fg, constants)

    def post(u, fresh=True):
        # the bottom boundary writes W in place: a state that is not a
        # fresh combination (the stage's base itself) gets a W of its own
        if not fresh:
            u = dict(u, W=u["W"].clone())
        return s.dss_fn(apply_w_boundary(u, fg))

    def tail(u):
        return step_after_subcycle(u, dt, cfg, fg, rayleigh=s.rayleigh,
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

