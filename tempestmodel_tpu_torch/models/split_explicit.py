"""Split-explicit (acoustic-substepped) nonhydrostatic dynamics on the
z-first engine.

Counterpart of the JAX package's ``models/split_explicit.py`` (the
reference's ``SplitExplicitDynamics`` with ``TimestepSchemeSplitExp``,
``--hmethod SPEX``): each KGU35 macro-stage evaluates the full slow + fast
tendency once, then runs ``NSUB`` acoustic subcycles that advance state
increments with the linearized fast (acoustic) operator: the horizontal
momentum forward with a forward-weighted pressure increment (divergence
damping, ``BETA_D``), then the off-centred (``BETA_S``) implicit vertical
solve ``(I + ts L_v) x = r`` over (Rt', W', Rho') of every column; after
the stages the nu4 / Rayleigh tail of the z-first engine.

The JAX package runs this on its reference-layout engine; here the same
math runs on the z-first fields and reuses the engine's pieces:
``engine.horizontal_tendency`` (the U, V penalty upwinding folded in, as
the JAX package's ``vertical_explicit_increment`` adds it),
``implicit.vertical_explicit_tendency``, the tracers' horizontal tendency
(``fast/tracers``), the full-state DSS (``dss_cuda.dss_state`` with the
default grouping, the tracers through ``dss_scalar``), ``apply_w_boundary``
and ``engine.step_after_subcycle`` (the nu4 kernels).  The fast operator
is linear in its tangents, so its bands come from applying it to the
``2q+1`` colour seeds (no autograd); they are in the interleaved ordering
and the ``(n, 2q+1, ncol)`` layout of ``ops/cuda_banded.banded_solve``,
the hand-written kernel that solves every subcycle's vertical system on
the card (whatever ``vertical_solver`` says; its plain form for CPU
tensors or with ``plain=True``).

A Cartesian grid runs in its natural (a, b) layout.  On a no-flux grid
the normal contravariant velocity is zeroed at the walls after every DSS
(the JAX package's ``apply_noflux_x/y``); no halo is threaded.  The step
carries nothing: ``step(d, carry)`` ignores ``carry`` and returns ``{}``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (ExplicitSubScheme, ModelConfig, TimestepSchemeType,
                      VerticalStaggering)
from ..fast import engine
from ..fast.engine import (FastGeometry, colop, hderiv_a, hderiv_b,
                           hweak_div, tree_map)
from ..fast.implicit import _deinterleave, _interleave
from ..ops.cuda_banded import banded_solve
from ..timestep.explicit import erk_substep
from .nonhydro import estimate_bandwidth, exner_from_rhotheta
from .vertical_banded import banded_solve_t

BETA_S = 0.1     # off-centring of the vertical implicit solve
BETA_D = 0.1     # forward weighting of the pressure increment
NSUB = 3         # acoustic subcycles a stage (the reference hardcodes 3)


def split_supported(cfg: ModelConfig, has_tracers: bool = False,
                    geom=None) -> bool:
    """Whether SPEX or HS can run here: one device, the LOR staggering, the
    grids of the z-first engine (``fast_engine_supported``'s; pass ``geom``
    for a Cartesian grid).  The JAX package's steps take neither the other
    staggerings (their column operators are Lorenz's).  Uniform
    diffusion, the explicit vertical switch and the column solver are not
    read by these schemes, in the JAX package as here."""
    if cfg.vertical_staggering != VerticalStaggering.LORENZ:
        return False
    return engine.fast_engine_supported(
        cfg.with_(timescheme=TimestepSchemeType.STRANG,
                  explicit_vertical=False, nu_uniform_scalar=0.0,
                  nu_uniform_vector=0.0, vertical_solver="pallas"),
        has_tracers=has_tracers, geom=geom)


def check_supported(cfg: ModelConfig, geom, name: str):
    if not split_supported(cfg, geom=geom):
        raise NotImplementedError(
            f"{name} runs in the LOR staggering on one device, on the "
            f"z-first engine's grids (the JAX package's {name} step takes "
            f"no other staggering)")


# ---------------------------------------------------------------------------
# the fast (acoustic) column operator and its bands
# ---------------------------------------------------------------------------

def _mask_i(nz, like):
    """1 on the interior interfaces, 0 on the bottom and top: (nz+1, 1)."""
    m = like.new_ones((nz + 1, 1))
    m[0] = 0.0
    m[-1] = 0.0
    return m


def fast_base(d, fg: FastGeometry, constants):
    """The base-state coefficients of the fast operator at the state ``d``
    (z-first), each ``(rows, ncol)``: the JAX package's
    ``fast_column_multi_jvp`` before it reads its tangents."""
    nz = fg.nz
    Q = d["Rho"][0].numel()
    rt0 = d["Rt"].reshape(nz, Q)
    rho0 = d["Rho"].reshape(nz, Q)
    w0 = d["W"].reshape(nz + 1, Q)
    u_i = fg.interp_n2i @ d["U"].reshape(nz, Q)
    v_i = fg.interp_n2i @ d["V"].reshape(nz, Q)
    mask_i = _mask_i(nz, rt0)
    pi_n0 = exner_from_rhotheta(rt0, constants)
    cxi = fg.con_xi_xi_int.reshape(nz + 1, Q)
    xid_i0 = (fg.con_a_xi_int.reshape(nz + 1, Q) * u_i
              + fg.con_b_xi_int.reshape(nz + 1, Q) * v_i + cxi * w0)
    return {
        "rho_i0": fg.interp_n2i @ rho0,
        "rt_i0": fg.interp_n2i @ rt0,
        "dpi_drt": (constants.Rd / (constants.Cp - constants.Rd))
        * pi_n0 / rt0,
        "dpi_i0": fg.diff_n2i @ pi_n0,
        "cxi": cxi,
        "xid_i0": xid_i0 * mask_i,
        "mask_i": mask_i,
        "jac_i": fg.jac3d_int.reshape(nz + 1, Q),
        "inv_jac": 1.0 / fg.jac3d.reshape(nz, Q),
    }


def fast_apply(b, fg: FastGeometry, drt, dw, drho):
    """The fast operator L_v on tangents ``(..., nz | nz+1, ncol)`` (or a
    column that broadcasts): the linearized vertical flux divergence of
    (Rt, Rho) and the linearized pressure gradient and buoyancy in W.
    Returns (dRt, dW, dRho) of the same leading shape."""
    drho_i = fg.interp_n2i @ drho
    drt_i = fg.interp_n2i @ drt
    dpi_n = b["dpi_drt"] * drt
    ddpi_i = fg.diff_n2i @ dpi_n
    mask_i = b["mask_i"]
    dxid_i = b["cxi"] * dw * mask_i
    rho_i0, rt_i0, xid_i0 = b["rho_i0"], b["rt_i0"], b["xid_i0"]
    jac_i = b["jac_i"]

    dmf_i = jac_i * (drho_i * xid_i0 + rho_i0 * dxid_i) * mask_i
    df_rho = (fg.diff_i2n @ dmf_i) * b["inv_jac"]
    dpf_i = jac_i * (drt_i * xid_i0 + rt_i0 * dxid_i) * mask_i
    df_rt = (fg.diff_i2n @ dpf_i) * b["inv_jac"]

    dpi_i0 = b["dpi_i0"]
    dpgf = (ddpi_i * rt_i0 / rho_i0 + dpi_i0 * drt_i / rho_i0
            - dpi_i0 * rt_i0 * drho_i / (rho_i0 * rho_i0))
    return df_rt, dpgf * mask_i, df_rho


def colour_seeds(nz, q, like):
    """The ``2q+1`` colour seeds in block parts, and the gather that reads
    the bands from the operator's products on them: seed ``c`` is 1 at
    every interleaved index ``j`` with ``j % (2q+1) == c``.  Returns
    ``(seeds, colour, valid)``: three tensors of shape ``(2q+1, nz | nz+1,
    1)``, then ``(n, 2q+1)`` the colour of column ``i + d - q`` and its 0/1
    range mask.  Built once (on the device and in the dtype of ``like``): a
    graph capture copies nothing from the host."""
    b = 2 * q + 1
    n = 3 * nz + 1
    k = np.arange(nz + 1)
    idx_w = np.where(k < nz, 3 * k + 1, 3 * nz)
    cols = np.arange(b)[:, None]

    def seed(idx):
        return like.new_tensor((idx[None, :] % b == cols).astype(np.float64)
                               )[..., None]
    col = np.arange(n)[:, None] + np.arange(b)[None, :] - q
    colour = torch.as_tensor(np.mod(col, b), device=like.device)
    valid = like.new_tensor(((col >= 0) & (col < n)).astype(np.float64))
    return ((seed(3 * k[:nz]), seed(idx_w), seed(3 * k[:nz] + 2)), colour,
            valid)


def fast_bands(b, fg: FastGeometry, q: int, seeds=None):
    """The bands of L_v, ``(n, 2q+1, ncol)`` in the interleaved ordering
    (band ``[i, d]`` = L[i, i + d - q], zero out of range): the operator
    applied to the colour seeds, entry ``[i, d]`` read from the colour of
    column ``i + d - q`` (the JAX package's ``_extract_fast_bands``).
    ``seeds``: ``colour_seeds(fg.nz, q, ...)``, made here when absent."""
    if seeds is None:
        seeds = colour_seeds(fg.nz, q, b["rt_i0"])
    parts, colour, valid = seeds
    jvs = _interleave(*fast_apply(b, fg, *parts), fg.nz)  # (2q+1, n, ncol)
    rows = torch.arange(jvs.shape[1], device=jvs.device)
    return jvs[colour, rows[:, None]] * valid[..., None]


# ---------------------------------------------------------------------------
# the acoustic loop
# ---------------------------------------------------------------------------

def hflux_div_linear(fg: FastGeometry, q0, du, dv):
    """The linearized horizontal flux divergence ``-div(J q0 u'(du, dv)) /
    J`` of the increment winds against the base density or rho theta."""
    con_u = fg.c2_aa[None] * du + fg.c2_ab[None] * dv
    con_v = fg.c2_ba[None] * du + fg.c2_bb[None] * dv
    div = hweak_div(fg.jac3d * con_u * q0, fg.jac3d * con_v * q0, fg)
    return -div / fg.jac3d


def make_acoustic_loop(cfg: ModelConfig, fg: FastGeometry, q: int, solve):
    """``acoustic_loop(state, tend, dt_s) -> increments`` (z-first dicts):
    ``NSUB`` subcycles of ``dt_s / NSUB``, each the forward horizontal
    momentum update with the forward-weighted pressure increment, the
    linearized horizontal flux divergences, and one vertical solve
    ``solve(bands, rhs, q)`` of ``(I + ts_i L_v) x = r``.  The tracers'
    increment is ``dt_s`` times their tendency."""
    constants = cfg.constants
    nz = fg.nz
    seeds = colour_seeds(nz, q, fg.jac3d)

    def acoustic_loop(state, tend, dt_s):
        dtau = dt_s / NSUB
        ts_i = dtau * 0.5 * (1.0 + BETA_S)
        ts_e = dtau * 0.5 * (1.0 - BETA_S)
        shp = tuple(state["Rho"].shape[1:])
        Q = state["Rho"][0].numel()
        b = fast_base(state, fg, constants)
        bands = ts_i * fast_bands(b, fg, q, seeds)
        bands[:, q] += 1.0                 # I + ts_i L_v (a fresh tensor)

        rt0, rho0 = state["Rt"], state["Rho"]
        theta0 = rt0 / rho0
        pi0 = exner_from_rhotheta(rt0, constants)
        dpi_drt0 = (constants.Rd / (constants.Cp - constants.Rd)) * pi0 / rt0
        t_rt = tend["Rt"].reshape(nz, Q)
        t_w = tend["W"].reshape(nz + 1, Q)
        t_rho = tend["Rho"].reshape(nz, Q)
        mask_w = b["mask_i"]

        inc = {k: torch.zeros_like(state[k]) for k in engine.FIELDS}
        rt_prev = inc["Rt"]
        for _ in range(NSUB):
            # forward-weighted pressure increment (divergence damping)
            rt_fw = (1.0 + BETA_D) * inc["Rt"] - BETA_D * rt_prev
            dpi = dpi_drt0 * rt_fw
            # horizontal momentum (covariant: the PGF is -theta d(pi))
            if fg.xz_zero == "U":
                u_new = inc["U"]
            else:
                u_new = inc["U"] + dtau * (
                    tend["U"] - theta0 * hderiv_a(dpi, fg))
            if fg.xz_zero == "V":
                v_new = inc["V"]
            else:
                v_new = inc["V"] + dtau * (
                    tend["V"] - theta0 * hderiv_b(dpi, fg))
            dh_rho = hflux_div_linear(fg, rho0, u_new, v_new).reshape(nz, Q)
            dh_rt = hflux_div_linear(fg, rt0, u_new, v_new).reshape(nz, Q)

            # the vertical implicit solve for (Rt', W', Rho')
            x_rt = inc["Rt"].reshape(nz, Q)
            x_w = inc["W"].reshape(nz + 1, Q)
            x_rho = inc["Rho"].reshape(nz, Q)
            l_rt, l_w, l_rho = fast_apply(b, fg, x_rt, x_w, x_rho)
            rhs = _interleave(
                x_rt + dtau * (t_rt + dh_rt) - ts_e * l_rt,
                (x_w + dtau * t_w - ts_e * l_w) * mask_w,
                x_rho + dtau * (t_rho + dh_rho) - ts_e * l_rho, nz)
            s_rt, s_w, s_rho = _deinterleave(solve(bands, rhs, q), nz)
            rt_prev = inc["Rt"]
            inc = {"U": u_new, "V": v_new,
                   "Rt": s_rt.reshape((nz,) + shp),
                   "W": s_w.reshape((nz + 1,) + shp),
                   "Rho": s_rho.reshape((nz,) + shp)}
        if "Tracers" in tend:
            inc["Tracers"] = dt_s * tend["Tracers"]
        return inc

    return acoustic_loop


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def noflux_zero(d, fg: FastGeometry):
    """Zero normal contravariant velocity at the no-flux walls (the JAX
    package's ``apply_noflux_x`` / ``apply_noflux_y`` on the z-first
    natural layout): U at the first and last node along a from V and W
    (g^{aa} U + g^{ab} V + g^{a xi} W = 0), V along b likewise.  Returns a
    new dict (the wall rows written into a copy)."""
    walls_a, walls_b = fg.noflux
    if not (walls_a or walls_b):
        return d
    d = dict(d)
    w_n = colop(fg.interp_i2n, d["W"])
    if walls_a:
        fix = -(fg.c2_ab[None] * d["V"] + fg.con_a_xi * w_n) / fg.c2_aa[None]
        u = d["U"].clone()
        u[:, :, 0] = fix[:, :, 0]
        u[:, :, -1] = fix[:, :, -1]
        d["U"] = u
    if walls_b:
        fix = -(fg.c2_ab[None] * d["U"] + fg.con_b_xi * w_n) / fg.c2_bb[None]
        v = d["V"].clone()
        v[..., 0] = fix[..., 0]
        v[..., -1] = fix[..., -1]
        d["V"] = v
    return d


def full_tendency(d, fg: FastGeometry, constants, saux=None):
    """The full slow + fast tendency of a z-first state: the horizontal one
    (the U, V penalty upwinding folded in), the explicit vertical one of
    (Rt, W, Rho), and the tracers' horizontal one."""
    from ..fast import implicit as fimp
    from ..fast import tracers as ftr
    tend = engine.horizontal_tendency(d, fg, constants)
    for k, v in fimp.vertical_explicit_tendency(d, fg, constants,
                                                saux).items():
        tend[k] = tend[k] + v
    if "Tracers" in d:
        tend["Tracers"] = ftr.horizontal_tendency_tr(d, fg)
    return tend


def make_spex_step(cfg: ModelConfig, geom, ref_state=None, device=None,
                   plain: bool = False):
    """(step, fg) of the split-explicit scheme on z-first states
    (``engine.pack_state``'s layout; tensors on ``device``, default
    ``cuda``, raising when absent): ``step(d[, carry]) -> (d, {})``, self-
    starting, so it is its own first step, the carry unused (the JAX
    package's ``make_spex_step`` returns a zero carry); it leaves its
    arguments alone.  KGU35 over full tendencies with ``NSUB`` acoustic
    subcycles a stage, then the nu4 / Rayleigh tail.  ``plain=True`` runs
    every kernel's plain version (a check of the kernel path)."""
    from ..fast import implicit as fimp
    check_supported(cfg, geom, "SPEX")
    s = engine._setup(cfg, geom, ref_state, device, plain, None, None,
                      False)
    fg, constants, dt = s.fg, cfg.constants, cfg.dt
    q = estimate_bandwidth(geom, constants)
    saux = fimp.static_aux(fg)
    loop = make_acoustic_loop(cfg, fg, q,
                              banded_solve_t if plain else banded_solve)

    def post(upd):
        return noflux_zero(s.dss_fn(upd), fg)

    def substage(base, ueval, dt_s):
        tend = s.dss_fn(full_tendency(ueval, fg, constants, saux))
        inc = loop(ueval, tend, dt_s)
        upd = tree_map(lambda a, b: a + b, base, inc)   # fresh tensors
        return post(engine.apply_w_boundary(upd, fg))

    def step_fn(d, carry=None):
        u4 = erk_substep(ExplicitSubScheme.KGU35, d, dt, substage)
        u1 = engine.step_after_subcycle(
            u4, dt, cfg, fg, rayleigh=s.rayleigh, dss_fn=s.dss_fn,
            use_fused_hyper=s.hyper_fns is not None, hyper_fns=s.hyper_fns)
        return noflux_zero(u1, fg), {}

    return step_fn, fg
