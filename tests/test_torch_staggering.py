"""The CPH, LEV and INT vertical staggerings on the port's z-first engine
against the JAX package, float64 on the CPU.

JAX runs these through its reference-layout engine (``nh_model.
make_nh_step``): every solver turns into a dense Newton solve with the
``jax.jacfwd`` Jacobian of the staggered column residual.  3 steps of
``make_fast_step`` (the fused choice and ``fused=False``) against 3 JAX
steps, 1e-11 relative per field (U and V against their common scale):

- the inertia-gravity wave x-z slice (nex 4, nz 8; INT nz 9 at vertical
  order 2; dt 2 s; explicit vertical path dt 0.5 s): CPH, LEV and INT,
  CPH with nu4, CPH with ``upwind_thermo=False``, the explicit vertical
  path under CPH and LEV; ``vertical_solver="pallas"`` under CPH is the
  dense step;
- UMJS on the sphere (ne2 p4 nz6, dt 100 s: at 300 s both packages turn
  non-finite within 3 steps from the converted start), CPH and LEV with
  nu4 and the Rayleigh layer.

JAX's tail fails where a scalar's location is not Lorenz's: its nu4/nu2
picks the interface Jacobian for Rt whenever Rt and W have the same
length (``hyperdiff.py:187-189``; under LEV and INT they both have nz),
and ``nonhydro.apply_rayleigh`` damps Rt with the level factor and W with
the interface one.  Where those run, the reference here is JAX's
``make_nh_step`` with its tail replaced by ``jax_tail_by_rows``: the same
order of the same pieces of the JAX package (``scalar_laplacian``,
``vector_hyperdiff_update``, the DSS), with each scalar's Jacobian and
Rayleigh factor chosen by its row count.  A test holds that tail to JAX's
own where JAX's runs, and another that JAX's own still raises, so that a
repair in the reference shows.

Each JAX configuration compiles once per module (about 5-10 s on the
x-z slice, 20 s on the sphere).  This file holds the pieces (no JAX step);
the steps are in ``test_torch_staggering_steps.py`` (CPH, LEV, INT, CPH
with nu4), ``test_torch_staggering_options.py`` (``upwind_thermo=False``,
the explicit vertical path, INT with nu4, the ``"pallas"`` solver) and
``test_torch_staggering_sphere.py`` (UMJS; JAX's own tail where it runs
and where it raises)."""

from unittest import mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import (hyperdiff as j_hd, nh_model as j_nh,
                                     nonhydro as j_nonh)
from tempestmodel_tpu.testcases import nonhydro_xz as j_xz
from tempestmodel_tpu.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as JaxUMJS)
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.fast import (engine as t_engine, hyper_cuda,
                                         implicit as t_imp)
from tempestmodel_tpu_torch.models import nh_model as t_nh, nonhydro as t_nonh
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz

from torch_port_common import CPU, FIELDS
from test_torch_vertical_solvers import assert_steps_close

STEPS = 3
XZ = dict(nex=4, ney=1, order=4, nz=8, dt=2.0, hyperdiffusion=False,
          nu_scalar=1e12, nu_div=1e12, nu_vort=1e12,
          vertical_solver="dense")
SPHERE = dict(ne=2, order=4, nz=6, dt=100.0, hyperdiffusion=True,
              nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
              vertical_solver="dense", rayleigh_damping=True)

# name: (grid, staggering, configuration changes, JAX's tail by rows)
CASES = {
    "cph": ("xz", "CPH", {}, False),
    "lev": ("xz", "LEV", {}, False),
    "int": ("xz", "INT", dict(nz=9, vertical_order=2), False),
    "cph_nu4": ("xz", "CPH", dict(hyperdiffusion=True), False),
    "cph_upwind_off": ("xz", "CPH", dict(upwind_thermo=False), False),
    "cph_explicit": ("xz", "CPH", dict(explicit_vertical=True, dt=0.5),
                     False),
    "lev_explicit": ("xz", "LEV", dict(explicit_vertical=True, dt=0.5),
                     False),
    "int_nu4": ("xz", "INT", dict(nz=9, vertical_order=2,
                                  hyperdiffusion=True), True),
    "sphere_cph": ("sphere", "CPH", {}, True),
    "sphere_lev": ("sphere", "LEV", {}, True),
}


def configs(name):
    """(jcfg, tcfg, jgeom, tgeom, start, ref) of case ``name``: the JAX
    package's initial and reference states (numpy) in the staggering."""
    grid, stag, over, _ = CASES[name]
    if grid == "xz":
        jtc, ttc = j_xz.InertiaGravityWave(), t_xz.InertiaGravityWave()
        kw = dict(XZ, ztop=jtc.ztop, x_extent=jtc.x_extent,
                  y_extent=jtc.y_extent, **over)
        kind = "CARTESIAN_XZ"
    else:
        jtc = JaxUMJS(pert="exp", rayleigh=True)
        kw = dict(SPHERE, ztop=jtc.ztop, **over)
        kind = "CUBED_SPHERE"
    jcfg = tj.ModelConfig(grid_kind=getattr(tj.GridKind, kind),
                          vertical_staggering=tj.VerticalStaggering(stag),
                          dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=getattr(tt.GridKind, kind),
                          vertical_staggering=tt.VerticalStaggering(stag),
                          dtype=torch.float64, **kw)
    ref = None
    if grid == "xz":
        jgeom = j_nh.build_nh_cartesian_geometry(jcfg)
        tgeom = t_nh.build_nh_cartesian_geometry(tcfg)
        start = jtc.initial_state(jgeom, jcfg.constants, stagger=stag)
    else:
        rayl = jtc.rayleigh_strength
        jgeom = j_nh.build_nh_sphere_geometry(jcfg, ztop=jtc.ztop,
                                              rayleigh=rayl)
        tgeom = t_nh.build_nh_sphere_geometry(tcfg, ztop=jtc.ztop,
                                              rayleigh=rayl)
        start = j_nonh.convert_stagger(
            jtc.initial_state(jgeom, jcfg.constants), jgeom, stag)
        ref = {k: np.asarray(v) for k, v in j_nonh.convert_stagger(
            jtc.reference_state(jgeom, jcfg.constants), jgeom,
            stag).items()}
    start = {k: np.asarray(v) for k, v in start.items()}
    return jcfg, tcfg, jgeom, tgeom, start, ref


def jax_tail_by_rows(state, dt, cfg, geom, dss_state, ref_state=None,
                     halo=None):
    """JAX ``hyperdiff.step_after_subcycle_nh`` (no tracers, no halo) with
    each scalar's 3-D Jacobian and Rayleigh factor chosen by its row count
    (nz: the level ones; nz + 1: the interface ones), assembled from the
    JAX package's own pieces in the same order."""
    assert halo is None and "Tracers" not in state
    nz = geom.nz

    def jac(f):
        return geom.jac3d if f.shape[-1] == nz else geom.jac3d_int

    def rayleigh(s):
        n = 10
        fac = {nz: (1.0 / (1.0 + dt * geom.rayleigh_lev / n)) ** n,
               nz + 1: (1.0 / (1.0 + dt * geom.rayleigh_int / n)) ** n}
        out = dict(s)
        for c in (["U", "Rt", "W"] if geom.is_xz else ["U", "V", "Rt", "W"]):
            f = fac[s[c].shape[-1]]
            out[c] = f * s[c] + (1.0 - f) * ref_state[c]
        return out

    def finish(s, with_dss):
        if with_dss:
            s = dss_state(s)
        if cfg.rayleigh_damping and ref_state is not None:
            s = rayleigh(s)
        return s

    if not cfg.hyperdiffusion:
        return finish(state, False)
    scale = j_hd.nu_local_scale(geom) if cfg.hypervis_order == 4 else 1.0
    nu_s = cfg.nu_scalar * scale

    def scalars(s, sign_dt, nus):
        return {k: sign_dt * nus * j_hd.scalar_laplacian(s[k], geom,
                                                         jac(s[k]))
                for k in ("Rt", "W", "Rho")}

    if cfg.hypervis_order == 2:
        out = dict(state)
        for k, v in scalars(state, dt, nu_s).items():
            out[k] = state[k] + v
        du, dv = j_hd.vector_hyperdiff_update(state["U"], state["V"],
                                              cfg.nu_div, cfg.nu_vort, geom)
        out["U"], out["V"] = state["U"] - dt * du, state["V"] - dt * dv
        return finish(out, True)
    work = scalars(state, 1.0, 1.0)
    wu, wv = j_hd.vector_hyperdiff_update(state["U"], state["V"], 1.0, 1.0,
                                          geom)
    work["U"], work["V"] = -wu, -wv
    work = dss_state(work)
    out = dict(state)
    for k, v in scalars(work, -dt, nu_s).items():
        out[k] = state[k] + v
    du, dv = j_hd.vector_hyperdiff_update(work["U"], work["V"],
                                          cfg.nu_div * scale,
                                          cfg.nu_vort * scale, geom)
    out["U"], out["V"] = state["U"] + dt * du, state["V"] + dt * dv
    return finish(out, True)


def jax_steps(jcfg, jgeom, start, ref, by_rows):
    """3 steps of JAX ``make_nh_step`` (its tail ``jax_tail_by_rows`` with
    ``by_rows``), traced and run inside the patch."""
    def run():
        first, step = j_nh.make_nh_step(
            jcfg, jgeom, ref_state=None if ref is None else
            {k: jnp.asarray(v) for k, v in ref.items()})
        s, c = first({k: jnp.asarray(v) for k, v in start.items()})
        for _ in range(STEPS - 1):
            s, c = step(s, c)
        return {k: np.asarray(v) for k, v in s.items()}
    if not by_rows:
        return run()
    with mock.patch.object(j_hd, "step_after_subcycle_nh", jax_tail_by_rows):
        return run()


def port_steps(tcfg, tgeom, start, ref, **kw):
    first, step = t_fast.make_fast_step(
        tcfg, tgeom, device=CPU, ref_state=None if ref is None else
        {k: torch.from_numpy(v.copy()) for k, v in ref.items()}, **kw)
    d, c = first(t_fast.pack_state(
        {k: torch.from_numpy(v.copy()) for k, v in start.items()},
        device=CPU))
    for _ in range(STEPS - 1):
        d, c = step(d, c)
    return {k: v.numpy() for k, v in t_fast.unpack_state(d).items()}


def case_runs():
    """``get(name)``: (configs, JAX's 3 steps) per case, computed at first
    use; the step tests (``test_torch_staggering_steps.py``,
    ``_options.py``, ``_sphere.py``) keep one for their module."""
    cache = {}

    def get(name):
        if name not in cache:
            cfgs = configs(name)
            cache[name] = cfgs, jax_steps(cfgs[0], cfgs[2], cfgs[4],
                                          cfgs[5], CASES[name][3])
        return cache[name]
    return get


def check_steps(runs, name, fused):
    """3 steps of ``make_fast_step`` against JAX's, 1e-11 relative per
    field (U and V against their common scale)."""
    (jcfg, tcfg, jgeom, tgeom, start, ref), want = runs(name)
    got = port_steps(tcfg, tgeom, start, ref, fused=fused)
    assert got["Rt"].shape == start["Rt"].shape
    assert got["W"].shape == start["W"].shape
    assert_steps_close(got, want, start)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def _fast_setup(stag, nz=8, vo=1):
    tc = t_xz.InertiaGravityWave()
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ, nex=2, ney=1,
                         order=4, nz=nz, vertical_order=vo, ztop=tc.ztop,
                         x_extent=tc.x_extent, y_extent=tc.y_extent,
                         vertical_staggering=tt.VerticalStaggering(stag),
                         dtype=torch.float64)
    geom = t_nh.build_nh_cartesian_geometry(cfg)
    fg = t_engine.build_fast_geometry_cartesian(geom, dtype=torch.float64,
                                                device=CPU, swap_ab=False)
    d = t_fast.pack_state(tc.initial_state(geom, cfg.constants, device=CPU,
                                           stagger=stag), device=CPU)
    rng = np.random.default_rng(5)
    d = {k: v * (1.0 + 1e-2 * torch.as_tensor(rng.standard_normal(v.shape)))
         for k, v in d.items()}
    # a seeded W and cross wind: every column has xi-velocities of both
    # signs, so each derivative of |u^xi| is exercised
    d["W"] = d["W"] + 50.0 * torch.as_tensor(rng.standard_normal(
        tuple(d["W"].shape)))
    d["V"] = d["V"] + 3e5 * torch.as_tensor(rng.standard_normal(
        tuple(d["V"].shape)))
    return cfg, geom, fg, d


@pytest.mark.parametrize("stag,nz,vo", [("CPH", 8, 1), ("LEV", 8, 1),
                                        ("INT", 9, 2), ("CPH", 8, 2),
                                        ("LEV", 8, 2)])
@pytest.mark.parametrize("upwind", [True, False], ids=["pen", "nopen"])
def test_dense_jacobian_is_the_residuals_derivative(stag, nz, vo, upwind):
    """``dense_jacobian`` (assembled from the column operators) equals
    ``torch.func.jacfwd`` of the batched residual to roundoff, with and
    without the upwind penalty."""
    cfg, _, fg, d = _fast_setup(stag, nz, vo)
    st = t_imp.stagger_statics(fg, upwind)
    sg = t_nonh.infer_stagger(d, nz, axis=0)
    assert sg == ("CPH" if stag == "CPH" else "LEV")
    x0, aux = t_imp._prep_aux(d, fg, None, levels=sg == "LEV")
    dt = 3.0
    J = t_imp.dense_jacobian(x0, aux, fg, st, cfg.constants, dt, sg)
    sizes = [p.shape[0] for p in x0]
    ncol = x0[0].shape[1]

    def F(xflat):
        parts = torch.split(xflat.reshape(-1, ncol), sizes)
        return torch.cat(t_imp.RESIDUALS[sg](
            parts, x0, aux, fg, cfg.constants, dt,
            penalty=st["has_penalty"]))

    x = torch.cat(x0)
    n = x.shape[0]
    full = torch.func.jacfwd(F)(x.reshape(-1)).reshape(n, ncol, n, ncol)
    want = torch.diagonal(full, dim1=1, dim2=3)            # (n, n, ncol)
    assert J.shape == want.shape
    assert float((J - want).abs().max() / want.abs().max()) < 1e-14
    assert st["has_penalty"] == (upwind and fg.penalty_left is not None
                                 and nz // vo > 1)


def test_stagger_helpers_match_jax():
    """``infer_stagger`` and ``convert_stagger`` (one ``infer_stagger``
    for the port: the diagnostics take it from ``models/nonhydro``)."""
    from tempestmodel_tpu_torch.io import diagnostics
    assert diagnostics.infer_stagger is t_nonh.infer_stagger
    jcfg, tcfg, jgeom, tgeom, start, _ = configs("cph")
    lor = {k: np.asarray(v) for k, v in j_xz.InertiaGravityWave(
    ).initial_state(jgeom, jcfg.constants).items()}
    nz = tcfg.nz
    for stag in ("LOR", "CPH", "LEV", "INT"):
        want = {k: np.asarray(v) for k, v in j_nonh.convert_stagger(
            {k: jnp.asarray(v) for k, v in lor.items()}, jgeom,
            stag).items()}
        got = t_nonh.convert_stagger(
            {k: torch.from_numpy(v.copy()) for k, v in lor.items()}, tgeom,
            stag)
        for k in FIELDS:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-15,
                                       atol=1e-12 * np.abs(want[k]).max())
        assert t_nonh.infer_stagger(got, nz) == j_nonh.infer_stagger(
            want, nz) == ("LEV" if stag == "INT" else stag)
        assert t_nonh.infer_stagger(t_fast.pack_state(got, device=CPU),
                                    nz, axis=0) == t_nonh.infer_stagger(
                                        got, nz)


@pytest.mark.parametrize("stag", ["LOR", "CPH", "LEV"])
def test_nu4_field_sets_and_plain_passes(stag):
    """The nu4 kernels' field set of each staggering: the mask of the
    scalars on interfaces, the steps a block walks, and the plain passes
    equal to the engine's plain tail (each scalar's Jacobian by rows)."""
    _, _, fg, d = _fast_setup(stag)
    assert hyper_cuda.top_mask(d) == hyper_cuda.TOP_MASKS[stag]
    nz, P, A, B = d["U"].shape
    sh = hyper_cuda.hyper_launch_shape(nz, P, A, B, 4, torch.float64, True,
                                       top=hyper_cuda.top_mask(d))
    steps = nz + (0 if stag == "LEV" else 1)
    assert sh.blocks == (A // sh.rows) * (B // sh.cols) * P * -(
        -steps // sh.levels)
    assert hyper_cuda.laplacians_supported(fg)
    work = hyper_cuda.nu4_pass1(d, fg)
    for k in ("Rt", "Rho", "W"):
        want = t_engine.scalar_laplacian(d[k], t_engine.jac_of(d[k], fg), fg)
        np.testing.assert_allclose(work[k].numpy(), want.numpy(),
                                   rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))
    out = hyper_cuda.nu4_pass2(d, work, 2.0, 3.0, 4.0, 0.5, fg)
    for k in FIELDS:
        assert out[k].shape == d[k].shape
    bad = dict(d, Rho=torch.cat([d["Rho"], d["Rho"][:1]]))
    with pytest.raises(ValueError):
        hyper_cuda.top_mask(bad)
    with pytest.raises(ValueError):
        hyper_cuda.hyper_launch_shape(nz, P, A, B, 4, torch.float64, True,
                                      top=1)


@pytest.mark.parametrize("stag", ["CPH", "LEV"])
def test_dss_groups_scalars_by_shape(stag):
    """``apply_dss`` pairs the two scalars of one row count in the
    ``"scalar2"`` launch (CPH: Rt and W; LEV: Rt and Rho) and never takes
    ``dss_state`` for a staggered state: every grouping gives the same
    bits, each field the plain scalar DSS of itself."""
    _, _, fg, d = _fast_setup(stag)
    outs = [t_engine.apply_dss(d, fg, merge=m)
            for m in ((), ("scalar2",), ("state", "scalar2"), ("state",))]
    for o in outs[1:]:
        for k in FIELDS:
            assert torch.equal(o[k], outs[0][k]), k
    from tempestmodel_tpu_torch.fast import dss_cuda
    for k in ("Rt", "Rho", "W"):
        want = dss_cuda.dss_scalar_plain(d[k], fg.inv_mult, fg.dss_links,
                                         fg.p, wrap=fg.wrap)
        assert torch.equal(outs[0][k], want), k


def test_predicates_take_the_staggerings():
    """``fast_engine_supported`` takes CPH, LEV and INT on periodic grids
    and the sphere, with any solver, ``upwind_thermo=False`` and the
    explicit path; it refuses them with tracers, no-flux walls or uniform
    diffusion (the roadmap's), and the IMEX family refuses them."""
    jcfg, tcfg, jgeom, tgeom, start, _ = configs("cph")
    for stag in ("CPH", "LEV", "INT"):
        cfg = tcfg.with_(vertical_staggering=tt.VerticalStaggering(stag),
                         **(dict(nz=9, vertical_order=2) if stag == "INT"
                            else {}))
        assert t_engine.fast_engine_supported(cfg, geom=tgeom)
        for over in (dict(vertical_solver="schur"),
                     dict(vertical_solver="jfnk"),
                     dict(upwind_thermo=False),
                     dict(explicit_vertical=True),
                     dict(timescheme=tt.TimestepSchemeType.ERK)):
            assert t_engine.fast_engine_supported(cfg.with_(**over),
                                                  geom=tgeom), over
        assert not t_engine.fast_engine_supported(cfg, has_tracers=True,
                                                  geom=tgeom)
        assert not t_engine.fast_engine_supported(
            cfg.with_(nu_uniform_scalar=10.0), geom=tgeom)
        walled = t_nh.build_nh_cartesian_geometry(cfg, bc_x="noflux")
        assert not t_engine.fast_engine_supported(cfg, geom=walled)
        assert not t_engine.fast_imex_supported(
            cfg.with_(timescheme=tt.TimestepSchemeType.ARS343,
                      vertical_solver="pallas"), geom=tgeom)
    assert t_engine.fast_imex_supported(
        tcfg.with_(vertical_staggering=tt.VerticalStaggering.LORENZ,
                   timescheme=tt.TimestepSchemeType.ARS343,
                   vertical_solver="pallas"), geom=tgeom)


def test_rayleigh_damps_each_field_where_it_lives():
    """The Rayleigh factors follow the fields' rows: Rt's the interface
    factor under CPH, W's the level factor under LEV."""
    for name, rows in (("sphere_cph", {"Rt": 7, "W": 7}),
                       ("sphere_lev", {"Rt": 6, "W": 6})):
        _, tcfg, _, tgeom, start, ref = configs(name)
        fg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64,
                                          device=CPU)
        fac, term = t_engine._rayleigh_terms(tcfg, tgeom, ref, fg)
        for k, n in rows.items():
            assert fac[k].shape[0] == term[k].shape[0] == n, (name, k)
        assert bool((fac["Rho"] == 1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("stag", ["CPH", "LEV"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-7),
                                       (torch.float64, 4e-16)])
def test_nu4_staggered_kernels_on_the_card(stag, dtype, tol):
    """The CPH and LEV instantiations of the nu4 kernels against their
    plain versions on the card (``chip_smoke.py`` phase 3 holds them at
    the flagship)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the nu4 kernels run only there")
    dev = torch.device("cuda")
    _, _, fg, d = _fast_setup(stag)
    fgc = t_engine.build_fast_geometry_cartesian(
        t_nh.build_nh_cartesian_geometry(_fast_setup(stag)[0]),
        dtype=dtype, device=dev, swap_ab=False)
    dc = {k: v.to(dev, dtype) for k, v in d.items()}
    got = hyper_cuda.nu4_pass1(dc, fgc)
    want = hyper_cuda.nu4_pass1_plain(dc, fgc)
    for k in FIELDS:
        scale = float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= tol * scale, k
