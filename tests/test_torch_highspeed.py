"""The port's HighSpeed (HS) step against the JAX package's: the x-z
inertia-gravity wave through ``make_nh_step`` (3 steps, float64, 1e-11
relative per field); the momentum conversions, the implicit update
through the plain q 1 banded solve, and the contravariant momentum DSS on
the sphere and on a plane with no-flux walls against JAX's pieces
(1e-13); the kernel wrappers a step calls; the C++ golden
``umjs_hs10.bin.gz`` (``slow``).  One JAX step is compiled, the x-z
slice's; the UMJS wave through both CLIs is in
``test_torch_highspeed_cli.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import highspeed as j_hs
from tempestmodel_tpu.models import nh_model as j_nh_model
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch.models import highspeed as t_hs
from tempestmodel_tpu_torch.models import nh_model as t_nh_model

from torch_port_common import CPU, FIELDS, rel_err

NSTEPS = 3
DT = 100.0


def _igw(nex=4, nz=10):
    from tempestmodel_tpu.testcases.nonhydro_xz import (
        InertiaGravityWave as JIGW)
    from tempestmodel_tpu_torch.testcases.nonhydro_xz import (
        InertiaGravityWave)
    jtc, ttc = JIGW(), InertiaGravityWave()
    kw = dict(nex=nex, ney=1, order=4, nz=nz, ztop=jtc.ztop,
              x_extent=jtc.x_extent, y_extent=jtc.y_extent, dt=1.0,
              hyperdiffusion=False)
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CARTESIAN_XZ,
                          timescheme=tj.TimestepSchemeType.HS,
                          dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ,
                          timescheme=tt.TimestepSchemeType.HS,
                          dtype=torch.float64, **kw)
    jgeom = j_nh_model.build_nh_cartesian_geometry(jcfg)
    tgeom = t_nh_model.build_nh_cartesian_geometry(tcfg)
    js = jtc.initial_state(jgeom, jcfg.constants, dtype=jnp.float64)
    return jcfg, jgeom, tcfg, tgeom, {k: np.asarray(v) for k, v in
                                      js.items()}


@pytest.fixture(scope="module")
def igw():
    return _igw()


def test_igw_hs_matches_jax_make_nh_step(igw):
    jcfg, jgeom, tcfg, tgeom, start = igw
    first, _ = j_nh_model.make_nh_step(jcfg, jgeom)
    s = {k: jnp.asarray(v) for k, v in start.items()}
    for _ in range(NSTEPS):
        s, _ = first(s)
    first, step = t_nh_model.make_nh_step(tcfg, tgeom, device=CPU)
    d, c = first({k: torch.from_numpy(v.copy()) for k, v in start.items()})
    for _ in range(NSTEPS - 1):
        d, c = step(d, c)
    for k in FIELDS:
        if k == "V":      # the slice's V is roundoff: against U's scale
            scale = float(np.abs(np.asarray(s["U"])).max())
            assert float(np.abs(d[k].numpy() - np.asarray(s[k])).max()) \
                < 1e-11 * scale
            continue
        assert rel_err(d[k].numpy(), np.asarray(s[k])) < 1e-11, k


def _fg_hs(tgeom, dtype=torch.float64):
    if hasattr(tgeom, "nex"):
        fg = t_engine.build_fast_geometry_cartesian(tgeom, dtype=dtype,
                                                    device=CPU, swap_ab=False)
    else:
        fg = t_engine.build_fast_geometry(tgeom, dtype=dtype, device=CPU)
    return fg, t_hs.hs_statics(tgeom, fg)


@pytest.fixture(scope="module")
def sphere_pair():
    """UMJS at ne2 p4 nz6 built by both packages, with W nonzero inside
    (the vertical part of the metric identities)."""
    from torch_port_common import build_pair
    from tempestmodel_tpu.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS as JaxUMJS)
    jcfg, jgeom, tcfg, tgeom = build_pair(ne=2, nz=6)
    js = JaxUMJS().initial_state(jgeom, jcfg.constants, dtype=jnp.float64)
    w = np.asarray(js["W"]).copy()
    w[..., 1:-1] += 1.0
    return jgeom, tgeom, dict({k: np.asarray(v) for k, v in js.items()},
                              W=w)


@pytest.mark.parametrize("grid", ["sphere", "igw"])
def test_momentum_conversions_match_jax(grid, sphere_pair, igw):
    """``to_momentum`` against JAX's (1e-13 relative per field) and the
    round trip velocity -> momentum -> velocity exact to roundoff (JAX
    ``tests/test_highspeed.py:28-52``)."""
    if grid == "sphere":
        jgeom, tgeom, start = sphere_pair
    else:
        _, jgeom, _, tgeom, start = igw
    fg, hs = _fg_hs(tgeom)
    jm = j_hs.to_momentum({k: jnp.asarray(v) for k, v in start.items()},
                          jgeom)
    d = t_engine.pack_state(start, device=CPU)
    m = t_hs.to_momentum(d, fg, hs)
    for k in t_hs.MOMENTA:
        want = np.moveaxis(np.asarray(jm[k]), -1, 0)
        assert rel_err(m[k].numpy(), want) < 1e-13, k
    back = t_hs.from_momentum(m, fg, hs)
    for k in FIELDS:
        scale = max(float(d[k].abs().max()), 1.0)
        assert float((back[k] - d[k]).abs().max()) / scale < 1e-13, k


def test_implicit_update_matches_jax(igw):
    """``hs_implicit_update`` through the plain q 1 banded solve against
    JAX's (``tridiagonal_solve``) on the slice with a random MW (1e-13),
    and the solution satisfies its tridiagonal system."""
    from tempestmodel_tpu_torch.fast.implicit import band_matvec
    from tempestmodel_tpu_torch.models.vertical_banded import banded_solve_t
    jcfg, jgeom, tcfg, tgeom, start = igw
    jm = j_hs.to_momentum({k: jnp.asarray(v) for k, v in start.items()},
                          jgeom)
    mw = np.asarray(jm["MW"]).copy()
    mw[..., 1:-1] = np.random.default_rng(0).standard_normal(
        mw[..., 1:-1].shape)
    jm = dict(jm, MW=jnp.asarray(mw))
    dt = 3.0
    want = j_hs.hs_implicit_update(jm, jgeom, jcfg.constants, dt)
    fg, hs = _fg_hs(tgeom)
    m = {k: torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(v), -1, 0))) for k, v in jm.items()}
    got = t_hs.hs_implicit_update(m, hs, tcfg.constants, dt)
    for k in t_hs.MOMENTA:
        assert rel_err(got[k].numpy(),
                       np.moveaxis(np.asarray(want[k]), -1, 0)) < 1e-13, k
    bands, rhs, _, _ = t_hs.hs_tridiagonal(m, hs, tcfg.constants, dt)
    x = banded_solve_t(bands, rhs, 1)
    assert float((band_matvec(bands, x, 1) - rhs).abs().max()) \
        < 1e-11 * float(rhs.abs().max())
    assert float(x[0].abs().max()) == float(x[-1].abs().max()) == 0.0


def _noflux_pair():
    from tempestmodel_tpu.testcases.nonhydro_xz import (
        DensityCurrent as JDC)
    jtc = JDC()
    kw = dict(nex=4, ney=1, order=4, nz=4, ztop=jtc.ztop,
              x_extent=jtc.x_extent, y_extent=jtc.y_extent, dt=0.1)
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CARTESIAN_XZ,
                          dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ,
                          dtype=torch.float64, **kw)
    return (j_nh_model.build_nh_cartesian_geometry(jcfg, bc_x="noflux"),
            t_nh_model.build_nh_cartesian_geometry(tcfg, bc_x="noflux"))


@pytest.mark.parametrize("grid", ["sphere", "plane_noflux"])
def test_momentum_dss_matches_jax(grid, sphere_pair):
    """The momentum DSS (the state mode with the contravariant table on
    the sphere; the wrap-sum with MU zeroed at the walls on the plane) on
    random momenta against JAX's ``make_momentum_dss`` (1e-13), and a
    smooth contravariant field stays a fixed point (JAX
    ``tests/test_highspeed.py:101-131``)."""
    if grid == "sphere":
        jgeom, tgeom, _ = sphere_pair
    else:
        jgeom, tgeom = _noflux_pair()
    fg, hs = _fg_hs(tgeom)
    nz = fg.nz
    P, A, B = fg.inv_mult.shape
    rng = np.random.default_rng(5)
    m = {k: rng.standard_normal((nz + (k == "MW"), P, A, B))
         for k in t_hs.MOMENTA}
    want = j_hs.make_momentum_dss(jgeom)(
        {k: jnp.asarray(np.moveaxis(v, 0, -1)) for k, v in m.items()})
    got = t_hs.make_momentum_dss(fg, hs)(
        {k: torch.from_numpy(v) for k, v in m.items()})
    plain = t_hs.make_momentum_dss(fg, hs, plain=True)(
        {k: torch.from_numpy(v) for k, v in m.items()})
    for k in t_hs.MOMENTA:
        w = np.moveaxis(np.asarray(want[k]), -1, 0)
        assert rel_err(got[k].numpy(), w) < 1e-13, k
        assert torch.equal(got[k], plain[k]), k
    if grid == "sphere":
        # the DSS of the DSS is itself: contravariant pairs rotate back
        again = t_hs.make_momentum_dss(fg, hs)(got)
        for k in t_hs.MOMENTA:
            assert rel_err(again[k].numpy(), got[k].numpy()) < 1e-13, k
        cov = t_engine.build_fast_geometry(tgeom, torch.float64, CPU).e_rot
        assert not torch.equal(cov, hs.rot)


def test_contravariant_table_inverts_the_covariant_one(sphere_pair):
    """Per edge node, the contravariant 2x2 matrix is the inverse
    transpose of the covariant one."""
    from tempestmodel_tpu_torch.fast import dss_cuda
    _, tgeom, _ = sphere_pair
    cov = dss_cuda.edge_rotations(tgeom)
    con = t_hs.contravariant_edge_rotations(tgeom)
    C = cov.reshape(2, 2, *cov.shape[1:])
    K = con.reshape(2, 2, *con.shape[1:])
    prod = np.einsum("jil...,jkl...->ikl...", K, C)   # K^T C
    eye = np.eye(2)[:, :, None, None]
    assert np.abs(prod - eye).max() < 1e-12


def test_hs_step_launches_its_kernels(igw, sphere_pair, monkeypatch):
    """The wrappers one HS step calls on the sphere (on the CPU each runs
    its plain version): ``banded_solve`` at q 1 three times,
    ``dss_state`` seven times with the contravariant table and twice in
    the tail with the covariant one, ``nu4_pass1/2`` once; ``plain=True``
    calls none and gives the same bits; tracers are dropped, as in the JAX
    package."""
    from tempestmodel_tpu_torch.fast import dss_cuda, hyper_cuda
    from torch_port_common import build_pair
    _, _, tcfg, tgeom = build_pair(ne=2, nz=6)
    tcfg = tcfg.with_(timescheme=tt.TimestepSchemeType.HS, dt=DT)
    _, _, start = sphere_pair
    fg, hs = _fg_hs(tgeom)
    calls, rots = {}, []

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            if name == "dss_state":
                rots.append(torch.equal(a[2], hs.rot))
            if name == "banded_solve":
                assert a[2] == 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    counting(t_hs, "banded_solve")
    for name in ("dss_state", "dss_scalar", "dss_vector", "dss_scalar2"):
        counting(dss_cuda, name)
    for name in ("nu4_pass1", "nu4_pass2"):
        counting(hyper_cuda, name)
    d = t_engine.pack_state(start, device=CPU)
    d["Tracers"] = torch.ones((2 * tcfg.nz,) + tuple(d["Rho"].shape[1:]),
                              dtype=torch.float64)
    step, _ = t_hs.make_hs_step(tcfg, tgeom, device=CPU)
    a, c = step(d, None)
    assert c == {} and "Tracers" not in a
    assert calls == {"banded_solve": 3, "dss_state": 9, "nu4_pass1": 1,
                     "nu4_pass2": 1}
    assert rots == [True] * 7 + [False] * 2
    calls.clear()
    step, _ = t_hs.make_hs_step(tcfg, tgeom, device=CPU, plain=True)
    b, _ = step(d, None)
    assert calls == {}
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.slow
def test_parity_highspeed_sphere_golden():
    """HS against the C++ reference, 10 steps UMJS ne4 L24 dt 50 s
    (``umjs_hs10.bin.gz``), at ``test_parity_highspeed_sphere``'s bars:
    momenta 2e-4, Rt and Rho 1e-6, rho w 2e-4."""
    from test_reference_parity import load_golden
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    patches = load_golden("umjs_hs10.bin.gz")
    node_ref = np.stack([p["node"] for p in patches])
    redge_ref = np.stack([p["redge"] for p in patches])
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, ne=4, order=4,
                         nz=24, ztop=30000.0, dt=50.0, hyperdiffusion=True,
                         nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                         timescheme=tt.TimestepSchemeType.HS,
                         dtype=torch.float64)
    geom = t_nh_model.build_nh_sphere_geometry(cfg, ztop=30000.0)
    s0 = tc.initial_state(geom, cfg.constants, device=CPU)
    first, step = t_nh_model.make_nh_step(cfg, geom, device=CPU)
    s, c = first(s0)
    for _ in range(9):
        s, c = step(s, c)
    s = {k: v.numpy() for k, v in s.items()}
    con = np.asarray(geom.con2d)
    rho = s["Rho"]
    u_c = con[..., 0, 0, None] * s["U"] + con[..., 0, 1, None] * s["V"]
    v_c = con[..., 1, 0, None] * s["U"] + con[..., 1, 1, None] * s["V"]
    for name, mine, comp, tol in (("rho*u^a", rho * u_c, 0, 2e-4),
                                  ("rho*u^b", rho * v_c, 1, 2e-4),
                                  ("Rt", s["Rt"], 2, 1e-6),
                                  ("Rho", rho, 4, 1e-6)):
        ref = node_ref[:, comp]
        rel = np.abs(ref - mine).max() / max(np.abs(ref).max(), 1e-30)
        assert rel < tol, f"{name}: rel {rel:.3e}"
    rho_i = np.einsum("KL,...L->...K", np.asarray(geom.interp_n2i), rho)
    mw = rho_i * s["W"] / np.asarray(geom.deriv_r_int)[..., 2]
    ref_w = redge_ref[:, 3]
    rel = np.abs(ref_w - mw).max() / np.abs(ref_w).max()
    assert rel < 2e-4, f"rho*w: rel {rel:.3e}"
