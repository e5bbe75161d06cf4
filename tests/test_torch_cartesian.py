"""Periodic Cartesian grids in the port vs the JAX package, float64 on the
CPU: the geometry (``grid/cartesian``, ``build_fast_geometry_cartesian`` in
both layouts), the test cases' states, the wrap-sum DSS of all five DSS
kernels' plain versions, the x-z branch of the fused stage and the nu4
passes on a plane against the JAX Pallas kernels in interpret mode, and the
slice as a whole: 3 steps of ``make_fast_step`` for the Schar mountain
waves, the inertia-gravity waves and the 3-D thermal bubble, fused and
unfused, both vertical solvers, Schar in both layouts.

V of an x-z slice carries roundoff only (about 1e-21 m/s in both packages),
so U and V are measured against their common scale, as
``tests/test_fast_xz.py`` does; every other field against its own."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu.fast import (engine as j_engine, dss_pallas,
                                   stage_pallas, hyper_pallas)
from tempestmodel_tpu.grid import cartesian as j_cart
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases import nonhydro_xz as j_xz
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu_torch import fast as t_fast, convert
from tempestmodel_tpu_torch.fast import (engine as t_engine, dss_cuda,
                                         hyper_cuda, stage_cuda)
from tempestmodel_tpu_torch.grid import cartesian as t_cart
from tempestmodel_tpu_torch.kernels import synthetic
from tempestmodel_tpu_torch.kernels.counts import launch_counts
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz

from torch_port_common import CPU, FIELDS, fast_geometry_fields_numpy, rel_err

# test scale: the Schar slice of tests/test_fast_xz.py, the inertia-gravity
# waves of the same file, and the 3-D bubble swapped (ney < nex) with
# hyperdiffusion on, which reaches the nu4 passes
CASES = {
    "schar": dict(case="ScharMountain", kind="CARTESIAN_XZ", nex=8, ney=1,
                  nz=8, dt=1.0, hyperdiffusion=True, nu=1e7, rayleigh=True),
    "igw": dict(case="InertiaGravityWave", kind="CARTESIAN_XZ", nex=10, ney=1,
                nz=10, dt=1.0, hyperdiffusion=False, nu=0.0, rayleigh=False),
    "bubble3d": dict(case="ThermalBubble3D", kind="CARTESIAN_3D", nex=4,
                     ney=2, nz=8, dt=0.1, hyperdiffusion=True, nu=1e6,
                     rayleigh=False),
}


def _configs(name, solver="banded"):
    c = CASES[name]
    jtc, ttc = getattr(j_xz, c["case"])(), getattr(t_xz, c["case"])()
    kw = dict(nex=c["nex"], ney=c["ney"], order=4, nz=c["nz"],
              x_extent=jtc.x_extent, y_extent=jtc.y_extent, ztop=jtc.ztop,
              dt=c["dt"], hyperdiffusion=c["hyperdiffusion"],
              nu_scalar=c["nu"], nu_div=c["nu"], nu_vort=c["nu"],
              rayleigh_damping=c["rayleigh"])
    jcfg = tj.ModelConfig(grid_kind=getattr(tj.GridKind, c["kind"]),
                          vertical_solver="banded", dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=getattr(tt.GridKind, c["kind"]),
                          vertical_solver=solver, dtype=torch.float64, **kw)
    extra = lambda tc: dict(
        topography=getattr(tc, "topography", None),
        rayleigh=tc.rayleigh_strength if c["rayleigh"] else None)
    jgeom = j_nh.build_nh_cartesian_geometry(jcfg, ztop=jtc.ztop,
                                             **extra(jtc))
    tgeom = t_nh.build_nh_cartesian_geometry(tcfg, ztop=ttc.ztop,
                                             **extra(ttc))
    return jtc, ttc, jcfg, tcfg, jgeom, tgeom


@pytest.fixture(scope="module")
def configs():
    return {name: _configs(name) for name in CASES}


# ---------------------------------------------------------------------------
# host precompute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_geometry_matches_jax(configs, name):
    """Every array of ``build_cartesian_geometry`` to 1e-12 of its scale,
    every static field equal."""
    *_, jgeom, tgeom = configs[name]
    assert isinstance(tgeom, t_cart.CartesianGeometry)
    for f in dataclasses.fields(t_cart.CartesianGeometry):
        want, got = getattr(jgeom, f.name), getattr(tgeom, f.name)
        if want is None or isinstance(want, (int, float, bool, str)):
            assert got == want, f.name
            continue
        assert isinstance(got, np.ndarray), f.name
        want = np.asarray(want)
        assert got.shape == want.shape, f.name
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-12 * max(np.abs(want).max(), 1e-300),
            err_msg=f.name)
    if name == "schar":
        # the terrain reaches the metric, the sponge the Rayleigh strength
        assert np.abs(tgeom.con_a_xi).max() > 1e-7
        assert np.abs(tgeom.rayleigh_lev).max() > 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_initial_and_reference_states_match_jax(configs, name):
    jtc, ttc, jcfg, tcfg, jgeom, tgeom = configs[name]
    for fn in ("initial_state", "reference_state"):
        want = getattr(jtc, fn)(jgeom, jcfg.constants, dtype=jnp.float64)
        got = getattr(ttc, fn)(tgeom, tcfg.constants, dtype=torch.float64,
                               device=CPU)
        assert set(got) == set(FIELDS)
        for k in FIELDS:
            assert got[k].dtype == torch.float64 and got[k].is_contiguous()
            assert got[k].shape == want[k].shape, (fn, k)
            assert rel_err(got[k].numpy(), want[k]) < 1e-13, (fn, k)
    if name == "igw":
        # the Charney-Phillips start: Rt on the interfaces
        want = jtc.initial_state(jgeom, jcfg.constants, dtype=jnp.float64,
                                 stagger="CPH")
        got = ttc.initial_state(tgeom, tcfg.constants, device=CPU,
                                stagger="CPH")
        assert rel_err(got["Rt"].numpy(), want["Rt"]) < 1e-13


@pytest.mark.parametrize("name", list(CASES))
def test_apply_dss_cartesian_matches_jax(configs, name):
    *_, jgeom, tgeom = configs[name]
    f = np.random.default_rng(5).standard_normal(
        np.asarray(jgeom.z_lev).shape)
    want = j_cart.apply_dss_cartesian(jnp.asarray(f), jgeom)
    t = torch.from_numpy(f.copy())
    got = t_cart.apply_dss_cartesian(t, tgeom)
    np.testing.assert_array_equal(t.numpy(), f)          # left alone
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-13)
    # a projection: coincident nodes hold one value
    again = t_cart.apply_dss_cartesian(got, tgeom)
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("swap", [True, False], ids=["swapped", "natural"])
@pytest.mark.parametrize("name", ["schar", "bubble3d"])
def test_fast_geometry_matches_jax(configs, name, swap):
    """``build_fast_geometry_cartesian`` field by field, in either layout;
    and ``convert.fast_geometry_from_numpy`` carries the JAX one across."""
    *_, jgeom, tgeom = configs[name]
    jfg = j_engine.build_fast_geometry_cartesian(jgeom, dtype=jnp.float64,
                                                 swap_ab=swap)
    tfg = t_engine.build_fast_geometry_cartesian(tgeom, dtype=torch.float64,
                                                 device=CPU, swap_ab=swap)
    carried = convert.fast_geometry_from_numpy(
        fast_geometry_fields_numpy(jfg), device=CPU, dtype=torch.float64)
    for f in dataclasses.fields(j_engine.FastGeometry):
        want = getattr(jfg, f.name)
        for got in (getattr(tfg, f.name), getattr(carried, f.name)):
            if want is None or isinstance(want, (int, float, bool, str,
                                                 tuple)):
                assert got == want, f.name
            elif isinstance(got, np.ndarray):          # DA_elem, S_elem
                np.testing.assert_array_equal(got, np.asarray(want))
            else:
                want_np = np.asarray(want)
                assert tuple(got.shape) == want_np.shape, f.name
                assert rel_err(got.numpy(), want_np) < 1e-12, f.name
    for fg in (tfg, carried):
        assert fg.dss_table.shape == (0, 4) and fg.dss_links == ()
        assert fg.npanels == 1 and fg.ab_swapped == swap
    assert tfg.wrap == (True, True)
    if name == "schar":
        assert tfg.xz_zero == ("U" if swap else "V")
        assert (tfg.A, tfg.B) == ((4, 32) if swap else (32, 4))
    assert t_engine.swap_ab_default(tgeom) == j_engine.build_fast_geometry_cartesian(
        jgeom, dtype=jnp.float64).ab_swapped


def test_fast_engine_supported_takes_periodic_cartesian_grids(configs):
    for name in CASES:
        _, _, jcfg, tcfg, jgeom, tgeom = configs[name]
        assert t_engine.fast_engine_supported(tcfg, geom=tgeom)
        assert j_engine.fast_engine_supported(jcfg, geom=jgeom)
        assert not t_engine.fast_engine_supported(tcfg)      # no geometry
        assert not t_engine.fast_engine_supported(tcfg, geom=tgeom,
                                                  mesh=object())
    _, _, _, tcfg, _, tgeom = configs["igw"]
    noflux = t_nh.build_nh_cartesian_geometry(tcfg, bc_x="noflux")
    assert not t_engine.fast_engine_supported(tcfg, geom=noflux)
    with pytest.raises(NotImplementedError):
        t_fast.make_fast_step(tcfg, noflux, device=CPU)


def test_bandwidth_and_band_statics_match_jax(configs):
    from tempestmodel_tpu.models import nonhydro as j_nonhydro
    from tempestmodel_tpu_torch.models import nonhydro as t_nonhydro
    for name in CASES:
        _, _, jcfg, tcfg, jgeom, tgeom = configs[name]
        q = t_nonhydro.estimate_bandwidth(tgeom, tcfg.constants)
        assert q == j_nonhydro.estimate_bandwidth(jgeom, jcfg.constants) == 4
        want = j_nonhydro.band_assembly_statics(jgeom, q)
        got = t_nonhydro.band_assembly_statics(tgeom, q)
        assert set(got) == set(want)
        for key, v in want.items():
            if isinstance(v, dict):
                for o in v:
                    np.testing.assert_array_equal(got[key][o],
                                                  np.asarray(v[o]))
            else:
                assert got[key] == v, key


# ---------------------------------------------------------------------------
# the kernels' plain versions on a Cartesian grid
# ---------------------------------------------------------------------------

WRAPS = [(True, True), (True, False), (False, True)]
WRAP_IDS = ["wrap_ab", "wrap_a", "wrap_b"]
A_, B_, P_ = 8, 12, 4          # A != B, one panel, no links


def _dss_inputs(K, seed):
    rng = np.random.default_rng(seed)
    d = {k: rng.standard_normal((K + (1 if k == "W" else 0), 1, A_, B_))
         for k in FIELDS}
    imult = 0.25 + rng.random((1, A_, B_))
    return d, imult, np.zeros((4, 1, A_))


@pytest.mark.parametrize("wrap", WRAPS, ids=WRAP_IDS)
@pytest.mark.parametrize("kernel", ["scalar", "vector", "uvw", "state",
                                    "scalar2"])
def test_dss_plain_with_wrap_matches_pallas(kernel, wrap):
    """Each of the five DSS kernels' plain versions with the periodic
    wrap-sum against the JAX Pallas kernel in interpret mode: one panel, no
    links, A != B, K of 8 and 9; 1e-13 of the scale.  ``dss_state`` also
    with the Rayleigh finish, whose x-z-exempt slot has the factor 1."""
    for K in (8, 9):
        d, imult, rot = _dss_inputs(K, seed=K)
        J = {k: jnp.asarray(v) for k, v in d.items()}
        T = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
        jm, tm = jnp.asarray(imult), torch.from_numpy(imult)
        jr, tr = jnp.asarray(rot), torch.from_numpy(rot)
        common = dict(interpret=True, wrap=wrap)
        if kernel == "scalar":
            pairs = [(dss_pallas.dss_scalar(J["W"], jm, (), P_, **common),
                      dss_cuda.dss_scalar(T["W"], tm, (), P_, wrap=wrap))]
        elif kernel == "scalar2":
            pairs = list(zip(
                dss_pallas.dss_scalar2(J["Rt"], J["Rho"], jm, (), P_,
                                       **common),
                dss_cuda.dss_scalar2(T["Rt"], T["Rho"], tm, (), P_,
                                     wrap=wrap)))
        elif kernel == "vector":
            pairs = list(zip(
                dss_pallas.dss_vector(J["U"], J["V"], jm, jr, (), P_,
                                      **common),
                dss_cuda.dss_vector(T["U"], T["V"], tm, tr, (), P_,
                                    wrap=wrap)))
        elif kernel == "uvw":
            rng = np.random.default_rng(K + 100)
            shp = d["W"].shape
            arr = {"bw1": rng.standard_normal(shp),
                   "bw2": rng.standard_normal(shp),
                   "dW": rng.standard_normal(shp),
                   "cax0": rng.standard_normal(shp[1:]),
                   "cbx0": rng.standard_normal(shp[1:]),
                   "cxx0": 1.0 + np.abs(rng.standard_normal(shp[1:]))}
            scal = {"cb1": 0.3, "cb2": 0.7, "dt_s": 0.5, "c00": 0.6,
                    "c01": 0.4}
            jwf = dict(scal, **{k: jnp.asarray(v) for k, v in arr.items()})
            twf = dict(scal, **{k: torch.from_numpy(v.copy())
                                for k, v in arr.items()})
            pairs = list(zip(
                dss_pallas.dss_uvw(J["U"], J["V"], jm, jr, (), P_, jwf,
                                   **common),
                dss_cuda.dss_uvw(T["U"], T["V"], tm, tr, (), P_, twf,
                                 wrap=wrap)))
        else:
            rng = np.random.default_rng(K + 200)
            fac = {k: rng.random(v.shape) for k, v in d.items()}
            fac["Rho"] = np.ones_like(fac["Rho"])
            fac["V"] = np.ones_like(fac["V"])       # the x-z-exempt slot
            ref = {k: (1.0 - fac[k]) * rng.standard_normal(fac[k].shape)
                   for k in d}
            pairs = []
            for ray in (None, (fac, ref)):
                jray = None if ray is None else tuple(
                    {k: jnp.asarray(v) for k, v in x.items()} for x in ray)
                tray = None if ray is None else tuple(
                    {k: torch.from_numpy(v.copy()) for k, v in x.items()}
                    for x in ray)
                want = dss_pallas.dss_state(J, jm, jr, (), P_, rayleigh=jray,
                                            **common)
                got = dss_cuda.dss_state(T, tm, tr, (), P_, rayleigh=tray,
                                         wrap=wrap)
                pairs += [(want[k], got[k]) for k in FIELDS]
                if ray is not None:
                    # the exempt slot: the DSS alone
                    alone = dss_cuda.dss_scalar(T["V"], tm, (), P_,
                                                wrap=wrap)
                    assert torch.equal(got["V"], alone + tray[1]["V"])
        for want, got in pairs:
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-13 * np.abs(want).max())


def test_dss_wrap_pairs_the_first_and_last_node():
    """What the wrap adds, on a field that is one at a single edge node."""
    K = 2
    for wrap, (a, b), partner in (((True, False), (0, 5), (A_ - 1, 5)),
                                  ((False, True), (3, B_ - 1), (3, 0))):
        f = torch.zeros((K, 1, A_, B_), dtype=torch.float64)
        f[:, 0, a, b] = 1.0
        one = torch.ones((1, A_, B_), dtype=torch.float64)
        s = dss_cuda.dss_scalar(f, one, (), P_, wrap=wrap)
        assert float(s[0, 0, a, b]) == float(s[0, 0, partner[0],
                                                partner[1]]) == 1.0
        plain = dss_cuda.dss_scalar(f, one, (), P_)
        assert float(plain[0, 0, partner[0], partner[1]]) == 0.0


@pytest.mark.parametrize("case", ["links_and_wrap", "two_panels",
                                  "ragged", "rot", "p1"])
def test_wrappers_raise_on_a_cartesian_field_they_do_not_take(case):
    d, imult, rot = _dss_inputs(4, seed=1)
    x = torch.from_numpy(d["Rt"])
    tm, tr = torch.from_numpy(imult), torch.from_numpy(rot)
    with pytest.raises(ValueError):
        if case == "links_and_wrap":
            dss_cuda.dss_scalar(x, tm, ((0, 0, 0, 1, False),) * 4, P_,
                                wrap=(True, False))
        elif case == "two_panels":
            x2 = torch.cat([x, x], dim=1)
            dss_cuda.dss_scalar(x2, torch.cat([tm, tm]), (), P_)
        elif case == "ragged":
            dss_cuda.dss_scalar(x[:, :, :, :-1].contiguous(),
                                tm[:, :, :-1].contiguous(), (), P_)
        elif case == "rot":
            dss_cuda.dss_vector(x, x, tm, tr[:, :, :-1], (), P_)
        else:
            dss_cuda.dss_scalar(x, tm, (), 1)


def _stage_geometry(configs, swap):
    *_, jgeom, tgeom = configs["schar"]
    jfg = j_engine.build_fast_geometry_cartesian(jgeom, dtype=jnp.float64,
                                                 swap_ab=swap)
    tfg = t_engine.build_fast_geometry_cartesian(tgeom, dtype=torch.float64,
                                                 device=CPU, swap_ab=swap)
    return jfg, tfg


@pytest.mark.parametrize("two", [False, True], ids=["one_base", "two_base"])
@pytest.mark.parametrize("swap", [True, False], ids=["xz_U", "xz_V"])
def test_fused_stage_plain_xz_matches_pallas(configs, swap, two):
    """``fused_stage_plain`` on the Schar geometry (terrain, no separable
    metric) with ``xz_zero`` "U" (swapped) and "V" against the JAX Pallas
    stage in interpret mode, 1e-11 relative; the exempt slot holds its base
    plus the penalty increment only."""
    jcfg = configs["schar"][2]
    jfg, tfg = _stage_geometry(configs, swap)
    assert not tfg.sep_ok and stage_cuda.stage_supported(tfg)
    P, A, B = tfg.inv_mult.shape
    d, b1, b2 = (synthetic.random_state_numpy(tfg.nz, P, A, B, seed=s)
                 for s in (1, 2, 3))
    J = lambda x: {k: jnp.asarray(v) for k, v in x.items()}
    T = lambda x: {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    jbase = ((0.3, J(b1)), (0.7, J(b2))) if two else J(b1)
    tbase = ((0.3, T(b1)), (0.7, T(b2))) if two else T(b1)
    dt_s = 0.5
    want = stage_pallas.fused_stage(jbase, J(d), dt_s, jfg, jcfg.constants,
                                    interpret=True)
    got = stage_cuda.fused_stage(tbase, T(d), dt_s, tfg, jcfg.constants)
    for k in FIELDS:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k
    # the exempt slot moves by the penalty only, far less than the other
    zero, other = ("U", "V") if swap else ("V", "U")
    base = (0.3 * b1[zero] + 0.7 * b2[zero]) if two else b1[zero]
    other_base = (0.3 * b1[other] + 0.7 * b2[other]) if two else b1[other]
    moved = np.abs(got[zero].numpy() - base).max()
    assert moved < 1e-3 * np.abs(got[other].numpy() - other_base).max()


def _bubble_geometry(configs, swap):
    *_, jgeom, tgeom = configs["bubble3d"]
    jfg = j_engine.build_fast_geometry_cartesian(jgeom, dtype=jnp.float64,
                                                 swap_ab=swap)
    tfg = t_engine.build_fast_geometry_cartesian(tgeom, dtype=torch.float64,
                                                 device=CPU, swap_ab=swap)
    return jfg, tfg


@pytest.mark.parametrize("swap", [True, False], ids=["swapped", "natural"])
def test_nu4_passes_plain_on_a_plane_match_pallas(configs, swap):
    """``nu4_pass1_plain`` and ``nu4_pass2_plain`` on the 3-D bubble's plane
    (nex 4, ney 2: the element widths along a and b differ) against the JAX
    Pallas passes in interpret mode, 1e-12 relative; the increment of pass 2
    is as large as the state and held on its own to 1e-10."""
    jcfg, tcfg = configs["bubble3d"][2:4]
    jfg, tfg = _bubble_geometry(configs, swap)
    assert hyper_cuda.supported(tfg, tcfg) and hyper_pallas.supported(jfg,
                                                                       jcfg)
    # the element widths along a and b differ
    assert not torch.allclose(tfg.Sd[:4, :4], tfg.Sd_b[:4, :4])
    P, A, B = tfg.inv_mult.shape
    d = synthetic.random_state_numpy(tfg.nz, P, A, B, seed=4)
    w = synthetic.random_state_numpy(tfg.nz, P, A, B, seed=5)
    T = lambda x: {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    J = lambda x: {k: jnp.asarray(v) for k, v in x.items()}
    st = hyper_cuda.hyper_statics(tfg)
    unit = hyper_cuda.nu4_pass1_plain(T(w), tfg, st)
    nu_s = float(np.abs(d["Rho"]).max() / unit["Rho"].abs().max())
    nu_v = float(np.abs(d["U"]).max() / unit["U"].abs().max())
    nu = (nu_s, nu_v, 0.7 * nu_v, 1.0)
    want1 = hyper_pallas.nu4_pass1(J(d), jfg, interpret=True)
    got1 = hyper_cuda.nu4_pass1(T(d), tfg, st)
    want2 = hyper_pallas.nu4_pass2(J(d), J(w), *nu, jfg, interpret=True)
    got2 = hyper_cuda.nu4_pass2(T(d), T(w), *nu, tfg, st)
    for k in FIELDS:
        assert rel_err(got1[k].numpy(), want1[k]) < 1e-12, k
        assert rel_err(got2[k].numpy(), want2[k]) < 1e-12, k
        inc = np.asarray(want2[k]) - d[k]
        assert np.abs(inc).max() > 1e-2 * np.abs(d[k]).max(), k
        assert rel_err(got2[k].numpy() - d[k], inc) < 1e-10, k


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(got, want, tol):
    """Worst relative error per field; U and V against their common scale
    (V of an x-z slice is roundoff)."""
    vel = max(np.abs(_np(want["U"])).max(), np.abs(_np(want["V"])).max())
    errs = {}
    for k in FIELDS:
        a, b = _np(want[k]), _np(got[k])
        scale = vel if k in ("U", "V") else np.abs(a).max()
        errs[k] = float(np.abs(a - b).max() / (scale + 1e-300))
    assert max(errs.values()) < tol, errs
    return errs


@pytest.fixture(scope="module")
def runs(configs):
    """3 steps of JAX ``make_fast_step`` per case (its default layout), and
    of the port per (case, solver, path, layout); computed at first use."""
    cache = {}

    def start(name):
        jtc, _, jcfg, _, jgeom, _ = configs[name]
        js = jtc.initial_state(jgeom, jcfg.constants, dtype=jnp.float64)
        ref = jtc.reference_state(jgeom, jcfg.constants, dtype=jnp.float64) \
            if CASES[name]["rayleigh"] else None
        return js, ref

    def jax_run(name):
        if ("jax", name) not in cache:
            _, _, jcfg, _, jgeom, _ = configs[name]
            js, ref = start(name)
            first, step = j_fast.make_fast_step(jcfg, jgeom, ref_state=ref)
            X, c = first(j_fast.pack_state(js))
            for _ in range(2):
                X, c = step(X, c)
            cache["jax", name] = j_fast.unpack_state(X, jcfg.nz)
        return cache["jax", name]

    def torch_run(name, solver, fused, swap):
        key = (name, solver, fused, swap)
        if key not in cache:
            _, _, _, tcfg, _, tgeom = configs[name]
            js, ref = start(name)
            cfg = tcfg.with_(vertical_solver=solver)
            first, step = t_fast.make_fast_step(
                cfg, tgeom, device=CPU, fused=fused, swap_ab=swap,
                ref_state=None if ref is None else {
                    k: np.array(v) for k, v in ref.items()})
            X = convert.state_from_numpy({k: np.asarray(v)
                                          for k, v in js.items()},
                                         device=CPU)
            X, c = first(X)
            for _ in range(2):
                X, c = step(X, c)
            cache[key] = t_fast.unpack_state(X)
        return cache[key]

    return jax_run, torch_run


SLICE = ([("schar", s, f, w) for s in ("pallas", "banded")
          for f in (None, False) for w in (True, False)]
         + [(n, s, f, None) for n in ("igw", "bubble3d")
            for s in ("pallas", "banded") for f in (None, False)])


@pytest.mark.parametrize("name,solver,fused,swap", SLICE, ids=[
    f"{n}-{s}-{'fused' if f is None else 'unfused'}"
    + ("" if w is None else ("-swapped" if w else "-natural"))
    for n, s, f, w in SLICE])
def test_three_steps_match_jax(runs, name, solver, fused, swap):
    """3 Strang-HEVI steps from JAX's own initial state, 1e-11 relative per
    field against JAX ``make_fast_step`` (whose layout is its default:
    swapped for all three cases)."""
    jax_run, torch_run = runs
    _compare(torch_run(name, solver, fused, swap), jax_run(name), 1e-11)


def test_the_two_layouts_agree(runs):
    """The swap is an exact relabeling: both layouts give one trajectory
    (to rounding: the sums run in another order)."""
    _, torch_run = runs
    a = torch_run("schar", "pallas", None, True)
    b = torch_run("schar", "pallas", None, False)
    _compare(a, b, 1e-12)


def test_multistep_equals_the_eager_steps(configs):
    """``make_fast_multistep(3)`` (a plain loop on the CPU, the swap once
    around it) against ``first_step`` and 3 eager steps: the same bits."""
    jtc, _, jcfg, tcfg, jgeom, tgeom = configs["schar"]
    js = jtc.initial_state(jgeom, jcfg.constants, dtype=jnp.float64)
    ref = {k: np.array(v) for k, v in js.items()}
    X0 = convert.state_from_numpy(ref, device=CPU)
    first, multi = t_fast.make_fast_multistep(tcfg, tgeom, 3, ref_state=ref,
                                              device=CPU)
    X, c = multi(*first(X0))
    first, step = t_fast.make_fast_step(tcfg, tgeom, ref_state=ref,
                                        device=CPU)
    E, ce = first(X0)
    for _ in range(3):
        E, ce = step(E, ce)
    for k in FIELDS:
        assert X[k].shape == X0[k].shape and torch.equal(X[k], E[k]), k
    for k in ce:
        assert torch.equal(c[k], ce[k]), k


@pytest.mark.parametrize("name,want", [
    ("schar", {"stage": 5, "uvw": 5, "update": 1, "banded": 0, "pass1": 0,
               "pass2": 0, "scalar": 16, "vector": 2, "state": 0,
               "scalar2": 0}),
    ("bubble3d", {"stage": 5, "uvw": 5, "update": 1, "banded": 0, "pass1": 1,
                  "pass2": 1, "scalar": 16, "vector": 2, "state": 0,
                  "scalar2": 0})])
def test_a_cartesian_step_goes_through_the_wrappers(configs, monkeypatch,
                                                    name, want):
    """Calls of the kernels' wrappers in one ``step`` (on the CPU each runs
    its plain version).  Schar: its terrain makes the 3-D Jacobian vary in
    z, so its nu4 tail is plain tensor code, as in the JAX package; the
    bubble's flat plane takes the two nu4 passes.  The DSS groups its fields
    as ``DSS_MERGE_DEFAULT`` says, as on the sphere."""
    from tempestmodel_tpu_torch.fast import implicit, implicit_cuda
    _, _, _, tcfg, _, tgeom = configs[name]
    if "state" in t_engine.DSS_MERGE_DEFAULT:
        want = dict(want, state=2, vector=0, scalar=want["scalar"] - 6)
    if "scalar2" in t_engine.DSS_MERGE_DEFAULT:
        pairs = 5 if "state" in t_engine.DSS_MERGE_DEFAULT else 7
        want = dict(want, scalar2=pairs, scalar=want["scalar"] - 2 * pairs)
    calls = dict.fromkeys(want, 0)

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(stage_cuda, "fused_stage",
                        counting("stage", stage_cuda.fused_stage))
    monkeypatch.setattr(implicit_cuda, "fused_implicit_update", counting(
        "update", implicit_cuda.fused_implicit_update))
    monkeypatch.setattr(implicit, "banded_solve",
                        counting("banded", implicit.banded_solve))
    for key, fname in (("pass1", "nu4_pass1"), ("pass2", "nu4_pass2")):
        monkeypatch.setattr(hyper_cuda, fname,
                            counting(key, getattr(hyper_cuda, fname)))
    for key in ("uvw", "scalar", "vector", "state", "scalar2"):
        monkeypatch.setattr(dss_cuda, f"dss_{key}",
                            counting(key, getattr(dss_cuda, f"dss_{key}")))
    cfg = tcfg.with_(vertical_solver="pallas")
    first, step = t_fast.make_fast_step(cfg, tgeom, device=CPU)
    fg = t_engine.build_fast_geometry_cartesian(tgeom, dtype=torch.float64,
                                                device=CPU)
    P, A, B = fg.inv_mult.shape
    d = synthetic.random_state_numpy(fg.nz, P, A, B, seed=2)
    # the natural layout at the step's boundary
    X = t_engine._swap_ab_state({k: torch.from_numpy(v) for k, v in d.items()})
    carry = {k: torch.zeros_like(X[k]) for k in ("Rt", "W", "Rho")}
    if fg.ab_swapped:
        carry = t_engine._swap_ab_state(carry)
    before = dict(launch_counts)
    step(X, carry)
    assert calls == want
    assert dict(launch_counts) == before          # CPU tensors: no launch


# ---------------------------------------------------------------------------
# the kernels on a card
# ---------------------------------------------------------------------------

def _to(fg, dev, dtype):
    return dataclasses.replace(fg, **{
        f.name: getattr(fg, f.name).to(dev, dtype)
        for f in dataclasses.fields(fg)
        if isinstance(getattr(fg, f.name), torch.Tensor)
        and getattr(fg, f.name).is_floating_point()})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("wrap", WRAPS, ids=WRAP_IDS)
def test_cuda_dss_kernels_with_wrap_match_plain(dtype, tol, wrap):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    d, imult, rot = _dss_inputs(9, seed=3)
    T = {k: torch.as_tensor(v, dtype=dtype, device="cuda")
         for k, v in d.items()}
    tm = torch.as_tensor(imult, dtype=dtype, device="cuda")
    tr = torch.as_tensor(rot, dtype=dtype, device="cuda")
    got = dss_cuda.dss_state(T, tm, tr, (), P_, wrap=wrap)
    got["W2"] = dss_cuda.dss_scalar(T["W"], tm, (), P_, wrap=wrap)
    torch.cuda.synchronize()
    want = dss_cuda.dss_state_plain(T, tm, tr, (), P_, wrap=wrap)
    want["W2"] = want["W"]
    for k in want:
        assert rel_err(got[k].cpu().numpy(), want[k].cpu().numpy()) <= tol, k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("swap", [True, False], ids=["xz_U", "xz_V"])
def test_cuda_fused_stage_xz_matches_plain(configs, swap, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    consts = configs["schar"][3].constants
    _, tfg = _stage_geometry(configs, swap)
    fg = _to(tfg, "cuda", dtype)
    d, b1, b2 = (synthetic.random_state(fg, seed=s) for s in (1, 2, 3))
    for base in (b1, ((0.3, b1), (0.7, b2))):
        got = stage_cuda.fused_stage(base, d, 0.5, fg, consts)
        torch.cuda.synchronize()
        want = stage_cuda.fused_stage_plain(base, d, 0.5, fg, consts)
        for k in FIELDS:
            assert rel_err(got[k].cpu().numpy(),
                           want[k].cpu().numpy()) <= tol, k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("swap", [True, False], ids=["swapped", "natural"])
def test_cuda_nu4_passes_on_a_plane_match_plain(configs, swap, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    _, tfg = _bubble_geometry(configs, swap)
    fg = _to(tfg, "cuda", dtype)
    d, w = (synthetic.random_state(fg, seed=s) for s in (4, 5))
    st = hyper_cuda.hyper_statics(fg)
    nu = (1e4, 1e4, 1e4, 1.0)
    got1 = hyper_cuda.nu4_pass1(d, fg, st)
    got2 = hyper_cuda.nu4_pass2(d, w, *nu, fg, st)
    torch.cuda.synchronize()
    want1 = hyper_cuda.nu4_pass1_plain(d, fg, st)
    want2 = hyper_cuda.nu4_pass2_plain(d, w, *nu, fg, st)
    for k in FIELDS:
        assert rel_err(got1[k].cpu().numpy(), want1[k].cpu().numpy()) <= tol
        assert rel_err((got2[k] - d[k]).cpu().numpy(),
                       (want2[k] - d[k]).cpu().numpy()) <= tol, k


@pytest.mark.gpu
def test_cartesian_kernel_path_matches_plain_path_on_the_card(configs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    for name in ("schar", "bubble3d"):
        ttc, tcfg, tgeom = configs[name][1], configs[name][3], configs[name][5]
        cfg = tcfg.with_(vertical_solver="pallas")
        state = ttc.initial_state(tgeom, cfg.constants, device="cuda")
        ref = ttc.reference_state(tgeom, cfg.constants, device="cuda") \
            if CASES[name]["rayleigh"] else None
        X0 = t_fast.pack_state(state, device="cuda")
        outs = []
        for kw in ({}, {"fused": False}, {"plain": True}):
            first, step = t_fast.make_fast_step(cfg, tgeom, ref_state=ref,
                                                device="cuda", **kw)
            X, c = step(*first(X0))
            outs.append(X)
        for other in outs[1:]:
            _compare(other, outs[0], 1e-11)
