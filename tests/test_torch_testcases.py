"""The port's remaining sphere and periodic x-z test cases against the JAX
package's, float64 on the CPU, with no step compiled: per case the initial
and reference states, the topography, the Rayleigh strength and the
constants to 1e-13 relative per field (the Held-Suarez start bit for bit:
its noise comes from the same seeded generator), the terrain geometry
(``build_nh_sphere_geometry``) and the separable metric of
``build_fast_geometry``, and the path predicates (the separable metric, the
stage and the nu4 kernels) equal to JAX's for every sphere case in float32
and float64.  Sphere grids: ne2 p4 nz6 with each case's own ztop and
constants; x-z grids: nex 6 nz 8."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.constants import PhysicalConstants as JConstants
from tempestmodel_tpu.fast import engine as j_engine, hyper_pallas
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases import nonhydro_sphere as j_sph
from tempestmodel_tpu.testcases import nonhydro_xz as j_xz
from tempestmodel_tpu_torch.constants import PhysicalConstants as TConstants
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch.fast import hyper_cuda, stage_cuda
from tempestmodel_tpu_torch.grid import geometry as t_geometry
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases import nonhydro_sphere as t_sph
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz

from torch_port_common import CPU, FIELDS, rel_err

TOL = 1e-13

# name -> (class, constructor keywords); every case of nonhydro_sphere the
# port carries besides UMJS, with each variant that changes a field
SPHERE = {
    "jw": ("BaroclinicWaveJW", {}),
    "jw_exp": ("BaroclinicWaveJW", {"pert": "exp"}),
    "held_suarez": ("HeldSuarezIC", {}),
    "held_suarez_seed3": ("HeldSuarezIC", {"seed": 3}),
    "igw": ("InertiaGravityWaveSphere", {}),
    "mountain_wave": ("MountainWaveSphere", {}),
    "mountain_wave_flat_still": ("MountainWaveSphere",
                                 {"mountain": "none", "no_rotation": True}),
    "schar": ("ScharMountainSphere", {}),
    "schar_sheared": ("ScharMountainSphere", {"cs": 2.5e-4}),
    "stationary": ("StationaryMountainFlow", {}),
    "rossby": ("MountainRossby3D", {}),
    "rossby_no_rayleigh": ("MountainRossby3D", {"use_rayleigh": False}),
    "baldauf": ("BaldaufGravityWave", {}),
    "baldauf_small": ("BaldaufGravityWave", {"radius_scale": 125.0}),
}
# the cases over a mountain
TERRAIN = ("jw", "jw_exp", "mountain_wave", "schar", "schar_sheared",
           "stationary", "rossby", "rossby_no_rayleigh")
XZ = ("ThermalBubble", "RobertBubble", "HydrostaticMountain",
      "NonHydroMountain", "ShearJetMountainWave")


def _constants(tc, base):
    return tc.constants(base) if hasattr(tc, "constants") else base


def _topography(tc, c):
    """The geometry's ``topography(lon, lat)``, as the JAX tests pass it."""
    if not hasattr(tc, "topography"):
        return None
    return lambda lon, lat: tc.topography(lon, lat, c)


def _rayleigh(tc):
    return getattr(tc, "rayleigh_strength", None)


def sphere_pair(name, dtype_j=jnp.float64, dtype_t=torch.float64):
    """(jtc, ttc, jcfg, tcfg, jgeom, tgeom) of one sphere case: ne2 p4 nz6,
    the case's own ztop and constants, its topography and Rayleigh layer."""
    cls, kw = SPHERE[name]
    jtc, ttc = getattr(j_sph, cls)(**kw), getattr(t_sph, cls)(**kw)
    jc, tc_ = _constants(jtc, JConstants()), _constants(ttc, TConstants())
    common = dict(ne=2, order=4, nz=6, ztop=jtc.ztop, dt=100.0,
                  rayleigh_damping=_rayleigh(jtc) is not None,
                  nu_scalar=1e15, nu_div=1e15, nu_vort=1e15)
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE, constants=jc,
                          dtype=dtype_j, **common)
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, constants=tc_,
                          dtype=dtype_t, **common)
    jgeom = j_nh.build_nh_sphere_geometry(
        jcfg, ztop=jtc.ztop, topography=_topography(jtc, jc),
        rayleigh=_rayleigh(jtc))
    tgeom = t_nh.build_nh_sphere_geometry(
        tcfg, ztop=ttc.ztop, topography=_topography(ttc, tc_),
        rayleigh=_rayleigh(ttc))
    return jtc, ttc, jcfg, tcfg, jgeom, tgeom


@pytest.fixture(scope="module")
def sphere():
    return {name: sphere_pair(name) for name in SPHERE}


def _states_match(jtc, ttc, jcfg, tcfg, jgeom, tgeom, bitwise=False):
    fns = ["initial_state"] + (["reference_state"]
                               if hasattr(jtc, "reference_state") else [])
    for fn in fns:
        want = getattr(jtc, fn)(jgeom, jcfg.constants, dtype=jnp.float64)
        got = getattr(ttc, fn)(tgeom, tcfg.constants, dtype=torch.float64,
                               device=CPU)
        assert set(got) == set(FIELDS), fn
        for k in FIELDS:
            assert got[k].dtype == torch.float64 and got[k].is_contiguous()
            assert got[k].device.type == "cpu"
            w = np.asarray(want[k])
            assert got[k].shape == w.shape, (fn, k)
            assert np.isfinite(w).all(), (fn, k)
            if bitwise:
                np.testing.assert_array_equal(got[k].numpy(), w,
                                              err_msg=f"{fn} {k}")
            else:
                assert rel_err(got[k].numpy(), w) < TOL, (fn, k)


# ---------------------------------------------------------------------------
# the sphere cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SPHERE))
def test_sphere_states_match_jax(sphere, name):
    _states_match(*sphere[name], bitwise=name.startswith("held_suarez"))


def test_held_suarez_noise_depends_on_its_seed(sphere):
    a = sphere["held_suarez"]
    b = sphere["held_suarez_seed3"]
    sa = a[1].initial_state(a[5], a[3].constants, device=CPU)
    sb = b[1].initial_state(b[5], b[3].constants, device=CPU)
    assert not torch.equal(sa["U"], sb["U"])
    np.testing.assert_array_equal(sa["Rho"].numpy(), sb["Rho"].numpy())


@pytest.mark.parametrize("name", list(SPHERE))
def test_sphere_constants_topography_and_rayleigh_match_jax(sphere, name):
    jtc, ttc, jcfg, tcfg, jgeom, tgeom = sphere[name]
    assert dataclasses.asdict(tcfg.constants) == \
        dataclasses.asdict(jcfg.constants)
    assert hasattr(ttc, "constants") == hasattr(jtc, "constants")
    assert hasattr(ttc, "topography") == hasattr(jtc, "topography")
    assert hasattr(ttc, "rayleigh_strength") == \
        hasattr(jtc, "rayleigh_strength")
    lon, lat = np.asarray(jgeom.lon), np.asarray(jgeom.lat)
    if hasattr(jtc, "topography"):
        want = jtc.topography(lon, lat, jcfg.constants)
        got = ttc.topography(lon, lat, tcfg.constants)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(
            np.abs(want).max(), 1.0))
    if hasattr(jtc, "rayleigh_strength"):
        z = np.asarray(jgeom.z_lev)
        np.testing.assert_array_equal(ttc.rayleigh_strength(z),
                                      jtc.rayleigh_strength(z))


@pytest.mark.parametrize("name", TERRAIN)
def test_terrain_geometry_matches_jax(sphere, name):
    """Every array of the sphere geometry over the case's mountain, bit
    for bit (the same host numpy code): the topography, its DSS'd
    derivative and the metric built from them reach ``z_lev``, ``z_int``,
    the contravariant terms and the Jacobians.  The terrain is real (its
    terms are not zero)."""
    *_, jgeom, tgeom = sphere[name]
    assert isinstance(tgeom, t_geometry.CubedSphereGeometry)
    for f in dataclasses.fields(t_geometry.CubedSphereGeometry):
        want, got = getattr(jgeom, f.name), getattr(tgeom, f.name)
        if want is None or isinstance(want, (int, float, bool, str, tuple)):
            assert got == want, f.name
            continue
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.shape == want.shape, \
            f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert np.abs(tgeom.con_a_xi).max() > 0.0
    assert np.abs(tgeom.z_int[..., 0]).max() > 1.0


@pytest.mark.parametrize("name", TERRAIN)
def test_separable_metric_matches_jax(sphere, name):
    """``build_fast_geometry``'s Gal-Chen extraction, bit for bit: the
    profile is taken at the same node (the geometries are bitwise equal,
    so a tie in |dZs/da| breaks alike), so the same ``s_lev`` / ``s_int``
    and 2-D fields, non-zero; the reduced planet's lengths reach the nu4
    scale (``reference_length``, ``nu_delta``, ``delta``) alike."""
    *_, jgeom, tgeom = sphere[name]
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    tfg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64,
                                       device=CPU)
    assert tfg.sep_ok and jfg.sep_ok
    for k in ("s_lev", "s_int", "sep_ca", "sep_cb", "sep_e", "sep_f",
              "sep_da", "sep_db", "sep_jacl", "jac3d", "jac3d_int",
              "deriv_r_a", "deriv_r_b"):
        want = np.asarray(getattr(jfg, k))
        got = getattr(tfg, k).numpy()
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in ("reference_length", "nu_delta", "delta"):
        assert getattr(tfg, k) == getattr(jfg, k), k
    assert np.abs(tfg.sep_ca.numpy()).max() > 0.0
    assert np.abs(tfg.s_int.numpy()).max() > 0.0


def _jax_stage_choice(fg):
    """The fused-stage choice of JAX ``make_fast_step``
    (``fast/engine.py:1021``)."""
    return (fg.vo == 1 and fg.p <= 8 and 8 % fg.p == 0
            and (fg.A % 8 == 0 or (fg.A <= 8 and fg.A % fg.p == 0)))


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("name", list(SPHERE))
def test_path_predicates_match_jax(name, precision):
    """The separable metric, the fused stage and the nu4 kernels are
    chosen as in the JAX package, on the geometry built in each dtype (a
    one-ulp difference of the z-constant Jacobian would flip the nu4
    choice in one package only).  Over a mountain, a geometry built in
    float32 fails the Gal-Chen factorization's 1e-10 residual test in both
    packages, so the stage takes its full 3-D metric form there; the
    z-constant Jacobian keeps the nu4 kernels in either dtype."""
    dj, dt = ((jnp.float32, torch.float32) if precision == "f32"
              else (jnp.float64, torch.float64))
    jtc, ttc, jcfg, tcfg, jgeom, tgeom = sphere_pair(name, dj, dt)
    jfg = j_engine.build_fast_geometry(jgeom, dtype=dj)
    tfg = t_engine.build_fast_geometry(tgeom, dtype=dt, device=CPU)
    assert tfg.jac3d.dtype == dt
    got = (tfg.sep_ok, stage_cuda.stage_supported(tfg),
           hyper_cuda.supported(tfg, tcfg))
    want = (jfg.sep_ok, _jax_stage_choice(jfg),
            hyper_pallas.supported(jfg, jcfg))
    assert got == want
    mountain = name in TERRAIN and SPHERE[name][1].get("mountain") != "none"
    assert got == (precision == "f64" or not mountain, True, True)


# ---------------------------------------------------------------------------
# the periodic x-z cases
# ---------------------------------------------------------------------------

def xz_pair(cls):
    jtc, ttc = getattr(j_xz, cls)(), getattr(t_xz, cls)()
    kw = dict(nex=6, ney=1, order=4, nz=8, x_extent=jtc.x_extent,
              y_extent=jtc.y_extent, ztop=jtc.ztop, dt=1.0)
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CARTESIAN_XZ,
                          dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ,
                          dtype=torch.float64, **kw)
    jgeom = j_nh.build_nh_cartesian_geometry(
        jcfg, ztop=jtc.ztop, topography=getattr(jtc, "topography", None))
    tgeom = t_nh.build_nh_cartesian_geometry(
        tcfg, ztop=ttc.ztop, topography=getattr(ttc, "topography", None))
    return jtc, ttc, jcfg, tcfg, jgeom, tgeom


@pytest.mark.parametrize("cls", XZ)
def test_xz_states_match_jax(cls):
    _states_match(*xz_pair(cls))


@pytest.mark.parametrize("cls", XZ)
def test_xz_topography_rayleigh_and_extents_match_jax(cls):
    jtc, ttc, _, _, jgeom, _ = xz_pair(cls)
    for attr in ("x_extent", "y_extent", "ztop", "rayleigh"):
        assert getattr(ttc, attr, None) == getattr(jtc, attr, None), attr
    assert getattr(ttc, "bc_x", "periodic") == "periodic"
    assert dataclasses.asdict(ttc) == dataclasses.asdict(jtc)
    z = np.asarray(jgeom.z_lev)
    x = np.broadcast_to(np.asarray(jgeom.x)[None, :, None, None], z.shape)
    if hasattr(jtc, "topography"):
        np.testing.assert_array_equal(ttc.topography(x[..., 0], 0.0),
                                      jtc.topography(x[..., 0], 0.0))
    if hasattr(jtc, "rayleigh_strength"):
        for args in ((z,), (z, x)):
            np.testing.assert_array_equal(ttc.rayleigh_strength(*args),
                                          jtc.rayleigh_strength(*args))
        # the lateral sponge is there: the strength depends on x
        assert np.ptp(ttc.rayleigh_strength(z, x)[..., 0]) > 0.0


def test_shear_jet_tropopause_bootstrap_matches_jax():
    c = JConstants()
    want = j_xz.ShearJetMountainWave()._tp_constants(c)
    got = t_xz.ShearJetMountainWave()._tp_constants(TConstants())
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    z = np.linspace(0.0, 30000.0, 61)
    for g, w in zip(t_xz.ShearJetMountainWave()._profiles(z, TConstants()),
                    j_xz.ShearJetMountainWave()._profiles(z, c)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["jw", "held_suarez", "rossby", "baldauf",
                                  "ShearJetMountainWave", "ThermalBubble"])
def test_states_need_a_cuda_device_unless_cpu_is_named(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    if name in SPHERE:
        _, ttc, _, tcfg, _, tgeom = sphere_pair(name)
    else:
        _, ttc, _, tcfg, _, tgeom = xz_pair(name)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttc.initial_state(tgeom, tcfg.constants)
    state = ttc.reference_state(tgeom, tcfg.constants, device="cpu")
    assert all(v.device.type == "cpu" for v in state.values())
