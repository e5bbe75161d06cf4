"""The port's physics packages and the test cases they run on, against the
JAX package's, float64 on the CPU, no JAX step compiled: the Held-Suarez,
Kessler (with rain enough for several sedimentation subcycles), DCMIP
simple-physics and Terminator updates on seeded inputs, each workflow
process's ``perform`` on a seeded state, and UMJS's
``apply_perturbation``, all to 1e-12 relative (the TropicalCyclone and
Supercell states are in ``test_torch_physics_states.py``)."""

import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tempestmodel_tpu.physics import dcmip_simple as j_simple
from tempestmodel_tpu.physics import held_suarez as j_hs
from tempestmodel_tpu.physics import kessler as j_kessler
from tempestmodel_tpu.physics import terminator as j_term
from tempestmodel_tpu_torch._device import OnDevice
from tempestmodel_tpu_torch.physics import dcmip_simple as t_simple
from tempestmodel_tpu_torch.physics import held_suarez as t_hs
from tempestmodel_tpu_torch.physics import kessler as t_kessler
from tempestmodel_tpu_torch.physics import terminator as t_term

from torch_port_common import CPU, FIELDS, JaxUMJS, TorchUMJS, build_pair

TOL = 1e-12


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = np.abs(want).max() + 1e-300
    err = np.abs(got - want).max() / scale
    assert err < tol, err
    return err


@pytest.fixture(scope="module")
def pair():
    return build_pair(ne=2, nz=6)


@pytest.fixture(scope="module")
def moist(pair):
    """A seeded moist state (z-last numpy): the UMJS start with noise and
    three tracer species [rho qv, rho qc, rho qr], the rain heavy enough
    that the sedimentation takes several subcycles of 300 s."""
    jcfg, jgeom, _, _ = pair
    js = JaxUMJS(pert="exp").initial_state(jgeom, jcfg.constants)
    rng = np.random.default_rng(11)
    s = {k: np.asarray(js[k]).copy() for k in FIELDS}
    for k in ("U", "V"):
        s[k] = s[k] * (1.0 + 0.05 * rng.standard_normal(s[k].shape))
    s["Rt"] = s["Rt"] * (1.0 + 1e-3 * rng.standard_normal(s["Rt"].shape))
    rho = s["Rho"]
    shp = rho.shape
    qv = 0.015 * np.exp(-np.arange(shp[-1]) / 2.0) \
        * (1.0 + 0.5 * rng.random(shp))
    qc = 1e-3 * rng.random(shp)
    qr = 5e-3 * rng.random(shp)
    s["Tracers"] = np.stack([qv * rho, qc * rho, qr * rho])
    return s


def _jstate(s):
    return {k: jnp.asarray(v) for k, v in s.items()}


def _tstate(s):
    return {k: torch.from_numpy(np.array(v)) for k, v in s.items()}


def test_held_suarez_update_matches_jax(pair, moist):
    jcfg, jgeom, tcfg, tgeom = pair
    want = j_hs.held_suarez_update(_jstate(moist), jgeom, jcfg.constants,
                                   300.0)
    for geom in (tgeom, OnDevice(tgeom, CPU)):
        got = t_hs.held_suarez_update(_tstate(moist), geom, tcfg.constants,
                                      300.0)
        assert set(got) == set(want)
        for k in ("U", "V", "Rt"):
            close(got[k], want[k])
            assert not np.array_equal(got[k].numpy(), moist[k]), k
        for k in ("W", "Rho", "Tracers"):
            np.testing.assert_array_equal(got[k].numpy(), moist[k])


def _kessler_inputs(pair, moist):
    jcfg, jgeom, _, _ = pair
    c = jcfg.constants
    rho = moist["Rho"]
    theta = moist["Rt"] / rho
    pk = np.asarray(c.exner_from_rhotheta(jnp.asarray(moist["Rt"]))) / c.Cp
    qv, qc, qr = (moist["Tracers"][i] / rho for i in range(3))
    return theta, qv, qc, qr, rho, pk, np.array(jgeom.z_lev)


def test_kessler_update_matches_jax_with_several_subcycles(pair, moist):
    args = _kessler_inputs(pair, moist)
    dt = 300.0
    # the CFL bound of the sedimentation, as both packages compute it
    theta, qv, qc, qr, rho, pk, z = args
    vel = 36.34 * (np.maximum(qr * 0.001 * rho, 0.0) ** 0.1364) \
        * np.sqrt(rho[..., :1] / rho)
    dt_max = min(dt, (0.8 * (z[..., 1:] - z[..., :-1]) / vel[..., :-1]).min())
    assert int(np.ceil(dt / dt_max)) > 1
    want = j_kessler.kessler_column_update(
        *(jnp.asarray(a) for a in args), dt)
    got = t_kessler.kessler_column_update(
        *(torch.from_numpy(np.array(a)) for a in args[:-1]), args[-1], dt)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("rj2012", [True, False])
@pytest.mark.parametrize("given_speed", [True, False])
def test_simple_physics_update_matches_jax(pair, moist, rj2012,
                                           given_speed):
    jcfg, jgeom, _, _ = pair
    c = jcfg.constants
    rng = np.random.default_rng(4)
    rho = moist["Rho"]
    q = moist["Tracers"][0] / rho
    pmid = np.asarray(c.pressure_from_rhotheta(jnp.asarray(moist["Rt"])))
    rt_i = np.einsum("KL,...L->...K", np.asarray(jgeom.interp_n2i),
                     moist["Rt"])
    pint = np.asarray(c.pressure_from_rhotheta(jnp.asarray(rt_i)))
    ps = pint[..., 0]
    temp = pmid / (rho * c.Rd) / (1.0 + 0.61 * q)
    # supersaturate a few points so the condensation branch acts
    q = np.where(rng.random(q.shape) < 0.1, 1.5 * q + 0.02, q)
    u = 20.0 * rng.standard_normal(temp.shape)
    v = 20.0 * rng.standard_normal(temp.shape)
    tsurf = 290.0 + 10.0 * rng.random(ps.shape)
    speed = np.abs(u[..., 0]) + 1.0 if given_speed else None
    args = (u, v, temp, q, pmid, pint, ps, tsurf)
    want = j_simple.simple_physics_update(
        *(jnp.asarray(a) for a in args), 300.0, rj2012_precip=rj2012,
        wind_speed=None if speed is None else jnp.asarray(speed))
    got = t_simple.simple_physics_update(
        *(torch.from_numpy(np.array(a)) for a in args), 300.0,
        rj2012_precip=rj2012,
        wind_speed=None if speed is None else torch.from_numpy(speed))
    for g, w in zip(got, want):
        close(g, w)


def test_terminator_matches_jax(pair):
    _, jgeom, _, tgeom = pair
    rng = np.random.default_rng(9)
    lat = np.array(jgeom.lat)[..., None]
    lon = np.array(jgeom.lon)[..., None]
    cl0, cl20 = t_term.terminator_initial(lat, lon)
    jcl0, jcl20 = j_term.terminator_initial(lat, lon)
    np.testing.assert_array_equal(cl0, jcl0)
    np.testing.assert_array_equal(cl20, jcl20)
    shp = lat.shape[:3] + (6,)
    cl = 2e-6 * rng.random(shp)
    cl2 = 1e-6 * rng.random(shp)
    dt = 300.0
    want = j_term.terminator_tendency(jnp.asarray(lat), jnp.asarray(lon),
                                      jnp.asarray(cl), jnp.asarray(cl2), dt)
    got = t_term.terminator_tendency(torch.from_numpy(lat),
                                     torch.from_numpy(lon),
                                     torch.from_numpy(cl),
                                     torch.from_numpy(cl2), dt)
    close(t_term.k_vals(torch.from_numpy(lat), torch.from_numpy(lon))[0],
          j_term.k_vals(jnp.asarray(lat), jnp.asarray(lon))[0])
    # the factor cl - det + r cancels (det ~ r ~ 0.25 against cl ~ 1e-6):
    # the rates are held against the scale of that factor's terms, |cl| +
    # det + r in its place, as a signed sum is held against its magnitudes
    k1 = np.maximum(0.0, np.sin(lat) * np.sin(j_term.K1_LAT_CENTER)
                    + np.cos(lat) * np.cos(j_term.K1_LAT_CENTER)
                    * np.cos(lon - j_term.K1_LON_CENTER))
    r = k1 / 4.0
    det = np.sqrt(r * r + 2.0 * r * (cl + 2.0 * cl2))
    expdt = np.exp(-4.0 * det * dt)
    el = np.where(np.abs(det * dt) > 1e-16,
                  (1.0 - expdt) / np.maximum(det, 1e-300) / dt, 4.0)
    scale = np.abs(el * (np.abs(cl) + det + r) * (cl + det + r)
                   / (1.0 + expdt + dt * el * (cl + r))).max()
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert np.abs(g.numpy() - np.asarray(w)).max() < TOL * scale


def test_moist_baroclinic_surface_temperature_matches_jax(pair):
    lat = np.asarray(pair[1].lat)
    np.testing.assert_array_equal(t_simple.moist_baro_tsurf(lat),
                                  j_simple.moist_baro_tsurf(lat))


def _models(pair, state):
    """Stand-ins for a JAX and a port model: what ``perform`` reads."""
    jcfg, jgeom, tcfg, tgeom = pair
    jm = types.SimpleNamespace(state=_jstate(state), geom=jgeom, cfg=jcfg,
                               user_data={})
    tm = types.SimpleNamespace(state=_tstate(state), geom=tgeom,
                               geom_dev=OnDevice(tgeom, CPU), cfg=tcfg,
                               user_data={}, device=CPU)
    return jm, tm


@pytest.mark.parametrize("name", ["held_suarez", "kessler", "simple_tc",
                                  "simple_moist", "terminator"])
def test_workflow_processes_match_jax(pair, moist, name):
    jm, tm = _models(pair, moist)
    jwp, twp = {
        "held_suarez": (j_hs.HeldSuarezPhysics(0.0),
                        t_hs.HeldSuarezPhysics(0.0)),
        "kessler": (j_kessler.KesslerPhysics(0.0),
                    t_kessler.KesslerPhysics(0.0)),
        "simple_tc": (j_simple.DCMIPSimplePhysics(0.0),
                      t_simple.DCMIPSimplePhysics(0.0)),
        "simple_moist": (
            j_simple.DCMIPSimplePhysics(600.0, test="moist_baroclinic"),
            t_simple.DCMIPSimplePhysics(600.0, test="moist_baroclinic")),
        "terminator": (j_term.TerminatorPhysics(0.0, cl_index=1),
                       t_term.TerminatorPhysics(0.0, cl_index=1)),
    }[name]
    want = jwp.perform(jm, 300.0)
    got = twp.perform(tm, 300.0)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    # the input state is left as it was
    for k in moist:
        np.testing.assert_array_equal(tm.state[k].numpy(), moist[k])
    if name == "kessler":
        close(tm.user_data["PRECL"], jm.user_data["PRECL"])
        assert float(tm.user_data["PRECL"].max()) > 0.0
    if name.startswith("simple"):
        close(twp.precl, jwp.precl)


def test_umjs_perturbation_matches_jax():
    # ne4: a grid fine enough for nodes inside the perturbation's radius
    jcfg, jgeom, tcfg, tgeom = build_pair(ne=4, nz=6)
    base = JaxUMJS(pert="none").initial_state(jgeom, jcfg.constants)
    want = JaxUMJS(pert="exp").apply_perturbation(base, jgeom,
                                                  jcfg.constants)
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in base.items()}
    got = TorchUMJS(pert="exp").apply_perturbation(tstate, tgeom,
                                                   tcfg.constants)
    for k in FIELDS:
        close(got[k], want[k])
    assert not torch.equal(got["U"], tstate["U"])
    assert torch.equal(got["Rho"], tstate["Rho"])
