"""Host-side precompute of the port equals the JAX package's at ne4 p4 nz8
in float64: quadrature, column operators, geometry, the implicit statics,
the bandwidth estimate, the z-first geometry and the UMJS initial state."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.ops import quadrature as j_quad, column_ops as j_co
from tempestmodel_tpu.models import nonhydro as j_nonhydro
from tempestmodel_tpu.fast import engine as j_engine
from tempestmodel_tpu_torch.ops import quadrature as t_quad, column_ops as t_co
from tempestmodel_tpu_torch.models import nonhydro as t_nonhydro
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch import convert

from torch_port_common import (build_pair, initial_states, CPU,
                               fast_geometry_fields_numpy)

RTOL = 1e-13


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _same(a, b, name):
    if b is None or a is None:
        assert a is None and b is None, name
    elif isinstance(b, torch.Tensor):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=0, err_msg=name)
    elif isinstance(b, np.ndarray):
        np.testing.assert_allclose(b, np.asarray(a), rtol=RTOL, atol=0,
                                   err_msg=name)
    elif isinstance(b, float):
        assert b == pytest.approx(a, rel=RTOL), name
    else:
        assert a == b, name


@pytest.mark.parametrize("p", [2, 4, 5])
def test_quadrature(p):
    for fn in ("gauss_lobatto", "gauss"):
        for a, b in zip(getattr(j_quad, fn)(p, 0.0, 1.0),
                        getattr(t_quad, fn)(p, 0.0, 1.0)):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)
    x, w = t_quad.gauss_lobatto(p, 0.0, 1.0)
    np.testing.assert_allclose(t_quad.derivative_matrix(x),
                               j_quad.derivative_matrix(x), rtol=RTOL)
    np.testing.assert_allclose(t_quad.stiffness_matrix(x, w),
                               j_quad.stiffness_matrix(x, w), rtol=RTOL)


@pytest.mark.parametrize("nz,vo", [(8, 1), (8, 2), (6, 3)])
def test_column_ops(nz, vo):
    a = j_co.build_column_ops(nz, vo)
    b = t_co.build_column_ops(nz, vo)
    for f in dataclasses.fields(b):
        _same(getattr(a, f.name), getattr(b, f.name), f.name)


def test_geometry(pair):
    _, jgeom, _, tgeom = pair
    names = [f.name for f in dataclasses.fields(tgeom)]
    assert len(names) > 50
    for name in names:
        b = getattr(tgeom, name)
        if isinstance(b, np.ndarray):
            assert b.dtype == np.float64, name
        _same(getattr(jgeom, name), b, name)


def test_geometry_float32_cast():
    from tempestmodel_tpu_torch.models import nh_model
    from torch_port_common import torch_config
    tgeom = nh_model.build_nh_sphere_geometry(
        torch_config(nz=4, ne=2).with_(dtype=torch.float32))
    assert tgeom.jac3d.dtype == np.float32
    assert tgeom.inv_mult.dtype == np.float32


def test_band_assembly_statics_and_bandwidth(pair):
    jcfg, jgeom, tcfg, tgeom = pair
    jq = j_nonhydro.estimate_bandwidth(jgeom, jcfg.constants)
    tq = t_nonhydro.estimate_bandwidth(tgeom, tcfg.constants)
    assert tq == jq == 4
    js = j_nonhydro.band_assembly_statics(jgeom, jq)
    ts = t_nonhydro.band_assembly_statics(tgeom, tq)
    assert set(js) == set(ts)
    for k, v in ts.items():
        if isinstance(v, dict):
            assert set(v) == set(js[k]), k
            for o in v:
                _same(js[k][o], v[o], f"{k}[{o}]")
        else:
            assert v == js[k], k


def test_bandwidth_at_vertical_order_2():
    jcfg, jgeom, tcfg, tgeom = build_pair(vertical_order=2)
    assert (t_nonhydro.estimate_bandwidth(tgeom, tcfg.constants)
            == j_nonhydro.estimate_bandwidth(jgeom, jcfg.constants))


def test_build_fast_geometry(pair):
    _, jgeom, _, tgeom = pair
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    tfg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64,
                                       device=CPU)
    jnames = {f.name for f in dataclasses.fields(jfg)}
    for f in dataclasses.fields(tfg):
        if f.name == "dss_table":
            continue
        assert f.name in jnames, f.name
        _same(getattr(jfg, f.name), getattr(tfg, f.name), f.name)
    assert tfg.sep_ok


def test_fast_geometry_from_numpy_round_trip(pair):
    _, jgeom, _, tgeom = pair
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    got = convert.fast_geometry_from_numpy(
        fast_geometry_fields_numpy(jfg), device=CPU, dtype=torch.float64)
    own = t_engine.build_fast_geometry(tgeom, dtype=torch.float64,
                                       device=CPU)
    for f in dataclasses.fields(own):
        a, b = getattr(got, f.name), getattr(own, f.name)
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype, f.name
            if f.name == "dss_table":
                assert torch.equal(a, b)
                continue
        _same(a, b, f.name)
    with pytest.raises(KeyError):
        convert.fast_geometry_from_numpy({"nonsense": 1}, device=CPU)


def test_initial_state_and_state_from_numpy(pair):
    jcfg, jgeom, tcfg, tgeom = pair
    js, ts = initial_states(jcfg, jgeom, tcfg, tgeom)
    for k in ("U", "V", "Rt", "W", "Rho"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=RTOL, atol=1e-13 * float(
                                       np.abs(np.asarray(js[k])).max()))
    X = convert.state_from_numpy({k: np.asarray(v) for k, v in js.items()},
                                 device=CPU, dtype=torch.float64)
    jX = j_engine.pack_state(js)
    for k in X:
        assert X[k].is_contiguous()
        np.testing.assert_array_equal(X[k].numpy(), np.asarray(jX[k]))
    back = t_engine.unpack_state(X)
    for k in back:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(js[k]))


@pytest.mark.parametrize("which", ["initial_state", "reference_state"])
def test_moist_baroclinic_wave_states(pair, which):
    """``MoistBaroclinicWave``: the dry UMJS fields and the three tracers,
    array by array."""
    from tempestmodel_tpu.testcases.dcmip2016 import (
        MoistBaroclinicWave as JaxMoist)
    from tempestmodel_tpu_torch.testcases.dcmip2016 import (
        MoistBaroclinicWave as TorchMoist)
    jcfg, jgeom, tcfg, tgeom = pair
    js = getattr(JaxMoist(), which)(jgeom, jcfg.constants, dtype=jnp.float64)
    ts = getattr(TorchMoist(), which)(tgeom, tcfg.constants,
                                      dtype=torch.float64, device=CPU)
    assert set(ts) == set(js) == {"U", "V", "Rt", "W", "Rho", "Tracers"}
    assert tuple(ts["Tracers"].shape) == (3, 6, 16, 16, tcfg.nz)
    for k in js:
        want = np.asarray(js[k])
        np.testing.assert_allclose(ts[k].numpy(), want, rtol=RTOL,
                                   atol=1e-13 * float(np.abs(want).max()))
    assert float(ts["Tracers"][0].min()) > 0.0
    assert float(ts["Tracers"][1:].abs().max()) == 0.0
    f32 = TorchMoist().initial_state(tgeom, tcfg.constants,
                                     dtype=torch.float32, device=CPU)
    assert f32["Tracers"].dtype == torch.float32


def test_state_from_numpy_and_pack_state_with_tracers(pair):
    """Tracers (ntr, 6, A, B, nz) <-> the flat species-major field, as the
    JAX package lays it out; seeded species of different size, so a mix-up
    of species or levels shows."""
    from tempestmodel_tpu_torch.kernels import synthetic
    jcfg, jgeom, tcfg, tgeom = pair
    js, _ = initial_states(jcfg, jgeom, tcfg, tgeom)
    state_np = {k: np.asarray(v) for k, v in js.items()}
    nz, A = tcfg.nz, tcfg.ne * tcfg.order
    flat = synthetic.random_tracers_numpy(nz, 6, A, A, 3, 4, seed=1)
    state_np["Tracers"] = np.moveaxis(flat.reshape(3, nz, 6, A, A), 1, -1)
    jX = j_engine.pack_state({k: jnp.asarray(v) for k, v in state_np.items()})
    X = convert.state_from_numpy(state_np, device=CPU, dtype=torch.float64)
    assert set(X) == set(jX)
    assert X["Tracers"].is_contiguous()
    np.testing.assert_array_equal(X["Tracers"].numpy(), flat)
    for k in X:
        np.testing.assert_array_equal(X[k].numpy(), np.asarray(jX[k]))
    back = t_engine.unpack_state(X)
    jback = j_engine.unpack_state(jX)
    assert set(back) == set(jback)
    for k in back:
        assert back[k].is_contiguous()
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
    np.testing.assert_array_equal(back["Tracers"].numpy(),
                                  state_np["Tracers"])
    assert "Tracers" not in convert.state_from_numpy(
        {k: state_np[k] for k in t_engine.FIELDS}, device=CPU)
