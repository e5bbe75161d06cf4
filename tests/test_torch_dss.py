"""The port's plain DSS vs the JAX Pallas DSS kernels (interpret mode),
as ``tests/test_dss_pallas.py`` holds those against the reference
formulation; the wrappers' checks; the CUDA kernels on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.fast import engine as j_engine, dss_pallas
from tempestmodel_tpu_torch.fast import engine as t_engine, dss_cuda
from tempestmodel_tpu_torch.kernels.counts import launch_counts

from torch_port_common import build_pair, CPU


@pytest.fixture(scope="module")
def setup():
    nz = 6
    jcfg, jgeom, tcfg, tgeom = build_pair(nz=nz, ztop=1e4)
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    tfg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64,
                                       device=CPU)
    rng = np.random.default_rng(0)
    d = {k: rng.standard_normal((nz + (1 if k == "W" else 0), 6, tfg.A,
                                 tfg.A)) for k in t_engine.FIELDS}
    return jfg, tfg, d


@pytest.mark.parametrize("field", ["Rt", "W"])
def test_dss_scalar_plain_matches_pallas(setup, field):
    jfg, tfg, d = setup
    want = dss_pallas.dss_scalar(jnp.asarray(d[field]), jfg.inv_mult,
                                 jfg.dss_links, jfg.p, interpret=True)
    got = dss_cuda.dss_scalar_plain(torch.from_numpy(d[field]), tfg.inv_mult,
                                    tfg.dss_links, tfg.p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-13)


def test_dss_vector_plain_matches_pallas(setup):
    jfg, tfg, d = setup
    wu, wv = dss_pallas.dss_vector(jnp.asarray(d["U"]), jnp.asarray(d["V"]),
                                   jfg.inv_mult, jfg.e_rot, jfg.dss_links,
                                   jfg.p, interpret=True)
    gu, gv = dss_cuda.dss_vector_plain(
        torch.from_numpy(d["U"]), torch.from_numpy(d["V"]), tfg.inv_mult,
        tfg.e_rot, tfg.dss_links, tfg.p)
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu), rtol=0, atol=1e-13)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=1e-13)


def test_dss_is_a_projection_and_leaves_inputs_alone(setup):
    _, tfg, d = setup
    x = torch.from_numpy(d["Rho"].copy())
    once = dss_cuda.dss_scalar(x, tfg.inv_mult, tfg.dss_links, tfg.p)
    np.testing.assert_array_equal(x.numpy(), d["Rho"])
    twice = dss_cuda.dss_scalar(once, tfg.inv_mult, tfg.dss_links, tfg.p)
    np.testing.assert_allclose(twice.numpy(), once.numpy(), rtol=0,
                               atol=1e-13)


def test_wrappers_run_plain_on_cpu_and_count_nothing(setup):
    _, tfg, d = setup
    before = dict(launch_counts)
    u, v = torch.from_numpy(d["U"]), torch.from_numpy(d["V"])
    gu, gv = dss_cuda.dss_vector(u, v, tfg.inv_mult, tfg.e_rot,
                                 tfg.dss_links, tfg.p, table=tfg.dss_table)
    wu, wv = dss_cuda.dss_vector_plain(u, v, tfg.inv_mult, tfg.e_rot,
                                       tfg.dss_links, tfg.p)
    assert torch.equal(gu, wu) and torch.equal(gv, wv)
    assert dict(launch_counts) == before


def test_link_table_follows_the_links(setup):
    _, tfg, _ = setup
    table = dss_cuda.link_table(tfg.dss_links)
    assert table.shape == (24, 4) and table.dtype == np.int32
    for i, (pa, e, qa, qe, flip) in enumerate(tfg.dss_links):
        assert tuple(table[pa * 4 + e]) == (qa, qe, int(flip), i)
    assert torch.equal(tfg.dss_table, torch.from_numpy(table))
    with pytest.raises(ValueError):
        dss_cuda.link_table(tfg.dss_links[:-1])


@pytest.mark.parametrize("case", ["wrap", "contiguity", "dtype", "imult",
                                  "rot"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(setup, case):
    _, tfg, d = setup
    x = torch.from_numpy(d["Rt"])
    args = (tfg.inv_mult, tfg.dss_links, tfg.p)
    if case == "wrap":
        with pytest.raises(NotImplementedError):
            dss_cuda.dss_scalar(x, *args, wrap=(True, False))
    elif case == "contiguity":
        with pytest.raises(ValueError):
            dss_cuda.dss_scalar(x.transpose(2, 3), *args)
    elif case == "dtype":
        with pytest.raises(TypeError):
            dss_cuda.dss_scalar(x.to(torch.float16), *args)
    elif case == "imult":
        with pytest.raises(ValueError):
            dss_cuda.dss_scalar(x, tfg.inv_mult[:, :-1], tfg.dss_links,
                                tfg.p)
    else:
        with pytest.raises(ValueError):
            dss_cuda.dss_vector(x, x, tfg.inv_mult, tfg.e_rot[:, :-1],
                                tfg.dss_links, tfg.p)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-6)])
def test_cuda_kernels_match_plain(setup, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    _, tfg, d = setup
    dev = torch.device("cuda")
    imult = tfg.inv_mult.to(dev, dtype)
    rot = tfg.e_rot.to(dev, dtype)
    t = {k: torch.from_numpy(v).to(dev, dtype) for k, v in d.items()}
    got = dss_cuda.dss_scalar(t["W"], imult, tfg.dss_links, tfg.p)
    gu, gv = dss_cuda.dss_vector(t["U"], t["V"], imult, rot, tfg.dss_links,
                                 tfg.p)
    torch.cuda.synchronize()
    want = dss_cuda.dss_scalar_plain(t["W"], imult, tfg.dss_links, tfg.p)
    wu, wv = dss_cuda.dss_vector_plain(t["U"], t["V"], imult, rot,
                                       tfg.dss_links, tfg.p)
    for g, w in ((got, want), (gu, wu), (gv, wv)):
        assert float((g - w).abs().max() / w.abs().max()) <= tol
