"""The port's plain DSS vs the JAX Pallas DSS kernels (interpret mode),
as ``tests/test_dss_pallas.py`` holds those against the reference
formulation (``dss_uvw`` with the W stage finish folded in, the one-launch
``dss_state`` and ``dss_scalar2`` among them); the wrappers' checks; the
CUDA kernels on a card."""

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


def test_dss_scalar_takes_a_flat_tracer_field(setup):
    """All species as one field of K = ntr * nz rows (more rows than the
    state has levels): the JAX kernel on the same flat field, and one DSS
    per species."""
    jfg, tfg, d = setup
    ntr, nz = 3, tfg.nz
    flat = np.random.default_rng(3).standard_normal((ntr * nz, 6, tfg.A,
                                                     tfg.A))
    want = dss_pallas.dss_scalar(jnp.asarray(flat), jfg.inv_mult,
                                 jfg.dss_links, jfg.p, interpret=True)
    t = torch.from_numpy(flat)
    before = dict(launch_counts)
    got = dss_cuda.dss_scalar(t, tfg.inv_mult, tfg.dss_links, tfg.p,
                              table=tfg.dss_table)
    assert dict(launch_counts) == before          # CPU tensors: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-13)
    for s in range(ntr):
        one = dss_cuda.dss_scalar_plain(t[s * nz:(s + 1) * nz], tfg.inv_mult,
                                        tfg.dss_links, tfg.p)
        assert torch.equal(got[s * nz:(s + 1) * nz], one), s


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


def _w_finish_pair(jfg, d, two_base, seed=5, bottom_only=False):
    """The same seeded W finish for both packages.  The surface metric rows
    are random: the configuration's own are zero (flat terrain), which
    would make the bottom row trivially zero."""
    rng = np.random.default_rng(seed)
    shp = d["W"].shape
    zero = np.zeros(shp)
    arr = {"bw1": zero if bottom_only else rng.standard_normal(shp),
           "bw2": zero if bottom_only else rng.standard_normal(shp),
           "dW": zero if bottom_only else rng.standard_normal(shp),
           "cax0": rng.standard_normal(shp[1:]),
           "cbx0": rng.standard_normal(shp[1:]),
           "cxx0": 1.0 + np.abs(rng.standard_normal(shp[1:]))}
    if not two_base:
        arr["bw2"] = None
    In0 = np.asarray(jfg.interp_n2i)[0]
    scal = {"cb1": 0.3, "cb2": 0.7, "dt_s": 12.5, "c00": float(In0[0]),
            "c01": float(In0[1])}
    jwf = dict(scal, **{k: None if v is None else jnp.asarray(v)
                        for k, v in arr.items()})
    twf = dict(scal, **{k: None if v is None else torch.from_numpy(v.copy())
                        for k, v in arr.items()})
    return jwf, twf


@pytest.mark.parametrize("two_base", [True, False],
                         ids=["two_base", "one_base"])
def test_dss_uvw_plain_matches_pallas(setup, two_base):
    """Mirror of ``tests/test_dss_pallas.py::test_dss_uvw_w_finish_fold``."""
    jfg, tfg, d = setup
    jwf, twf = _w_finish_pair(jfg, d, two_base)
    want = dss_pallas.dss_uvw(jnp.asarray(d["U"]), jnp.asarray(d["V"]),
                              jfg.inv_mult, jfg.e_rot, jfg.dss_links, jfg.p,
                              jwf, interpret=True)
    u, v = torch.from_numpy(d["U"]), torch.from_numpy(d["V"])
    before = dict(launch_counts)
    got = dss_cuda.dss_uvw(u, v, tfg.inv_mult, tfg.e_rot, tfg.dss_links,
                           tfg.p, twf, table=tfg.dss_table)
    assert dict(launch_counts) == before          # CPU tensors: no launch
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12 * float(np.abs(w).max()))
    # the pieces: vector DSS of (U, V), W finish, scalar DSS of W
    wu, wv = dss_cuda.dss_vector_plain(u, v, tfg.inv_mult, tfg.e_rot,
                                       tfg.dss_links, tfg.p)
    ww = dss_cuda.dss_scalar_plain(
        t_engine.w_finish_xla({"U": u, "V": v}, twf), tfg.inv_mult,
        tfg.dss_links, tfg.p)
    assert torch.equal(got[0], wu) and torch.equal(got[1], wv)
    assert torch.equal(got[2], ww)


def test_dss_uvw_bottom_row_on_panel_edges_and_corners(setup):
    """Base W and dW zero: the output W is the DSS of the bottom row alone,
    which on a panel edge takes the partner node's U, V and surface
    metric.  Held against the JAX kernel on edges and corners."""
    jfg, tfg, d = setup
    jwf, twf = _w_finish_pair(jfg, d, two_base=True, seed=9,
                              bottom_only=True)
    _, _, want = dss_pallas.dss_uvw(
        jnp.asarray(d["U"]), jnp.asarray(d["V"]), jfg.inv_mult, jfg.e_rot,
        jfg.dss_links, jfg.p, jwf, interpret=True)
    _, _, got = dss_cuda.dss_uvw_plain(
        torch.from_numpy(d["U"]), torch.from_numpy(d["V"]), tfg.inv_mult,
        tfg.e_rot, tfg.dss_links, tfg.p, twf)
    want = np.asarray(want)
    assert not got[1:].any() and np.abs(want[0]).max() > 0.1
    edge = np.zeros(want.shape[2:], bool)
    edge[0, :] = edge[-1, :] = edge[:, 0] = edge[:, -1] = True
    scale = np.abs(want[0]).max()
    np.testing.assert_allclose(got[0].numpy()[:, edge], want[0][:, edge],
                               rtol=0, atol=1e-13 * scale)
    corners = got[0].numpy()[:, [0, 0, -1, -1], [0, -1, 0, -1]]
    np.testing.assert_allclose(corners,
                               want[0][:, [0, 0, -1, -1], [0, -1, 0, -1]],
                               rtol=0, atol=1e-13 * scale)
    # the three panels that meet at a cube corner hold one value there
    w0 = got[0].numpy()
    vals = sorted(set(np.round(corners.ravel() / scale, 10)))
    assert len(vals) <= 8 and np.isfinite(w0).all()


def _state(d, nz, lib):
    """The first ``nz`` levels (``nz + 1`` interfaces) of the seeded state."""
    conv = jnp.asarray if lib == "jax" else (
        lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    return {k: conv(v[:nz + (1 if k == "W" else 0)]) for k, v in d.items()}


def _rayleigh(d, nz, lib, seed=4):
    rng = np.random.default_rng(seed)
    fac = {k: rng.random(v[:nz + (1 if k == "W" else 0)].shape)
           for k, v in d.items()}
    fac["Rho"] = np.ones_like(fac["Rho"])
    ref = {k: (1.0 - fac[k]) * rng.standard_normal(fac[k].shape) for k in d}
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return ({k: conv(v) for k, v in fac.items()},
            {k: conv(v) for k, v in ref.items()})


@pytest.mark.parametrize("nz", [6, 5], ids=["even_nz", "odd_nz"])
@pytest.mark.parametrize("ray", [False, True], ids=["no_rayleigh",
                                                    "rayleigh"])
def test_dss_state_plain_matches_pallas_and_the_separate_launches(
        setup, nz, ray):
    """Mirror of ``tests/test_dss_pallas.py::test_dss_state_*``."""
    jfg, tfg, d = setup
    want = dss_pallas.dss_state(
        _state(d, nz, "jax"), jfg.inv_mult, jfg.e_rot, jfg.dss_links, jfg.p,
        rayleigh=_rayleigh(d, nz, "jax") if ray else None, interpret=True)
    td = _state(d, nz, "torch")
    tray = _rayleigh(d, nz, "torch") if ray else None
    before = dict(launch_counts)
    got = dss_cuda.dss_state(td, tfg.inv_mult, tfg.e_rot, tfg.dss_links,
                             tfg.p, rayleigh=tray, table=tfg.dss_table)
    assert dict(launch_counts) == before          # CPU tensors: no launch
    for k in t_engine.FIELDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0,
                                   atol=1e-13 * float(np.abs(want[k]).max()))
    # bit for bit what the four launches (and the plain finish) give
    sep = t_engine.apply_dss(td, tfg, rayleigh=tray, merge=())
    one = t_engine.apply_dss(td, tfg, rayleigh=tray, merge=("state",))
    pl = t_engine.apply_dss(td, tfg, rayleigh=tray, merge=("state",),
                            plain=True)
    for k in t_engine.FIELDS:
        assert torch.equal(got[k], sep[k]), k
        assert torch.equal(one[k], sep[k]) and torch.equal(pl[k], sep[k]), k


@pytest.mark.parametrize("nz", [6, 5], ids=["even_nz", "odd_nz"])
def test_dss_scalar2_plain_matches_pallas_and_two_launches(setup, nz):
    jfg, tfg, d = setup
    w1, w2 = dss_pallas.dss_scalar2(
        jnp.asarray(d["Rt"][:nz]), jnp.asarray(d["Rho"][:nz]), jfg.inv_mult,
        jfg.dss_links, jfg.p, interpret=True)
    f1 = torch.from_numpy(np.ascontiguousarray(d["Rt"][:nz]))
    f2 = torch.from_numpy(np.ascontiguousarray(d["Rho"][:nz]))
    before = dict(launch_counts)
    g1, g2 = dss_cuda.dss_scalar2(f1, f2, tfg.inv_mult, tfg.dss_links, tfg.p,
                                  table=tfg.dss_table)
    assert dict(launch_counts) == before
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=0, atol=1e-13)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), rtol=0, atol=1e-13)
    for g, f in ((g1, f1), (g2, f2)):
        assert torch.equal(g, dss_cuda.dss_scalar_plain(
            f, tfg.inv_mult, tfg.dss_links, tfg.p))


def test_apply_dss_scalar2_with_the_w_finish(setup):
    """``merge=("scalar2",)`` beside the folded W finish: same bits."""
    jfg, tfg, d = setup
    _, twf = _w_finish_pair(jfg, d, two_base=True)
    upd = {k: torch.from_numpy(d[k]) for k in ("U", "V", "Rt", "Rho")}
    a = t_engine.apply_dss(upd, tfg, w_finish=twf, merge=())
    b = t_engine.apply_dss(upd, tfg, w_finish=twf,
                           merge=("state", "scalar2"))
    for k in t_engine.FIELDS:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", ["w_levels", "rayleigh_shape", "f2_shape",
                                  "f2_dtype", "rot"])
def test_one_launch_wrappers_raise_on_what_the_kernels_do_not_take(setup,
                                                                   case):
    _, tfg, d = setup
    td = _state(d, 6, "torch")
    args = (tfg.inv_mult, tfg.e_rot, tfg.dss_links, tfg.p)
    with pytest.raises((ValueError, TypeError)):
        if case == "w_levels":
            dss_cuda.dss_state(dict(td, W=td["W"][:-1].contiguous()), *args)
        elif case == "rayleigh_shape":
            fac, ref = _rayleigh(d, 6, "torch")
            dss_cuda.dss_state(td, *args, rayleigh=(
                fac, dict(ref, W=ref["W"][:-1].contiguous())))
        elif case == "f2_shape":
            dss_cuda.dss_scalar2(td["Rt"], td["W"], tfg.inv_mult,
                                 tfg.dss_links, tfg.p)
        elif case == "f2_dtype":
            dss_cuda.dss_scalar2(td["Rt"], td["Rho"].to(torch.float32),
                                 tfg.inv_mult, tfg.dss_links, tfg.p)
        else:
            dss_cuda.dss_state(td, tfg.inv_mult, tfg.e_rot[:, :-1],
                               tfg.dss_links, tfg.p)


def test_w_finish_xla_matches_jax(setup):
    jfg, tfg, d = setup
    for two_base in (True, False):
        jwf, twf = _w_finish_pair(jfg, d, two_base, seed=3)
        want = j_engine.w_finish_xla(
            {"U": jnp.asarray(d["U"]), "V": jnp.asarray(d["V"])}, jwf)
        keep = twf["dW"].clone()
        got = t_engine.w_finish_xla(
            {"U": torch.from_numpy(d["U"]), "V": torch.from_numpy(d["V"])},
            twf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-13 * float(np.abs(want).max()))
        assert torch.equal(twf["dW"], keep)       # the argument is left alone


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
        # the periodic wrap belongs to a grid without edge links
        with pytest.raises(ValueError):
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


@pytest.mark.parametrize("case", ["bw1_shape", "metric_shape", "dW_dtype",
                                  "levels"])
def test_dss_uvw_raises_on_what_the_kernel_does_not_take(setup, case):
    jfg, tfg, d = setup
    _, twf = _w_finish_pair(jfg, d, two_base=True)
    u, v = torch.from_numpy(d["U"]), torch.from_numpy(d["V"])
    args = (tfg.inv_mult, tfg.e_rot, tfg.dss_links, tfg.p)
    if case == "bw1_shape":
        twf["bw1"] = twf["bw1"][:-1]
    elif case == "metric_shape":
        twf["cxx0"] = twf["cxx0"][:, :-1]
    elif case == "dW_dtype":
        twf["dW"] = twf["dW"].to(torch.float32)
    else:
        u, v = u[:1], v[:1]
        twf = {k: x[:2] if k in ("bw1", "bw2", "dW") else x
               for k, x in twf.items()}
    with pytest.raises((ValueError, TypeError)):
        dss_cuda.dss_uvw(u, v, *args, twf)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-6)])
def test_cuda_dss_uvw_matches_plain(setup, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    jfg, tfg, d = setup
    dev = torch.device("cuda")
    imult = tfg.inv_mult.to(dev, dtype)
    rot = tfg.e_rot.to(dev, dtype)
    u, v = (torch.from_numpy(d[k]).to(dev, dtype) for k in ("U", "V"))
    for two_base in (True, False):
        _, twf = _w_finish_pair(jfg, d, two_base)
        twf = {k: x.to(dev, dtype) if isinstance(x, torch.Tensor) else x
               for k, x in twf.items()}
        got = dss_cuda.dss_uvw(u, v, imult, rot, tfg.dss_links, tfg.p, twf)
        torch.cuda.synchronize()
        want = dss_cuda.dss_uvw_plain(u, v, imult, rot, tfg.dss_links, tfg.p,
                                      twf)
        for g, w in zip(got + (got[2][0],), want + (want[2][0],)):
            assert float((g - w).abs().max() / w.abs().max()) <= tol


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_one_launch_kernels_equal_the_separate_launches(setup, dtype):
    """``dss_state`` (with and without the Rayleigh finish) and
    ``dss_scalar2`` on the card: bit for bit the separate kernels' results,
    and the plain versions' to 1e-13 / 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    _, tfg, d = setup
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    dev = torch.device("cuda")
    imult = tfg.inv_mult.to(dev, dtype)
    rot = tfg.e_rot.to(dev, dtype)
    args = (imult, rot, tfg.dss_links, tfg.p)
    for nz in (6, 5):
        td = {k: v.to(dev, dtype) for k, v in _state(d, nz, "torch").items()}
        ray = tuple({k: v.to(dev, dtype) for k, v in part.items()}
                    for part in _rayleigh(d, nz, "torch"))
        u, v = dss_cuda.dss_vector(td["U"], td["V"], *args)
        sep = {"U": u, "V": v}
        for k in ("Rt", "Rho", "W"):
            sep[k] = dss_cuda.dss_scalar(td[k], imult, tfg.dss_links, tfg.p)
        g1, g2 = dss_cuda.dss_scalar2(td["Rt"], td["Rho"], imult,
                                      tfg.dss_links, tfg.p)
        assert torch.equal(g1, sep["Rt"]) and torch.equal(g2, sep["Rho"])
        for r in (None, ray):
            got = dss_cuda.dss_state(td, *args, rayleigh=r)
            torch.cuda.synchronize()
            want = dss_cuda.dss_state_plain(td, *args, rayleigh=r)
            fin = sep if r is None else {
                k: r[0][k] * sep[k] + r[1][k] for k in sep}
            for k in t_engine.FIELDS:
                assert torch.equal(got[k], fin[k]), (k, nz, r is not None)
                assert float((got[k] - want[k]).abs().max()
                             / want[k].abs().max()) <= tol
