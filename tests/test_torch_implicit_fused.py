"""The port's fused implicit Newton update vs the JAX Pallas kernel
(interpret mode) on the same seeded inputs, float64: the plain version, the
packed statics and diagonal tables array by array, the fixed-window table
the CUDA kernel reads, the fused branch of ``vertical_implicit``; the
kernel on a card."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.fast import (engine as j_engine, implicit as j_imp,
                                   pallas_implicit as j_pim)
from tempestmodel_tpu.models import nonhydro as j_nonhydro
from tempestmodel_tpu_torch.fast import implicit as t_imp, implicit_cuda
from tempestmodel_tpu_torch.kernels import synthetic
from tempestmodel_tpu_torch.kernels.counts import launch_counts
from tempestmodel_tpu_torch.models import nonhydro as t_nonhydro

from torch_port_common import (build_pair, CPU, perturbed_umjs_state, rel_err,
                               terrain_like_pair)

TOL = 1e-12
DT = 100.0


@pytest.fixture(scope="module")
def setup():
    jcfg, jgeom, tcfg, tgeom = build_pair()
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    # a terrain-like metric: on the flat UMJS terrain the curl term that
    # tells the exact Jacobian from the reference one vanishes
    jfg, tfg = terrain_like_pair(jfg, seed=6)
    q = j_nonhydro.estimate_bandwidth(jgeom, jcfg.constants)
    jst = j_nonhydro.band_assembly_statics(jgeom, q)
    tst = t_imp.statics_to_device(
        t_nonhydro.band_assembly_statics(tgeom, q), torch.float64, CPU)
    d = perturbed_umjs_state(jcfg, jgeom, seed=3)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    jmats = {k: getattr(jfg, k) for k in implicit_cuda.MATS}
    tmats = {k: getattr(tfg, k) for k in implicit_cuda.MATS}
    jps = j_pim.pack_statics(jst, dtype=np.float64, fold=1)
    ist = implicit_cuda.implicit_statics(tst, tfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jfg=jfg, tfg=tfg, q=q, jst=jst, tst=tst,
                jd=jd, td=td, jmats=jmats, tmats=tmats, jps=jps, ist=ist)


def test_pack_statics_array_by_array(setup):
    jps, tps = setup["jps"], setup["ist"].ps
    for f in dataclasses.fields(tps):
        got, want = getattr(tps, f.name), getattr(jps, f.name)
        if isinstance(got, np.ndarray):
            assert got.shape == want.shape, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, f.name
    assert tps.q == 4 and tps.offs0 == tps.offs_p1 == tps.offs_m1 == (-1, 0, 1)


def test_pack_statics_without_penalty(setup):
    st = dict(setup["tst"], has_penalty=False)
    tps = implicit_cuda.pack_statics(st, dtype=np.float64)
    jps = j_pim.pack_statics(dict(setup["jst"], has_penalty=False),
                             dtype=np.float64, fold=1)
    for name in ("Pl_b", "Pr_b", "Ul", "Ur"):
        np.testing.assert_array_equal(getattr(tps, name), getattr(jps, name))


def test_build_diag_table_array_by_array(setup):
    s = setup
    jvd, jmeta = j_pim.build_diag_table(s["jps"], s["jmats"], 1, np.float64)
    tvd, tmeta = implicit_cuda.build_diag_table(s["ist"].ps, s["tmats"],
                                                np.float64)
    assert tmeta == jmeta
    np.testing.assert_array_equal(tvd, jvd)


def _columns():
    cols, col = {}, 0
    for name, offs in implicit_cuda.LAYOUT + implicit_cuda.BAND_COLUMNS:
        cols[name] = (col, offs)
        col += len(offs)
    assert col == implicit_cuda.NCOLS == 70
    return cols


@pytest.mark.parametrize("name", ["In2i", "Dn2i", "DD", "Ii2n", "Di2n", "Pl",
                                  "Pr", "TA-1", "TA0", "TA1", "TB-1", "TB0",
                                  "TB1"])
def test_stencil_table_reproduces_the_operator(setup, name):
    s = setup
    ps = s["ist"].ps
    table = implicit_cuda.stencil_table(ps, s["tmats"])
    assert table.shape == (ps.nz + 1, implicit_cuda.NCOLS)
    named = {"In2i": "interp_n2i", "Dn2i": "diff_n2i", "DD": "diffdiff_i2i",
             "Ii2n": "interp_i2n", "Di2n": "diff_i2n", "Pl": "penalty_left",
             "Pr": "penalty_right"}
    if name in named:
        M = s["tmats"][named[name]].numpy()
    else:
        M = getattr(ps, name[:2])[ps.offs0.index(int(name[2:]))]
    col, offs = _columns()[name]
    x = np.random.default_rng(0).standard_normal(M.shape[1])
    got = np.zeros(M.shape[0])
    for r in range(M.shape[0]):
        for j, o in enumerate(offs):
            if table[r, col + j] != 0.0:
                got[r] += table[r, col + j] * x[r + o]
    np.testing.assert_allclose(got, M @ x, rtol=0,
                               atol=1e-12 * np.abs(M).max())


@pytest.mark.parametrize("name", ["Wl", "Wr", "Ul0", "Ul1", "Ur0", "Ur1"])
def test_stencil_table_edge_operators_act_on_interfaces(setup, name):
    """Wl, Wr, Ul_o, Ur_o take values on interior element edges; the table
    holds them against the interfaces k and k + 1 (edge j = interface
    j + 1)."""
    s = setup
    ps = s["ist"].ps
    table = implicit_cuda.stencil_table(ps, s["tmats"])
    if name in ("Wl", "Wr"):
        M = s["tmats"]["wscat_left" if name == "Wl" else "wscat_right"].numpy()
    else:
        M = getattr(ps, name[:2])[ps.ow.index(int(name[2:]))]
    col, offs = _columns()[name]
    assert offs == (-1, 0)
    xi = np.random.default_rng(1).standard_normal(ps.nz + 1)   # interfaces
    got = np.array([table[k, col] * xi[k] + table[k, col + 1] * xi[k + 1]
                    for k in range(ps.nz)])
    np.testing.assert_allclose(got, M @ xi[1:ps.nz], rtol=0, atol=1e-14)


def test_stencil_table_band_columns(setup):
    ps = setup["ist"].ps
    table = implicit_cuda.stencil_table(ps, setup["tmats"])
    cols = _columns()
    for name, offs in implicit_cuda.BAND_COLUMNS:
        col, _ = cols[name]
        arr = getattr(ps, name)
        for j, o in enumerate(offs):
            vec = arr[(-1, 0, 1).index(o)][:, 0]
            np.testing.assert_array_equal(table[:len(vec), col + j], vec)
            assert not table[len(vec):, col + j].any()


def test_predicate_is_about_the_configuration(setup):
    s = setup
    assert implicit_cuda.fused_supported(s["ist"])
    no_pen = implicit_cuda.implicit_statics(
        dict(s["tst"], has_penalty=False), s["tfg"])
    assert not implicit_cuda.fused_supported(no_pen)
    vo2 = implicit_cuda.implicit_statics(
        s["tst"], dataclasses.replace(s["tfg"], vo=2))
    assert not implicit_cuda.fused_supported(vo2)
    wide = implicit_cuda.stencil_table(
        s["ist"].ps, dict(s["tmats"], diff_i2n=torch.ones_like(
            s["tmats"]["diff_i2n"])))
    assert wide is None
    assert implicit_cuda.stencil_table(
        dataclasses.replace(s["ist"].ps, q=5), s["tmats"]) is None


@pytest.fixture(scope="module")
def pallas_update(setup):
    """The JAX kernel at fold=1, one jitted function per (mode, time term),
    compiled at first use and kept for the module."""
    s = setup
    jx0, jaux = j_imp._prep_aux(s["jd"], s["jfg"])
    cache = {}

    def run(ref_jacobian, time_term, x_parts):
        key = (ref_jacobian, time_term)
        if key not in cache:
            cache[key] = jax.jit(lambda x, x0: j_pim.fused_implicit_update(
                x, x0, jaux, s["jmats"], s["jps"], DT, s["jcfg"].constants,
                ref_jacobian=ref_jacobian, newton_time_term=time_term,
                col_tile=512, interpret=True))
        return cache[key](x_parts, jx0)

    return jx0, run


@pytest.mark.parametrize("time_term", [False, True], ids=["first", "later"])
@pytest.mark.parametrize("ref_jacobian", [False, True],
                         ids=["exact", "reference"])
def test_fused_update_plain_matches_pallas(setup, pallas_update, ref_jacobian,
                                           time_term):
    s = setup
    jx0, run = pallas_update
    tx0, taux = t_imp._prep_aux(s["td"], s["tfg"], interfaces=False)
    jx = tuple(p * 1.001 for p in jx0) if time_term else jx0
    tx = tuple(p * 1.001 for p in tx0) if time_term else tx0
    want = run(ref_jacobian, time_term, jx)
    before = dict(launch_counts)
    got = implicit_cuda.fused_implicit_update(
        tx, tx0, taux, s["ist"], DT, s["tcfg"].constants,
        ref_jacobian=ref_jacobian, newton_time_term=time_term)
    assert dict(launch_counts) == before          # CPU tensors: no launch
    for g, w, name in zip(got, want, ("d_rt", "d_w", "d_rho")):
        assert rel_err(g.numpy(), w) < TOL, name


def test_exact_and_reference_updates_differ(setup):
    """The inputs do tell the two Jacobian modes apart."""
    s = setup
    tx0, taux = t_imp._prep_aux(s["td"], s["tfg"], interfaces=False)
    a, b = (implicit_cuda.fused_implicit_update_plain(
        tx0, tx0, taux, s["ist"], DT, s["tcfg"].constants, ref_jacobian=r)
        for r in (False, True))
    assert rel_err(a[1].numpy(), b[1].numpy()) > 1e-9


@pytest.mark.parametrize("ref_jacobian,iters", [(False, 2), (True, 1)],
                         ids=["exact_2_newton", "reference_1_newton"])
def test_vertical_implicit_fused_branch_matches_pallas(setup, ref_jacobian,
                                                       iters):
    """Through ``vertical_implicit(use_pallas=True)`` on both sides: the JAX
    package then runs its folded Pallas kernel, the port its fused branch."""
    s = setup
    jout = jax.jit(lambda d: j_imp.vertical_implicit(
        d, s["jfg"], s["jcfg"].constants, DT, s["q"], s["jst"],
        newton_iters=iters, use_pallas=True, ref_jacobian=ref_jacobian))(
            s["jd"])
    tout = t_imp.vertical_implicit(
        s["td"], s["tfg"], s["tcfg"].constants, DT, s["q"], s["tst"],
        newton_iters=iters, use_pallas=True, ref_jacobian=ref_jacobian,
        ist=s["ist"])
    for k in ("U", "V", "Rt", "W", "Rho"):
        assert rel_err(tout[k].numpy(), jout[k]) < TOL, k
    # the unfused branch and the plain switch agree with it
    unfused = t_imp.vertical_implicit(
        s["td"], s["tfg"], s["tcfg"].constants, DT, s["q"], s["tst"],
        newton_iters=iters, use_pallas=True, ref_jacobian=ref_jacobian)
    plain = t_imp.vertical_implicit(
        s["td"], s["tfg"], s["tcfg"].constants, DT, s["q"], s["tst"],
        newton_iters=iters, use_pallas=True, ref_jacobian=ref_jacobian,
        ist=s["ist"], plain=True)
    for k in ("Rt", "W", "Rho"):
        assert rel_err(unfused[k].numpy(), tout[k].numpy()) < TOL, k
        assert torch.equal(plain[k], tout[k]), k


@pytest.mark.parametrize("case", ["shape", "dtype", "contiguity", "aux"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(setup, case):
    s = setup
    x0, aux = t_imp._prep_aux(s["td"], s["tfg"], interfaces=False)
    rt, w, rho = x0
    args = (s["ist"], DT, s["tcfg"].constants)
    if case == "shape":
        with pytest.raises(ValueError):
            implicit_cuda.fused_implicit_update((rt, w[:-1], rho), x0, aux,
                                                *args)
    elif case == "dtype":
        with pytest.raises(ValueError):
            implicit_cuda.fused_implicit_update(
                tuple(p.to(torch.float16) for p in x0), x0, aux, *args)
    elif case == "contiguity":
        with pytest.raises(ValueError):
            implicit_cuda.fused_implicit_update(
                (rt.T.contiguous().T, w, rho), x0, aux, *args)
    else:
        with pytest.raises(ValueError):
            implicit_cuda.fused_implicit_update(
                x0, x0, dict(aux, jac=aux["jac"][:-1]), *args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-3)])
def test_cuda_kernel_matches_plain(setup, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.models import nh_model
    s = setup
    tcfg = s["tcfg"].with_(dtype=dtype)
    geom = nh_model.build_nh_sphere_geometry(tcfg, ztop=tcfg.ztop)
    fg = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device="cuda"), seed=6)
    statics = t_imp.statics_to_device(
        t_nonhydro.band_assembly_statics(geom, s["q"]), dtype, "cuda")
    ist = implicit_cuda.implicit_statics(statics, fg)
    d = {k: v.to("cuda", dtype) for k, v in s["td"].items()}
    x0, aux = t_imp._prep_aux(d, fg, interfaces=False)
    x1 = tuple((p * 1.001).contiguous() for p in x0)
    for ref_jacobian in (False, True):
        for time_term in (False, True):
            xs = x1 if time_term else x0
            got = implicit_cuda.fused_implicit_update(
                xs, x0, aux, ist, DT, tcfg.constants,
                ref_jacobian=ref_jacobian, newton_time_term=time_term)
            torch.cuda.synchronize()
            want = implicit_cuda.fused_implicit_update_plain(
                xs, x0, aux, ist, DT, tcfg.constants,
                ref_jacobian=ref_jacobian, newton_time_term=time_term)
            for g, w in zip(got, want):
                assert rel_err(g.cpu(), w.cpu()) < tol
