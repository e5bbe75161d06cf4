"""The port's fused implicit Newton update vs the JAX Pallas kernel
(interpret mode) on the same seeded inputs, float64: the plain version, the
packed statics and diagonal tables array by array, the fixed-window table
the CUDA kernel reads, the fused branch of ``vertical_implicit``; the
kernel's launch rule and copy width; the kernel on a card, at the flagship's
shapes and at its edge shapes."""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.fast import (engine as j_engine, implicit as j_imp,
                                   pallas_implicit as j_pim)
from tempestmodel_tpu.models import nonhydro as j_nonhydro
from tempestmodel_tpu_torch.fast import (implicit as t_imp, implicit_cuda,
                                         stage_cuda)
from tempestmodel_tpu_torch.kernels import implicit_edges, synthetic
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
    # without the penalty terms (upwind_thermo=False) the kernel runs with
    # zero penalty columns in its table
    no_pen = implicit_cuda.implicit_statics(
        dict(s["tst"], has_penalty=False), s["tfg"])
    assert implicit_cuda.fused_supported(no_pen)
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


NZS = (2, 8, 30, 40, 64)
NCOLS_ = (1, 7, 1536, 1600, 86400)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("nz", NZS)
def test_implicit_launch_shape_fits_a_block(nz, dtype):
    """For every column count: whole warps, at most the kernel's threads,
    a tile whose shared memory (as the kernel lays it out) fits an H100
    block and leaves an SM at least one block, no more tiles than the
    columns need."""
    esize = 4 if dtype == torch.float32 else 8
    for ncol in NCOLS_:
        sh = implicit_cuda.implicit_launch_shape(nz, ncol, dtype)
        assert sh.threads % 32 == 0
        assert 32 <= sh.threads <= implicit_cuda.MAX_THREADS <= 1024
        assert sh.cols >= 1 and sh.threads % sh.cols == 0
        assert sh.smem == implicit_cuda.implicit_smem_bytes(nz, sh.cols,
                                                            esize)
        assert sh.smem <= implicit_cuda.SMEM_MAX
        assert stage_cuda.resident_blocks(
            sh.smem, sh.threads, implicit_cuda.REGISTERS[esize]) >= 1
        assert sh.blocks(ncol) == -(-ncol // sh.cols)
        # a smaller tile is taken wherever a larger one would leave SMs idle
        if ncol >= implicit_cuda.SMS * min(implicit_cuda.COLS):
            assert sh.blocks(ncol) >= implicit_cuda.SMS


def test_implicit_smem_bytes_counts_the_kernels_layout():
    """W rows of 10 values, level rows of 6 or the staged interface fields
    (whichever is more), each to twice an odd count, 11 level and 5
    interface values a column; the table is not in shared memory."""
    nz, C = 30, 12
    per_col = 310 + 362 + 11 * 30 + 5 * 31
    assert implicit_cuda.implicit_smem_bytes(nz, C, 4) == 4 * C * per_col
    # two levels: the staged interface fields (7 fields, c2) outgrow the
    # four level rows
    assert implicit_cuda.implicit_smem_bytes(2, 1, 8) == \
        8 * (30 + 26 + 22 + 15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_implicit_launch_shape_covers_the_card_on_schar(dtype):
    """Schar's 1600 columns of 40 levels: at least one block for each of the
    132 SMs."""
    sh = implicit_cuda.implicit_launch_shape(40, 1600, dtype)
    assert sh.blocks(1600) >= implicit_cuda.SMS
    assert sh.cols <= 12


def test_implicit_launch_shape_raises_where_nothing_fits():
    f32, f64 = torch.float32, torch.float64
    with pytest.raises(ValueError):        # no tile of 400 levels fits
        implicit_cuda.implicit_launch_shape(400, 86400, f64)
    with pytest.raises(ValueError):        # this tile does not
        implicit_cuda.implicit_launch_shape(64, 86400, f64, cols=32)
    for dtype, threads in ((f32, 0), (f32, 48), (f32, 256), (f64, 256)):
        with pytest.raises(ValueError):
            implicit_cuda.implicit_launch_shape(30, 86400, dtype,
                                                threads=threads)
    with pytest.raises(ValueError):        # 12 columns, 128 threads
        implicit_cuda.implicit_launch_shape(30, 86400, f32, cols=12)
    mine = implicit_cuda.implicit_launch_shape(30, 86400, f32, cols=32,
                                               threads=96)
    assert (mine.cols, mine.threads) == (32, 96)


@pytest.mark.parametrize("ncol,cols,esize,offset,want", [
    (86400, 12, 4, 0, 4), (86400, 12, 4, 8, 2), (86400, 12, 4, 4, 1),
    (86400, 8, 8, 0, 2), (86400, 8, 8, 8, 1), (1600, 4, 4, 0, 4),
    (1532, 12, 4, 0, 4), (7, 4, 4, 0, 1), (1, 4, 8, 0, 1), (1534, 4, 4, 0, 2),
    (86400, 6, 4, 0, 2), (86400, 3, 8, 0, 1)])
def test_implicit_copy_width(ncol, cols, esize, offset, want):
    """16-byte copies where the column count, the tile and every pointer
    allow them, else 8 bytes, else one value."""
    ptrs = [256, 4096 + offset, 1 << 20]
    assert implicit_cuda.copy_width(ncol, cols, esize, ptrs) == want


def test_fused_supported_does_not_ask_the_device(setup):
    """The predicate reads the configuration (statics, levels, dtype): the
    same statics with a table and a geometry typed for a CUDA device give
    the same answer; a tile of one column that cannot fit an H100 block
    refuses the configuration."""
    ist = setup["ist"]
    for dtype in (torch.float32, torch.float64):
        on_cpu = dataclasses.replace(ist, tab=ist.tab.to(dtype))
        cuda_typed = dataclasses.replace(
            ist, tab=types.SimpleNamespace(dtype=dtype,
                                           device=torch.device("cuda")),
            fg=types.SimpleNamespace(inv_mult=types.SimpleNamespace(
                dtype=dtype, device=torch.device("cuda"))))
        assert implicit_cuda.fused_supported(on_cpu) \
            == implicit_cuda.fused_supported(cuda_typed) is True
        deep = dataclasses.replace(on_cpu, ps=dataclasses.replace(
            ist.ps, nz=2000))
        assert not implicit_cuda.fused_supported(deep)


def test_implicit_launch_config_reports_the_launch(setup):
    s = setup
    x0, aux = t_imp._prep_aux(s["td"], s["tfg"], interfaces=False)
    nz, ncol = x0[0].shape
    conf = implicit_cuda.launch_config(x0, x0, aux, s["ist"])
    sh = implicit_cuda.implicit_launch_shape(nz, ncol, torch.float64)
    assert conf["cols_per_block"] == sh.cols
    assert conf["threads"] == sh.threads
    assert conf["blocks"] == sh.blocks(ncol)
    assert conf["smem_bytes"] == sh.smem
    assert conf["copy_bytes"] == 16 and conf["copy_route"].startswith(
        "cp.async.cg")
    # a staged input one value off: 8-byte copies; the time-term inputs
    # count only with the time term
    buf = torch.empty(x0[0].numel() + 1, dtype=x0[0].dtype)
    odd = buf[1:].view(x0[0].shape)
    odd.copy_(x0[0])
    assert implicit_cuda.launch_config((odd,) + x0[1:], x0, aux, s["ist"])[
        "copy_bytes"] == 8
    x0_odd = (odd,) + x0[1:]
    assert implicit_cuda.launch_config(x0, x0_odd, aux, s["ist"])[
        "copy_bytes"] == 16
    assert implicit_cuda.launch_config(x0, x0_odd, aux, s["ist"], True)[
        "copy_bytes"] == 8


def test_implicit_kernel_resources_parses_the_build_report(monkeypatch):
    from tempestmodel_tpu_torch.kernels import build
    report = {
        "_ZN12_GLOBAL__N_121fused_implicit_kernelIfLi4EEEvNS_12Implicit"
        "ArgsIT_EE": {"registers": 72, "spill_stores": 0, "spill_loads": 0},
        "_ZN12_GLOBAL__N_121fused_implicit_kernelIdLi1EEEvNS_12Implicit"
        "ArgsIT_EE": {"registers": 120, "spill_stores": 0,
                      "spill_loads": 0}}
    monkeypatch.setattr(build, "ptxas_usage", lambda stem: report)
    got = implicit_cuda.kernel_resources()
    assert got == {"f32/16B": report[next(iter(report))],
                   "f64/8B": list(report.values())[1]}


@pytest.mark.parametrize("case", list(implicit_edges.CASES))
def test_implicit_edge_case_inputs(case):
    """Each edge case of the card's checks builds on the CPU: inside the
    envelope, the columns and the offset it names, a launch shape that fits,
    the copy width the offset forces, and a finite plain update."""
    nz, _, ncol, lover, offset = implicit_edges.CASES[case]
    x0, x1, aux, ist, consts, launch = implicit_edges.case_inputs(
        case, torch.float64, CPU)
    assert tuple(x0[0].shape) == (nz, ncol)
    assert tuple(aux["c2"].shape) == (4, ncol)
    for t in (*x0, *x1, *aux.values()):
        assert t.is_contiguous()
        assert t.data_ptr() % 16 == 8 * offset % 16
    conf = implicit_cuda.launch_config(
        x1, x0, aux, ist, True, launch)
    if lover:
        assert conf["cols_per_block"] == lover["cols"]
    want_bytes = {0: 16 if ncol % 2 == 0 else 8, 1: 8, 2: 16}[offset]
    assert conf["copy_bytes"] == want_bytes
    got = implicit_cuda.fused_implicit_update_plain(
        x1, x0, aux, ist, implicit_edges.DT, consts, False, True)
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-3)])
@pytest.mark.parametrize("case", ["flagship"] + list(implicit_edges.CASES))
def test_cuda_kernel_matches_plain(setup, dtype, tol, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    if case != "flagship":
        got = implicit_edges.run_case(case, dtype, torch.device("cuda"))
        assert got["max_err"] < tol, got["err_by_output"]
        return
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
