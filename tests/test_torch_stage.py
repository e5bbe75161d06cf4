"""The port's fused explicit stage vs the JAX Pallas stage kernel (interpret
mode) on the same seeded inputs, float64: the plain version (with and
without tracers), the host-side tables the CUDA kernel reads, the wrapper's
checks; the kernel on a card."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.fast import engine as j_engine, stage_pallas
from tempestmodel_tpu_torch.fast import (engine as t_engine, stage_cuda,
                                         tracers as t_tracers)
from tempestmodel_tpu_torch.kernels import stage_edges, stencils, synthetic
from tempestmodel_tpu_torch.kernels.counts import launch_counts

from torch_port_common import (build_pair, rel_err, state_pair,
                               terrain_like_pair)

TOL = 1e-12
DT_S = 12.5
STATE4 = ("U", "V", "Rt", "Rho")


@pytest.fixture(scope="module")
def setup():
    jcfg, jgeom, tcfg, tgeom = build_pair()
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    jfg, tfg = terrain_like_pair(jfg, seed=4)
    states = [state_pair(jfg.nz, jfg.A, seed) for seed in (1, 2, 3)]
    return dict(jcfg=jcfg, tcfg=tcfg, jfg=jfg, tfg=tfg,
                j=[s[0] for s in states], t=[s[1] for s in states])


def _bases(s, which, two):
    ue, b1, b2 = s[which]
    return (((0.3, b1), (0.7, b2)) if two else b1), ue


@pytest.mark.parametrize("two", [False, True], ids=["one_base", "two_base"])
def test_fused_stage_plain_matches_pallas(setup, two):
    """``defer_w=False``: all five fields of the pre-DSS state."""
    s = setup
    jbase, jue = _bases(s, "j", two)
    tbase, tue = _bases(s, "t", two)
    want = stage_pallas.fused_stage(jbase, jue, DT_S, s["jfg"],
                                    s["jcfg"].constants, interpret=True)
    got = stage_cuda.fused_stage_plain(tbase, tue, DT_S, s["tfg"],
                                       s["tcfg"].constants)
    assert set(got) == set(want) == set(t_engine.FIELDS)
    for k in t_engine.FIELDS:
        assert rel_err(got[k].numpy(), want[k]) < TOL, k


@pytest.mark.parametrize("two", [False, True], ids=["one_base", "two_base"])
def test_fused_stage_plain_defer_w_matches_pallas(setup, two):
    """``defer_w=True``: the four fields and every ``w_finish`` entry."""
    s = setup
    jbase, jue = _bases(s, "j", two)
    tbase, tue = _bases(s, "t", two)
    want, wwf = stage_pallas.fused_stage(jbase, jue, DT_S, s["jfg"],
                                         s["jcfg"].constants, interpret=True,
                                         defer_w=True)
    got, gwf = stage_cuda.fused_stage_plain(tbase, tue, DT_S, s["tfg"],
                                            s["tcfg"].constants, defer_w=True)
    assert set(got) == set(want) == set(STATE4)
    for k in STATE4:
        assert rel_err(got[k].numpy(), want[k]) < TOL, k
    assert set(gwf) == set(wwf)
    for k, w in wwf.items():
        if w is None:
            assert gwf[k] is None, k
        elif isinstance(w, float):
            assert gwf[k] == pytest.approx(w, rel=1e-15), k
        else:
            assert rel_err(gwf[k].numpy(), w) < TOL, k


@pytest.fixture(scope="module")
def moist(setup):
    """The three states of ``setup`` with three seeded tracer species each
    (different sizes, a share of negative values), and a stage step so long
    that the tracers' increment is as large as the tracers: at ``DT_S`` it is
    a 1e-9th of them and a wrong tendency would pass unseen."""
    s = setup
    nz, A = s["tfg"].nz, s["tfg"].A
    trs = [synthetic.random_tracers_numpy(nz, 6, A, A, 3, 4, seed)
           for seed in (7, 8, 9)]
    j = [dict(d, Tracers=jnp.asarray(t)) for d, t in zip(s["j"], trs)]
    t = [dict(d, Tracers=torch.from_numpy(t.copy()))
         for d, t in zip(s["t"], trs)]
    tend = t_tracers.horizontal_update(torch.zeros_like(t[0]["Tracers"]),
                                       t[0], 1.0, s["tfg"])
    dt_big = float(t[0]["Tracers"].abs().max() / tend.abs().max())
    assert dt_big > 1e3 * DT_S
    return dict(s, j=j, t=t, dt_big=dt_big)


def _species_err(got, want, nz):
    want = np.asarray(want)
    return max(rel_err(got.numpy()[i:i + nz], want[i:i + nz])
               for i in range(0, want.shape[0], nz))


@pytest.mark.parametrize("defer_w", [False, True], ids=["w_here", "defer_w"])
@pytest.mark.parametrize("two", [False, True], ids=["one_base", "two_base"])
def test_fused_stage_plain_with_tracers_matches_pallas(moist, two, defer_w):
    """Every output of the stage with ``"Tracers"`` in the evaluation state
    and in the bases, the tracers species by species."""
    s = moist
    jbase, jue = _bases(s, "j", two)
    tbase, tue = _bases(s, "t", two)
    for dt_s in (DT_S, s["dt_big"]):
        want = stage_pallas.fused_stage(jbase, jue, dt_s, s["jfg"],
                                        s["jcfg"].constants, interpret=True,
                                        defer_w=defer_w)
        got = stage_cuda.fused_stage_plain(tbase, tue, dt_s, s["tfg"],
                                           s["tcfg"].constants,
                                           defer_w=defer_w)
        if defer_w:
            (want, wwf), (got, gwf) = want, got
            assert rel_err(gwf["dW"].numpy(), wwf["dW"]) < TOL
        assert set(got) == set(want)
        assert ("W" in got) == (not defer_w) and "Tracers" in got
        for k in got:
            assert got[k].is_contiguous(), k
            assert rel_err(got[k].numpy(), want[k]) < TOL, k
        assert _species_err(got["Tracers"], want["Tracers"],
                            s["tfg"].nz) < TOL


def test_a_base_without_tracers_stands_for_the_evaluation_states(moist):
    s = moist
    ue_j, ue_t = s["j"][0], s["t"][0]
    b_j = {k: v for k, v in s["j"][1].items() if k != "Tracers"}
    b_t = {k: v for k, v in s["t"][1].items() if k != "Tracers"}
    want = stage_pallas.fused_stage(b_j, ue_j, s["dt_big"], s["jfg"],
                                    s["jcfg"].constants, interpret=True)
    got = stage_cuda.fused_stage(b_t, ue_t, s["dt_big"], s["tfg"],
                                 s["tcfg"].constants)
    assert rel_err(got["Tracers"].numpy(), want["Tracers"]) < TOL
    same = stage_cuda.fused_stage(dict(b_t, Tracers=ue_t["Tracers"]), ue_t,
                                  s["dt_big"], s["tfg"], s["tcfg"].constants)
    assert torch.equal(got["Tracers"], same["Tracers"])


def test_build_stage_diags_match(setup):
    s = setup
    jvd, jmeta = stage_pallas.build_stage_diags(s["jfg"], np.float64)
    tvd, tmeta = stage_cuda.build_stage_diags(s["tfg"], np.float64)
    assert tmeta == jmeta
    np.testing.assert_array_equal(tvd, jvd)
    wide = dataclasses.replace(
        s["tfg"], diff_n2n=torch.ones_like(s["tfg"].diff_n2n))
    assert stage_cuda.build_stage_diags(wide, np.float64) == (None, None)


@pytest.mark.parametrize("name,attr", [
    ("Ii2n", "interp_i2n"), ("Dn2n", "diff_n2n"), ("In2i", "interp_n2i"),
    ("Pl", "penalty_left"), ("Pr", "penalty_right"),
    ("Wl", "wscat_left"), ("Wr", "wscat_right")])
def test_stencil_table_reproduces_the_operator(setup, name, attr):
    """The fixed-window table the CUDA kernel reads applies each vertical
    operator as the matrix does."""
    tfg = setup["tfg"]
    table = stage_cuda._stencil_table(tfg)
    assert table.shape == (tfg.nz + 1, stage_cuda.NCOLS)
    M = getattr(tfg, attr).numpy()
    col = 0
    for n, offs in stage_cuda.LAYOUT:
        if n == name:
            break
        col += len(offs)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(M.shape[1])
    got = np.zeros(M.shape[0])
    for r in range(M.shape[0]):
        for j, o in enumerate(offs):
            if table[r, col + j] != 0.0:
                got[r] += table[r, col + j] * x[r + o]
    np.testing.assert_allclose(got, M @ x, rtol=0, atol=1e-12 * np.abs(M).max())


def test_stage_statics_and_predicate(setup):
    tfg = setup["tfg"]
    assert stage_cuda.stage_supported(tfg)
    st = stage_cuda.stage_statics(tfg)
    n = (tfg.nz + 1) * stage_cuda.NCOLS
    p = tfg.p
    assert st.tab.shape == (n + 4 * p ** 2,) and st.use_sep and st.has_pen
    assert tuple(st.m2d.shape) == (12, 6, tfg.A, tfg.A)
    Da, Sa, Db, Sb = st.tab[n:].numpy().reshape(4, p, p)
    for got in (Da, Db):
        np.testing.assert_allclose(got, np.asarray(tfg.DA_elem) / tfg.delta,
                                   rtol=1e-15)
    for got in (Sa, Sb):
        np.testing.assert_allclose(got, np.asarray(tfg.S_elem) / tfg.delta,
                                   rtol=1e-15)
    In0 = tfg.interp_n2i[0]
    assert (st.c00, st.c01) == (float(In0[0]), float(In0[1]))
    full = stage_cuda.stage_statics(dataclasses.replace(tfg, sep_ok=False))
    assert not full.use_sep and tuple(full.m2d.shape) == (5, 6, tfg.A, tfg.A)
    # the switches of a Cartesian grid are inside the envelope
    assert stage_cuda.stage_supported(dataclasses.replace(
        tfg, xz_zero="U", ab_swapped=True, wrap=(True, True)))
    # outside the envelope: vertical order 2, a wide operator
    for bad in (dataclasses.replace(tfg, vo=2),
                dataclasses.replace(
                    tfg, diff_n2n=torch.ones_like(tfg.diff_n2n)),
                dataclasses.replace(
                    tfg, interp_i2n=torch.ones_like(tfg.interp_i2n))):
        assert not stage_cuda.stage_supported(bad)
        with pytest.raises(NotImplementedError):
            stage_cuda.stage_statics(bad)


def test_stencil_pack_refuses_a_diagonal_outside_its_window():
    M = np.eye(4) + np.eye(4, k=2)
    diags = {"M": stencils.extract_diags(M)}
    table = stencils.pack([("M", (0, 2))], diags, 5)
    assert table.shape == (5, 2)
    np.testing.assert_array_equal(table[:, 0], [1, 1, 1, 1, 0])
    np.testing.assert_array_equal(table[:, 1], [1, 1, 0, 0, 0])
    assert stencils.pack([("M", (0, 1))], diags, 5) is None
    assert stencils.extract_diags(np.ones((8, 8))) is None


def test_wrapper_runs_plain_on_cpu_and_counts_nothing(setup):
    s = setup
    base, ue = _bases(s, "t", True)
    before = dict(launch_counts)
    got = stage_cuda.fused_stage(base, ue, DT_S, s["tfg"],
                                 s["tcfg"].constants)
    want = stage_cuda.fused_stage_plain(base, ue, DT_S, s["tfg"],
                                        s["tcfg"].constants)
    for k in t_engine.FIELDS:
        assert torch.equal(got[k], want[k]), k
    assert dict(launch_counts) == before


@pytest.mark.parametrize("case", ["tracers", "shape", "contiguity", "dtype"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(setup, case):
    s = setup
    base, ue = _bases(s, "t", False)
    args = (DT_S, s["tfg"], s["tcfg"].constants)
    if case == "tracers":
        # a flat tracer field has ntr * nz rows, and the bases' must match
        with pytest.raises(ValueError):
            stage_cuda.fused_stage(base, dict(ue, Tracers=ue["W"]), *args)
        with pytest.raises(ValueError):
            stage_cuda.fused_stage(
                dict(base, Tracers=torch.cat([ue["Rho"], ue["Rho"]])),
                dict(ue, Tracers=ue["Rho"]), *args)
        with pytest.raises(ValueError):
            stage_cuda.fused_stage(
                base, dict(ue, Tracers=ue["Rho"].transpose(2, 3)), *args)
    elif case == "shape":
        with pytest.raises(ValueError):
            stage_cuda.fused_stage(base, dict(ue, W=ue["W"][:-1]), *args)
    elif case == "contiguity":
        with pytest.raises(ValueError):
            stage_cuda.fused_stage(
                dict(base, Rt=base["Rt"].transpose(2, 3)), ue, *args)
    else:
        with pytest.raises(ValueError):
            stage_cuda.fused_stage(
                base, {k: v.to(torch.float16) for k, v in ue.items()}, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("sep", [True, False], ids=["separable", "full3d"])
def test_cuda_kernel_matches_plain(setup, dtype, tol, sep):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.models import nh_model
    tcfg = setup["tcfg"].with_(dtype=dtype)
    geom = nh_model.build_nh_sphere_geometry(tcfg, ztop=tcfg.ztop)
    fg = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device="cuda"), seed=4)
    fg = dataclasses.replace(fg, sep_ok=sep)
    ue, b1, b2 = (synthetic.random_state(fg, seed) for seed in (1, 2, 3))
    for base in (b1, ((0.3, b1), (0.7, b2))):
        got, gwf = stage_cuda.fused_stage(base, ue, DT_S, fg, tcfg.constants,
                                          defer_w=True)
        torch.cuda.synchronize()
        want, wwf = stage_cuda.fused_stage_plain(base, ue, DT_S, fg,
                                                 tcfg.constants, defer_w=True)
        for k in STATE4:
            assert rel_err(got[k].cpu(), want[k].cpu()) < tol, k
        assert rel_err(gwf["dW"].cpu(), wwf["dW"].cpu()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("ntr", [3, 6], ids=["one_group", "two_groups"])
def test_cuda_kernel_with_tracers_matches_plain(setup, dtype, tol, ntr):
    """The tracer branch of the kernel at a step that makes the increment as
    large as the tracers, species by species; six species need a second
    group of flux tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.models import nh_model
    tcfg = setup["tcfg"].with_(dtype=dtype)
    geom = nh_model.build_nh_sphere_geometry(tcfg, ztop=tcfg.ztop)
    fg = synthetic.terrain_like(
        fast.build_fast_geometry(geom, dtype=dtype, device="cuda"), seed=4,
        vary_jac=True)
    ue, b1, b2 = (dict(synthetic.random_state(fg, seed),
                       Tracers=synthetic.random_tracers(fg, ntr, seed + 6))
                  for seed in (1, 2, 3))
    tend = t_tracers.horizontal_update(torch.zeros_like(ue["Tracers"]), ue,
                                       1.0, fg)
    dt_big = float(ue["Tracers"].abs().max() / tend.abs().max())
    nz = fg.nz
    for dt_s in (DT_S, dt_big):
        for base in (b1, ((0.3, b1), (0.7, b2))):
            got, _ = stage_cuda.fused_stage(base, ue, dt_s, fg,
                                            tcfg.constants, defer_w=True)
            torch.cuda.synchronize()
            want, _ = stage_cuda.fused_stage_plain(
                base, ue, dt_s, fg, tcfg.constants, defer_w=True)
            for k in STATE4:
                assert rel_err(got[k].cpu(), want[k].cpu()) < tol, k
            for i in range(0, ntr * nz, nz):
                assert rel_err(got["Tracers"][i:i + nz].cpu(),
                               want["Tracers"][i:i + nz].cpu()) < tol, i


# (nz, P, A, B, p) of the shapes the stage kernel runs at: the flagship, the
# test configuration, the Schar slice in both layouts, the 3-D bubble's
# plane, other element orders and level counts
LAUNCH_SHAPES = {
    "flagship": (30, 6, 120, 120, 4),
    "ne4": (8, 6, 16, 16, 4),
    "schar_swapped": (40, 1, 4, 400, 4),
    "schar_natural": (40, 1, 400, 4, 4),
    "bubble_plane": (40, 1, 128, 128, 4),
    "p3": (8, 6, 12, 12, 3),
    "p5": (8, 6, 20, 20, 5),
    "nz2": (2, 6, 16, 16, 4),
    "nz7": (7, 6, 16, 16, 4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("ntr", [0, 1, 3, 6])
@pytest.mark.parametrize("shape", list(LAUNCH_SHAPES))
def test_stage_launch_shape(shape, ntr, dtype):
    """Whole elements, 64-1024 threads a block wherever A * B allows 64 (at
    most MAX_THREADS), a ring the kernel takes, the species groups, and
    shared memory that fits an H100 block, for every base count and metric
    form."""
    nz, P, A, B, p = LAUNCH_SHAPES[shape]
    esize = 4 if dtype == torch.float32 else 8
    for two_base in (False, True):
        for sep in (True, False):
            sh = stage_cuda.stage_launch_shape(nz, A, B, p, ntr, dtype,
                                               two_base, sep, P)
            assert sh.TA % p == 0 and sh.TB % p == 0
            assert sh.TA <= A and sh.TB <= B
            assert min(64, A * B) <= sh.threads <= stage_cuda.MAX_THREADS
            assert 1 <= sh.levels <= nz
            assert stage_cuda.MIN_RING <= sh.ring <= stage_cuda.MAX_RING
            assert sh.group == min(ntr, stage_cuda.STAGE_SPECIES)
            nslab = stage_cuda.ring_slabs(ntr, two_base, sep)
            assert sh.smem == stage_cuda.stage_smem_bytes(
                nz, p, sh.TA, sh.TB, sh.ring, sh.group, nslab, esize)
            assert sh.smem <= stage_cuda.SMEM_MAX
            # the ring is shallower than RING only where a deeper one would
            # not fit or would leave an SM fewer than MIN_RESIDENT threads
            if sh.ring < stage_cuda.RING:
                deeper = stage_cuda.stage_smem_bytes(
                    nz, p, sh.TA, sh.TB, sh.ring + 1, sh.group, nslab, esize)
                assert deeper > stage_cuda.SMEM_MAX or sh.threads * \
                    stage_cuda.resident_blocks(
                        deeper, sh.threads,
                        stage_cuda.REGISTERS[esize, ntr > 0]) \
                    < stage_cuda.MIN_RESIDENT


def test_stage_launch_shape_fits_the_rows():
    """A warp on one row and at most MAX_IDLE of the last tiles idle on the
    flagship (B = 120); 32-64 rows, never 16-thread blocks, on Schar's
    natural layout (B = 4); Schar's small grids cut into chunks of
    MIN_LEVELS; explicit choices are kept."""
    f32, f64 = torch.float32, torch.float64

    def idle(A, B, sh):
        return 1 - A * B / (-(-A // sh.TA) * sh.TA * -(-B // sh.TB) * sh.TB)

    for dtype in (f32, f64):
        fl = stage_cuda.stage_launch_shape(30, 120, 120, 4, 0, dtype, True,
                                           True, 6)
        assert fl.TB >= 32 and idle(120, 120, fl) <= stage_cuda.MAX_IDLE
        assert 64 <= fl.threads <= stage_cuda.MAX_THREADS
    nat = stage_cuda.stage_launch_shape(40, 400, 4, 4, 0, f32, True, False, 1)
    assert nat.TB == 4 and 32 <= nat.TA <= 64
    sw = stage_cuda.stage_launch_shape(40, 4, 400, 4, 0, f32, True, False, 1)
    assert sw.TA == 4 and sw.TB >= 32 and idle(4, 400, sw) <= 0.1
    for sh in (nat, sw):
        assert sh.levels == stage_cuda.MIN_LEVELS
    mine = stage_cuda.stage_launch_shape(30, 120, 120, 4, 3, f32, True, True,
                                         6, tile=(8, 24), levels=10, ring=5)
    assert (mine.TA, mine.TB, mine.levels, mine.ring, mine.group) == \
        (8, 24, 10, 5, 3)
    with pytest.raises(ValueError):
        stage_cuda.stage_launch_shape(30, 120, 120, 4, 0, f32, tile=(6, 32))
    # a species count whose ring cannot fit an H100 block at any tile
    with pytest.raises(ValueError):
        stage_cuda.stage_launch_shape(30, 120, 120, 4, 400, torch.float64)


@pytest.mark.parametrize("B,TB,esize,offset,want", [
    (120, 40, 4, 0, 4), (120, 40, 4, 8, 2), (120, 40, 4, 4, 1),
    (9, 9, 4, 0, 1), (10, 10, 4, 0, 2), (4, 4, 4, 0, 4),
    (120, 40, 8, 0, 2), (120, 40, 8, 8, 1), (9, 9, 8, 0, 1), (4, 4, 8, 0, 2)])
def test_copy_width(B, TB, esize, offset, want):
    """16-byte copies where B, the tile row and every pointer allow them,
    else 8 bytes, else one value; a null pointer asks for nothing."""
    ptrs = [256, 4096 + offset, 0, 1 << 20]
    assert stage_cuda.copy_width(B, TB, esize, ptrs) == want


def test_launch_config_reports_the_launch(setup):
    s = setup
    base, ue = _bases(s, "t", True)
    conf = stage_cuda.launch_config(base, ue, s["tfg"])
    sh = stage_cuda.stage_launch_shape(8, 16, 16, 4, 0, torch.float64,
                                       True, True, 6)
    assert conf["tile"] == [sh.TA, sh.TB] and conf["ring"] == sh.ring
    assert conf["levels_per_block"] == sh.levels
    assert conf["slabs"] == stage_cuda.ring_slabs(0, True, True) == 13
    assert conf["copy_bytes"] == 16 and conf["copy_route"].startswith(
        "cp.async.cg")
    odd = {k: v.clone() for k, v in ue.items()}
    buf = torch.empty(odd["Rt"].numel() + 1, dtype=odd["Rt"].dtype)
    odd["Rt"] = buf[1:].view(odd["Rt"].shape)
    assert stage_cuda.launch_config(base, odd, s["tfg"])["copy_bytes"] == 8


def test_ptxas_report_is_parsed():
    from tempestmodel_tpu_torch.kernels import build
    text = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118fused_stage_kernelIfLb1ELb0EEEvNS_9StageArgsIT_EE'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1...\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 896 bytes "
        "cmem[0]\n")
    got = build.parse_ptxas(text)
    (name, use), = got.items()
    assert stage_cuda._ENTRY.search(name).groups() == ("f", "1", "0")
    assert use == {"registers": 96, "spill_stores": 8, "spill_loads": 12}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", list(stage_edges.CASES))
def test_cuda_kernel_edge_shapes_match_plain(dtype, tol, case):
    """Two levels, a level count no multiple of the chunk or the ring,
    one-value and 8-byte copies (p = 3, p = 5, unaligned pointers), one
    species and two groups of species: kernel against plain at the stage's
    step and at steps as long as each field's own scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    got = stage_edges.run_case(case, dtype, torch.device("cuda"))
    assert got["max_err"] < tol, got["err_by_output"]
