"""The band kernel's host side (``dss_cuda.dss_launch_shape`` for its five
modes ``dss_scalar``, ``dss_vector``, ``dss_uvw``, ``dss_scalar2`` and
``dss_state``,
``copy_width``, the build report's instantiations), the edge shapes of
``kernels/dss_edges.py``
(the plain DSS against the JAX Pallas kernels in interpret mode at each
shape, and the kernels against the plain versions on a card), and the
sparse operator that ``chip_smoke.py`` times as the DSS kernels' library
yardstick.  No JAX step is compiled here."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.fast import dss_pallas
from tempestmodel_tpu_torch.fast import dss_cuda
from tempestmodel_tpu_torch.kernels import dss_edges, dss_operator

CPU = torch.device("cpu")
F32, F64 = torch.float32, torch.float64

# (K, P, A, B, p): the flagship (levels, interfaces, the moist wave's flat
# tracer field), Schar swapped and natural, the 3-D bubble's plane, and the
# edge cases' grids
SHAPES = [(30, 6, 120, 120, 4), (31, 6, 120, 120, 4), (90, 6, 120, 120, 4),
          (40, 1, 4, 400, 4), (41, 1, 4, 400, 4), (40, 1, 400, 4, 4),
          (41, 1, 400, 4, 4), (40, 1, 128, 128, 4), (8, 6, 16, 16, 4),
          (3, 6, 4, 4, 4), (3, 6, 6, 6, 3), (2, 6, 3, 3, 3), (4, 6, 6, 6, 2),
          (2, 6, 8, 8, 4), (3, 1, 9, 6, 3), (2, 1, 4, 4, 4)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


MODES = ["scalar", "vector", "uvw", "scalar2", "state"]
MODE_IDS = MODES


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_dss_launch_shape_fits_a_block(shape, mode, dtype):
    """Shared memory within a block's 227 KB and as the kernel lays it
    out, bands of whole elements that tile the panel, threads a multiple of
    a warp up to the launch bound, enough steps a block for the kernel."""
    K, P, A, B, p = shape
    sh = dss_cuda.dss_launch_shape(K, P, A, B, p, dtype, mode)
    esize = 4 if dtype == F32 else 8
    assert sh.smem <= dss_cuda.SMEM_MAX
    assert sh.smem == dss_cuda.dss_smem_bytes(sh.rows, A, B, sh.ring,
                                              mode, esize, P > 1)
    assert sh.rows % p == 0 and A % sh.rows == 0
    assert sh.threads % 32 == 0 and 32 <= sh.threads <= dss_cuda.MAX_THREADS
    # a block passes over its band's segments as few times as its threads
    # allow, with fewer than a warp of idle threads a pass
    nseg = sh.rows * B // p
    passes = math.ceil(nseg / sh.threads)
    assert passes == math.ceil(nseg / dss_cuda.MAX_THREADS)
    assert passes * sh.threads - nseg < 32 * passes
    # dss_uvw's and dss_state's K + 1 steps: the bottom interface (the top
    # interface of W) is a run of its own
    assert 1 <= sh.levels <= K
    assert sh.blocks == (A // sh.rows) * P * (
        math.ceil(K / sh.levels) + (mode in dss_cuda.EXTRA_RUN))
    assert 1 <= sh.ring <= dss_cuda.MAX_RING
    assert mode != "uvw" or sh.ring >= 2


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", MODES[:4], ids=MODE_IDS[:4])
def test_dss_launch_shape_fills_the_card_at_the_flagship(mode, dtype):
    """More than a full wave: at least two blocks for every SM (one stages
    while another sums), with the levels (K = 30) and the moist wave's
    flat tracer field (K = 90); the float32 modes with a run target of
    their own (``RUN_BLOCKS``) at least one block for every SM (the vector
    mode's sweep found 1.6 an SM, in longer runs, fastest)."""
    waves = 1 if (mode, 4 if dtype == F32 else 8) in dss_cuda.RUN_BLOCKS \
        else 2
    for K in (30, 90):
        sh = dss_cuda.dss_launch_shape(K, 6, 120, 120, 4, dtype, mode)
        assert sh.blocks >= waves * dss_cuda.SMS
        assert sh.levels >= 2 or K * 6 * 120 // sh.rows < 4 * dss_cuda.SMS


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_dss_launch_shape_does_not_starve_schar(mode):
    """Schar's slab (1600 nodes a level): a block a level, at least one
    block a level in both layouts."""
    for A, B in ((4, 400), (400, 4)):
        sh = dss_cuda.dss_launch_shape(40, 1, A, B, 4, F32, mode)
        assert sh.levels == 1 and sh.blocks >= 40


@pytest.mark.parametrize("case", ["p17", "rows", "uvw_levels", "uvw_ring",
                                  "too_wide", "vector_levels", "vector_ring",
                                  "vector_too_wide", "no_such_mode",
                                  "state_levels", "state_ring",
                                  "state_too_wide"])
def test_dss_launch_shape_raises_where_the_kernel_cannot_run(case):
    args = {"p17": ((4, 6, 34, 34, 17, F32, "scalar"), {}),
            "rows": ((4, 6, 16, 16, 4, F32, "scalar"), dict(rows=12)),
            "uvw_levels": ((4, 6, 16, 16, 4, F32, "uvw"), dict(levels=0)),
            "uvw_ring": ((4, 6, 16, 16, 4, F32, "uvw"), dict(ring=1)),
            "too_wide": ((4, 1, 4, 2000, 4, F64, "uvw"), {}),
            "vector_levels": ((4, 6, 16, 16, 4, F32, "vector"),
                              dict(levels=0)),
            "vector_ring": ((4, 6, 16, 16, 4, F32, "vector"), dict(ring=5)),
            "vector_too_wide": ((4, 1, 4, 6000, 4, F64, "vector"), {}),
            "no_such_mode": ((4, 6, 16, 16, 4, F32, 3), {}),
            "state_levels": ((4, 6, 16, 16, 4, F32, "state"),
                             dict(levels=0)),
            "state_ring": ((4, 6, 16, 16, 4, F32, "state"), dict(ring=5)),
            "state_too_wide": ((4, 1, 4, 3000, 4, F64, "state"), {})}[case]
    with pytest.raises(ValueError):
        dss_cuda.dss_launch_shape(*args[0], **args[1])


@pytest.mark.parametrize("B,esize,ptrs,want", [
    (120, 4, [256, 512], 16), (120, 8, [256], 16), (120, 4, [256, 260], 4),
    (120, 4, [256, 264], 8), (120, 8, [256, 264], 8), (6, 4, [256], 8),
    (3, 4, [256], 4), (6, 8, [256], 16), (3, 8, [256], 8),
    (4, 4, [256, 0], 16), (400, 4, [16, 32, 48], 16), (2, 4, [256], 8)])
def test_dss_copy_width(B, esize, ptrs, want):
    """16-byte bulk copies where a row and every pointer allow them, else
    8-byte copies, else one value; an absent pointer (0) allows all."""
    assert dss_cuda.copy_width(B, esize, ptrs) == want


def test_dss_vector_mode_takes_a_ring_of_one_and_no_bottom_run():
    """Unlike ``dss_uvw``, the vector mode walks K steps (no bottom
    interface of its own) and may stage through one stage; its block
    holds two field slots a stage and the edge rotations, no W slot."""
    sh = dss_cuda.dss_launch_shape(8, 6, 16, 16, 4, F32, "vector", ring=1,
                                   levels=3, rows=4)
    assert sh.ring == 1 and sh.blocks == 4 * 6 * 3
    nedge = 2 * (4 + 2) + 2 * 16
    fs = 6 * 16 + 44                    # span, edge lines (to 16 bytes)
    assert sh.smem == dss_cuda.BAR_BYTES + 4 * (
        2 * fs + 4 * 16 + 4 * nedge)
    cart = dss_cuda.dss_launch_shape(8, 1, 16, 16, 4, F32, "vector",
                                     ring=2, rows=4, links=False)
    assert cart.smem == dss_cuda.BAR_BYTES + 4 * (2 * 2 * 6 * 16 + 4 * 16)


def test_band_kernel_resources_are_read_from_the_build_report(monkeypatch):
    """The 40 instantiations (value type x mode x grid family x p 4 or
    any p) are named from their mangled names."""
    report = {}
    for t in "fd":
        for cart in "01":
            for pp in ("4", "0"):
                for m in "01234":
                    report[f"_ZN12_GLOBAL__N_111band_kernelI{t}Lb{cart}ELi"
                           f"{pp}ELi{m}EEEvNS_8BandArgsIT_EE"] = {
                        "registers": 40}
    report["_ZN12_GLOBAL__N_116dss_state_kernelIfLb0ELb0EEEvv"] = {}
    monkeypatch.setattr(dss_cuda.build, "ptxas_usage", lambda stem: report)
    got = dss_cuda.kernel_resources()
    assert len(got) == 40
    assert got["f32 vector sphere p4"] == {"registers": 40}
    assert "f64 uvw cart generic" in got and "f32 scalar cart p4" in got
    assert "f32 scalar2 sphere p4" in got and "f64 scalar2 cart generic" \
        in got
    assert "f32 state sphere p4" in got and "f64 state cart generic" in got


def test_dss_launch_config_reports_the_launch():
    x = torch.zeros((30, 6, 120, 120), dtype=F32)
    cfg = dss_cuda.launch_config(x, 4, "scalar", [x.data_ptr()], True)
    sh = dss_cuda.dss_launch_shape(30, 6, 120, 120, 4, F32, "scalar")
    assert cfg == dict(sh._asdict(), copy=16)
    odd = dss_cuda.launch_config(x, 4, "scalar", [x.data_ptr() + 4], True,
                                 sh._replace(levels=5))
    assert odd["copy"] == 4 and odd["levels"] == 5


def test_dss_launch_config_reports_the_scalar2_mode():
    """``dss_scalar2``'s launch is the rule's in the scalar2 mode, its copy
    width that of all three pointers it stages from."""
    x = torch.zeros((30, 6, 120, 120), dtype=F32)
    y = torch.zeros((30 * 6 * 120 * 120 + 2,), dtype=F32)[2:].view(x.shape)
    im = torch.zeros((6, 120, 120), dtype=F32)
    cfg = dss_cuda.launch_config(x, 4, "scalar2",
                                 dss_cuda._scalar2_ptrs(x, x, im), True)
    sh = dss_cuda.dss_launch_shape(30, 6, 120, 120, 4, F32, "scalar2")
    assert cfg == dict(sh._asdict(), copy=16)
    assert dss_cuda.launch_config(x, 4, "scalar2",
                                  dss_cuda._scalar2_ptrs(x, y, im),
                                  True)["copy"] == 8


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(30, 6, 120, 120, 4), (40, 1, 4, 400, 4),
                                   (40, 1, 400, 4, 4), (40, 1, 128, 128, 4)],
                         ids=["flagship", "schar_swapped", "schar_natural",
                              "plane"])
def test_dss_scalar2_mode_stages_two_fields_and_no_rotation(shape, dtype):
    """At the flagship, Schar in both layouts and the plane: the scalar2
    mode's block holds two field slots a stage, like the vector mode's, but
    no edge rotations; its rule has targets of its own (the float32 sweep's
    best shape at the flagship: bands of 24 rows, runs of 4 levels)."""
    K, P, A, B, p = shape
    esize = 4 if dtype == F32 else 8
    sh = dss_cuda.dss_launch_shape(K, P, A, B, p, dtype, "scalar2")
    nedge = 2 * (sh.rows + 2) + 2 * A if P > 1 else 0
    rot = -(-4 * nedge * esize // 16) * 16
    assert sh.smem == dss_cuda.dss_smem_bytes(sh.rows, A, B, sh.ring,
                                              "vector", esize, P > 1) - rot
    assert sh.smem <= dss_cuda.SMEM_MAX and sh.blocks >= K
    if (P, dtype) == (6, F32):
        assert (sh.rows, sh.levels, sh.blocks) == (24, 4, 240)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(30, 6, 120, 120, 4), (40, 1, 4, 400, 4),
                                   (40, 1, 400, 4, 4), (40, 1, 128, 128, 4),
                                   (3, 6, 6, 6, 3), (4, 6, 6, 6, 2),
                                   (3, 1, 9, 6, 3)],
                         ids=["flagship", "schar_swapped", "schar_natural",
                              "plane", "p3", "p2", "cart_p3"])
def test_dss_state_mode_stages_the_uvw_modes_fields_without_its_w_buffer(
        shape, dtype):
    """The state mode's block holds five field slots a stage and the (U, V)
    pair's edge rotations, like the uvw mode's, but not its assembled-W
    slot; so it fits wherever the uvw mode fits."""
    K, P, A, B, p = shape
    esize = 4 if dtype == F32 else 8
    links = P > 1
    v16 = 16 // esize

    def up(n):
        return -(-n // v16) * v16

    sh = dss_cuda.dss_launch_shape(K, P, A, B, p, dtype, "state")
    nedge = 2 * (sh.rows + 2) + 2 * A if links else 0
    fs = up((sh.rows + 2) * B) + up(nedge)
    for ring in (1, 2, 3):
        assert dss_cuda.dss_smem_bytes(sh.rows, A, B, ring, "state", esize,
                                       links) == dss_cuda.dss_smem_bytes(
            sh.rows, A, B, ring, "uvw", esize, links) - fs * esize
    uvw = dss_cuda.dss_launch_shape(K, P, A, B, p, dtype, "uvw")
    assert dss_cuda.dss_smem_bytes(uvw.rows, A, B, uvw.ring, "state", esize,
                                   links) <= uvw.smem <= dss_cuda.SMEM_MAX
    assert sh.smem == dss_cuda.dss_smem_bytes(sh.rows, A, B, sh.ring,
                                              "state", esize, links)
    # one stage where a run is one level: a second would never be filled
    assert sh.ring <= sh.levels and sh.blocks >= K


@pytest.mark.parametrize("shape,dtype,want", [
    ((30, 6, 120, 120), F32, (20, 1, 1, 320, 1116)),
    ((30, 6, 120, 120), F64, (8, 1, 1, 256, 2790)),
    ((40, 1, 4, 400), F32, (4, 1, 1, 416, 41)),
    ((40, 1, 128, 128), F32, (4, 2, 2, 128, 672)),
    ((90, 6, 120, 120), F32, (20, 5, 2, 320, 684))],
    ids=["flagship_f32", "flagship_f64", "schar_swapped", "plane",
         "k90"])
def test_dss_state_mode_rule_takes_the_swept_shapes(shape, dtype, want):
    """The rule's state-mode shapes: the fastest of the sweep
    (``kernels/tune_dss.py band state``) at the flagship in both dtypes, at
    Schar swapped and on the float32 plane (rows, levels, ring, threads,
    blocks); a taller field keeps longer runs and a ring of two."""
    sh = dss_cuda.dss_launch_shape(*shape, 4, dtype, "state")
    assert (sh.rows, sh.levels, sh.ring, sh.threads, sh.blocks) == want


def test_dss_launch_config_reports_the_state_mode():
    """``dss_state``'s launch is the rule's in the state mode, its copy
    width that of the five fields and the inverse multiplicity (the Rayleigh
    finish's fields are not staged)."""
    d = {k: torch.zeros((31 if k == "W" else 30, 6, 120, 120), dtype=F32)
         for k in dss_cuda.STATE_FIELDS}
    im = torch.zeros((6, 120, 120), dtype=F32)
    ptrs = dss_cuda._state_ptrs(d, im)
    assert len(ptrs) == 6
    cfg = dss_cuda.launch_config(d["U"], 4, "state", ptrs, True)
    sh = dss_cuda.dss_launch_shape(30, 6, 120, 120, 4, F32, "state")
    assert cfg == dict(sh._asdict(), copy=16)
    odd = dict(d, Rho=torch.zeros((30 * 6 * 120 * 120 + 1,),
                                  dtype=F32)[1:].view(d["Rt"].shape))
    assert dss_cuda.launch_config(d["U"], 4, "state",
                                  dss_cuda._state_ptrs(odd, im),
                                  True)["copy"] == 4


def _jax_wf(wf):
    return {k: (None if v is None else jnp.asarray(v.numpy()))
            if isinstance(v, torch.Tensor) or v is None else v
            for k, v in wf.items()}


# the edge cases' distinct grids: the other cases repeat the ne4 grid (held
# against the Pallas kernels in tests/test_torch_dss.py) with launch shapes
# or offsets, which the plain version does not see
PALLAS_CASES = [c for c in dss_edges.CASES if not c.startswith("sphere_ne4")]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_dss_edge_case_vector_plain_matches_pallas(case):
    """Each edge grid's plain ``dss_vector`` against the JAX Pallas
    ``dss_vector`` in interpret mode, 1e-13 of each component's scale."""
    (im, links, rot, wrap, p), _, u, v, _ = dss_edges.case_inputs(
        case, F64, CPU)
    want = dss_pallas.dss_vector(jnp.asarray(u.numpy()),
                                 jnp.asarray(v.numpy()),
                                 jnp.asarray(im.numpy()),
                                 jnp.asarray(rot.numpy()), links, p,
                                 interpret=True, wrap=wrap)
    got = dss_cuda.dss_vector_plain(u, v, im, rot, links, p, wrap)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-13 * float(np.abs(w).max()))


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(dss_edges.CASES))
def test_dss_edge_case_launch_shapes(case, dtype):
    """Every case's shape of each mode is one the kernel takes: the rule's
    with the case's overrides, fitting a block."""
    shapes = dss_edges.launch_shapes(case, dtype)
    assert tuple(shapes) == dss_edges.KERNELS
    over = dss_edges.CASES[case][3:]
    # dss_scalar2 and dss_state take dss_vector's overrides
    for kernel, ov in zip(dss_edges.KERNELS, over + over[1:2] + over[1:2]):
        sh = shapes[kernel]
        assert sh.smem <= dss_cuda.SMEM_MAX
        for k, v in ov.items():
            assert getattr(sh, k) == v, (kernel, k)


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_dss_edge_case_plain_matches_pallas(case):
    """Each edge grid's plain ``dss_scalar`` and ``dss_uvw`` (two bases;
    one base on the Cartesian grids) against the JAX Pallas kernels in
    interpret mode at that shape."""
    (im, links, rot, wrap, p), x, u, v, wf = dss_edges.case_inputs(
        case, F64, CPU)
    jim = jnp.asarray(im.numpy())
    want = dss_pallas.dss_scalar(jnp.asarray(x.numpy()), jim, links, p,
                                 interpret=True, wrap=wrap)
    got = dss_cuda.dss_scalar_plain(x, im, links, p, wrap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-13 * float(np.abs(want).max()))
    for w in (wf, dict(wf, bw2=None))[:1 if links else 2]:
        want = dss_pallas.dss_uvw(jnp.asarray(u.numpy()),
                                  jnp.asarray(v.numpy()), jim,
                                  jnp.asarray(rot.numpy()), links, p,
                                  _jax_wf(w), interpret=True, wrap=wrap)
        got = dss_cuda.dss_uvw_plain(u, v, im, rot, links, p, w, wrap)
        for g, jw in zip(got, want):
            jw = np.asarray(jw)
            np.testing.assert_allclose(g.numpy(), jw, rtol=0,
                                       atol=1e-12 * float(np.abs(jw).max()))


@pytest.mark.parametrize("ray", [False, True], ids=["no_rayleigh",
                                                    "rayleigh"])
@pytest.mark.parametrize("case", PALLAS_CASES)
def test_dss_edge_case_state_plain_matches_pallas(case, ray):
    """Each edge grid's plain ``dss_state`` (the five fields of
    ``dss_edges.state_inputs``, W with one level more), without and with
    the Rayleigh finish, against the JAX Pallas ``dss_state`` in interpret
    mode, 1e-13 of each field's scale."""
    (im, links, rot, wrap, p), x, _, _, _ = dss_edges.case_inputs(
        case, F64, CPU)
    K, P, A, B = x.shape
    d, r = dss_edges.state_inputs(case, F64, CPU, P, A, B)
    r = r if ray else None
    J = {k: jnp.asarray(v.numpy()) for k, v in d.items()}
    jr = None if r is None else tuple(
        {k: jnp.asarray(v.numpy()) for k, v in part.items()} for part in r)
    want = dss_pallas.dss_state(J, jnp.asarray(im.numpy()),
                                jnp.asarray(rot.numpy()), links, p,
                                rayleigh=jr, interpret=True, wrap=wrap)
    got = dss_cuda.dss_state_plain(d, im, rot, links, p, r, wrap)
    for k in dss_cuda.STATE_FIELDS:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-13 * float(np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("case", ["sphere_ne4", "sphere_ne2_p3",
                                  "sphere_ne3_p2", "cart_plane",
                                  "cart_wrap_a", "cart_one_element"])
def test_dss_sparse_operator_is_the_plain_dss(case):
    """The library yardstick computes the same function: one sparse product
    with the scalar operator, and with the rotated pair's on (U, V)
    stacked."""
    (im, links, rot, wrap, p), x, u, v, _ = dss_edges.case_inputs(
        case, F64, CPU)
    K = x.shape[0]
    got = dss_operator.apply(dss_operator.scalar_operator(im, links, p, wrap),
                             x).t().reshape(x.shape)
    want = dss_cuda.dss_scalar_plain(x, im, links, p, wrap)
    assert float((got - want).abs().max()) <= 1e-13 * float(
        want.abs().max())
    uv = torch.cat([u.reshape(K, -1), v.reshape(K, -1)], 1)
    got = dss_operator.apply(
        dss_operator.vector_operator(im, rot, links, p, wrap), uv).t()
    wu, wv = dss_cuda.dss_vector_plain(u, v, im, rot, links, p, wrap)
    n = wu[0].numel()
    for g, w in ((got[:, :n].reshape(wu.shape), wu),
                 (got[:, n:].reshape(wv.shape), wv)):
        assert float((g - w).abs().max()) <= 1e-13 * float(w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(F64, 1e-13), (F32, 1e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(dss_edges.CASES))
def test_cuda_dss_edge_case_matches_plain(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    got = dss_edges.run_case(case, dtype, torch.device("cuda"))
    assert got["max_err"] <= tol, got["err_by_output"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(dss_edges.CASES))
def test_cuda_dss_scalar2_edge_case_is_bit_for_bit(case, dtype):
    """The scalar2 mode bit for bit equal to ``dss_scalar2_plain`` and to
    two ``dss_scalar`` launches at every edge case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    got = dss_edges.run_case(case, dtype, torch.device("cuda"))
    assert got["err_by_output"]["dss_scalar2_x"] == 0.0
    assert got["err_by_output"]["dss_scalar2_U"] == 0.0
    assert got["scalar2_equals_two_launches"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(dss_edges.CASES))
def test_cuda_dss_state_edge_case_is_bit_for_bit(case, dtype):
    """The state mode bit for bit equal to ``dss_state_plain`` and to the
    separate launches followed by the plain finish, without and with the
    Rayleigh finish, at every edge case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    got = dss_edges.run_case(case, dtype, torch.device("cuda"))
    errs = {k: v for k, v in got["err_by_output"].items()
            if k.startswith("dss_state")}
    assert len(errs) == 10 and not any(errs.values()), errs
    assert got["state_equals_separate_launches"]

