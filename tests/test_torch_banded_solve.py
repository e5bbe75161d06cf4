"""``banded_solve``'s host side (``cuda_banded.banded_solve_launch_shape``:
the ring form and the forms it falls back to or is forced into,
``launch_config``, the build report's ring instantiations), the edge shapes
of ``kernels/banded_edges.SOLVE_CASES`` (the plain solve against the JAX
Pallas kernel in interpret mode at each shape, and the kernel against the
plain version on a card), and the ring form's quotients (``recip`` and
``quick_div`` of ``csrc/banded_multi.cu``, the division where they clear
``ok``) bit for bit against the division: emulated in float32 here, on the
card in both dtypes.  No JAX step is compiled here."""

import pathlib
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.ops.pallas_banded import banded_solve_pallas
from tempestmodel_tpu_torch.ops import cuda_banded
from tempestmodel_tpu_torch.kernels import banded_edges
from tempestmodel_tpu_torch.kernels.counts import launch_counts

CPU = torch.device("cpu")
F32, F64 = torch.float32, torch.float64
NCOL = 6 * 120 * 120          # the flagship's columns
CASES = list(banded_edges.SOLVE_CASES)


@pytest.mark.parametrize("case", CASES)
def test_banded_solve_edge_case_plain_matches_pallas(case):
    """Each edge shape's plain solve against the Pallas kernel itself (in
    interpret mode on the CPU), 1e-12 of the solution's scale in fp64."""
    bands, rhs, q = banded_edges.solve_inputs(case, F64, CPU)
    got = cuda_banded.banded_solve_plain(bands, rhs, q).numpy()
    want = np.asarray(banded_solve_pallas(
        jnp.asarray(bands.numpy()), jnp.asarray(rhs.numpy()), q,
        col_tile=128, interpret=True))
    assert got.shape == want.shape == tuple(rhs.shape)
    assert float(np.abs(got - want).max()) <= 1e-12 * float(
        np.abs(want).max())


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_banded_solve_edge_case_takes_the_form_named(case, dtype):
    """Each case's launch is the form it names, with the case's overrides,
    within a block's 227 KB and laid out as the kernel lays it out: the
    ring form a warp a block of 32, 16 or 8 columns and RING_SLOTS
    slots."""
    n, q, ncol, _, over, form = banded_edges.SOLVE_CASES[case]
    sh = banded_edges.solve_launch_shape(case, dtype)
    esize = 4 if dtype == F32 else 8
    assert sh.form == form
    assert sh.smem <= cuda_banded.SMEM_MAX
    assert sh.blocks == -(-ncol // sh.cols)
    for k, v in over.items():
        assert getattr(sh, k) == v, k
    if form == "ring":
        assert sh.threads == 32 and sh.cols in cuda_banded.RING_COLS
        assert sh.chunk == cuda_banded.RING_SLOTS
        assert sh.smem == cuda_banded.ring_smem_bytes(n, q, sh.cols, esize)
    elif form == "stream":
        assert sh.smem == cuda_banded.stream_smem_bytes(q, sh.chunk,
                                                        sh.cols, esize)
    else:
        assert sh.smem == cuda_banded.tile_smem_bytes(n, q, 1, sh.cols,
                                                      esize)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_banded_solve_launch_shape_at_the_unfused_flagship(dtype):
    """The flagship's Newton systems (n 91, q 4, 86 400 columns) take the
    ring form with the block that keeps the most columns on an SM: three
    blocks of 32 columns in float32 (96 columns), three of 16 in float64
    (48; one block of 32 would keep 32)."""
    sh = cuda_banded.banded_solve_launch_shape(91, 4, NCOL, dtype)
    cols = 32 if dtype == F32 else 16
    assert sh.form == "ring" and sh.cols == cols and sh.threads == 32
    assert sh.blocks == NCOL // cols and sh.chunk == cuda_banded.RING_SLOTS
    assert cuda_banded.blocks_per_sm(sh.smem) == 3
    esize = 4 if dtype == F32 else 8
    for c in cuda_banded.RING_COLS:
        kept = c * cuda_banded.blocks_per_sm(cuda_banded.ring_smem_bytes(
            91, 4, c, esize))
        assert kept <= 3 * cols


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_banded_solve_launch_shape_takes_what_the_old_kernel_took(dtype):
    """Every (n, q, ncol) the one-thread-a-column kernel took gets a launch
    shape that fits a block: the ring form where a block of 8 columns or
    more fits, with the columns that keep the most on an SM, else the
    stream form."""
    esize = 4 if dtype == F32 else 8
    for n in (1, 2, 30, 91, 300, 800, 5000):
        for q in range(1, 9):
            for ncol in (1, 31, 33, NCOL):
                sh = cuda_banded.banded_solve_launch_shape(n, q, ncol, dtype)
                assert sh.smem <= cuda_banded.SMEM_MAX
                fit = {C: C * cuda_banded.blocks_per_sm(
                    cuda_banded.ring_smem_bytes(n, q, C, esize))
                    for C in cuda_banded.RING_COLS
                    if cuda_banded.ring_smem_bytes(n, q, C, esize)
                    <= cuda_banded.SMEM_MAX}
                assert sh.form == ("ring" if fit else "stream")
                if fit:
                    assert fit[sh.cols] == max(fit.values())
                    assert sh.cols == max(c for c, k in fit.items()
                                          if k == fit[sh.cols])
                assert sh.blocks == -(-ncol // sh.cols)


@pytest.mark.parametrize("case", ["q0", "q9", "n0", "ncol0", "cols64",
                                  "cols12", "ring_too_big", "form",
                                  "tile_too_big", "stream_cols"])
def test_banded_solve_launch_shape_raises_where_no_form_can_run(case):
    args = {"q0": ((30, 0, 100, F32), {}),
            "q9": ((30, 9, 100, F32), {}),
            "n0": ((0, 1, 100, F32), {}),
            "ncol0": ((30, 1, 0, F32), {}),
            "cols64": ((30, 1, 100, F32), dict(cols=64)),
            "cols12": ((30, 1, 100, F32), dict(form="ring", cols=12)),
            "ring_too_big": ((800, 8, 100, F32), dict(form="ring")),
            "form": ((30, 1, 100, F32), dict(form="rows")),
            "tile_too_big": ((91, 4, 100, F64), dict(form="tile")),
            "stream_cols": ((30, 1, 100, F32), dict(form="stream",
                                                    cols=48))}[case]
    with pytest.raises(ValueError):
        cuda_banded.banded_solve_launch_shape(*args[0], **args[1])


def test_banded_solve_launch_config_reports_the_launch():
    """A 2-D right-hand side takes ``banded_solve``'s rule; the ring form
    copies a value at a time whatever the alignment, the tile form forced
    follows the pointers' alignment."""
    bands, rhs, q = banded_edges.solve_inputs("solve_offset1", F32, CPU)
    cfg = cuda_banded.launch_config(bands, rhs, q)
    sh = cuda_banded.banded_solve_launch_shape(30, 1, 70, F32)
    assert cfg == dict(sh._asdict(), copy=4, copy_route=(
        "cp.async 4 B, a lane its column, a commit group a row"))
    tile = cuda_banded.banded_solve_launch_shape(30, 1, 70, F32, form="tile")
    assert cuda_banded.launch_config(bands, rhs, q, tile)["copy"] == 4
    bands, rhs, q = banded_edges.solve_inputs("solve_flagship_ragged", F64,
                                              CPU)
    cfg = cuda_banded.launch_config(bands, rhs, q)
    assert cfg["form"] == "ring" and cfg["copy"] == 8
    stream = cuda_banded.banded_solve_launch_shape(91, 4, 1000, F64,
                                                   form="stream")
    cfg = cuda_banded.launch_config(bands, rhs, q, stream)
    assert cfg["form"] == "stream" and cfg["chunk"] == 91


def test_banded_solve_edge_cases_reach_every_route_form_and_block():
    """Between them the cases run all three forms, the ring form with
    blocks of 32, 16 and 8 columns, from unaligned inputs, and on fewer
    rows than its slots, the tile form by 8- or 16-byte copies, and the
    stream form chosen by the rule."""
    routes, forms, cols, chosen, short = set(), set(), set(), set(), False
    for dtype in (F32, F64):
        for case, spec in banded_edges.SOLVE_CASES.items():
            bands, rhs, q = banded_edges.solve_inputs(case, dtype, CPU)
            cfg = cuda_banded.launch_config(
                bands, rhs, q, banded_edges.solve_launch_shape(case, dtype))
            forms.add(cfg["form"])
            if not spec[4]:
                chosen.add(cfg["form"])
            if cfg["form"] == "ring":
                cols.add(cfg["cols"])
                short |= spec[0] < cfg["chunk"]
                routes.add(spec[3])
            if cfg["form"] == "tile":
                assert cfg["copy"] in (8, 16)
    assert forms == {"ring", "stream", "tile"}
    assert chosen == {"ring", "stream"}
    assert cols == {32, 16, 8} and short and routes == {0, 1, 2}


def test_banded_ring_resources_are_read_from_the_build_report(monkeypatch):
    """The 48 instantiations of ``csrc/banded_multi.cu`` (tile, stream and
    ring forms x value type x q 1..8) are named from their mangled names."""
    report = {}
    for k, name in (("tile", "multi_tile"), ("stream", "multi_stream"),
                    ("ring", "solve_ring")):
        for t in "fd":
            for q in range(1, 9):
                report[f"_ZN12_GLOBAL__N_1{len(name) + 7}{name}_kernelI{t}Li"
                       f"{q}EEEvNS_10MultiArgsIT_EE"] = {"registers": q}
    monkeypatch.setattr(cuda_banded.build, "ptxas_usage",
                        lambda stem: report)
    got = cuda_banded.kernel_resources()
    assert len(got) == 48
    assert got["ring f32 q4"] == {"registers": 4}
    assert got["ring f64 q8"] == {"registers": 8}


def test_banded_solve_counts_only_its_own_launches_on_cpu():
    """On CPU tensors neither wrapper launches a kernel: no count moves."""
    bands, rhs, q = banded_edges.solve_inputs("solve_n30_q4", F64, CPU)
    before = dict(launch_counts)
    x = cuda_banded.banded_solve(bands, rhs, q)
    assert dict(launch_counts) == before
    torch.testing.assert_close(
        x, cuda_banded.banded_solve_plain(bands, rhs, q), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(F64, 1e-10), (F32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_cuda_banded_solve_edge_case_matches_plain(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    got = banded_edges.run_solve_case(case, dtype, torch.device("cuda"))
    assert got["max_err"] <= tol
    assert got["launch"]["form"] == banded_edges.SOLVE_CASES[case][5]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_cuda_banded_solve_allocates_its_output_only(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    bands, rhs, q = banded_edges.solve_inputs("solve_flagship_ragged", dtype,
                                              torch.device("cuda"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts["banded_solve"]
    x = cuda_banded.banded_solve(bands, rhs, q)
    torch.cuda.synchronize()
    assert launch_counts["banded_solve"] == before + 1
    assert torch.cuda.max_memory_allocated() - base <= -(
        -x.numel() * x.element_size() // 512) * 512


# ---------------------------------------------------------------------------
# the eliminations' quotients: w / p from the pivot's reciprocal
# ---------------------------------------------------------------------------

DIV_KINDS = ("newton", "bits", "ends")


def _div_operands(dtype, kind, count, seed=0):
    """numpy (w, p) of ``dtype``: "newton", magnitudes log-uniform over the
    range of the flagship's Newton systems (2e-19 to 8e6) with random
    signs; "bits", random bit patterns (every exponent, subnormals,
    infinities, NaN); "ends", pivots within 30 binades of either end of
    the normal range (subnormals too) and numerators of any exponent.  A
    numerator in 16 is a signed zero (the Newton systems' structural
    zeros); outside "newton" a pivot in 64 is a zero, an infinity or a
    NaN."""
    rng = np.random.default_rng(seed + DIV_KINDS.index(kind))
    sign = lambda: rng.choice(np.array([-1.0, 1.0]), count)
    if kind == "newton":
        mag = lambda: np.exp(rng.uniform(np.log(2e-19), np.log(8e6), count))
        w, p = (mag() * sign()).astype(dtype), (mag() * sign()).astype(dtype)
    elif kind == "bits":
        ib = np.uint32 if dtype == np.float32 else np.uint64
        bits = lambda: rng.integers(0, np.iinfo(ib).max, count, dtype=ib,
                                    endpoint=True).view(dtype)
        w, p = bits(), bits()
    else:
        fi = np.finfo(dtype)
        ends = np.r_[np.arange(fi.minexp - 30, fi.minexp + 8),
                     np.arange(fi.maxexp - 8, fi.maxexp)]
        p = np.ldexp(rng.uniform(1, 2, count), rng.choice(ends, count))
        w = np.ldexp(rng.uniform(1, 2, count),
                     rng.integers(fi.minexp - 30, fi.maxexp, count))
        with np.errstate(over="ignore", under="ignore"):
            w, p = (w * sign()).astype(dtype), (p * sign()).astype(dtype)
    zero = rng.random(count) < 1 / 16
    w[zero] = np.where(sign()[zero] > 0, 0.0, -0.0)
    if kind != "newton":
        odd = rng.random(count) < 1 / 64
        p[odd] = rng.choice(np.array([0.0, -0.0, np.inf, -np.inf, np.nan],
                                     dtype), int(odd.sum()))
    return w, p


def _bits_differ(got, want):
    """Where ``got`` and ``want`` differ in their bits (any NaN equals any
    NaN)."""
    ib = np.int32 if got.dtype == np.float32 else np.int64
    return (got.view(ib) != want.view(ib)) & ~(np.isnan(got)
                                                & np.isnan(want))


def _range_f32():
    """``Range<float>`` of ``csrc/banded_multi.cu``: lo, hi, w_lo, q_hi."""
    src = (pathlib.Path(cuda_banded.__file__).parents[1] / "csrc"
           / "banded_multi.cu").read_text()
    m = re.search(r"struct Range<float> \{\s*static constexpr float lo = "
                  r"(\S+)f, hi = (\S+)f, w_lo = (\S+)f,\s*q_hi = (\S+)f;",
                  src)
    return tuple(float.fromhex(g) for g in m.groups())


def _fma_f32(a, b, c):
    """float32 ``a * b + c`` rounded once: the product is exact in float64,
    TwoSum carries the sum's error, and where the float64 sum lies on a
    float32 midpoint that error decides the side."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    t = s.astype(np.float32)
    td = t.astype(np.float64)
    t2 = np.nextafter(t, np.where(s > td, np.float32(np.inf),
                                  np.float32(-np.inf)).astype(np.float32))
    mid = (td != s) & ((td + t2.astype(np.float64)) * 0.5 == s) & (e != 0)
    return np.where(mid, np.where(e > 0, np.maximum(t, t2),
                                  np.minimum(t, t2)), t).astype(np.float32)


def _quick_div_f32(w, p):
    """The ring form's quotient in float32: ``recip`` and ``quick_div`` of
    ``csrc/banded_multi.cu``, and the division where they clear ``ok``."""
    lo, hi, w_lo, q_hi = _range_f32()
    ok = (np.abs(p) >= lo) & (np.abs(p) <= hi)
    y = (np.float32(1) / p).astype(np.float32)
    q = (w * y).astype(np.float32)
    r = _fma_f32(_fma_f32(-p, q, w), y, q)
    zero = w == 0
    ok &= zero | ((np.abs(r) >= lo) & (np.abs(r) <= q_hi)
                  & (np.abs(w) >= w_lo))
    return np.where(ok, np.where(zero, q, r), w / p).astype(np.float32)


@pytest.mark.parametrize("kind", DIV_KINDS)
def test_quick_div_emulated_in_float32_equals_the_division(kind):
    """The ring form's quotient, its float32 arithmetic emulated exactly,
    has the bits of ``w / p``: Markstein's correction where the source's
    range lets it act (the whole Newton range, where a zero numerator takes
    ``w y``), the division elsewhere."""
    w, p = _div_operands(np.float32, kind, 1 << 20)
    with np.errstate(all="ignore"):
        got, want = _quick_div_f32(w, p), w / p
        lo, hi, _, q_hi = _range_f32()
        fast = ((np.abs(p) >= lo) & (np.abs(p) <= hi)
                & (np.abs(want) >= 2 * lo) & (np.abs(want) <= q_hi / 2))
    assert not _bits_differ(got, want).any()
    if kind == "newton":
        assert (fast | (w == 0)).all()
    else:
        assert fast.any() and not (fast | (w == 0)).all()


def test_quick_div_emulated_with_no_range_would_differ():
    """The range is what keeps the bits: the same arithmetic with the
    reciprocal of every pivot and no fallback differs from ``w / p`` at the
    ends of the range (overflowed reciprocals, subnormal residuals)."""
    w, p = _div_operands(np.float32, "ends", 1 << 16)
    with np.errstate(all="ignore"):
        y = (np.float32(1) / p).astype(np.float32)
        q = (w * y).astype(np.float32)
        bare = _fma_f32(_fma_f32(-p, q, w), y, q)
        assert _bits_differ(bare, w / p).any()


def test_pivot_divide_on_cpu_is_the_division():
    w, p = _div_operands(np.float64, "bits", 1000)
    with np.errstate(all="ignore"):
        want = w / p
    got = cuda_banded.pivot_divide(torch.from_numpy(w), torch.from_numpy(p))
    assert not _bits_differ(got.numpy(), want).any()
    with pytest.raises(ValueError):
        cuda_banded.pivot_divide(torch.zeros(3), torch.zeros(4))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", DIV_KINDS + ("significands",))
def test_cuda_quick_div_equals_the_division_bit_for_bit(kind, dtype):
    """Millions of quotients as the ring form takes them on the card
    against ``w / p`` on the CPU (IEEE division), bit for bit; "significands":
    every float32 pivot significand in [1, 2) against eight numerators (in
    float64 the same count of random significands)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    if kind == "significands":
        rng = np.random.default_rng(7)
        if dtype == np.float32:
            p = ((np.arange(1 << 23, dtype=np.uint32) + (127 << 23))
                 .view(np.float32))
        else:
            p = rng.uniform(1, 2, 1 << 23)
        w = rng.uniform(1, 2, 8).astype(dtype)
        w, p = np.repeat(w, p.size), np.tile(p, w.size)
    else:
        w, p = _div_operands(dtype, kind, 1 << 22)
    dev = torch.device("cuda")
    got = cuda_banded.pivot_divide(torch.from_numpy(w).to(dev),
                                   torch.from_numpy(p).to(dev))
    with np.errstate(all="ignore"):
        want = w / p
    bad = _bits_differ(got.cpu().numpy(), want)
    assert not bad.any(), (w[bad][:4], p[bad][:4])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_cuda_banded_solve_form_equals_the_stream_form_bit_for_bit(case,
                                                                   dtype):
    """Every form does the same arithmetic in the same order, and the ring
    form's quotients are the division's: each case's launch gives the
    stream form's solution (which divides) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    bands, rhs, q = banded_edges.solve_inputs(case, dtype,
                                              torch.device("cuda"))
    n, _, ncol = bands.shape
    got = cuda_banded._banded_solve_cuda(
        bands, rhs, q, banded_edges.solve_launch_shape(case, dtype))
    want = cuda_banded._banded_solve_cuda(
        bands, rhs, q, cuda_banded.banded_solve_launch_shape(
            n, q, ncol, dtype, form="stream"))
    assert torch.equal(got, want)
