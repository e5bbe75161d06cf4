"""``banded_solve_multi``'s host side
(``cuda_banded.banded_multi_launch_shape``: the tile and the stream form,
``copy_width``, ``launch_config``, the build report's instantiations), the
edge shapes of ``kernels/banded_edges.py``
(the plain solve against the JAX Pallas kernel in interpret mode at each
shape, and the kernel against the plain version on a card).  No JAX step is
compiled here."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.ops.pallas_banded import banded_solve_multi_pallas
from tempestmodel_tpu_torch.ops import cuda_banded
from tempestmodel_tpu_torch.kernels import banded_edges

CPU = torch.device("cpu")
F32, F64 = torch.float32, torch.float64
NCOL = 6 * 120 * 120          # the flagship's columns


@pytest.mark.parametrize("case", list(banded_edges.CASES))
def test_banded_edge_case_plain_matches_pallas(case):
    """Each edge shape's plain solve against the Pallas kernel itself (in
    interpret mode on the CPU), 1e-10 of each species' scale."""
    bands, rhs, q = banded_edges.case_inputs(case, F64, CPU)
    got = cuda_banded.banded_solve_multi_plain(bands, rhs, q).numpy()
    want = np.asarray(banded_solve_multi_pallas(
        jnp.asarray(bands.numpy()), jnp.asarray(rhs.numpy()), q,
        interpret=True))
    assert got.shape == want.shape == tuple(rhs.shape)
    for r in range(rhs.shape[1]):
        scale = float(np.abs(want[:, r]).max())
        assert float(np.abs(got[:, r] - want[:, r]).max()) <= 1e-10 * scale


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(banded_edges.CASES))
def test_banded_edge_case_takes_the_form_named(case, dtype):
    """Each case's launch is the form it names, fits a block, and lays its
    shared memory out as the kernel does."""
    n, q, R, ncol, _, over, form = banded_edges.CASES[case]
    sh = banded_edges.launch_shape(case, dtype)
    esize = 4 if dtype == F32 else 8
    assert sh.form == form
    assert sh.smem <= cuda_banded.SMEM_MAX
    assert sh.blocks == -(-ncol // sh.cols)
    for k, v in over.items():
        assert getattr(sh, k) == v, k
    if form == "tile":
        assert sh.smem == cuda_banded.tile_smem_bytes(n, q, R, sh.cols, esize)
        assert -(-n // sh.chunk) <= cuda_banded.MAX_BARS
    else:
        assert sh.smem == cuda_banded.stream_smem_bytes(q, sh.chunk,
                                                        sh.cols, esize)
        assert 1 <= sh.chunk <= n


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_banded_multi_launch_shape_takes_what_the_old_kernel_took(dtype):
    """Every (n, q, R, ncol) the earlier kernel took (any n, q 1..8, any R,
    any column count) gets a launch shape that fits a block: the tile form
    where a tile of 32 columns fits, the stream form (every U row on chip
    where they fit) else."""
    esize = 4 if dtype == F32 else 8
    for n in (1, 2, 30, 91, 200, 1000, 5000):
        for q in range(1, 9):
            for R in (1, 3, 8, 32):
                for ncol in (1, 31, 33, NCOL):
                    sh = cuda_banded.banded_multi_launch_shape(n, q, R, ncol,
                                                               dtype)
                    assert sh.smem <= cuda_banded.SMEM_MAX
                    tile = cuda_banded.tile_smem_bytes(n, q, R, 32, esize)
                    assert sh.form == ("tile" if tile <= cuda_banded.SMEM_MAX
                                       else "stream")
                    assert sh.cols == 32 and sh.blocks == -(-ncol // 32)
                    assert sh.threads == (32 * min(R, 8) if sh.form == "tile"
                                          else 32)
                    if sh.form == "stream":
                        most = cuda_banded.SMEM_MAX // (
                            (q + 1) * 32 * esize)
                        assert sh.chunk == min(n, most)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("q,R", [(1, 3), (4, 5)], ids=["moist", "q4_r5"])
def test_banded_multi_launch_shape_at_the_moist_flagship(q, R, dtype):
    """The moist wave's systems and n 30, q 4, R 5 at 86 400 columns take
    the tile form, fill the card (at least two blocks a streaming
    multiprocessor), leave room for two tiles on one and substitute every
    right-hand side of a column side by side."""
    sh = cuda_banded.banded_multi_launch_shape(30, q, R, NCOL, dtype)
    assert sh.form == "tile" and sh.cols == 32 and sh.threads == 32 * R
    assert sh.blocks >= 2 * 132
    assert 2 * sh.smem <= 228 * 1024
    assert sh.chunk == cuda_banded.CHUNK


@pytest.mark.parametrize("case", ["q0", "q9", "r0", "n0", "cols48",
                                  "cols512", "chunk_bars", "tile_too_big",
                                  "stream_chunk", "stream_too_big", "form",
                                  "threads48", "threads512",
                                  "stream_threads"])
def test_banded_multi_launch_shape_raises_where_the_kernel_cannot_run(case):
    args = {"q0": ((30, 0, 3, 100, F32), {}),
            # q 9 and up take the wide form: the case asks for a q past
            # its limit (the id names the template forms' old limit)
            "q9": ((300, cuda_banded.wide_max_q(F32) + 1, 3, 100, F32), {}),
            "r0": ((30, 1, 0, 100, F32), {}),
            "n0": ((0, 1, 3, 100, F32), {}),
            "cols48": ((30, 1, 3, 100, F32), dict(cols=48)),
            "cols512": ((30, 1, 3, 100, F32), dict(cols=512)),
            "chunk_bars": ((30, 1, 3, 100, F32), dict(chunk=1)),
            "tile_too_big": ((300, 8, 3, 100, F64), dict(form="tile")),
            "stream_chunk": ((30, 1, 3, 100, F32), dict(form="stream",
                                                        chunk=31)),
            "stream_too_big": ((300, 8, 3, 100, F64),
                               dict(form="stream", chunk=300)),
            "form": ((30, 1, 3, 100, F32), dict(form="rows")),
            "threads48": ((30, 1, 3, 100, F32), dict(threads=48)),
            "threads512": ((30, 1, 3, 100, F32), dict(threads=512)),
            "stream_threads": ((30, 1, 3, 100, F32),
                               dict(form="stream", threads=64))}[case]
    with pytest.raises(ValueError):
        cuda_banded.banded_multi_launch_shape(*args[0], **args[1])


@pytest.mark.parametrize("ncol,esize,ptrs,want", [
    (86400, 4, [256, 512], 16), (86400, 8, [256, 1024], 16),
    (86400, 4, [256, 260], 4), (86400, 4, [256, 264], 8),
    (86400, 8, [256, 264], 8), (70, 4, [256], 8), (70, 8, [256], 16),
    (37, 4, [256], 4), (37, 8, [256], 8), (31, 8, [256], 8),
    (2, 4, [256], 8), (1, 4, [256], 4)])
def test_banded_copy_width(ncol, esize, ptrs, want):
    """One bulk copy a row where a row of ncol values and every pointer are
    16-byte multiples, else 8-byte copies, else one value."""
    assert cuda_banded.copy_width(ncol, esize, ptrs) == want


def test_banded_launch_config_reports_the_launch():
    bands, rhs, q = banded_edges.case_inputs("offset1", F32, CPU)
    cfg = cuda_banded.launch_config(bands, rhs, q)
    sh = cuda_banded.banded_multi_launch_shape(30, 1, 3, 70, F32)
    assert cfg == dict(sh._asdict(), copy=4, copy_route="cp.async 4 B")
    bands, rhs, q = banded_edges.case_inputs("moist_ragged", F64, CPU)
    assert cuda_banded.launch_config(bands, rhs, q)["copy"] == 16
    stream = cuda_banded.banded_multi_launch_shape(30, 1, 3, 1000, F64,
                                                   form="stream")
    cfg = cuda_banded.launch_config(bands, rhs, q, stream)
    assert cfg["form"] == "stream" and cfg["chunk"] == 30


def test_banded_multi_resources_are_read_from_the_build_report(monkeypatch):
    """The 32 instantiations (form x value type x q 1..8) are named from
    their mangled names."""
    report = {f"_ZN12_GLOBAL__N_1{len(k) + 7}multi_{k}_kernelI{t}Li{q}EEEvNS_"
              f"10MultiArgsIT_EE": {"registers": q}
              for k in ("tile", "stream") for t in "fd" for q in range(1, 9)}
    monkeypatch.setattr(cuda_banded.build, "ptxas_usage",
                        lambda stem: report)
    got = cuda_banded.kernel_resources()
    assert len(got) == 32
    assert got["tile f32 q1"] == {"registers": 1}
    assert got["stream f64 q8"] == {"registers": 8}


def test_banded_edge_cases_reach_every_copy_route_and_form():
    """Between them the cases stage by bulk copies, 8- and 4-byte copies
    (float32) and run both forms, the stream form also with its chunks
    rebuilt."""
    routes, forms, rebuilt = set(), set(), False
    for case, spec in banded_edges.CASES.items():
        bands, rhs, q = banded_edges.case_inputs(case, F32, CPU)
        cfg = cuda_banded.launch_config(bands, rhs, q,
                                        banded_edges.launch_shape(case, F32))
        forms.add(cfg["form"])
        if cfg["form"] == "tile":
            routes.add(cfg["copy"])
        rebuilt |= cfg["form"] == "stream" and cfg["chunk"] < spec[0]
    assert routes == {16, 8, 4} and forms == {"tile", "stream"} and rebuilt


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(F64, 1e-10), (F32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(banded_edges.CASES))
def test_cuda_banded_edge_case_matches_plain(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    got = banded_edges.run_case(case, dtype, torch.device("cuda"))
    assert got["max_err"] <= tol, got["err_by_species"]
    assert got["launch"]["form"] == banded_edges.CASES[case][6]
