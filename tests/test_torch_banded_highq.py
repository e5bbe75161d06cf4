"""Half-bandwidths above the template forms' 8: the banded solves of
vertical order 2 and up (the Lorenz column systems have q = 6 vo - 2: 10 at
order 2, 16 at order 3; the tracer systems q = 2 vo - 1: 9 from order 5).

The plain ``banded_solve`` and ``banded_solve_multi`` against the JAX Pallas
kernels (interpret mode; they have no limit on q) and a dense solve, and
the wide form's launch rule, float64.  The step at vertical order 2 and
up is in ``test_torch_banded_highq_umjs.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.ops.pallas_banded import (banded_solve_pallas,
                                                banded_solve_multi_pallas)
from tempestmodel_tpu_torch.kernels import banded_edges
from tempestmodel_tpu_torch.kernels.banded_edges import systems
from tempestmodel_tpu_torch.ops import cuda_banded

from torch_port_common import CPU

F32, F64 = torch.float32, torch.float64


def _dense(bands, rhs, q):
    """numpy x of A x = rhs column by column (rhs (n, R, ncol))."""
    n, b, ncol = bands.shape
    x = np.zeros_like(rhs)
    for c in range(ncol):
        A = np.zeros((n, n))
        for d in range(b):
            for i in range(n):
                if 0 <= i + d - q < n:
                    A[i, i + d - q] = bands[i, d, c]
        x[:, :, c] = np.linalg.solve(A, rhs[:, :, c])
    return x


@pytest.mark.parametrize("q", [9, 10, 16])
def test_plain_solves_take_q_above_8(q):
    """Both plain versions and both wrappers on CPU tensors solve q 9, 10
    and 16 as the Pallas kernels and a dense solve do."""
    n, ncol = 3 * 12 + 1, 16
    bands, rhs = systems(n, q, 3, ncol, seed=q)
    want = _dense(bands, rhs, q)
    tb, tr = torch.from_numpy(bands), torch.from_numpy(rhs)
    multi = cuda_banded.banded_solve_multi(tb, tr, q).numpy()
    np.testing.assert_allclose(multi, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(
        multi, cuda_banded.banded_solve_multi_plain(tb, tr, q).numpy())
    one = cuda_banded.banded_solve(tb, tr[:, 0].contiguous(), q).numpy()
    np.testing.assert_allclose(one, want[:, 0], rtol=1e-10, atol=1e-12)
    x_pl = np.asarray(banded_solve_pallas(
        jnp.asarray(bands), jnp.asarray(rhs[:, 0]), q, col_tile=8,
        interpret=True))
    np.testing.assert_allclose(one, x_pl, rtol=1e-10, atol=1e-12)
    xm_pl = np.asarray(banded_solve_multi_pallas(
        jnp.asarray(bands), jnp.asarray(rhs), q, interpret=True))
    np.testing.assert_allclose(multi, xm_pl, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_every_q_the_engine_makes_has_a_launch(dtype):
    """The Lorenz systems of vertical orders 1-10 (q = 6 vo - 2, n = 3 nz +
    1 at nz 30 and 128) and the tracer systems (q = 2 vo - 1, R up to 6)
    all get a launch shape: the template forms at q 1..8, 10 and 16 where
    their block fits, the wide form else."""
    for vo in range(1, 11):
        for nz in (30, 128):
            for q, n, R in ((6 * vo - 2, 3 * nz + 1, 1),
                            (2 * vo - 1, nz, 6)):
                sh = cuda_banded.banded_solve_launch_shape(n, q, 86400, dtype)
                shm = cuda_banded.banded_multi_launch_shape(n, q, R, 86400,
                                                            dtype)
                for s in (sh, shm):
                    assert s.smem <= cuda_banded.SMEM_MAX
                    if q not in cuda_banded.TEMPLATE_Q:
                        assert s.form == "wide"
                    if s.form == "wide":
                        assert q > cuda_banded.MAX_Q
                        assert s.threads == 32 and s.cols in (32, 16, 8)
                        assert min(q, n) <= s.chunk <= n
                        assert s.smem == cuda_banded.wide_smem_bytes(
                            q, s.chunk, s.cols, 4 if dtype == F32 else 8)
                if q in (10, 16) and n == 91:
                    assert sh.form == "ring"


def test_wide_launch_shape_rule():
    """q 10 and 16 take the template forms where their block fits; any
    other q above 8 the wide form: every U row on chip at the widest block
    that holds them, else the widest block that holds at least q rows, as
    many as fit; past that the error names the limit."""
    for q, dtype in ((10, F32), (16, F64)):
        sh = cuda_banded.banded_solve_launch_shape(91, q, 1000, dtype)
        assert sh == cuda_banded.banded_solve_launch_shape(91, q, 1000, dtype,
                                                           form="ring")
    assert cuda_banded.banded_multi_launch_shape(30, 10, 3, 1000,
                                                 F32).form == "tile"
    sh = cuda_banded.banded_solve_launch_shape(91, 11, 1000, F32)
    assert (sh.form, sh.cols, sh.chunk) == ("wide", 32, 91)
    sh = cuda_banded.banded_solve_launch_shape(91, 11, 1000, F64)
    assert (sh.form, sh.cols, sh.chunk) == ("wide", 16, 91)
    sh = cuda_banded.banded_solve_launch_shape(385, 16, 1000, F64)
    assert sh.form == "wide" and 16 <= sh.chunk < 385 and sh.cols == 32
    forced = cuda_banded.banded_solve_launch_shape(91, 10, 1000, F32,
                                                   form="wide", cols=8)
    assert (forced.form, forced.cols, forced.chunk) == ("wide", 8, 91)
    chunked = cuda_banded.banded_multi_launch_shape(91, 10, 2, 1000, F32,
                                                    chunk=12)
    assert (chunked.form, chunked.chunk) == ("wide", 12)
    top = cuda_banded.wide_max_q(F64)
    cuda_banded.banded_solve_launch_shape(3 * top, top, 10, F64)
    with pytest.raises(ValueError, match=f"q up to {top}"):
        cuda_banded.banded_solve_launch_shape(3 * top, top + 1, 10, F64)
    with pytest.raises(ValueError):
        cuda_banded.banded_multi_launch_shape(91, 11, 2, 1000, F32, chunk=9)
    with pytest.raises(ValueError):      # no ring form instantiated at 11
        cuda_banded.banded_solve_launch_shape(91, 11, 1000, F32, form="ring")


@pytest.mark.parametrize("case", list(banded_edges.HIGHQ_CASES))
def test_highq_edge_case_plain_matches_pallas(case):
    """Each case's plain solve against the Pallas kernel (interpret mode),
    1e-10 of the solution's scale in float64."""
    bands, rhs, q = banded_edges.highq_inputs(case, F64, CPU)
    b, r = jnp.asarray(bands.numpy()), jnp.asarray(rhs.numpy())
    if rhs.dim() == 2:
        got = cuda_banded.banded_solve_plain(bands, rhs, q).numpy()
        want = np.asarray(banded_solve_pallas(b, r, q, col_tile=128,
                                              interpret=True))
    else:
        got = cuda_banded.banded_solve_multi_plain(bands, rhs, q).numpy()
        want = np.asarray(banded_solve_multi_pallas(b, r, q, interpret=True))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-10 * float(
        np.abs(want).max())


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(banded_edges.HIGHQ_CASES))
def test_highq_edge_case_takes_the_form_named(case, dtype):
    kind, n, q, R, ncol, _, over, form = banded_edges.HIGHQ_CASES[case]
    sh = banded_edges.highq_launch_shape(case, dtype)
    esize = 4 if dtype == F32 else 8
    assert sh.form == form
    assert sh.smem <= cuda_banded.SMEM_MAX
    assert sh.blocks == -(-ncol // sh.cols)
    for k, v in over.items():
        assert getattr(sh, k) == v, k
    if form == "wide":
        assert sh.threads == 32 and min(q, n) <= sh.chunk <= n
        assert sh.smem == cuda_banded.wide_smem_bytes(q, sh.chunk, sh.cols,
                                                      esize)
    if case == "long_q16":
        assert (sh.chunk < n) == (dtype == F64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(F64, 1e-10), (F32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(banded_edges.HIGHQ_CASES))
def test_cuda_highq_edge_case_matches_plain(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    got = banded_edges.run_highq_case(case, dtype, torch.device("cuda"))
    assert got["max_err"] <= tol
    assert got["launch"]["form"] == banded_edges.HIGHQ_CASES[case][7]


def test_launch_config_reports_the_wide_form():
    bands, rhs = systems(31, 11, 1, 40)
    tb = torch.from_numpy(bands)
    tr = torch.from_numpy(rhs[:, 0].copy())
    cfg = cuda_banded.launch_config(tb, tr, 11)
    assert cfg["form"] == "wide" and cfg["copy"] == 8
    assert cfg["copy_route"].startswith("none")
    assert cuda_banded.FORMS.index("wide") == 3
