"""The port's plain banded solves vs the JAX Pallas kernels (interpret mode)
and vs a dense solve, with one right-hand side and with R that share the
matrix; the wrappers' checks; the CUDA kernels on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.models.vertical_banded import (
    banded_solve_multi_t as j_banded_solve_multi_t)
from tempestmodel_tpu.ops.pallas_banded import (banded_solve_pallas,
                                                banded_solve_multi_pallas)
from tempestmodel_tpu_torch.ops import cuda_banded
from tempestmodel_tpu_torch.kernels.counts import launch_counts


def _random_banded(n, q, ncol, seed=0):
    """Diagonally dominant banded systems, (n, 2q+1, ncol), numpy."""
    rng = np.random.default_rng(seed)
    b = 2 * q + 1
    bands = rng.standard_normal((n, b, ncol))
    bands[:, q, :] += 2.0 * b
    rows = np.arange(n)
    for d in range(b):
        col = rows + d - q
        bands[(col < 0) | (col >= n), d, :] = 0.0
    return bands, rng.standard_normal((n, ncol))


def _dense_solve(bands, rhs, q):
    n, b, ncol = bands.shape
    X = np.zeros((n, ncol))
    for c in range(ncol):
        A = np.zeros((n, n))
        for d in range(b):
            for i in range(n):
                j = i + d - q
                if 0 <= j < n:
                    A[i, j] = bands[i, d, c]
        X[:, c] = np.linalg.solve(A, rhs[:, c])
    return X


# ncol = 24 divides the Pallas column tile; 21 is ragged for the port
@pytest.mark.parametrize("q,ncol", [(1, 24), (2, 24), (4, 24), (4, 21)])
def test_plain_banded_matches_pallas_and_dense(q, ncol):
    n = 3 * 10 + 1
    bands, rhs = _random_banded(n, q, ncol, seed=q)
    x = cuda_banded.banded_solve_plain(
        torch.from_numpy(bands), torch.from_numpy(rhs), q).numpy()
    np.testing.assert_allclose(x, _dense_solve(bands, rhs, q),
                               rtol=1e-10, atol=1e-12)
    if ncol % 8 == 0:
        x_pl = np.asarray(banded_solve_pallas(
            jnp.asarray(bands), jnp.asarray(rhs), q, col_tile=8,
            interpret=True))
        np.testing.assert_allclose(x, x_pl, rtol=1e-10, atol=1e-12)


def test_wrapper_runs_plain_on_cpu_and_counts_nothing():
    bands, rhs = _random_banded(13, 2, 7)
    tb, tr = torch.from_numpy(bands), torch.from_numpy(rhs)
    before = launch_counts["banded_solve"]
    x = cuda_banded.banded_solve(tb, tr, 2)
    assert launch_counts["banded_solve"] == before
    torch.testing.assert_close(
        x, cuda_banded.banded_solve_plain(tb, tr, 2), rtol=0, atol=0)


def test_wrapper_float32_on_cpu():
    bands, rhs = _random_banded(16, 4, 9)
    x = cuda_banded.banded_solve(torch.from_numpy(bands).float(),
                                 torch.from_numpy(rhs).float(), 4)
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), _dense_solve(bands, rhs, 4),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["q_too_large", "shape", "dtype",
                                  "contiguity", "mixed_dtype"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    bands, rhs = _random_banded(12, 2, 6)
    tb, tr = torch.from_numpy(bands), torch.from_numpy(rhs)
    if case == "q_too_large":
        big = torch.zeros((12, 19, 6), dtype=torch.float64)
        with pytest.raises(ValueError):
            cuda_banded.banded_solve(big, tr, 9)
    elif case == "shape":
        with pytest.raises(ValueError):
            cuda_banded.banded_solve(tb, tr[:-1], 2)
    elif case == "dtype":
        with pytest.raises(TypeError):
            cuda_banded.banded_solve(tb.to(torch.int64),
                                     tr.to(torch.int64), 2)
    elif case == "contiguity":
        with pytest.raises(ValueError):
            cuda_banded.banded_solve(tb, tr.T.contiguous().T, 2)
    else:
        with pytest.raises(TypeError):
            cuda_banded.banded_solve(tb, tr.float(), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_cuda_kernel_matches_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    for q, n, ncol in ((4, 31, 1000), (1, 9, 33), (8, 40, 257)):
        bands, rhs = _random_banded(n, q, ncol, seed=q)
        tb = torch.from_numpy(bands).to("cuda", dtype)
        tr = torch.from_numpy(rhs).to("cuda", dtype)
        before = launch_counts["banded_solve"]
        x = cuda_banded.banded_solve(tb, tr, q)
        torch.cuda.synchronize()
        assert launch_counts["banded_solve"] == before + 1
        want = cuda_banded.banded_solve_plain(tb, tr, q)
        err = float((x - want).abs().max() / want.abs().max())
        assert err < tol


# --- R right-hand sides that share the column's matrix ---------------------

def _random_multi(n, q, R, ncol, seed=0):
    bands, _ = _random_banded(n, q, ncol, seed)
    rhs = np.random.default_rng(seed + 100).standard_normal((n, R, ncol))
    # right-hand sides of different size, so a mix-up of them shows
    return bands, rhs * 10.0 ** -np.arange(R).reshape(1, R, 1)


# ncol = 37 is no multiple of the Pallas column tile (512: it pads)
@pytest.mark.parametrize("R", [1, 3, 5])
@pytest.mark.parametrize("q", [1, 2, 4])
def test_plain_banded_multi_matches_pallas_and_jax(q, R):
    """``banded_solve_multi_plain`` against the Pallas kernel itself (called
    directly it runs in interpret mode on the CPU), against the JAX
    package's scan form, and against R separate single solves."""
    n, ncol = 13, 37
    bands, rhs = _random_multi(n, q, R, ncol, seed=10 * q + R)
    tb, tr = torch.from_numpy(bands), torch.from_numpy(rhs)
    x = cuda_banded.banded_solve_multi_plain(tb, tr, q)
    assert tuple(x.shape) == (n, R, ncol) and x.is_contiguous()
    scale = np.abs(x.numpy()).max(axis=(0, 2), keepdims=True)
    x_pl = np.asarray(banded_solve_multi_pallas(
        jnp.asarray(bands), jnp.asarray(rhs), q, interpret=True))
    x_j = np.asarray(j_banded_solve_multi_t(
        jnp.asarray(bands), jnp.asarray(rhs), q))
    assert np.abs((x.numpy() - x_pl) / scale).max() < 1e-12
    assert np.abs((x.numpy() - x_j) / scale).max() < 1e-12
    for r in range(R):
        one = cuda_banded.banded_solve_plain(tb, tr[:, r].contiguous(), q)
        assert np.abs((x[:, r] - one).numpy()).max() < 1e-12 * scale[0, r, 0]
        np.testing.assert_allclose(
            x[:, r].numpy(), _dense_solve(bands, rhs[:, r], q), rtol=1e-10,
            atol=1e-12 * scale[0, r, 0])


def test_multi_wrapper_runs_plain_on_cpu_and_counts_nothing():
    bands, rhs = _random_multi(11, 2, 3, 7)
    tb, tr = torch.from_numpy(bands), torch.from_numpy(rhs)
    before = dict(launch_counts)
    x = cuda_banded.banded_solve_multi(tb, tr, 2)
    assert dict(launch_counts) == before
    assert torch.equal(x, cuda_banded.banded_solve_multi_plain(tb, tr, 2))
    x32 = cuda_banded.banded_solve_multi(tb.float(), tr.float(), 2)
    assert x32.dtype == torch.float32
    assert float((x32 - x).abs().max() / x.abs().max()) < 1e-4


@pytest.mark.parametrize("case", ["q_too_large", "shape", "two_dim_rhs",
                                  "no_rhs", "dtype", "contiguity",
                                  "mixed_dtype"])
def test_multi_wrapper_raises_on_what_the_kernel_does_not_take(case):
    bands, rhs = _random_multi(12, 2, 3, 6)
    tb, tr = torch.from_numpy(bands), torch.from_numpy(rhs)
    if case == "q_too_large":
        big = torch.zeros((12, 19, 6), dtype=torch.float64)
        with pytest.raises(ValueError):
            cuda_banded.banded_solve_multi(big, tr, 9)
    elif case == "shape":
        with pytest.raises(ValueError):
            cuda_banded.banded_solve_multi(tb, tr[:, :, :-1].contiguous(), 2)
    elif case == "two_dim_rhs":
        with pytest.raises(ValueError):
            cuda_banded.banded_solve_multi(tb, tr[:, 0].contiguous(), 2)
    elif case == "no_rhs":
        with pytest.raises(ValueError):
            cuda_banded.banded_solve_multi(tb, tr[:, :0].contiguous(), 2)
    elif case == "dtype":
        with pytest.raises(TypeError):
            cuda_banded.banded_solve_multi(tb.to(torch.int64),
                                           tr.to(torch.int64), 2)
    elif case == "contiguity":
        with pytest.raises(ValueError):
            cuda_banded.banded_solve_multi(tb, tr.transpose(1, 2).contiguous()
                                           .transpose(1, 2), 2)
    else:
        with pytest.raises(TypeError):
            cuda_banded.banded_solve_multi(tb, tr.float(), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_cuda_multi_kernel_matches_plain(dtype, tol):
    """Both forms of the kernel (the tile staged in shared memory, the
    stream form), a ragged width, R above 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    for q, R, n, ncol in ((1, 3, 30, 1000), (4, 5, 31, 257), (2, 1, 9, 33),
                          (8, 2, 40, 130), (3, 7, 12, 129)):
        bands, rhs = _random_multi(n, q, R, ncol, seed=q)
        tb = torch.from_numpy(bands).to("cuda", dtype)
        tr = torch.from_numpy(rhs).to("cuda", dtype)
        want = cuda_banded.banded_solve_multi_plain(tb, tr, q)
        before = launch_counts["banded_solve_multi"]
        x = cuda_banded.banded_solve_multi(tb, tr, q)
        torch.cuda.synchronize()
        assert launch_counts["banded_solve_multi"] == before + 1
        y = cuda_banded._banded_solve_multi_cuda(
            tb, tr, q, cuda_banded.banded_multi_launch_shape(
                n, q, R, ncol, dtype, form="stream"))
        torch.cuda.synchronize()
        for got in (x, y):
            for r in range(R):
                err = float((got[:, r] - want[:, r]).abs().max()
                            / want[:, r].abs().max())
                assert err < tol, (q, R, r)
