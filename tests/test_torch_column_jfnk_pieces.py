"""The pieces of the port's JFNK column solver (``models/jfnk.py``)
against the JAX package's, float64 on the CPU, with no JAX step:
``gmres_batched`` on random well-posed systems (a full Krylov space and a
restarted short one), the finite-difference probe (``jv=None``) against the
exact product, and the band product against the dense one.  The JFNK steps
are in ``test_torch_column_jfnk.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.models.jfnk import gmres_batched as j_gmres
from tempestmodel_tpu_torch.fast import implicit as t_imp
from tempestmodel_tpu_torch.models import jfnk as t_jfnk


def _systems(n, ncol, seed):
    rng = np.random.default_rng(seed)
    A = rng.random((ncol, n, n)) + n * np.eye(n)
    b = rng.random((n, ncol))
    return A, b


@pytest.mark.parametrize("m,restarts", [(12, 1), (5, 3)])
def test_gmres_batched_matches_jax(m, restarts):
    """Full Krylov space (m = n) and a restarted short one, on random
    diagonally dominant systems: the port's iterate equals JAX's to 1e-12,
    and with m = n both solve the systems."""
    n, ncol = 12, 7
    A, b = _systems(n, ncol, 3)
    want = np.asarray(j_gmres(
        lambda v: jnp.einsum("cij,jc->ic", jnp.asarray(A), v),
        jnp.asarray(b), m=m, restarts=restarts))
    At = torch.from_numpy(A)
    got = t_jfnk.gmres_batched(
        lambda v: torch.einsum("cij,jc->ic", At, v), torch.from_numpy(b),
        m=m, restarts=restarts).numpy()
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()
    if m == n:
        x = np.stack([np.linalg.solve(A[c], b[:, c]) for c in range(ncol)],
                     axis=1)
        assert np.abs(got - x).max() < 1e-10


def test_the_finite_difference_probe_follows_the_exact_product():
    """``jfnk_newton_update`` with ``jv=None`` (the reference's probe:
    J·v ≈ (F(x + e v) - F(x)) / e) on a mildly nonlinear column system:
    within 1e-6 of the step with the exact product, which solves the
    linearized system (checked against a dense solve)."""
    n, ncol = 10, 5
    A, b = _systems(n, ncol, 11)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x0 = torch.from_numpy(np.random.default_rng(2).random((n, ncol)))

    def resid(x):                      # F(x) = A x + x^3 / 10 - b
        return torch.einsum("cij,jc->ic", At, x) + 0.1 * x ** 3 - bt

    def jv(v):
        return torch.einsum("cij,jc->ic", At, v) + 0.3 * x0 ** 2 * v

    exact = t_jfnk.jfnk_newton_update(resid, x0, jv=jv, m=n, restarts=1)
    fd = t_jfnk.jfnk_newton_update(resid, x0, m=n, restarts=1)
    assert float((fd - exact).abs().max()) < 1e-6
    J = At + torch.diag_embed(0.3 * x0.T ** 2)
    want = x0 - torch.linalg.solve(J, resid(x0).T[..., None])[..., 0].T
    assert float((exact - want).abs().max()) < 1e-10


def test_band_matvec_is_the_dense_product():
    rng = np.random.default_rng(4)
    n, q, ncol = 9, 3, 6
    bands = torch.from_numpy(rng.standard_normal((n, 2 * q + 1, ncol)))
    for i in range(n):                 # out-of-range entries are zero
        for d in range(2 * q + 1):
            if not 0 <= i + d - q < n:
                bands[i, d] = 0.0
    v = torch.from_numpy(rng.standard_normal((n, ncol)))
    J = t_imp.dense_from_bands(bands, q)
    want = torch.einsum("cij,jc->ic", J, v)
    got = t_imp.band_matvec(bands, v, q)
    assert float((got - want).abs().max()) < 1e-13
    for c in range(ncol):
        for i in range(n):
            for d in range(2 * q + 1):
                j = i + d - q
                if 0 <= j < n:
                    assert J[c, i, j] == bands[i, d, c]
