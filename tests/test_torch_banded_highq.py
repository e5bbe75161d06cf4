"""Half-bandwidths above the template forms' 8: the banded solves of
vertical order 2 and up (the Lorenz column systems have q = 6 vo - 2: 10 at
order 2, 16 at order 3; the tracer systems q = 2 vo - 1: 9 from order 5).

The plain ``banded_solve`` and ``banded_solve_multi`` against the JAX Pallas
kernels (interpret mode; they have no limit on q) and a dense solve, the
wide form's launch rule, and UMJS at vertical order 2 with the ``"pallas"``
solver (the unfused path: the banded kernel's route) against the JAX
package's ``make_fast_step`` (its banded solver), float64.  The orders 3, the finite-volume
order 2 and a stretched grid are ``slow``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu.ops.pallas_banded import (banded_solve_pallas,
                                                banded_solve_multi_pallas)
from tempestmodel_tpu_torch import fast as t_fast, convert
from tempestmodel_tpu_torch.kernels import banded_edges
from tempestmodel_tpu_torch.kernels.banded_edges import systems
from tempestmodel_tpu_torch.models import nonhydro as t_nonhydro
from tempestmodel_tpu_torch.ops import cuda_banded

from torch_port_common import build_pair, initial_states, CPU, FIELDS, rel_err

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


# ---------------------------------------------------------------------------
# the step at vertical order 2 and up ("pallas": the unfused path's banded
# kernel where the fused implicit kernel does not take the order)
# ---------------------------------------------------------------------------

UMJS = dict(ne=2, order=4, nz=6)


def _three_steps(jcfg, jgeom, tcfg, tgeom):
    """3 steps of both packages' ``make_fast_step`` from the JAX initial
    state; returns the worst relative error of a field and the port's
    half-bandwidth."""
    js, _ = initial_states(jcfg, jgeom, tcfg, tgeom)
    jfirst, jstep = j_fast.make_fast_step(jcfg, jgeom)
    jX, jc = jfirst(j_fast.pack_state(js))
    for _ in range(2):
        jX, jc = jstep(jX, jc)
    want = j_fast.unpack_state(jX, jcfg.nz)
    tfirst, tstep = t_fast.make_fast_step(tcfg, tgeom, device=CPU)
    tX, tc = tfirst(convert.state_from_numpy(
        {k: np.asarray(v) for k, v in js.items()}, device=CPU, dtype=F64))
    for _ in range(2):
        tX, tc = tstep(tX, tc)
    got = t_fast.unpack_state(tX)
    errs = {k: rel_err(got[k].numpy(), want[k]) for k in FIELDS}
    q = t_nonhydro.estimate_bandwidth(tgeom, tcfg.constants)
    return max(errs.values()), q


def _pair(**kw):
    """The port with ``"pallas"`` (the solver that raised), the JAX package
    with ``"banded"``: the same elimination as its Pallas kernel, which on
    the CPU runs in interpret mode and takes minutes to compile at q 10."""
    return build_pair(**{**UMJS, **kw})


def test_umjs_vertical_order_2_pallas_matches_jax():
    """q = 10 raised in the port before the repair; the unfused path now
    takes the wide form of ``banded_solve`` and the step equals JAX's."""
    jcfg, jgeom, tcfg, tgeom = _pair(vertical_order=2)
    err, q = _three_steps(jcfg, jgeom, tcfg, tgeom)
    assert q == 10
    assert err < 1e-11, err


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["order3", "fv_order2", "stretched"])
def test_umjs_wider_bands_match_jax(variant):
    kw = {"order3": dict(vertical_order=3),
          "fv_order2": dict(vertical_order=2, vertical_discretization="FV"),
          "stretched": dict(vertical_order=2,
                            vertical_stretch="cubic")}[variant]
    jcfg, jgeom, tcfg, tgeom = _pair(**kw)
    err, q = _three_steps(jcfg, jgeom, tcfg, tgeom)
    # the finite-volume column of order 2 is banded like order 1 (q 4)
    assert q == (4 if variant == "fv_order2" else 16 if variant == "order3"
                 else 10)
    assert err < 1e-11, (variant, err)
