"""The nu4 kernels' host side (``hyper_cuda.hyper_launch_shape``,
``copy_width``, ``launch_config``) and the edge shapes of
``kernels/hyper_edges.py``: each case's plain passes against the JAX
package (its Pallas passes in interpret mode where they take the shape,
``A % 8 == 0`` and ``8 % p == 0``; elsewhere the JAX engine's order-4
pieces), and the kernels against the plain versions on a card.  float64;
no JAX step is compiled here."""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
from tempestmodel_tpu.fast import engine as j_engine, hyper_pallas
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases.nonhydro_xz import (
    ThermalBubble3D as JaxBubble)
from tempestmodel_tpu_torch.fast import hyper_cuda
from tempestmodel_tpu_torch.kernels import hyper_edges

from torch_port_common import CPU, FIELDS, rel_err

F32, F64 = torch.float32, torch.float64


def _grid_shape(case):
    """(nz, P, A, B, p) of an edge case's fields, from its spec."""
    spec, nz = hyper_edges.CASES[case][:2]
    if spec[0] == "sphere":
        _, ne, p = spec
        return nz, 6, ne * p, ne * p, p
    _, nex, ney, p, swap = spec
    A, B = nex * p, ney * p
    return (nz, 1, B, A, p) if swap else (nz, 1, A, B, p)


# (nz, P, A, B, p): the flagship, the 3-D bubble's two planes, an x-z slice
# in both layouts (wider than a band of whole rows when swapped), and the
# edge cases' grids
SHAPES = sorted({(30, 6, 120, 120, 4), (40, 1, 128, 128, 4),
                 (40, 1, 128, 64, 4), (40, 1, 4, 400, 4),
                 (40, 1, 400, 4, 4)}
                | {_grid_shape(c) for c in hyper_edges.CASES})


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("pass2", [False, True], ids=["pass1", "pass2"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_hyper_launch_shape_fits_a_block(shape, pass2, dtype):
    """Shared memory within a block's 227 KB and as the kernel lays it out,
    bands of whole elements that tile the panel, a thread a segment within
    the launch bound, runs that cover the nz + 1 steps, and a ring of two
    stages or more wherever a block walks two levels or more."""
    nz, P, A, B, p = shape
    sh = hyper_cuda.hyper_launch_shape(nz, P, A, B, p, dtype, pass2)
    esize = 4 if dtype == F32 else 8
    assert sh.smem <= hyper_cuda.SMEM_MAX
    assert sh.smem == hyper_cuda.hyper_smem_bytes(sh.rows, sh.cols, sh.ring,
                                                  pass2, esize)
    assert sh.rows % p == 0 and A % sh.rows == 0
    assert sh.cols % p == 0 and B % sh.cols == 0
    assert sh.threads == sh.rows * sh.cols // p <= hyper_cuda.MAX_THREADS
    # whole rows wherever one element row of them fits the block (a thread
    # a segment: p rows of B values take B threads)
    assert sh.cols == B or B > hyper_cuda.MAX_THREADS
    assert 1 <= sh.levels <= nz + 1
    assert sh.blocks == (A // sh.rows) * (B // sh.cols) * P * math.ceil(
        (nz + 1) / sh.levels)
    assert 1 <= sh.ring <= min(hyper_cuda.MAX_RING, sh.levels)
    assert sh.levels == 1 or sh.ring >= 2


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("pass2", [False, True], ids=["pass1", "pass2"])
@pytest.mark.parametrize("shape", [(30, 6, 120, 120, 4), (40, 1, 128, 128, 4),
                                   (40, 1, 128, 64, 4)],
                         ids=["flagship", "plane", "plane_rectangular"])
def test_hyper_launch_shape_fills_the_card(shape, pass2, dtype):
    """At least one full wave of blocks at the flagship and on the
    bubble's planes, each block walking a run of several levels (the metric
    is read once a run), with the next levels' copies in flight (a ring of
    two stages or more)."""
    sh = hyper_cuda.hyper_launch_shape(*shape, dtype, pass2)
    assert sh.blocks >= hyper_cuda.SMS
    assert sh.levels >= 2 and sh.ring >= 2
    # the flagship's band is one contiguous span a level (whole rows)
    assert sh.cols == shape[3]


@pytest.mark.parametrize("case", ["p9", "rows", "cols", "ring1", "levels",
                                  "ring5"])
def test_hyper_launch_shape_raises_where_the_kernel_cannot_run(case):
    args = {"p9": ((4, 6, 18, 18, 9, F32, False), {}),
            "rows": ((4, 6, 16, 16, 4, F32, False), dict(rows=12)),
            "cols": ((4, 6, 16, 16, 4, F32, True), dict(cols=6)),
            "ring1": ((4, 6, 16, 16, 4, F32, True), dict(levels=3, ring=1)),
            "levels": ((4, 6, 16, 16, 4, F32, False), dict(levels=0)),
            "ring5": ((8, 6, 16, 16, 4, F64, True), dict(levels=8,
                                                         ring=5))}[case]
    with pytest.raises(ValueError):
        hyper_cuda.hyper_launch_shape(*args[0], **args[1])


@pytest.mark.parametrize("B,cols,esize,ptrs,want", [
    (120, 120, 4, [256, 512], 16), (120, 120, 8, [256], 16),
    (120, 120, 4, [256, 260], 4), (120, 120, 4, [256, 264], 8),
    (120, 120, 8, [256, 264], 8), (6, 6, 4, [256], 8), (3, 3, 4, [256], 4),
    (6, 6, 8, [256], 16), (3, 3, 8, [256], 8), (128, 128, 4, [256, 0], 16),
    (320, 160, 4, [16, 32], 16), (12, 6, 4, [256], 8),
    (18, 6, 8, [256, 264], 8)])
def test_hyper_copy_width(B, cols, esize, ptrs, want):
    """16-byte bulk copies where a panel row, a band row and every pointer
    allow them, else 8-byte copies, else one value; an absent pointer (0)
    allows all."""
    assert hyper_cuda.copy_width(B, cols, esize, ptrs) == want


def test_hyper_launch_config_reports_the_launch():
    fg = hyper_edges.geometry("sphere_ne4", F32, CPU)
    st = hyper_cuda.hyper_statics(fg)
    d, w, _ = hyper_edges.case_inputs("sphere_ne4", fg)
    sh = hyper_cuda.hyper_launch_shape(8, 6, 16, 16, 4, F32, True)
    assert hyper_cuda.launch_config(w, d, st) == dict(sh._asdict(), copy=16)
    d1, _, _ = hyper_edges.case_inputs("sphere_ne4_offset1", fg)
    odd = hyper_cuda.launch_config(d1, None, st,
                                   sh._replace(levels=3, ring=2))
    assert odd["copy"] == 4 and odd["levels"] == 3


def _jax_pair(case):
    """(jfg, tfg, jcfg): the JAX package's geometry of an edge case with
    the port's seeded metric in place of its own, the port's geometry
    (float64, CPU), and the JAX configuration."""
    tfg = hyper_edges.geometry(case, F64, CPU)
    spec, nz = hyper_edges.CASES[case][:2]
    if spec[0] == "sphere":
        _, ne, p = spec
        jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE, ne=ne,
                              order=p, nz=nz, ztop=30000.0,
                              dtype=jnp.float64)
        jfg = j_engine.build_fast_geometry(
            j_nh.build_nh_sphere_geometry(jcfg), dtype=jnp.float64)
    else:
        _, nex, ney, p, swap = spec
        tc = JaxBubble()
        jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CARTESIAN_3D, nex=nex,
                              ney=ney, order=p, nz=nz, x_extent=tc.x_extent,
                              y_extent=tc.y_extent, ztop=tc.ztop,
                              dtype=jnp.float64)
        jfg = j_engine.build_fast_geometry_cartesian(
            j_nh.build_nh_cartesian_geometry(jcfg, ztop=tc.ztop),
            dtype=jnp.float64, swap_ab=swap)
    jfg = dataclasses.replace(jfg, **{
        k: jnp.asarray(getattr(tfg, k).numpy()) for k in hyper_edges.METRIC})
    return jfg, tfg, jcfg.with_(hypervis_order=4)


def _inputs(case, tfg):
    d, w, nu = hyper_edges.case_inputs(case, tfg)
    return ({k: v.numpy() for k, v in d.items()},
            {k: v.numpy() for k, v in w.items()}, nu)


def _pallas_takes(case):
    _, _, A, _, p = _grid_shape(case)
    return A % 8 == 0 and 8 % p == 0


# the edge grids: the other sphere_ne4 cases repeat that grid with other
# levels, launch shapes or offsets, which the plain versions do not see
GRIDS = [c for c in hyper_edges.CASES
         if not (c.startswith("sphere_ne4_")
                 and hyper_edges.CASES[c][0] == ("sphere", 4, 4))]


@pytest.mark.parametrize("case", [c for c in GRIDS if _pallas_takes(c)])
def test_hyper_edge_case_plain_matches_pallas(case):
    """Each edge grid's plain passes against the JAX Pallas passes in
    interpret mode, 1e-12 relative; pass 2's increment is as large as the
    state and held on its own to 1e-10."""
    jfg, tfg, jcfg = _jax_pair(case)
    assert hyper_pallas.supported(jfg, jcfg)
    st = hyper_cuda.hyper_statics(tfg)
    d, w, nu = _inputs(case, tfg)
    T = lambda x: {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    J = lambda x: {k: jnp.asarray(v) for k, v in x.items()}
    want1 = hyper_pallas.nu4_pass1(J(d), jfg, interpret=True)
    want2 = hyper_pallas.nu4_pass2(J(d), J(w), *nu, jfg, interpret=True)
    got1 = hyper_cuda.nu4_pass1_plain(T(d), tfg, st)
    got2 = hyper_cuda.nu4_pass2_plain(T(d), T(w), *nu, tfg, st)
    for k in FIELDS:
        assert rel_err(got1[k].numpy(), want1[k]) < 1e-12, k
        assert rel_err(got2[k].numpy(), want2[k]) < 1e-12, k
        inc = np.asarray(want2[k]) - d[k]
        assert np.abs(inc).max() > 1e-2 * np.abs(d[k]).max(), k
        assert rel_err(got2[k].numpy() - d[k], inc) < 1e-10, k


@pytest.mark.parametrize("case", [c for c in GRIDS if not _pallas_takes(c)])
def test_hyper_edge_case_plain_matches_the_jax_engines_order4_pieces(case):
    """Where the Pallas passes do not take the shape: the plain passes
    against the JAX engine's order-4 pieces (dense operators, the 3-D
    Jacobians, the division), 1e-11 relative; pass 2's increment on its own
    to 1e-10."""
    jfg, tfg, _ = _jax_pair(case)
    st = hyper_cuda.hyper_statics(tfg)
    d, w, (nu_s, nu_d, nu_v, dt) = _inputs(case, tfg)
    T = lambda x: {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    J = lambda x: {k: jnp.asarray(v) for k, v in x.items()}
    jd, jw = J(d), J(w)
    wu, wv = j_engine.vector_hyperdiff_update(jd["U"], jd["V"], 1.0, 1.0,
                                              jfg)
    want1 = {"U": -wu, "V": -wv}
    du, dv = j_engine.vector_hyperdiff_update(jw["U"], jw["V"], nu_d, nu_v,
                                              jfg)
    want2 = {"U": jd["U"] + dt * du, "V": jd["V"] + dt * dv}
    for k, jac in (("Rt", jfg.jac3d), ("Rho", jfg.jac3d),
                   ("W", jfg.jac3d_int)):
        want1[k] = j_engine.scalar_laplacian(jd[k], jac, jfg)
        want2[k] = jd[k] - dt * nu_s * j_engine.scalar_laplacian(jw[k], jac,
                                                                 jfg)
    got1 = hyper_cuda.nu4_pass1_plain(T(d), tfg, st)
    got2 = hyper_cuda.nu4_pass2_plain(T(d), T(w), nu_s, nu_d, nu_v, dt, tfg,
                                      st)
    for k in FIELDS:
        assert rel_err(got1[k].numpy(), want1[k]) < 1e-11, k
        assert rel_err(got2[k].numpy(), want2[k]) < 1e-11, k
        assert rel_err(got2[k].numpy() - d[k],
                       np.asarray(want2[k]) - d[k]) < 1e-10, k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(F64, 1e-11), (F32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(hyper_edges.CASES))
def test_cuda_hyper_edge_case_matches_plain(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    got = hyper_edges.run_case(case, dtype, torch.device("cuda"))
    assert got["max_err"] <= tol, got["err_by_output"]
