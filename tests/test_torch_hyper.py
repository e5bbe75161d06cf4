"""The port's nu4 hyperdiffusion passes vs the JAX package's Pallas kernels
(interpret mode) and vs the port's own order-4 tail as plain tensor code;
the ``supported`` predicate; the wrappers' checks; the CUDA kernels on a
card.  float64, a terrain-like metric whose 3-D Jacobian is no multiple of
the 2-D one (flat terrain would hide a mix-up of the two)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.fast import engine as j_engine, hyper_pallas
from tempestmodel_tpu_torch.fast import engine as t_engine, hyper_cuda
from tempestmodel_tpu_torch.kernels.counts import launch_counts

from torch_port_common import (build_pair, terrain_like_pair, state_pair,
                               rel_err, FIELDS)

NU = (3.0e10, 2.0e10, 1.5e10)      # nu_s, nu_d, nu_v: increments of O(state)
DT = 200.0


@pytest.fixture(scope="module")
def setup():
    jcfg, jgeom, tcfg, tgeom = build_pair()
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    jfg_t, tfg_t = terrain_like_pair(jfg, seed=3, vary_jac=True)
    jd, td = state_pair(jfg.nz, jfg.A, seed=21)
    jw, tw = state_pair(jfg.nz, jfg.A, seed=22)
    return jcfg, tcfg, jfg_t, tfg_t, jd, td, jw, tw


@pytest.fixture(scope="module")
def passes(setup):
    """Both passes from both packages, computed once."""
    jcfg, tcfg, jfg, tfg, jd, td, jw, tw = setup
    assert hyper_pallas.supported(jfg, jcfg)
    st = hyper_cuda.hyper_statics(tfg)
    return {
        "pass1": (hyper_pallas.nu4_pass1(jd, jfg, interpret=True),
                  hyper_cuda.nu4_pass1_plain(td, tfg, st), None),
        "pass2": (hyper_pallas.nu4_pass2(jd, jw, *NU, DT, jfg,
                                         interpret=True),
                  hyper_cuda.nu4_pass2_plain(td, tw, *NU, DT, tfg, st), td),
    }


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("which", ["pass1", "pass2"])
def test_plain_matches_pallas(passes, which, field):
    want, got, base = passes[which]
    assert got[field].is_contiguous()
    assert rel_err(got[field].numpy(), want[field]) < 1e-12
    if base is not None:
        # the increment on its own, so that the state cannot mask it
        inc = got[field].numpy() - base[field].numpy()
        want_inc = np.asarray(want[field]) - base[field].numpy()
        assert np.abs(want_inc).max() > 1e-3 * np.abs(base[field].numpy()).max()
        assert rel_err(inc, want_inc) < 1e-10


def test_metric_stack_follows_the_jax_one(setup):
    _, _, jfg, tfg, *_ = setup
    st = hyper_cuda.hyper_statics(tfg)
    np.testing.assert_allclose(st.m2d.numpy(),
                               np.asarray(hyper_pallas._m2d(jfg, jnp.float64)),
                               rtol=1e-15)
    p = tfg.p
    Da, Sa, Db, Sb = st.ds.reshape(4, p, p).numpy()
    # the block-diagonal operators the TPU kernel multiplies by, along a and
    # along b (the (B, B) ones)
    for got, want in ((Da.T, jfg.DA), (Sa, jfg.Sd), (Db.T, jfg.DA_b),
                      (Sb, jfg.Sd_b)):
        np.testing.assert_allclose(np.asarray(want)[:p, :p], got, atol=1e-18)


def test_two_jacobians_are_told_apart(setup):
    """The check's geometry must be able to see a mix-up of j2 and jl."""
    _, _, _, tfg, *_ = setup
    ratio = tfg.jac3d[0] / tfg.jac2d
    assert float(ratio.max() / ratio.min()) > 1.2


@pytest.mark.parametrize("which", ["pass1", "pass2", "tail"])
def test_plain_matches_the_engines_order4_pieces(setup, which):
    """The kernels' arithmetic (element-local sums, z-constant metric, the
    multiply by 1/J) against ``step_after_subcycle``'s (dense operators, the
    3-D Jacobians, the division)."""
    _, tcfg, _, tfg, _, td, _, tw = setup
    st = hyper_cuda.hyper_statics(tfg)
    if which == "pass1":
        wu, wv = t_engine.vector_hyperdiff_update(td["U"], td["V"], 1.0, 1.0,
                                                  tfg)
        want = {"U": -wu, "V": -wv,
                "Rt": t_engine.scalar_laplacian(td["Rt"], tfg.jac3d, tfg),
                "Rho": t_engine.scalar_laplacian(td["Rho"], tfg.jac3d, tfg),
                "W": t_engine.scalar_laplacian(td["W"], tfg.jac3d_int, tfg)}
        got = hyper_cuda.nu4_pass1_plain(td, tfg, st)
    elif which == "pass2":
        nu_s, nu_d, nu_v = NU
        du, dv = t_engine.vector_hyperdiff_update(tw["U"], tw["V"], nu_d,
                                                  nu_v, tfg)
        want = {"U": td["U"] + DT * du, "V": td["V"] + DT * dv}
        for k, jac in (("Rt", tfg.jac3d), ("Rho", tfg.jac3d),
                       ("W", tfg.jac3d_int)):
            want[k] = td[k] - DT * nu_s * t_engine.scalar_laplacian(
                tw[k], jac, tfg)
        got = hyper_cuda.nu4_pass2_plain(td, tw, *NU, DT, tfg, st)
    else:
        want = t_engine.step_after_subcycle(td, tcfg.dt, tcfg, tfg)
        before = dict(launch_counts)
        got = t_engine.step_after_subcycle(td, tcfg.dt, tcfg, tfg,
                                           use_fused_hyper=True)
        assert dict(launch_counts) == before      # CPU tensors: no launch
    for k in FIELDS:
        assert rel_err(got[k].numpy(), want[k].numpy()) < 1e-11, k
        if which != "pass1":
            assert rel_err((got[k] - td[k]).numpy(),
                           (want[k] - td[k]).numpy()) < 1e-10, k


def test_fused_tail_matches_jax_fused_tail(setup):
    jcfg, tcfg, jfg, tfg, jd, td, _, _ = setup
    want = j_engine.step_after_subcycle(jd, jcfg.dt, jcfg, jfg,
                                        use_fused_hyper=True)
    got = t_engine.step_after_subcycle(td, tcfg.dt, tcfg, tfg,
                                       use_fused_hyper=True)
    for k in FIELDS:
        assert rel_err(got[k].numpy(), want[k]) < 1e-12, k


@pytest.mark.parametrize("case", ["ne4", "order2", "z_varying",
                                  "interfaces_differ", "swapped"])
def test_supported(setup, case):
    _, tcfg, _, tfg, *_ = setup
    if case in ("ne4", "swapped"):
        # the passes read neither the layout nor the x-z switch of a
        # Cartesian grid
        fg = tfg if case == "ne4" else dataclasses.replace(
            tfg, ab_swapped=True, xz_zero="U", wrap=(True, True))
        assert hyper_cuda.supported(fg, tcfg)
        return
    cfg, fg = tcfg, tfg
    if case == "order2":
        cfg = tcfg.with_(hypervis_order=2)
    elif case == "z_varying":
        jac = tfg.jac3d.clone()
        jac[-1] *= 1.0 + 1e-9
        fg = dataclasses.replace(tfg, jac3d=jac)
    elif case == "interfaces_differ":
        fg = dataclasses.replace(tfg, jac3d_int=tfg.jac3d_int * (1 + 1e-9))
    assert not hyper_cuda.supported(fg, cfg)


def test_wrappers_run_plain_on_cpu_and_count_nothing(setup):
    _, _, _, tfg, _, td, _, tw = setup
    keep = {k: v.clone() for k, v in td.items()}
    before = dict(launch_counts)
    a = hyper_cuda.nu4_pass1(td, tfg)
    b = hyper_cuda.nu4_pass2(td, tw, *NU, DT, tfg)
    assert dict(launch_counts) == before
    pa = hyper_cuda.nu4_pass1_plain(td, tfg)
    pb = hyper_cuda.nu4_pass2_plain(td, tw, *NU, DT, tfg)
    for k in FIELDS:
        assert torch.equal(a[k], pa[k]) and torch.equal(b[k], pb[k])
        assert torch.equal(td[k], keep[k])        # the state is left alone
        assert b[k].data_ptr() != td[k].data_ptr()


@pytest.mark.parametrize("case", ["w_levels", "contiguity", "dtype",
                                  "work_shape", "metric", "elements"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(setup, case):
    _, _, _, tfg, _, td, _, tw = setup
    st = hyper_cuda.hyper_statics(tfg)
    d, w = dict(td), dict(tw)
    if case == "w_levels":
        d["W"] = d["W"][:-1]
    elif case == "contiguity":
        d["Rt"] = d["Rt"].transpose(2, 3)
    elif case == "dtype":
        d["Rho"] = d["Rho"].to(torch.float32)
    elif case == "work_shape":
        w["U"] = w["U"][:, :, :-4]
    elif case == "metric":
        st = dataclasses.replace(st, m2d=st.m2d[:7])
    else:
        st = dataclasses.replace(st, p=5)
    with pytest.raises(ValueError):
        hyper_cuda.nu4_pass2(d, w, *NU, DT, tfg, statics=st)
    if case not in ("work_shape",):
        with pytest.raises(ValueError):
            hyper_cuda.nu4_pass1(d, tfg, statics=st)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-4)])
def test_cuda_kernels_match_plain(setup, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    _, _, _, tfg, _, td, _, tw = setup
    dev = torch.device("cuda")
    fg = dataclasses.replace(tfg, **{
        f.name: getattr(tfg, f.name).to(dev, dtype)
        for f in dataclasses.fields(tfg)
        if isinstance(getattr(tfg, f.name), torch.Tensor)
        and getattr(tfg, f.name).is_floating_point()})
    d = {k: v.to(dev, dtype) for k, v in td.items()}
    w = {k: v.to(dev, dtype) for k, v in tw.items()}
    st = hyper_cuda.hyper_statics(fg)
    got1 = hyper_cuda.nu4_pass1(d, fg, st)
    got2 = hyper_cuda.nu4_pass2(d, w, *NU, DT, fg, st)
    torch.cuda.synchronize()
    want1 = hyper_cuda.nu4_pass1_plain(d, fg, st)
    want2 = hyper_cuda.nu4_pass2_plain(d, w, *NU, DT, fg, st)
    for k in FIELDS:
        assert float((got1[k] - want1[k]).abs().max()
                     / want1[k].abs().max()) <= tol, k
        assert float((got2[k] - want2[k]).abs().max()
                     / (want2[k] - d[k]).abs().max()) <= tol, k
