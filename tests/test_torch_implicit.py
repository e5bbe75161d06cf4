"""The port's vertical implicit solve vs the JAX package's, on the same
z-first geometry and state (both carried across as numpy), float64."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu.fast import engine as j_engine, implicit as j_imp
from tempestmodel_tpu.models import nonhydro as j_nonhydro
from tempestmodel_tpu_torch.fast import implicit as t_imp
from tempestmodel_tpu_torch.models import nonhydro as t_nonhydro
from tempestmodel_tpu_torch import convert

from torch_port_common import (build_pair, CPU, fast_geometry_fields_numpy,
                               perturbed_umjs_state, rel_err)

TOL = 1e-12
DT = 100.0


@pytest.fixture(scope="module")
def setup():
    jcfg, jgeom, tcfg, tgeom = build_pair()
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    tfg = convert.fast_geometry_from_numpy(
        fast_geometry_fields_numpy(jfg), device=CPU, dtype=torch.float64)
    q = j_nonhydro.estimate_bandwidth(jgeom, jcfg.constants)
    jst = j_nonhydro.band_assembly_statics(jgeom, q)
    tst = t_imp.statics_to_device(
        t_nonhydro.band_assembly_statics(tgeom, q), torch.float64, CPU)
    d = perturbed_umjs_state(jcfg, jgeom, seed=3)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, jfg=jfg, tfg=tfg, q=q, jst=jst,
                tst=tst, jd=jd, td=td, d=d)


def _perturbed(parts, xp):
    """A second iterate distinct from x0, so the time term is exercised."""
    return tuple(p * 1.001 for p in parts)


def test_residual_lor(setup):
    s = setup
    jx0, jaux = j_imp._prep_aux(s["jd"], s["jfg"])
    tx0, taux = t_imp._prep_aux(s["td"], s["tfg"])
    jf = j_imp.residual_lor(_perturbed(jx0, jnp), jx0, jaux, s["jfg"],
                            s["jcfg"].constants, DT)
    tf = t_imp.residual_lor(_perturbed(tx0, torch), tx0, taux, s["tfg"],
                            s["tcfg"].constants, DT)
    for a, b, name in zip(jf, tf, ("f_rt", "f_w", "f_rho")):
        assert rel_err(b.numpy(), a) < TOL, name
    for k, v in s["td"].items():            # arguments are left alone
        np.testing.assert_array_equal(v.numpy(), s["d"][k])


@pytest.mark.parametrize("ref_jacobian", [False, True])
def test_assemble_bands(setup, ref_jacobian):
    s = setup
    jx0, jaux = j_imp._prep_aux(s["jd"], s["jfg"])
    tx0, taux = t_imp._prep_aux(s["td"], s["tfg"])
    jb = j_imp.assemble_bands(jx0, jaux, s["jfg"], s["jst"],
                              s["jcfg"].constants, DT,
                              ref_jacobian=ref_jacobian)
    tb = t_imp.assemble_bands(tx0, taux, s["tfg"], s["tst"],
                              s["tcfg"].constants, DT,
                              ref_jacobian=ref_jacobian)
    assert tuple(tb.shape) == jb.shape == (3 * 8 + 1, 2 * s["q"] + 1,
                                           6 * 16 * 16)
    assert tb.is_contiguous()
    jb = np.asarray(jb)
    scale = np.abs(jb).max(axis=(0, 2), keepdims=True)
    assert np.max(np.abs(tb.numpy() - jb) / scale) < TOL


def test_interleave_round_trip(setup):
    rng = np.random.default_rng(5)
    nz = 8
    parts = (rng.standard_normal((nz, 7)), rng.standard_normal((nz + 1, 7)),
             rng.standard_normal((nz, 7)))
    jf = j_imp._interleave(*(jnp.asarray(p) for p in parts), nz)
    tf = t_imp._interleave(*(torch.from_numpy(p) for p in parts), nz)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for a, b in zip(t_imp._deinterleave(tf, nz), parts):
        np.testing.assert_array_equal(a.numpy(), b)
    sh = t_imp._shift_rows(torch.from_numpy(parts[1]), -1, nz)
    np.testing.assert_array_equal(
        sh.numpy(), np.asarray(j_imp._shift_rows(jnp.asarray(parts[1]), -1,
                                                 nz)))


@pytest.mark.parametrize("ref_jacobian,iters", [(False, 1), (True, 1),
                                                (False, 2)])
def test_vertical_implicit(setup, ref_jacobian, iters):
    s = setup
    jout = j_imp.vertical_implicit(
        s["jd"], s["jfg"], s["jcfg"].constants, DT, s["q"], s["jst"],
        newton_iters=iters, use_pallas=False, ref_jacobian=ref_jacobian)
    tout = t_imp.vertical_implicit(
        s["td"], s["tfg"], s["tcfg"].constants, DT, s["q"], s["tst"],
        newton_iters=iters, use_pallas=True, ref_jacobian=ref_jacobian)
    for k in ("U", "V", "Rt", "W", "Rho"):
        assert rel_err(tout[k].numpy(), jout[k]) < TOL, k
    # the plain switch takes the same arithmetic on the CPU
    tplain = t_imp.vertical_implicit(
        s["td"], s["tfg"], s["tcfg"].constants, DT, s["q"], s["tst"],
        newton_iters=iters, use_pallas=True, ref_jacobian=ref_jacobian,
        plain=True)
    for k in ("Rt", "W", "Rho"):
        assert torch.equal(tplain[k], tout[k])
