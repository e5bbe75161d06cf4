"""No-flux grids and uniform (nu2) diffusion on the port's z-first engine
vs the JAX package's reference-layout step (``nh_model.make_nh_step``),
float64 on the CPU, 3 steps (fused and unfused), 1e-11 relative per field:
the Straka density current under the four explicit schemes other than
KGU35, and UMJS on the cubed sphere with nu2 against its unperturbed
reference (``test_torch_noflux`` has the density current and the channel
under KGU35)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as JaxUMJS)
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as TorchUMJS)

from torch_port_common import CPU, FIELDS
from test_torch_noflux import (STEPS, TOL, _configs, _errors, _jax_steps,
                               _port_steps)


@pytest.mark.parametrize("scheme", ["fe", "rk4", "ssprk3", "ssprk53"])
def test_other_schemes_on_the_density_current(scheme):
    jtc, ttc, jcfg, tcfg, jgeom, tgeom = _configs("density_current", scheme)
    want = _jax_steps(jtc, jcfg, jgeom)
    for fused in (True, False):
        got, _ = _port_steps(ttc, tcfg, tgeom, fused=fused)
        errs = _errors(got, want)
        assert max(errs.values()) < TOL, (fused, errs)


def test_sphere_with_nu2_matches_jax():
    """Uniform diffusion on the cubed sphere (UMJS, ne2 p4 nz6, nu2 1e5
    against the unperturbed reference), fused and unfused, against the JAX
    reference-layout step."""
    kw = dict(ne=2, order=4, nz=6, ztop=30000.0, dt=200.0,
              hyperdiffusion=True, nu_scalar=1e15, nu_div=1e15,
              nu_vort=1e15, nu_uniform_scalar=1e5, nu_uniform_vector=1e5,
              rayleigh_damping=True)
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE,
                          vertical_solver="banded", dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE,
                          vertical_solver="pallas", dtype=torch.float64, **kw)
    jgeom = j_nh.build_nh_sphere_geometry(jcfg, ztop=jcfg.ztop)
    tgeom = t_nh.build_nh_sphere_geometry(tcfg, ztop=tcfg.ztop)
    jtc, ttc = JaxUMJS(pert="exp"), TorchUMJS(pert="exp")
    js = jtc.initial_state(jgeom, jcfg.constants)
    jref = JaxUMJS(pert="none").initial_state(jgeom, jcfg.constants)
    first, step = j_nh.make_nh_step(jcfg, jgeom, ref_state=jref)
    s, c = first(js)
    for _ in range(STEPS - 1):
        s, c = step(s, c)
    want = {k: np.asarray(v) for k, v in s.items()}
    ts = ttc.initial_state(tgeom, tcfg.constants, device=CPU)
    tref = TorchUMJS(pert="none").initial_state(tgeom, tcfg.constants,
                                                device=CPU)
    for fused in (True, False):
        f1, st = t_fast.make_fast_step(tcfg, tgeom, ref_state=tref,
                                       device=CPU, fused=fused)
        d, carry = f1(t_fast.pack_state(ts, device=CPU))
        for _ in range(STEPS - 1):
            d, carry = st(d, carry)
        assert not any(k.startswith("halo_") for k in carry)
        got = {k: v.numpy() for k, v in t_fast.unpack_state(d).items()}
        for k in FIELDS:
            e = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
            assert e < TOL, (fused, k, e)
