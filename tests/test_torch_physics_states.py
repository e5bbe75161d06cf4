"""The DCMIP2016 tropical cyclone's and supercell's initial and reference
states of the port against the JAX package's on the cubed sphere (ne2 p4
nz6; the supercell on its reduced, non-rotating planet), float64 on the
CPU, to 1e-12 relative (``test_torch_physics.close``).  (The physics
updates are in ``test_torch_physics.py``.)"""

import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases import dcmip2016 as j_dcmip
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases import dcmip2016 as t_dcmip

from torch_port_common import CPU
from test_torch_physics import close


def _sphere(ne, nz, ztop, constants=None):
    kw = {} if constants is None else {"constants": constants}
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE, ne=ne, order=4,
                          nz=nz, ztop=ztop, dtype=jnp.float64,
                          **({"constants": tj.constants.PhysicalConstants(
                              **vars(constants))} if constants else {}))
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, ne=ne,
                          order=4, nz=nz, ztop=ztop, dtype=torch.float64,
                          **kw)
    return (jcfg, j_nh.build_nh_sphere_geometry(jcfg, ztop=ztop),
            tcfg, t_nh.build_nh_sphere_geometry(tcfg, ztop=ztop))


@pytest.mark.parametrize("which", ["initial", "reference"])
def test_tropical_cyclone_states_match_jax(which):
    jtc, ttc = j_dcmip.TropicalCyclone(), t_dcmip.TropicalCyclone()
    jcfg, jgeom, tcfg, tgeom = _sphere(2, 6, jtc.ztop)
    want = getattr(jtc, f"{which}_state")(jgeom, jcfg.constants)
    got = getattr(ttc, f"{which}_state")(tgeom, tcfg.constants, device=CPU)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    if which == "initial":
        assert float(got["U"].abs().max()) > 0.0           # the vortex
        assert got["Tracers"].shape == (3, 6, 8, 8, 6)


@pytest.mark.parametrize("which", ["initial", "reference"])
def test_supercell_states_match_jax(which):
    jsc, tsc = j_dcmip.Supercell(), t_dcmip.Supercell()
    tconst = tsc.constants_override(tt.ModelConfig().constants)
    jconst = jsc.constants_override(tj.ModelConfig().constants)
    assert tconst.earth_radius == jconst.earth_radius and tconst.omega == 0.0
    jcfg, jgeom, tcfg, tgeom = _sphere(2, 6, jsc.ztop, constants=tconst)
    want = getattr(jsc, f"{which}_state")(jgeom, jconst)
    got = getattr(tsc, f"{which}_state")(tgeom, tconst, device=CPU)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
