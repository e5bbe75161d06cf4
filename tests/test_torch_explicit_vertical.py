"""The fully explicit vertical path on the port's z-first engine against
the JAX package, float64 on the CPU (``upwind_thermo=False`` is in
``test_torch_upwind_thermo.py``).

The explicit path (``explicit_vertical=True``, or ``timescheme`` ERK; JAX
``timestep/strang.py``'s explicit branch): every RK stage adds the
vertical tendency (minus the implicit residual with no time term), there
is no implicit solve and no carry, and on a no-flux grid no halo (the DSS
averages no wall).  3 steps of ``make_fast_step``, fused and unfused,
against 3 steps of JAX ``nh_model.make_nh_step``, 1e-11 relative per field:
KGU(3,5) on the inertia-gravity wave at test scale (nex 10, nz 10, dt
0.5 s, the golden's configuration), on UMJS at ne2 p4 nz6 at a vertically
stable dt (10 s; nz 6 under 30 km: 5 km layers) and on the Straka density
current on its walls (nex 4, nz 8, dt 0.1 s, nu2 300/300, sponges); SSPRK3
on the inertia-gravity wave.

Each JAX step compiles once, at first use (about 25 s a case).  V of an
x-z slice carries roundoff only: U and V are measured against their common
scale."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases import nonhydro_xz as j_xz
from tempestmodel_tpu.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as JaxUMJS)
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz

from torch_port_common import CPU, FIELDS
import test_torch_vertical_solvers as solvers

STEPS = 3

CASES = {
    "igw": dict(case="InertiaGravityWave", kind="CARTESIAN_XZ", nex=10,
                nz=10, dt=0.5, hyper=False, bc={}),
    "umjs": dict(case=None, kind="CUBED_SPHERE", ne=2, nz=6, dt=10.0,
                 hyper=True),
    "density_current": dict(case="DensityCurrent", kind="CARTESIAN_XZ",
                            nex=4, nz=8, dt=0.1, hyper=False, nu2=300.0,
                            bc=dict(bc_x="noflux")),
}


def _configs(name, scheme, **over):
    """(jcfg, tcfg, jgeom, tgeom, start, ref): case ``name`` with the
    explicit vertical path and ``scheme``; JAX's initial (and reference)
    state as numpy arrays."""
    c = CASES[name]
    common = dict(explicit_vertical=True, dt=c["dt"], order=4, nz=c["nz"],
                  hyperdiffusion=c["hyper"], vertical_solver="banded")
    common.update(over)
    if c["kind"] == "CUBED_SPHERE":
        jtc = JaxUMJS(pert="exp")
        kw = dict(common, ne=c["ne"], ztop=jtc.ztop, nu_scalar=1e15,
                  nu_div=1e15, nu_vort=1e15)
    else:
        jtc = getattr(j_xz, c["case"])()
        kw = dict(common, nex=c["nex"], ney=1, ztop=jtc.ztop,
                  x_extent=jtc.x_extent, y_extent=jtc.y_extent,
                  nu_uniform_scalar=c.get("nu2", 0.0),
                  nu_uniform_vector=c.get("nu2", 0.0),
                  rayleigh_damping=bool(c.get("nu2")))
    jcfg = tj.ModelConfig(grid_kind=getattr(tj.GridKind, c["kind"]),
                          dtype=jnp.float64,
                          explicit_scheme=tj.ExplicitSubScheme(scheme), **kw)
    tcfg = tt.ModelConfig(grid_kind=getattr(tt.GridKind, c["kind"]),
                          dtype=torch.float64,
                          explicit_scheme=tt.ExplicitSubScheme(scheme), **kw)
    ref = None
    if c["kind"] == "CUBED_SPHERE":
        jgeom = j_nh.build_nh_sphere_geometry(jcfg, ztop=jtc.ztop)
        tgeom = t_nh.build_nh_sphere_geometry(tcfg, ztop=jtc.ztop)
    else:
        rayl = getattr(jtc, "rayleigh_strength", None) if c.get("nu2") \
            else None
        jgeom = j_nh.build_nh_cartesian_geometry(jcfg, ztop=jtc.ztop,
                                                 rayleigh=rayl, **c["bc"])
        trayl = getattr(getattr(t_xz, c["case"])(), "rayleigh_strength",
                        None) if c.get("nu2") else None
        tgeom = t_nh.build_nh_cartesian_geometry(tcfg, ztop=jtc.ztop,
                                                 rayleigh=trayl, **c["bc"])
        if hasattr(jtc, "reference_state"):
            ref = {k: np.asarray(v) for k, v in
                   jtc.reference_state(jgeom, jcfg.constants).items()}
    start = {k: np.asarray(v) for k, v in
             jtc.initial_state(jgeom, jcfg.constants).items()}
    return jcfg, tcfg, jgeom, tgeom, start, ref


def _jax_steps(jcfg, jgeom, start, ref):
    first, step = j_nh.make_nh_step(
        jcfg, jgeom, ref_state=None if ref is None else
        {k: jnp.asarray(v) for k, v in ref.items()})
    s, c = first({k: jnp.asarray(v) for k, v in start.items()})
    for _ in range(STEPS - 1):
        s, c = step(s, c)
    return {k: np.asarray(v) for k, v in s.items()}


def _port_steps(tcfg, tgeom, start, ref, **kw):
    first, step = t_fast.make_fast_step(
        tcfg, tgeom, device=CPU, ref_state=None if ref is None else
        {k: torch.from_numpy(v.copy()) for k, v in ref.items()}, **kw)
    d, c = first(t_fast.pack_state(
        {k: torch.from_numpy(v.copy()) for k, v in start.items()},
        device=CPU))
    assert c == {}
    for _ in range(STEPS - 1):
        d, c = step(d, c)
        assert c == {}
    return {k: v.numpy() for k, v in t_fast.unpack_state(d).items()}


@pytest.fixture(scope="module")
def runs():
    """JAX's 3 steps per (case, scheme), computed at first use."""
    cache = {}

    def get(name, scheme):
        if (name, scheme) not in cache:
            cfgs = _configs(name, scheme)
            cache[name, scheme] = cfgs, _jax_steps(cfgs[0], cfgs[2],
                                                   cfgs[4], cfgs[5])
        return cache[name, scheme]
    return get


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name,scheme", [
    ("igw", "kgu35"), ("umjs", "kgu35"), ("density_current", "kgu35"),
    ("igw", "ssprk3")])
def test_explicit_vertical_steps_match_make_nh_step(runs, name, scheme,
                                                    fused):
    (jcfg, tcfg, jgeom, tgeom, start, ref), want = runs(name, scheme)
    got = _port_steps(tcfg, tgeom, start, ref, fused=fused)
    solvers.assert_steps_close(got, want, start)


def test_erk_is_the_explicit_vertical_path(runs):
    """``timescheme=ERK`` runs the same step as ``explicit_vertical=True``,
    bit for bit; the predicates take both (and refuse tracers there), and
    the IMEX family takes neither."""
    (jcfg, tcfg, jgeom, tgeom, start, ref), _ = runs("igw", "kgu35")
    erk = tcfg.with_(explicit_vertical=False,
                     timescheme=tt.TimestepSchemeType.ERK)
    a = _port_steps(tcfg, tgeom, start, ref)
    b = _port_steps(erk, tgeom, start, ref)
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k], k)
    for cfg in (tcfg, erk):
        assert t_engine.fast_engine_supported(cfg, geom=tgeom)
        assert not t_engine.fast_engine_supported(cfg, has_tracers=True,
                                                  geom=tgeom)
    strang = tcfg.with_(explicit_vertical=False)
    assert t_engine.fast_engine_supported(strang, has_tracers=True,
                                          geom=tgeom)
    for over in (dict(explicit_vertical=True), dict(upwind_thermo=False),
                 dict(vertical_solver="dense"), dict(vertical_solver="schur"),
                 dict(vertical_solver="jfnk")):
        imex = strang.with_(timescheme=tt.TimestepSchemeType.ARS343, **over)
        assert not t_engine.fast_imex_supported(imex, geom=tgeom), over
    assert t_engine.fast_imex_supported(
        strang.with_(timescheme=tt.TimestepSchemeType.ARS343), geom=tgeom)
