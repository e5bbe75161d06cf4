"""The port against the C++ reference's golden state dumps
(``tests/golden/``), float64 on the CPU, with the configurations and bars
of ``tests/test_reference_parity.py``: the UMJS wave over 1000 steps (the
north star) and over 10 from its balanced state (the reference Jacobian),
the thermal bubble with and without nu4, the inertia-gravity wave (FE, FV
at vertical order 2, the cubic stretch) and the shear jet over the Schar
mountain.  Each run is the port's own: its test cases, its ``make_nh_step``
on the kernels' plain versions; no JAX step runs.  The golden tests of the
other port files cover ``densitycurrent``, ``igw_expvert``,
``jw_l10_nothermoupwind``, ``swtc2``, ``swtc2_hv`` and ``umjs_hs10``."""

import numpy as np
import pytest
import torch

import tempestmodel_tpu_torch as tt
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz
from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS)

from test_reference_parity import assert_state_close, load_golden
from torch_port_common import CPU

pytestmark = pytest.mark.slow


def _steps(cfg, geom, s0, nsteps, ref=None):
    """``nsteps`` steps of the port's ``make_nh_step`` (numpy out)."""
    first, step = t_nh.make_nh_step(cfg, geom, ref_state=ref, device=CPU)
    s, c = first(s0)
    for _ in range(nsteps - 1):
        s, c = step(s, c)
    return {k: v.numpy() for k, v in s.items()}


def _xz(tc, **kw):
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ, ney=1, order=4,
                         ztop=tc.ztop, x_extent=tc.x_extent,
                         y_extent=tc.y_extent, hyperdiffusion=False,
                         dtype=torch.float64, **kw)
    return cfg


def _sphere_close(s, patches, tols, tol_w):
    node = np.stack([p["node"] for p in patches])
    redge = np.stack([p["redge"] for p in patches])
    for name, c in (("U", 0), ("V", 1), ("Rt", 2), ("Rho", 4)):
        ref = node[:, c]
        rel = np.abs(ref - s[name]).max() / max(np.abs(ref).max(), 1e-30)
        assert rel < tols[name], f"{name}: rel {rel:.3e}"
    ref_w = redge[:, 3]
    rel = np.abs(ref_w - s["W"]).max() / np.abs(ref_w).max()
    assert rel < tol_w, f"W: rel {rel:.3e}"


def _umjs(pert):
    tc = BaroclinicWaveUMJS(pert=pert)
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, ne=4, order=4,
                         nz=24, ztop=30000.0, dt=50.0, hyperdiffusion=True,
                         nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                         jacobian_mode="reference", vertical_solver="pallas",
                         dtype=torch.float64)
    geom = t_nh.build_nh_sphere_geometry(cfg, ztop=30000.0)
    return tc, cfg, geom


def test_parity_umjs_1000step():
    """``umjs_pert_1000``: 1000 steps of the perturbed wave, 1e-9."""
    tc, cfg, geom = _umjs("exp")
    s = _steps(cfg, geom, tc.initial_state(geom, cfg.constants, device=CPU),
               1000)
    _sphere_close(s, load_golden("umjs_pert_1000.bin.gz"),
                  dict(U=1e-9, V=1e-9, Rt=1e-9, Rho=1e-9), 1e-9)


def test_parity_umjs_sphere():
    """``umjs_l24``: 10 steps from the balanced state."""
    tc, cfg, geom = _umjs("none")
    s = _steps(cfg, geom, tc.reference_state(geom, cfg.constants,
                                             device=CPU), 10)
    _sphere_close(s, load_golden("umjs_l24.bin.gz"),
                  dict(U=1e-12, V=1e-12, Rt=1e-13, Rho=1e-13), 1e-9)


@pytest.mark.parametrize("golden,nu", [("bubble.bin.gz", 0.0),
                                       ("bubble_hv.bin.gz", 1.0e7)])
def test_parity_thermal_bubble(golden, nu):
    tc = t_xz.ThermalBubble()
    cfg = _xz(tc, nex=12, nz=24, dt=0.05).with_(
        hyperdiffusion=nu > 0, nu_scalar=nu, nu_div=nu, nu_vort=nu)
    geom = t_nh.build_nh_cartesian_geometry(cfg)
    s = _steps(cfg, geom, tc.initial_state(geom, cfg.constants, device=CPU),
               20)
    assert_state_close(s, load_golden(golden)[0])


@pytest.mark.parametrize("golden,kw,nsteps,tols", [
    ("igw.bin.gz", dict(nz=10), 20, (3e-5, 5e-3)),
    ("igw_fv_vo2.bin.gz", dict(nz=20, vertical_order=2,
                               vertical_discretization="FV",
                               vertical_solver="banded"), 10, (1e-5, 2e-3)),
    ("igw_stretch_cubic.bin.gz", dict(nz=10, vertical_stretch="cubic"), 10,
     (3e-3, 6e-2))], ids=["fe", "fv_vo2", "stretch_cubic"])
def test_parity_inertia_gravity(golden, kw, nsteps, tols):
    tc = t_xz.InertiaGravityWave()
    cfg = _xz(tc, nex=10, dt=1.0, **kw)
    geom = t_nh.build_nh_cartesian_geometry(cfg)
    s = _steps(cfg, geom, tc.initial_state(geom, cfg.constants, device=CPU),
               nsteps)
    assert_state_close(s, load_golden(golden)[0], rtol_scalar=tols[0],
                       rtol_vel=tols[1])


def test_parity_shearjet_mountain():
    tc = t_xz.ShearJetMountainWave()
    cfg = _xz(tc, nex=40, nz=20, dt=0.1, rayleigh_damping=True)
    geom = t_nh.build_nh_cartesian_geometry(
        cfg, topography=tc.topography, rayleigh=tc.rayleigh_strength)
    s = _steps(cfg, geom, tc.initial_state(geom, cfg.constants, device=CPU),
               20, ref=tc.reference_state(geom, cfg.constants, device=CPU))
    assert_state_close(s, load_golden("shearjet.bin.gz")[0],
                       rtol_scalar=5e-5, rtol_vel=2e-3)
