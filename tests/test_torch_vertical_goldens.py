"""The port's explicit vertical path and ``upwind_thermo=False`` against the
C++ reference's golden state dumps (``tests/golden/``), float64 on the CPU,
within the bars of ``tests/test_reference_parity.py``: the inertia-gravity
wave on the fully explicit path (``igw_expvert.bin.gz``, 10 steps at dt
0.5 s; ``:568-588``) and the Jablonowski-Williamson wave over its terrain
with the implicit Rt/Rho upwind penalty off (``jw_l10_nothermoupwind.bin.gz``,
ne4 p4 nz10, 10 steps at dt 50 s, the reference Jacobian; ``:357-407``).
Every state is the port's own (its test cases, its ``make_fast_step``); no
JAX step runs."""

import numpy as np
import pytest
import torch

import tempestmodel_tpu_torch as tt
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases.nonhydro_sphere import BaroclinicWaveJW
from tempestmodel_tpu_torch.testcases.nonhydro_xz import InertiaGravityWave

from test_reference_parity import assert_state_close, load_golden
from torch_port_common import CPU

pytestmark = pytest.mark.slow


def _run(cfg, geom, s0, nsteps):
    first, step = t_fast.make_fast_step(cfg, geom, device=CPU)
    d, c = first(t_fast.pack_state(s0, device=CPU))
    for _ in range(nsteps - 1):
        d, c = step(d, c)
    return {k: v.numpy() for k, v in t_fast.unpack_state(d).items()}


def test_parity_igw_explicit_vertical():
    golden = load_golden("igw_expvert.bin.gz")[0]
    tc = InertiaGravityWave()
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ, nex=10, ney=1,
                         order=4, nz=10, ztop=tc.ztop, x_extent=tc.x_extent,
                         y_extent=tc.y_extent, dt=0.5, hyperdiffusion=False,
                         explicit_vertical=True, dtype=torch.float64)
    geom = t_nh.build_nh_cartesian_geometry(cfg)
    s = _run(cfg, geom, tc.initial_state(geom, cfg.constants, device=CPU),
             10)
    assert_state_close(s, golden, rtol_scalar=2e-6, rtol_vel=1e-3)


def test_parity_jw_sphere_no_thermo_upwind():
    patches = load_golden("jw_l10_nothermoupwind.bin.gz")
    node_ref = np.stack([p["node"] for p in patches])
    redge_ref = np.stack([p["redge"] for p in patches])
    tc = BaroclinicWaveJW(pert="exp", ztop=30000.0)
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, ne=4, order=4,
                         nz=10, ztop=30000.0, dt=50.0, hyperdiffusion=True,
                         nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                         jacobian_mode="reference", upwind_thermo=False,
                         vertical_solver="pallas", dtype=torch.float64)
    geom = t_nh.build_nh_sphere_geometry(
        cfg, ztop=30000.0,
        topography=lambda lon, lat: tc.topography(lon, lat, cfg.constants))
    s = _run(cfg, geom, tc.initial_state(geom, cfg.constants,
                                         dtype=torch.float64, device=CPU),
             10)
    for name, c, tol in (("U", 0, 3e-9), ("V", 1, 3e-9),
                         ("Rt", 2, 1e-11), ("Rho", 4, 1e-11)):
        ref = node_ref[:, c]
        rel = np.abs(ref - s[name]).max() / max(np.abs(ref).max(), 1e-30)
        assert rel < tol, f"{name}: rel {rel:.3e}"
    ref_w = redge_ref[:, 3]
    rel = np.abs(ref_w - s["W"]).max() / np.abs(ref_w).max()
    assert rel < 2e-7, f"W: rel {rel:.3e}"
