"""The port never imports jax or the JAX package, and its entry points
refuse to run without a CUDA device unless the caller asks for the CPU."""

import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tempestmodel_tpu_torch as tt

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _module_names():
    names = ["tempestmodel_tpu_torch"]
    for m in pkgutil.walk_packages(tt.__path__, "tempestmodel_tpu_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax():
    names = _module_names()
    assert len(names) > 15
    for new in ("fast.stage_cuda", "fast.implicit_cuda", "kernels.stencils",
                "kernels.synthetic", "fast.hyper_cuda", "kernels.tune_tail",
                "fast.tracers", "testcases.dcmip2016", "grid.cartesian",
                "testcases.nonhydro_xz", "timestep.imex", "model", "cli",
                "__main__", "utils.timeobj", "utils.timers",
                "utils.announce", "io.diagnostics", "io.latlon",
                "io.netcdf", "io.arena", "io.output", "ops.sem",
                "models.hyperdiff", "physics.held_suarez",
                "physics.kessler", "physics.dcmip_simple",
                "physics.terminator", "utils.preferences",
                "utils.mountain_waves", "utils.devprof", "utils.postprocess",
                "ops.spacing", "ops.flux_correction"):
        assert f"tempestmodel_tpu_torch.{new}" in names
    code = (
        "import importlib, sys\n"
        f"names = {names!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'tempestmodel_tpu'"
        " or m.startswith('tempestmodel_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean', len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src
    assert "tempestmodel_tpu " not in src and "tempestmodel_tpu." not in src


def test_tf32_is_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_need_a_cuda_device_unless_cpu_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from tempestmodel_tpu_torch import fast
    from tempestmodel_tpu_torch.models import nh_model
    from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS)
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, ne=2, order=4,
                         nz=4, ztop=30000.0, dtype=torch.float64)
    geom = nh_model.build_nh_sphere_geometry(cfg)
    tc = BaroclinicWaveUMJS()
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.initial_state(geom, cfg.constants)
    with pytest.raises(RuntimeError, match="CUDA"):
        fast.build_fast_geometry(geom, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="CUDA"):
        fast.make_fast_step(cfg, geom)
    with pytest.raises(RuntimeError, match="CUDA"):
        fast.make_fast_multistep(cfg, geom, 2)
    state = tc.initial_state(geom, cfg.constants, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fast.pack_state(state)
    X = fast.pack_state(state, device="cpu")
    assert X["W"].shape == (5, 6, 8, 8)
    fg = fast.build_fast_geometry(geom, dtype=torch.float64, device="cpu")
    assert fg.inv_mult.device.type == "cpu"
    # the same on a periodic Cartesian grid
    from tempestmodel_tpu_torch.testcases.nonhydro_xz import ScharMountain
    sc = ScharMountain()
    ccfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ, nex=4, ney=1,
                          order=4, nz=4, x_extent=sc.x_extent, ztop=sc.ztop,
                          dtype=torch.float64)
    cgeom = nh_model.build_nh_cartesian_geometry(
        ccfg, topography=sc.topography)
    with pytest.raises(RuntimeError, match="CUDA"):
        sc.initial_state(cgeom, ccfg.constants)
    with pytest.raises(RuntimeError, match="CUDA"):
        fast.build_fast_geometry_cartesian(cgeom, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="CUDA"):
        fast.make_fast_step(ccfg, cgeom)
    with pytest.raises(RuntimeError, match="CUDA"):
        fast.make_fast_multistep(ccfg, cgeom, 2)
    cfg_ = fast.build_fast_geometry_cartesian(cgeom, dtype=torch.float64,
                                              device="cpu")
    assert cfg_.inv_mult.device.type == "cpu" and cfg_.ab_swapped
    # the driver, the CLI, the checkpoint loader and the DCMIP cases
    from tempestmodel_tpu_torch import cli
    from tempestmodel_tpu_torch.model import Model
    from tempestmodel_tpu_torch.io.output import CompositeCheckpoint
    from tempestmodel_tpu_torch.testcases.dcmip2016 import (
        TropicalCyclone, Supercell)
    mcfg = cfg.with_(equation_set=tt.EquationSet.PRIMITIVE_NONHYDRO)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(mcfg, tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--case", "umjs", "--resolution", "2", "--levels", "4",
                  "--nsteps", "1"])
    m = Model(mcfg, tc, device="cpu")
    assert m.state["U"].device.type == "cpu"
    np_path = tmp_path / "restart.npz"
    np.savez(np_path, state_U=np.zeros(3), time=np.float64(0.0),
             step=np.int64(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        CompositeCheckpoint.load(str(np_path))
    state, carry, t, step = CompositeCheckpoint.load(str(np_path),
                                                     device="cpu")
    assert state["U"].device.type == "cpu" and carry is None
    for case in (TropicalCyclone(), Supercell()):
        with pytest.raises(RuntimeError, match="CUDA"):
            case.initial_state(geom, cfg.constants)
    assert TropicalCyclone().initial_state(
        geom, cfg.constants, device="cpu")["Tracers"].device.type == "cpu"
