"""IMEX-ARK on the port's z-first engine against the JAX package, float64 on
the CPU: ``fast.make_fast_imex_step`` for ARS222, ARS232, ARK232 and GARK2
(``tests/test_torch_imex_ars3.py`` has the four four-stage schemes), 2
steps from the UMJS start at ne2 p4 nz6, with both vertical solvers (the
fused implicit kernel's plain version and the banded solve), 1e-11
relative per field; ``fast_imex_supported`` against JAX's on a grid of
configurations (no compile); the path's kernel wrappers; the entry point's
device.  JAX's step runs ``vertical_solver="banded"``, as JAX's own test
does.  Each JAX step is compiled once for the module."""

import numpy as np
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.fast import engine as j_engine
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.fast import (engine as t_engine, dss_cuda,
                                         hyper_cuda, implicit_cuda,
                                         implicit as t_implicit)
from tempestmodel_tpu_torch.kernels.counts import launch_counts
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.timestep import imex as t_imex

from torch_port_common import CPU, FIELDS, ImexRuns, assert_imex_close

SCHEMES = ("ars222", "ars232", "ark232", "gark2")


@pytest.fixture(scope="module")
def runs():
    return ImexRuns()


@pytest.mark.parametrize("solver", ["pallas", "banded"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_two_imex_steps_match_jax(runs, scheme, solver):
    assert_imex_close(runs.torch(scheme, solver), runs.jax(scheme),
                      runs.start)


def test_the_dss_groupings_give_the_same_bits(runs):
    """``dss_merge=("state",)`` (every stage's DSS and the tail's through
    ``dss_state``) and ``()`` (four launches a DSS) against the default:
    the same bits."""
    want = runs.torch("gark2")
    for merge in (("state",), (), ("state", "scalar2")):
        got = runs.torch("gark2", dss_merge=merge)
        for k in FIELDS:
            assert torch.equal(got[k], want[k]), (merge, k)


def test_the_tableaux_are_the_jax_packages():
    from tempestmodel_tpu.timestep import imex as j_imex
    for name in t_engine.IMEX_SCHEMES:
        if name == "gark2":
            continue
        want = j_imex._tableaux(tj.TimestepSchemeType(name))
        got = t_imex._tableaux(tt.TimestepSchemeType(name))
        assert got == want, name
    with pytest.raises(ValueError):
        t_imex._tableaux(tt.TimestepSchemeType.STRANG)
    assert t_fast.IMEX_SCHEMES == j_engine.IMEX_SCHEMES


# ---------------------------------------------------------------------------
# the envelope
# ---------------------------------------------------------------------------

GRIDS = ("sphere", "periodic", "noflux")
SOLVERS = ("banded", "pallas", "dense")


@pytest.fixture(scope="module")
def envelope_geometries():
    """(jcfg, jgeom, tcfg, tgeom) per grid of the envelope grid: the cubed
    sphere at ne2, and a 3-D plane periodic and with no-flux walls along x
    (small; no step is made)."""
    out = {}
    for grid in GRIDS:
        kw = dict(order=4, nz=4, ztop=10000.0)
        if grid == "sphere":
            jc = tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE, ne=2,
                                **kw)
            tc = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, ne=2,
                                **kw)
            out[grid] = (jc, j_nh.build_nh_sphere_geometry(jc), tc,
                         t_nh.build_nh_sphere_geometry(tc))
            continue
        kw.update(nex=2, ney=2, x_extent=(0.0, 4000.0), y_extent=(0.0, 4000.0))
        jc = tj.ModelConfig(grid_kind=tj.GridKind.CARTESIAN_3D, **kw)
        tc = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_3D, **kw)
        bc = "periodic" if grid == "periodic" else "noflux"
        out[grid] = (jc, j_nh.build_nh_cartesian_geometry(jc, bc_x=bc), tc,
                     t_nh.build_nh_cartesian_geometry(tc, bc_x=bc))
    return out


ENVELOPE = [(s, tr, g, v) for s in t_engine.IMEX_SCHEMES + ("strang",)
            for tr in (False, True) for g in GRIDS for v in SOLVERS]


@pytest.mark.parametrize("scheme,tracers,grid,solver", ENVELOPE, ids=[
    f"{s}-{'tracers' if tr else 'dry'}-{g}-{v}" for s, tr, g, v in ENVELOPE])
def test_fast_imex_supported_is_the_jax_packages(envelope_geometries, scheme,
                                                  tracers, grid, solver):
    jc, jg, tc, tg = envelope_geometries[grid]
    jc = jc.with_(timescheme=tj.TimestepSchemeType(scheme),
                  vertical_solver=solver)
    tc = tc.with_(timescheme=tt.TimestepSchemeType(scheme),
                  vertical_solver=solver)
    want = j_engine.fast_imex_supported(jc, has_tracers=tracers, geom=jg)
    got = t_engine.fast_imex_supported(tc, has_tracers=tracers, geom=tg)
    assert got == want
    assert got == (scheme != "strang" and not tracers and grid != "noflux"
                   and solver != "dense")


def test_make_fast_imex_step_refuses_what_the_envelope_does_not_take(
        envelope_geometries):
    _, _, tc, tg = envelope_geometries["noflux"]
    with pytest.raises(NotImplementedError):
        t_fast.make_fast_imex_step(
            tc.with_(timescheme=tt.TimestepSchemeType.ARS343), tg,
            device=CPU)
    _, _, tc, tg = envelope_geometries["sphere"]
    with pytest.raises(NotImplementedError):
        t_fast.make_fast_imex_step(tc, tg, device=CPU)     # Strang


def test_the_entry_point_needs_a_cuda_device_unless_cpu_is_named(
        envelope_geometries):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    _, _, tc, tg = envelope_geometries["sphere"]
    cfg = tc.with_(timescheme=tt.TimestepSchemeType.ARS343)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_fast.make_fast_imex_step(cfg, tg)
    assert callable(t_fast.make_fast_imex_step(cfg, tg, device="cpu"))


# ---------------------------------------------------------------------------
# the path's kernel wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge,scheme,want", [
    (None, "ars343", {"state": 0, "vector": 6, "scalar": 6, "scalar2": 6,
                      "update": 3, "banded": 0, "pass1": 1, "pass2": 1}),
    (("state",), "ars343", {"state": 6, "vector": 0, "scalar": 0,
                            "scalar2": 0, "update": 3, "banded": 0,
                            "pass1": 1, "pass2": 1}),
    (("state",), "gark2", {"state": 5, "vector": 0, "scalar": 0,
                           "scalar2": 0, "update": 2, "banded": 0,
                           "pass1": 1, "pass2": 1})],
    ids=["default-ars343", "state-ars343", "state-gark2"])
def test_an_imex_step_goes_through_the_wrappers(runs, monkeypatch, merge,
                                                scheme, want):
    """Calls of the kernels' wrappers in one IMEX step (on the CPU each runs
    its plain version): a DSS a stage and two in the tail, grouped as
    ``dss_merge`` says (``DSS_MERGE_DEFAULT`` by default), one fused implicit
    update a stage with an implicit part (one Newton iteration), the two nu4
    passes; no fused stage kernel, no launch on CPU tensors."""
    if merge is None and "state" in t_engine.DSS_MERGE_DEFAULT:
        merge = t_engine.DSS_MERGE_DEFAULT
        want = dict(want, state=6, vector=0, scalar=0, scalar2=0)
    calls = dict.fromkeys(want, 0)
    calls["stage"] = 0

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    from tempestmodel_tpu_torch.fast import stage_cuda
    monkeypatch.setattr(stage_cuda, "fused_stage",
                        counting("stage", stage_cuda.fused_stage))
    monkeypatch.setattr(implicit_cuda, "fused_implicit_update", counting(
        "update", implicit_cuda.fused_implicit_update))
    monkeypatch.setattr(t_implicit, "banded_solve",
                        counting("banded", t_implicit.banded_solve))
    for key, fname in (("pass1", "nu4_pass1"), ("pass2", "nu4_pass2")):
        monkeypatch.setattr(hyper_cuda, fname,
                            counting(key, getattr(hyper_cuda, fname)))
    for key in ("scalar", "vector", "state", "scalar2"):
        monkeypatch.setattr(dss_cuda, f"dss_{key}",
                            counting(key, getattr(dss_cuda, f"dss_{key}")))
    cfg = runs.configs(scheme)[1].with_(vertical_solver="pallas",
                                        newton_iterations=1)
    step = t_fast.make_fast_imex_step(cfg, runs.tgeom, device=CPU,
                                      dss_merge=merge)
    s = {k: torch.from_numpy(v.copy()) for k, v in runs.start.items()}
    before = dict(launch_counts)
    out = step(s)
    assert calls == dict(want, stage=0)
    assert dict(launch_counts) == before          # CPU tensors: no launch
    for k in FIELDS:                              # the input is left alone
        assert np.array_equal(s[k].numpy(), runs.start[k]), k
        assert out[k].shape == s[k].shape
