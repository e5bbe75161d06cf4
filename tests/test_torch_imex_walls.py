"""The port's IMEX on no-flux grids against the JAX package's
reference-layout ``make_nh_imex_step``, float64 on the CPU, ARS343, 3
steps, 1e-11 relative per field (U and V against their common scale):
the density current (nex 4, nz 8, dt 0.1 s; walls in x, nu2 300, Rayleigh
sponges), the same with two seeded tracer species, and the baroclinic
channel (walls in y, nu4, dt 100 s) of ``test_torch_noflux.CASES``.

JAX's IMEX threads no halo: each stage's DSS and the tail's run without
one, so no wall node is averaged with a lagged shadow (the port's
``apply_dss(halo=None)``), no halo is carried from step to step, and the
uniform diffusion is not applied.  The CLI runs the density current under
``--timescheme ars343`` through ``Model``."""

import numpy as np
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu_torch import cli as t_cli
from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.fast import engine as t_engine

from torch_port_common import CPU, FIELDS
from torch_imex_wide import (assert_imex_matches, jax_imex, port_imex,
                             seeded_tracers)
from test_torch_noflux import _configs

ARS343 = "ars343"


def _imex_configs(case):
    jtc, ttc, jcfg, tcfg, jgeom, tgeom = _configs(case)
    jcfg = jcfg.with_(timescheme=tj.TimestepSchemeType(ARS343))
    tcfg = tcfg.with_(timescheme=tt.TimestepSchemeType(ARS343))
    start = {k: np.asarray(v) for k, v in
             jtc.initial_state(jgeom, jcfg.constants).items()}
    ref = {k: np.asarray(v) for k, v in
           jtc.reference_state(jgeom, jcfg.constants).items()}
    return jcfg, tcfg, jgeom, tgeom, start, ref


@pytest.fixture(scope="module")
def runs():
    """``get(name)``: (tcfg, tgeom, start, ref, JAX's 3 steps), at first
    use; ``density_current_tracers`` adds two seeded species to the start
    of ``density_current``."""
    cache = {}

    def get(name):
        if name not in cache:
            case = name.replace("_tracers", "")
            jcfg, tcfg, jgeom, tgeom, start, ref = _imex_configs(case)
            if name.endswith("_tracers"):
                P, A, B, nz = start["Rho"].shape
                start["Tracers"] = seeded_tracers(P, A, B, nz)
            cache[name] = (tcfg, tgeom, start, ref,
                           jax_imex(jcfg, jgeom, start, ref))
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["density_current", "density_current_tracers",
                                  "channel"])
def test_noflux_imex_matches_make_nh_imex_step(runs, name):
    tcfg, tgeom, start, ref, want = runs(name)
    assert "noflux" in (tgeom.bc_x, tgeom.bc_y)
    assert not t_engine.fast_imex_supported(tcfg, geom=tgeom)
    assert t_engine.imex_supported(tcfg, has_tracers="Tracers" in start,
                                   geom=tgeom)
    assert_imex_matches(port_imex(tcfg, tgeom, start, ref), want, start)


def test_cli_runs_the_density_current_under_ars343(capsys):
    """``--case density_current --timescheme ars343`` through the CLI: finite
    checksums; ``Model`` with the CLI's configuration runs ARS343 on the
    walled grid (the parent raised there)."""
    argv = ["--case", "density_current", "--resolution", "4", "--levels",
            "8", "--dt", "0.1s", "--nsteps", "3", "--nohypervis",
            "--checksum_dt", "0.1s", "--timescheme", ARS343]
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "..Checksums" in l]
    assert len(lines) == 4
    assert all("nan" not in l and "inf" not in l for l in lines)
    tc, cfg, _ = t_cli.configure(t_cli.make_parser().parse_args(argv))
    assert cfg.timescheme == tt.TimestepSchemeType.ARS343
    m = t_model.Model(cfg, tc, device=CPU)
    assert m.geom.bc_x == "noflux"
    m.go(nsteps=3)
    for k in FIELDS:
        assert bool(torch.isfinite(m.state[k]).all()), k
    assert m.carry is None and float(m.state["U"].abs().max()) > 0.0
