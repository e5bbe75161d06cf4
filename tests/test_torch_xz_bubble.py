"""The periodic x-z cases' sponges (``test_torch_xz_cases.CASES``: the
shear jet's lateral and top sponge, the hydrostatic mountain's inverted
left sponge) reach the Rayleigh terms; and the thermal bubble through the
port's ``Model`` and its CLI (``--case thermal_bubble``) against the JAX
``Model`` at nex 4 nz 8 (its step compiled once for the module), float64 on
the CPU, 1e-11 relative per field and checksum.  (The steps over the
mountains are in ``test_torch_xz_cases.py``.)"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu import model as j_model
from tempestmodel_tpu.io import output as j_output
from tempestmodel_tpu.testcases import nonhydro_xz as j_xz
from tempestmodel_tpu_torch import cli as t_cli, fast as t_fast
from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.io import output as t_output
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz

from torch_port_common import CPU, FIELDS
from test_torch_xz_cases import CASES, TOL, _compare, _configs


@pytest.mark.parametrize("name", list(CASES))
def test_the_sponge_depends_on_x(name):
    """The lateral sponge reaches the Rayleigh terms: the damping factor of
    Rt on the lowest level varies along x."""
    _, tcfg, _, tgeom, _, ref = _configs(name)
    fg = t_fast.build_fast_geometry_cartesian(tgeom, dtype=torch.float64,
                                              device=CPU)
    fac, _ = t_fast.engine._rayleigh_terms(tcfg, tgeom, ref, fg)
    assert float(fac["Rt"][0].max() - fac["Rt"][0].min()) > 1e-6
    assert float(np.ptp(tgeom.topo)) > 0.5


BUBBLE_ARGV = ["--case", "thermal_bubble", "--resolution", "4", "--levels",
               "8", "--dt", "0.05s", "--nsteps", "2", "--nohypervis",
               "--checksum_dt", "0.05s"]
BUBBLE_STEPS = 2


@pytest.fixture(scope="module")
def bubble():
    """The JAX ``Model`` of the CLI's thermal bubble (periodic x-z, nex 4,
    nz 8, dt 0.05 s, no hyperdiffusion), checksums every step."""
    tc = j_xz.ThermalBubble()
    assert not hasattr(tc, "bc_x")            # a periodic grid
    cfg = tj.ModelConfig(
        equation_set=tj.EquationSet.PRIMITIVE_NONHYDRO,
        grid_kind=tj.GridKind.CARTESIAN_XZ, x_extent=tc.x_extent,
        y_extent=tc.y_extent, ztop=tc.ztop, nex=4, nz=8, order=4, dt=0.05,
        hyperdiffusion=False, dtype=jnp.float64)
    cks = j_output.ChecksumOutput(0.05)
    m = j_model.Model(cfg, tc, output_managers=[cks])
    m.go(nsteps=BUBBLE_STEPS)
    return {"state": {k: np.asarray(v) for k, v in m.state.items()},
            "checksums": cks.records}


def _checksums_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g["time"] - w["time"]) < 1e-12
        for k in FIELDS:
            assert abs(g[k] - w[k]) <= TOL * max(abs(w[k]), 1e-300) \
                or abs(w[k]) < 1e-15, (k, g[k], w[k])


def test_thermal_bubble_model_matches_jax(bubble):
    args = t_cli.make_parser().parse_args(BUBBLE_ARGV + ["--vmethod", "V2"])
    tc, cfg, wps = t_cli.configure(args)
    assert isinstance(tc, t_xz.ThermalBubble) and not wps
    assert cfg.grid_kind == tt.GridKind.CARTESIAN_XZ and cfg.nex == 4
    cks = t_output.ChecksumOutput(0.05)
    m = t_model.Model(cfg, tc, output_managers=[cks], device=CPU)
    assert m.geom.bc_x == "periodic"
    m.go(nsteps=BUBBLE_STEPS)
    _compare(m.state, bubble["state"], TOL)
    _checksums_close(cks.records, bubble["checksums"])


def test_cli_runs_the_thermal_bubble(bubble, capsys):
    """``--case thermal_bubble`` runs on the periodic grid (it was refused
    as needing no-flux boundaries); its checksum lines equal the JAX
    ``Model``'s records to 1e-11."""
    rc = t_cli.main(BUBBLE_ARGV + ["--vmethod", "V2", "--device", "cpu"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "..Checksums" in l]
    assert len(lines) == BUBBLE_STEPS + 1
    got = []
    for line in lines:
        rec = {"time": float(re.search(r"t=([0-9.e+-]+)s", line).group(1))}
        rec.update({k: float(v) for k, v in
                    re.findall(r"(\w+): ([-0-9.e+]+)", line)})
        got.append(rec)
    want = [dict(r, time=round(r["time"], 1)) for r in bubble["checksums"]]
    _checksums_close(got, want)
