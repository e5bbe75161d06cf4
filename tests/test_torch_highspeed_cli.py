"""The port's HighSpeed (HS) step on the UMJS wave at ne2 p4 nz6 through
both CLIs (``--hmethod HS``), and the port's ``make_nh_step`` and ``Model``
from the CLI's case, against the JAX CLI's state after 3 steps (float64,
1e-11 relative per field).

The JAX package's ``Model`` sends HS to its IMEX factory, which raises
("not an IMEX scheme"); its CLI run here has that factory patched to the
package's own ``make_nh_step`` HS step, as ``Model`` calls an IMEX step
(state -> state).  One JAX step is compiled, the CLI's."""

from unittest import mock

import pytest
import torch

import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import nh_model as j_nh_model
from tempestmodel_tpu_torch.models import nh_model as t_nh_model

from torch_port_common import CPU, FIELDS, rel_err

NSTEPS = 3
DT = 100.0
CLI_ARGV = ["--case", "umjs_pert", "--resolution", "2", "--levels", "6",
            "--dt", f"{DT:g}s", "--nsteps", str(NSTEPS), "--hmethod", "HS",
            "--output_restart_dt", f"{NSTEPS * DT:g}s"]


def _jax_hs_as_imex(cfg, geom, ref_state=None, mesh=None):
    """The JAX package's HS step (``make_nh_step``) as ``Model`` calls an
    IMEX step: state -> state."""
    first, _ = j_nh_model.make_nh_step(cfg, geom, ref_state=ref_state)
    return lambda s: first(s)[0]


def _restart(path):
    from tempestmodel_tpu_torch.io.output import CompositeCheckpoint
    files = sorted(path.glob("*restart*"))
    loaded = [CompositeCheckpoint.load(str(p), device=CPU) for p in files]
    return max(loaded, key=lambda r: r[2])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX CLI (its IMEX factory patched) and the port's CLI, each
    writing its state after ``NSTEPS`` steps; the JAX CLI's own refusal."""
    from tempestmodel_tpu import cli as j_cli
    from tempestmodel_tpu_torch import cli as t_cli
    with pytest.raises(ValueError, match="not an IMEX scheme"):
        j_cli.main(CLI_ARGV[:-2] + ["--nsteps", "1"])
    jdir = tmp_path_factory.mktemp("jax_hs")
    tdir = tmp_path_factory.mktemp("port_hs")
    with mock.patch.object(j_nh_model, "make_nh_imex_step",
                           _jax_hs_as_imex):
        assert j_cli.main(CLI_ARGV + ["--output_dir", str(jdir)]) in (0,
                                                                      None)
    assert t_cli.main(CLI_ARGV + ["--output_dir", str(tdir), "--device",
                                  "cpu"]) == 0
    return _restart(jdir), _restart(tdir)


def test_cli_hs_matches_the_jax_cli(cli_runs):
    (js, _, jt, jstep), (ts, _, tt_, tstep) = cli_runs
    assert jt == tt_ == NSTEPS * DT and jstep == tstep == NSTEPS
    assert set(js) == set(ts) == set(FIELDS)
    for k in FIELDS:
        assert bool(torch.isfinite(ts[k]).all()), k
        assert rel_err(ts[k].numpy(), js[k].numpy()) < 1e-11, k


def test_make_nh_step_and_model_hs_match_the_jax_cli(cli_runs):
    """The port's ``make_nh_step`` and ``Model`` from the CLI's case (its
    Rayleigh layer and reference state) against the JAX CLI's state."""
    from tempestmodel_tpu_torch import cli as t_cli
    from tempestmodel_tpu_torch.model import Model
    (js, _, _, _), _ = cli_runs
    tc, cfg, _ = t_cli.configure(t_cli.make_parser().parse_args(CLI_ARGV))
    assert cfg.timescheme == tt.TimestepSchemeType.HS
    m = Model(cfg, tc, device=CPU)
    first, step = t_nh_model.make_nh_step(cfg, m.geom,
                                          ref_state=m.reference, device=CPU)
    s, c = first(m.state)
    for _ in range(NSTEPS - 1):
        s, c = step(s, c)
    assert c == {}
    m.go(nsteps=NSTEPS)
    for k in FIELDS:
        assert torch.equal(m.state[k], s[k]), k
        assert rel_err(s[k].numpy(), js[k].numpy()) < 1e-11, k
