"""The port's IMEX under the CPH, LEV and INT staggerings against the JAX
package's reference-layout ``make_nh_imex_step``, float64 on the CPU,
ARS343, 3 steps, 1e-11 relative per field (U and V against their common
scale), on the configurations of ``test_torch_staggering.CASES``: the
inertia-gravity wave x-z slice (nex 4, nz 8, dt 2 s; INT at nz 9, vertical
order 2) under CPH, LEV and INT, CPH with nu4, and UMJS on the sphere (ne2
p4 nz6) under CPH with nu4 and the Rayleigh layer, at dt 25 s: from the
converted start both packages turn non-finite in the third ARS343 step at
dt 100 s (the same max |W| to 1e-14 relative over the first two, CPU,
float64), and hold 3 steps at 50 s and 25 s.

JAX's IMEX solves every staggering densely, as its Strang step does.  Its
tail raises under CPH with the Rayleigh finish (the level factor meets Rt
on interfaces); there the reference is JAX's IMEX with its tail replaced by
``jax_tail_by_rows``, and a test shows that JAX's own still raises, so that
a repair in the reference shows.  The CLI runs ``--vstagger CPH
--timescheme ars343`` through ``Model``."""

from unittest import mock

import pytest

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.timestep import imex as j_imex
from tempestmodel_tpu_torch import cli as t_cli
from tempestmodel_tpu_torch.fast import engine as t_engine

from torch_port_common import FIELDS
from torch_imex_wide import assert_imex_matches, jax_imex, port_imex
from test_torch_staggering import CASES, configs, jax_tail_by_rows

NAMES = ["cph", "lev", "int", "cph_nu4", "sphere_cph"]
# the cases' dt under ARS343 where it is not the Strang tests'
IMEX_DT = {"sphere_cph": 25.0}


def _imex_configs(name):
    jcfg, tcfg, jgeom, tgeom, start, ref = configs(name)
    kw = dict(dt=IMEX_DT.get(name, jcfg.dt))
    return (jcfg.with_(timescheme=tj.TimestepSchemeType.ARS343, **kw),
            tcfg.with_(timescheme=tt.TimestepSchemeType.ARS343, **kw),
            jgeom, tgeom, start, ref)


@pytest.fixture(scope="module")
def runs():
    """``get(name)``: (tcfg, tgeom, start, ref, JAX's 3 steps), at first
    use, JAX's tail by rows where the case says so."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, tcfg, jgeom, tgeom, start, ref = _imex_configs(name)
            if CASES[name][3]:
                with mock.patch.object(j_imex.hyperdiff,
                                       "step_after_subcycle_nh",
                                       jax_tail_by_rows):
                    want = jax_imex(jcfg, jgeom, start, ref)
            else:
                want = jax_imex(jcfg, jgeom, start, ref)
            cache[name] = tcfg, tgeom, start, ref, want
        return cache[name]
    return get


@pytest.mark.parametrize("name", NAMES)
def test_staggered_imex_matches_make_nh_imex_step(runs, name):
    tcfg, tgeom, start, ref, want = runs(name)
    assert not t_engine.fast_imex_supported(tcfg, geom=tgeom)
    assert t_engine.imex_supported(tcfg, geom=tgeom)
    assert not t_engine.imex_supported(tcfg, has_tracers=True, geom=tgeom)
    got = port_imex(tcfg, tgeom, start, ref)
    for k in FIELDS:
        assert got[k].shape == start[k].shape, k
    assert_imex_matches(got, want, start)


def test_jax_imex_tail_still_fails_under_cph_with_rayleigh(runs):
    jcfg, _, jgeom, _, start, ref = _imex_configs("sphere_cph")
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_imex(jcfg, jgeom, start, ref, steps=1)


def test_cli_runs_cph_under_ars343(capsys):
    """``--vstagger CPH --timescheme ars343`` on the inertia-gravity wave
    through the CLI: finite checksums."""
    rc = t_cli.main(["--case", "inertia_gravity", "--resolution", "4",
                     "--levels", "8", "--vstagger", "CPH", "--vmethod",
                     "DENSE", "--dt", "2s", "--nsteps", "2",
                     "--checksum_dt", "2s", "--timescheme", "ars343",
                     "--device", "cpu"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "..Checksums" in l]
    assert len(lines) == 3
    assert all("nan" not in l and "inf" not in l for l in lines)
