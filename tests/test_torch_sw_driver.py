"""The port's shallow-water ``Model`` against the JAX package's, float64
on the CPU (``make_sw_step`` in every explicit scheme and with a tracer is
in ``test_torch_sw_schemes.py``): ``Model.go`` on Williamson 5 with
``ChecksumOutput``,
``EnergyOutput`` and ``ReferenceOutput`` (1e-11 on the state and the
lat-lon fields, 1e-12 on the records); restarts from ``.npz`` and
``.tarena`` bit for bit the uninterrupted run (the CLI's cases:
``tests/test_torch_sw_cli.py``).  A ``slow`` test holds the port to the
C++ reference's Williamson 2 goldens (``swtc2.bin.gz``,
``swtc2_hv.bin.gz``).  Each JAX step is compiled once."""

import glob

import numpy as np
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu import model as j_model
from tempestmodel_tpu.io import output as j_output
from tempestmodel_tpu.models import sw_model as j_swm
from tempestmodel_tpu.testcases import shallow_water as j_tc
from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.io import arena as t_arena
from tempestmodel_tpu_torch.io import output as t_output
from tempestmodel_tpu_torch.models import sw_model as t_swm
from tempestmodel_tpu_torch.testcases import shallow_water as t_tc

from torch_port_common import CPU, rel_err

TOL, STREAM_TOL = 1e-11, 1e-12
NSTEPS = 3
NU4, DT = 1e14, 600.0


def configs(ne, scheme="kgu35", **kw):
    base = dict(ne=ne, order=4, dt=DT, nu_scalar=NU4, nu_div=NU4,
                nu_vort=NU4)
    base.update(kw)
    return (tj.ModelConfig(explicit_scheme=tj.ExplicitSubScheme(scheme),
                           **base),
            tt.ModelConfig(explicit_scheme=tt.ExplicitSubScheme(scheme),
                           **base))


def w5_pair(ne, **kw):
    """(jc, tc, jg, tg, JAX state, port state) of Williamson 5."""
    jc, tc = configs(ne, **kw)
    j5, t5 = j_tc.Williamson5(), t_tc.Williamson5()
    jg = j_swm.build_sw_geometry(jc, j5.topography)
    tg = t_swm.build_sw_geometry(tc, t5.topography)
    return (jc, tc, jg, tg, j5.initial_state(jg, jc.constants),
            t5.initial_state(tg, tc.constants, device=CPU))


def assert_close(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert np.isfinite(g).all(), k
        assert rel_err(g, np.asarray(want[k])) < tol, (
            k, rel_err(g, np.asarray(want[k])))


def arena_or_skip():
    if not t_arena.available():
        pytest.skip("no C++ toolchain: the arena library cannot be built")


# ---------------------------------------------------------------------------
# Model and the output managers
# ---------------------------------------------------------------------------

def managers(pkg, root):
    out = pkg
    return [out.ChecksumOutput(DT), out.EnergyOutput(DT),
            out.ReferenceOutput(2 * DT, str(root), nlat=9, nlon=18,
                                output_vorticity=True,
                                output_divergence=True)]


@pytest.fixture(scope="module")
def model_pair(tmp_path_factory):
    """Williamson 5 at ne3 through both packages' ``Model.go``, 3 steps,
    with checksums and invariants every step and lat-lon output every
    second step."""
    jc, tc = configs(3)
    jroot = tmp_path_factory.mktemp("jax_sw")
    troot = tmp_path_factory.mktemp("port_sw")
    joms, toms = managers(j_output, jroot), managers(t_output, troot)
    jm = j_model.Model(jc, j_tc.Williamson5(), output_managers=joms)
    jm.go(nsteps=NSTEPS)
    tm = t_model.Model(tc, t_tc.Williamson5(), output_managers=toms,
                       device=CPU)
    tm.go(nsteps=NSTEPS)
    return jm, tm, joms, toms, jroot, troot


def test_model_go_matches_jax(model_pair):
    jm, tm, _, _, _, _ = model_pair
    assert tm.step_count == NSTEPS and tm.time == NSTEPS * DT
    assert tm.carry is None
    assert_close(tm.state, jm.state)


@pytest.mark.parametrize("which", [0, 1], ids=["checksums", "energy"])
def test_the_sw_records_match_jax(model_pair, which):
    _, _, joms, toms, _, _ = model_pair
    got, want = toms[which].records, joms[which].records
    assert len(got) == len(want) == NSTEPS + 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= STREAM_TOL * abs(w[k]), (k, g, w)


def test_the_sw_latlon_output_matches_jax(model_pair):
    _, _, _, _, jroot, troot = model_pair
    jfiles = sorted(glob.glob(str(jroot / "*.npz")))
    tfiles = sorted(glob.glob(str(troot / "*.npz")))
    assert len(jfiles) == len(tfiles) == 2
    for jf, tf in zip(jfiles, tfiles):
        with np.load(jf) as a, np.load(tf) as b:
            assert set(b.files) == set(a.files)
            for k in ("U", "V", "H", "Vorticity", "Divergence"):
                assert rel_err(b[k], a[k]) < TOL, k


def test_model_rejects_levels_for_the_sw_set():
    _, tc = configs(2)
    with pytest.raises(ValueError, match="nz > 1"):
        t_model.Model(tc.with_(nz=4), t_tc.Williamson2(), device=CPU)


def test_the_eddy_runs_without_rotation_through_model():
    """``ShallowWaterEddy`` sets omega = 0 through the test case, which
    ``Model`` reads (JAX ``model.py:70-73``)."""
    _, tc = configs(2)
    m = t_model.Model(tc, t_tc.ShallowWaterEddy(), device=CPU)
    assert m.cfg.constants.omega == 0.0
    assert float(np.abs(np.asarray(m.geom.coriolis)).max()) == 0.0
    m.go(nsteps=1)
    assert all(bool(torch.isfinite(v).all()) for v in m.state.values())


# ---------------------------------------------------------------------------
# restarts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["npz", "arena"])
def test_sw_restart_continues_bit_for_bit(tmp_path, fmt):
    if fmt == "arena":
        arena_or_skip()
    _, tc = configs(3)
    ck = t_output.CompositeCheckpoint(2 * DT, str(tmp_path), fmt=fmt)
    m = t_model.Model(tc, t_tc.BarotropicInstability(), output_managers=[ck],
                      device=CPU)
    m.go(nsteps=4)
    ext = ".npz" if fmt == "npz" else ".tarena"
    path = str(tmp_path / f"restart.{2 * DT:012.2f}{ext}")
    r = t_model.Model(tc, t_tc.BarotropicInstability(), device=CPU)
    r.restart_from(path)
    assert r.step_count == 2 and r.time == 2 * DT and r.carry is None
    r.go(nsteps=2)
    assert set(r.state) == set(m.state) == {"U", "V", "H"}
    for k in m.state:
        assert torch.equal(r.state[k], m.state[k]), k


# ---------------------------------------------------------------------------
# the C++ reference's goldens
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("case,hv", [("swtc2.bin.gz", False),
                                     ("swtc2_hv.bin.gz", True)])
def test_parity_shallow_water_tc2(case, hv):
    """The configuration of ``test_reference_parity.py``'s TC2 test (ne8,
    dt 400 s, 20 steps, with and without hyperdiffusion) through the port,
    to the same 1e-11 against the reference's final state."""
    from test_reference_parity import _load_sw_golden
    golden = _load_sw_golden(case)
    cfg = tt.ModelConfig(ne=8, order=4, dt=400.0, hyperdiffusion=hv)
    geom = t_swm.build_sw_geometry(cfg)
    s = t_tc.Williamson2().initial_state(geom, cfg.constants, device=CPU)
    step = t_swm.make_sw_step(cfg, geom, device=CPU)
    for _ in range(20):
        s = step(s)
    for name, c in (("U", 0), ("V", 1), ("H", 2)):
        ref = golden[:, c]
        scale = max(np.abs(ref).max(), 1e-30)
        rel = np.abs(ref - s[name].numpy()).max() / scale
        assert rel < 1e-11, f"{name}: rel {rel:.3e}"


# ---------------------------------------------------------------------------
# the device of the entry points
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    """``make_sw_step``, ``make_sw_multistep``, ``make_advection_step``, the
    test cases, ``Model`` and ``cli.main`` run on ``cuda`` unless told
    otherwise, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    from tempestmodel_tpu_torch import cli as t_cli
    from tempestmodel_tpu_torch.models import advection as t_adv
    _, tc = configs(2)
    geom = t_swm.build_sw_geometry(tc)
    zero = torch.zeros((6, 8, 8), dtype=torch.float64)
    calls = [
        lambda: t_swm.make_sw_step(tc, geom),
        lambda: t_swm.make_sw_multistep(tc, geom, 2),
        lambda: t_adv.make_advection_step(tc, geom, (zero, zero)),
        lambda: t_model.Model(tc, t_tc.Williamson2()),
        lambda: t_cli.main(["--case", "sw_tc2", "--resolution", "2",
                            "--nsteps", "1"]),
    ] + [lambda case=case: case.initial_state(geom, tc.constants)
         for case in (t_tc.Williamson2(), t_tc.Williamson5(),
                      t_tc.RossbyHaurwitz(), t_tc.ShallowWaterEddy(),
                      t_tc.BarotropicInstability())]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
