"""The CPH, LEV and INT staggerings through the port's driver and CLI,
float64 on the CPU.

- ``Model.go`` under each staggering is the engine's step bit for bit
  (the inertia-gravity wave x-z slice, whose ``initial_state`` takes
  ``stagger``), and its converted start (UMJS, which has no ``stagger``
  parameter: ``nonhydro.convert_stagger``) is the JAX ``Model``'s;
- the CLI's ``--vstagger CPH`` equals the JAX CLI's final checkpoint to
  1e-11 (one JAX step compiled), ``--vstagger LEV`` and ``--vstagger INT
  --vertorder 2`` equal the port's ``Model`` bit for bit (the JAX CLI
  raises there with its default nu4 tail: see
  ``test_torch_staggering.py``);
- a restart from either checkpoint format, and from a carry in the JAX
  package's layout, continues bit for bit; the lat-lon output, the
  checksums and the invariants take each staggering.

The slow tier ports the JAX package's own staggering checks
(``tests/test_staggering.py``: convergence to the Lorenz solution under
vertical refinement, the balance of the unperturbed background, INT
against LOR) to the port, and holds the growth of LEV at ne16 to the JAX
package's step for step."""

import glob
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu import cli as j_cli
from tempestmodel_tpu.model import Model as JaxModel
from tempestmodel_tpu.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as JaxUMJS)
from tempestmodel_tpu_torch import cli as t_cli, fast as t_fast
from tempestmodel_tpu_torch import model as t_model
from tempestmodel_tpu_torch.io import arena as t_arena, output as t_output
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz
from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS as TorchUMJS)

from torch_port_common import CPU, FIELDS

# staggering: (levels, vertical order) of the x-z slice
XZ_LEVELS = {"CPH": (8, 1), "LEV": (8, 1), "INT": (9, 2)}


def xz_config(stag, **over):
    tc = t_xz.InertiaGravityWave()
    nz, vo = XZ_LEVELS[stag]
    kw = dict(equation_set=tt.EquationSet.PRIMITIVE_NONHYDRO,
              grid_kind=tt.GridKind.CARTESIAN_XZ, nex=4, ney=1, order=4,
              nz=nz, vertical_order=vo, ztop=tc.ztop, x_extent=tc.x_extent,
              y_extent=tc.y_extent, dt=2.0, nu_scalar=1e12, nu_div=1e12,
              nu_vort=1e12, vertical_solver="dense",
              vertical_staggering=tt.VerticalStaggering(stag),
              dtype=torch.float64)
    kw.update(over)
    return tc, tt.ModelConfig(**kw)


def sphere_config(stag, **over):
    kw = dict(equation_set=tt.EquationSet.PRIMITIVE_NONHYDRO,
              grid_kind=tt.GridKind.CUBED_SPHERE, ne=2, order=4, nz=6,
              ztop=30000.0, dt=100.0, nu_scalar=1e15, nu_div=1e15,
              nu_vort=1e15, rayleigh_damping=True,
              vertical_staggering=tt.VerticalStaggering(stag),
              dtype=torch.float64)
    kw.update(over)
    return TorchUMJS(pert="exp", rayleigh=True), tt.ModelConfig(**kw)


@pytest.mark.parametrize("stag", list(XZ_LEVELS))
def test_model_go_is_the_engine_step(stag):
    """``Model.go`` (``first_step``, then the rest as one run) equals
    ``make_fast_step`` from the case's staggered start, bit for bit."""
    tc, cfg = xz_config(stag, hyperdiffusion=True)
    m = t_model.Model(cfg, tc, device=CPU)
    start = {k: v.clone() for k, v in m.state.items()}
    nz = cfg.nz
    assert start["W"].shape[-1] == (nz if stag != "CPH" else nz + 1)
    assert start["Rt"].shape[-1] == (nz + 1 if stag == "CPH" else nz)
    m.go(nsteps=3)
    first, step = t_fast.make_fast_step(cfg, m.geom, device=CPU)
    d, c = first(t_fast.pack_state(start, device=CPU))
    for _ in range(2):
        d, c = step(d, c)
    want = t_fast.unpack_state(d)
    for k in FIELDS:
        assert torch.equal(m.state[k], want[k]), k
    assert set(m.carry) == {"Rt", "W", "Rho"}


@pytest.mark.parametrize("stag", ["CPH", "LEV"])
def test_model_converted_start_is_jax_models(stag):
    """A case without a ``stagger`` parameter starts converted, as the JAX
    ``Model`` converts it; the reference state (the Rayleigh target) is
    converted too, where the JAX ``Model`` keeps the Lorenz one."""
    tc, cfg = sphere_config(stag)
    m = t_model.Model(cfg, tc, device=CPU)
    jcfg = tj.ModelConfig(
        equation_set=tj.EquationSet.PRIMITIVE_NONHYDRO,
        grid_kind=tj.GridKind.CUBED_SPHERE, ne=2, order=4, nz=6,
        ztop=30000.0, dt=100.0, rayleigh_damping=True,
        vertical_staggering=tj.VerticalStaggering(stag), dtype=jnp.float64)
    jm = JaxModel(jcfg, testcase=JaxUMJS(pert="exp", rayleigh=True))
    for k in FIELDS:
        np.testing.assert_allclose(m.state[k].numpy(),
                                   np.asarray(jm.state[k]), rtol=1e-13,
                                   atol=1e-13 * float(np.abs(np.asarray(
                                       jm.state[k])).max()))
    for k in FIELDS:
        assert m.reference[k].shape == m.state[k].shape, k


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The final checkpoint of a CLI run (``"jax"`` or ``"port"``) of the
    inertia-gravity wave under a staggering, run at first use."""
    cache = {}

    def get(which, stag):
        if (which, stag) not in cache:
            nz, vo = XZ_LEVELS[stag]
            root = str(tmp_path_factory.mktemp(f"{which}_{stag}"))
            argv = ["--case", "inertia_gravity", "--resolution", "4",
                    "--levels", str(nz), "--vertorder", str(vo),
                    "--vstagger", stag, "--vmethod", "DENSE", "--dt", "2s",
                    "--nsteps", "3", "--nu", "1e12", "--nud", "1e12",
                    "--nuv", "1e12", "--checksum_dt", "2s",
                    "--output_restart_dt", "6s", "--norefstate",
                    "--output_dir", root]
            if which == "jax":
                assert j_cli.main(argv) == 0
            else:
                assert t_cli.main(argv + ["--device", "cpu"]) == 0
            files = sorted(glob.glob(os.path.join(root, "restart.*")))
            state, _, t, step = t_output.CompositeCheckpoint.load(
                files[-1], device=CPU)
            assert step == 3 and abs(t - 6.0) < 1e-9
            cache[which, stag] = state
        return cache[which, stag]
    return get


def test_cli_cph_matches_the_jax_cli(cli_runs):
    got, want = cli_runs("port", "CPH"), cli_runs("jax", "CPH")
    assert got["Rt"].shape[-1] == got["W"].shape[-1] == 9
    uv = max(float(torch.as_tensor(want[k]).abs().max()) for k in "UV")
    for k in FIELDS:
        g = got[k].numpy()
        w = np.asarray(torch.as_tensor(want[k]))
        scale = uv if k in "UV" else np.abs(w).max()
        assert np.isfinite(g).all() and np.abs(g - w).max() < 1e-11 * scale, k


@pytest.mark.parametrize("stag", ["LEV", "INT"])
def test_cli_lev_int_is_the_model(cli_runs, stag):
    """``--vstagger LEV`` and ``--vstagger INT --vertorder 2`` run end to
    end with the CLI's nu4 tail: the same bits as ``Model`` with the CLI's
    configuration."""
    got = cli_runs("port", stag)
    nz, vo = XZ_LEVELS[stag]
    args = t_cli.make_parser().parse_args(
        ["--case", "inertia_gravity", "--resolution", "4", "--levels",
         str(nz), "--vertorder", str(vo), "--vstagger", stag, "--vmethod",
         "DENSE", "--dt", "2s", "--nu", "1e12", "--nud", "1e12", "--nuv",
         "1e12"])
    tc, cfg, _ = t_cli.configure(args)
    m = t_model.Model(cfg, tc, device=CPU)
    m.go(nsteps=3)
    assert got["W"].shape[-1] == nz
    for k in FIELDS:
        assert torch.equal(got[k], m.state[k]), k


@pytest.mark.parametrize("fmt", ["npz", "arena"])
@pytest.mark.parametrize("stag", ["CPH", "LEV"])
def test_a_staggered_model_restarts_bit_for_bit(tmp_path, stag, fmt):
    """4 steps straight against 2 steps, a checkpoint, and 2 more of a new
    ``Model`` restarted from it (UMJS with nu4 and the Rayleigh layer); the
    same from the state and a carry in the JAX package's (z-last) layout,
    as its checkpoints hold it."""
    if fmt == "arena" and not t_arena.available():
        pytest.skip("no C++ toolchain: the arena library cannot be built")
    tc, cfg = sphere_config(stag)
    ck = t_output.CompositeCheckpoint(200.0, str(tmp_path), fmt=fmt)
    m = t_model.Model(cfg, tc, output_managers=[ck], device=CPU)
    m.go(nsteps=4)
    first = sorted(os.listdir(tmp_path))[0]
    r = t_model.Model(cfg, tc, device=CPU)
    r.restart_from(str(tmp_path / first))
    assert r.step_count == 2
    state, carry = dict(r.state), dict(r.carry)
    r.go(nsteps=2)
    for k in FIELDS:
        assert torch.equal(r.state[k], m.state[k]), k
    z = t_model.Model(cfg, tc, device=CPU)
    z.set_state(state, {k: v.movedim(0, -1).contiguous()
                        for k, v in carry.items()}, r.time - 200.0, 2)
    z.go(nsteps=2)
    for k in FIELDS:
        assert torch.equal(z.state[k], m.state[k]), k


@pytest.mark.parametrize("stag", ["CPH", "LEV"])
def test_outputs_take_each_staggering(tmp_path, stag):
    """The lat-lon NetCDF output (Rt interpolated to levels under CPH, W
    divided by dz/dxi where it lives), the checksums (each field with the
    weights of its rows) and the invariants stay finite."""
    tc, cfg = sphere_config(stag)
    lines = []
    oms = [t_output.ReferenceOutput(200.0, str(tmp_path), nlat=10, nlon=20,
                                    fmt="nc", output_surface_pressure=True,
                                    output_richardson=True),
           t_output.ChecksumOutput(200.0, printer=lines.append),
           t_output.EnergyOutput(200.0, printer=lines.append)]
    m = t_model.Model(cfg, tc, output_managers=oms, device=CPU)
    m.go(nsteps=2)
    assert len(glob.glob(str(tmp_path / "out.*.nc"))) == 2
    assert len(lines) == 4
    assert all("nan" not in ln and "inf" not in ln for ln in lines)
    norms = m.compute_error_norms()
    assert all(np.isfinite(float(n["l2"])) for n in norms.values())


# ---------------------------------------------------------------------------
# slow: the JAX package's staggering checks (tests/test_staggering.py)
# ---------------------------------------------------------------------------

def _run_igw(stag, nz, dt, nsteps, vo=None, theta_c=None):
    tc = t_xz.InertiaGravityWave() if theta_c is None else \
        t_xz.InertiaGravityWave(theta_c=theta_c)
    if vo is None:
        vo = 2 if stag == "INT" else 1
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ, nex=10, ney=1,
                         order=4, nz=nz, ztop=tc.ztop, x_extent=tc.x_extent,
                         y_extent=tc.y_extent, dt=dt, hyperdiffusion=False,
                         vertical_staggering=tt.VerticalStaggering(stag),
                         vertical_order=vo,
                         vertical_solver="dense" if stag != "LOR"
                         else "banded", dtype=torch.float64)
    geom = t_nh.build_nh_cartesian_geometry(cfg)
    s0 = tc.initial_state(geom, cfg.constants, device=CPU, stagger=stag)
    first, step = t_fast.make_fast_step(cfg, geom, device=CPU)
    d, c = first(t_fast.pack_state(s0, device=CPU))
    for _ in range(nsteps - 1):
        d, c = step(d, c)
    return t_fast.unpack_state(d), s0, geom


@pytest.mark.slow
@pytest.mark.parametrize("stag,ratio", [("CPH", 0.45), ("LEV", 0.65)])
def test_stagger_igw_converges_to_lorenz(stag, ratio):
    rels = []
    for nz, dt, ns in ((10, 1.0, 20), (20, 0.5, 40)):
        s, _, geom = _run_igw(stag, nz, dt, ns)
        sL, s0L, _ = _run_igw("LOR", nz, dt, ns)
        rt = s["Rt"]
        if stag == "CPH":
            rt = torch.einsum("KL,...L->...K",
                              torch.as_tensor(geom.interp_i2n), rt)
        assert bool(torch.isfinite(rt).all())
        d = float((rt - sL["Rt"]).abs().max())
        sig = float((sL["Rt"] - s0L["Rt"]).abs().max())
        rels.append(d / sig)
    assert rels[1] < ratio * rels[0], rels
    assert rels[1] < 0.25, rels


@pytest.mark.slow
@pytest.mark.parametrize("stag", ["CPH", "LEV"])
def test_stagger_hydrostatic_balance_held(stag):
    tc = t_xz.InertiaGravityWave(theta_c=0.0)
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ, nex=4, ney=1,
                         order=4, nz=16, ztop=tc.ztop, x_extent=tc.x_extent,
                         y_extent=tc.y_extent, dt=1.0, hyperdiffusion=False,
                         vertical_staggering=tt.VerticalStaggering(stag),
                         vertical_solver="dense", dtype=torch.float64)
    geom = t_nh.build_nh_cartesian_geometry(cfg)
    s0 = tc.initial_state(geom, cfg.constants, device=CPU, stagger=stag)
    first, step = t_fast.make_fast_step(cfg, geom, device=CPU)
    d, c = first(t_fast.pack_state(s0, device=CPU))
    for _ in range(29):
        d, c = step(d, c)
    s = t_fast.unpack_state(d)
    zxi = (geom.deriv_r[..., 2] if stag == "LEV"
           else geom.deriv_r_int[..., 2])
    assert float((s["W"] / torch.as_tensor(zxi)).abs().max()) < 0.01
    drho = float((s["Rho"] - s0["Rho"]).abs().max() / s0["Rho"].abs().max())
    assert drho < 1e-3


@pytest.mark.slow
def test_int_igw_matches_lorenz():
    sI, s0I, _ = _run_igw("INT", 21, 6.0, 10)
    sL, s0L, _ = _run_igw("LOR", 20, 6.0, 10)
    thI = float((sI["Rt"] / sI["Rho"] - s0I["Rt"] / s0I["Rho"]).abs().max())
    thL = float((sL["Rt"] / sL["Rho"] - s0L["Rt"] / s0L["Rho"]).abs().max())
    assert np.isfinite(thI)
    assert abs(thI - thL) / thL < 0.05


@pytest.mark.slow
def test_lev_grows_at_ne16_in_the_port_as_in_jax():
    """UMJS under LEV at ne16 p4 L30 (dt 100 s, nu4 1e15, no Rayleigh
    layer; fp64): max |W| grows about tenfold between steps 10 and 50, in
    the port as in JAX ``make_nh_step`` with the tail assembled from its
    own pieces (``test_torch_staggering.jax_tail_by_rows``), step for step
    to 1e-9 (about 20 minutes and 6 GB on the CPU)."""
    from unittest import mock
    from tempestmodel_tpu.models import (hyperdiff as j_hd,
                                         nh_model as j_nh,
                                         nonhydro as j_nonh)
    import test_torch_staggering as stg
    kw = dict(ne=16, order=4, nz=30, ztop=30000.0, dt=100.0,
              hyperdiffusion=True, nu_scalar=1e15, nu_div=1e15,
              nu_vort=1e15, vertical_solver="dense")
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE,
                          vertical_staggering=tj.VerticalStaggering.LEVELS,
                          dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE,
                          vertical_staggering=tt.VerticalStaggering.LEVELS,
                          dtype=torch.float64, **kw)
    jgeom = j_nh.build_nh_sphere_geometry(jcfg, ztop=30000.0)
    tgeom = t_nh.build_nh_sphere_geometry(tcfg, ztop=30000.0)
    start = {k: np.asarray(v) for k, v in j_nonh.convert_stagger(
        JaxUMJS(pert="exp").initial_state(jgeom, jcfg.constants), jgeom,
        "LEV").items()}
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU)
    d, c = first(t_fast.pack_state(
        {k: torch.from_numpy(v.copy()) for k, v in start.items()},
        device=CPU))
    port = [float(d["W"].abs().max())]
    for _ in range(49):
        d, c = step(d, c)
        port.append(float(d["W"].abs().max()))
    with mock.patch.object(j_hd, "step_after_subcycle_nh",
                           stg.jax_tail_by_rows):
        jfirst, jstep = j_nh.make_nh_step(jcfg, jgeom)
        s, c = jfirst({k: jnp.asarray(v) for k, v in start.items()})
        jax_w = [float(jnp.abs(s["W"]).max())]
        for _ in range(49):
            s, c = jstep(s, c)
            jax_w.append(float(jnp.abs(s["W"]).max()))
    np.testing.assert_allclose(port, jax_w, rtol=1e-9)
    assert port[-1] > 5.0 * port[9], port
