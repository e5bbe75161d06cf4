"""The port's split-explicit (SPEX) step against the JAX package's
``nh_model.make_nh_step`` with ``TimestepSchemeType.SPEX`` (the
reference-layout engine; the JAX package's z-first engine refuses SPEX):
UMJS ne2 p4 nz6 with two seeded tracer species, and the x-z thermal bubble
of ``tests/test_split_explicit.py``; 3 steps, float64, 1e-11 relative per
field, each from a seeded W (so that no upwind sign is decided by
roundoff).  SPEX and HS on a no-flux grid: the density current of
``test_torch_noflux.CASES`` (walls in x, nu2, Rayleigh sponges) at dt 0.1
s against ``make_nh_step`` with each scheme, 3 steps, 1e-11 (U and V
against their common scale: V of an x-z slice is roundoff).  Also the
fast operator's bands against JAX's ``_extract_fast_bands`` (1e-13), the
kernel wrappers' launches a step, ``Model`` and the CLI against
``make_nh_step``.

Each JAX configuration compiles one step: its ``first_step`` (a jit of the
step, which ignores the carry) is called three times."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import nh_model as j_nh_model
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch.kernels import synthetic
from tempestmodel_tpu_torch.models import nh_model as t_nh_model
from tempestmodel_tpu_torch.models import split_explicit as t_se

from torch_port_common import CPU, FIELDS, build_pair, rel_err

NSTEPS = 3
NTR = 2
# UMJS at ne2 nz6 (5 km layers): SPEX is non-finite within 10 steps at
# dt 50 s and 100 s there (at 100 s the port and the JAX package's step
# blow up alike, to 4e-13 over 3 steps), and holds 40 steps at 25 s
SPHERE_DT = 25.0
BUBBLE_DT = 0.2          # tests/test_split_explicit.py's coarse step
W_SEED = {"sphere": 1.0e3, "bubble": 100.0}


def _jax_steps(jcfg, jgeom, state, nsteps=NSTEPS, ref_state=None):
    first, _ = j_nh_model.make_nh_step(jcfg, jgeom, ref_state=ref_state)
    s = state
    for _ in range(nsteps):
        s, _ = first(s)
    return {k: np.asarray(v) for k, v in s.items()}


def _seed_w(start, amplitude, seed=7):
    out = dict(start)
    w = amplitude * np.random.default_rng(seed).standard_normal(
        start["W"].shape)
    w[..., 0] = w[..., -1] = 0.0
    out["W"] = w
    return out


@pytest.fixture(scope="module")
def sphere():
    """UMJS (its perturbation) at ne2 p4 nz6, nu4 1e15, two seeded tracer
    species, a seeded W: the start (reference layout, numpy), the configs,
    and JAX's state after ``NSTEPS`` steps."""
    from tempestmodel_tpu.testcases.nonhydro_sphere import (
        BaroclinicWaveUMJS as JaxUMJS)
    jcfg, jgeom, tcfg, tgeom = build_pair(ne=2, nz=6, dt=SPHERE_DT)
    jcfg = jcfg.with_(timescheme=tj.TimestepSchemeType.SPEX)
    tcfg = tcfg.with_(timescheme=tt.TimestepSchemeType.SPEX)
    js = JaxUMJS(pert="exp").initial_state(jgeom, jcfg.constants,
                                           dtype=jnp.float64)
    start = _seed_w({k: np.asarray(v) for k, v in js.items()},
                    W_SEED["sphere"])
    nz, A = tcfg.nz, tcfg.ne * tcfg.order
    flat = synthetic.random_tracers_numpy(nz, 6, A, A, NTR, tcfg.order,
                                          seed=3)
    start["Tracers"] = np.ascontiguousarray(np.moveaxis(
        flat.reshape(NTR, nz, 6, A, A), 1, -1))
    want = _jax_steps(jcfg, jgeom, {k: jnp.asarray(v)
                                    for k, v in start.items()})
    return jcfg, jgeom, tcfg, tgeom, start, want


@pytest.fixture(scope="module")
def bubble():
    """The thermal bubble x-z slice (nex 4, p4, nz 8, no hyperdiffusion)
    from a seeded W, and JAX's state after ``NSTEPS`` steps."""
    from tempestmodel_tpu.testcases.nonhydro_xz import (
        ThermalBubble as JBubble)
    from tempestmodel_tpu_torch.testcases.nonhydro_xz import ThermalBubble
    jtc, ttc = JBubble(), ThermalBubble()
    kw = dict(nex=4, ney=1, order=4, nz=8, ztop=jtc.ztop,
              x_extent=jtc.x_extent, y_extent=jtc.y_extent, dt=BUBBLE_DT,
              hyperdiffusion=False)
    jcfg = tj.ModelConfig(grid_kind=tj.GridKind.CARTESIAN_XZ,
                          timescheme=tj.TimestepSchemeType.SPEX,
                          vertical_solver="banded", dtype=jnp.float64, **kw)
    tcfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ,
                          timescheme=tt.TimestepSchemeType.SPEX,
                          vertical_solver="pallas", dtype=torch.float64, **kw)
    jgeom = j_nh_model.build_nh_cartesian_geometry(jcfg)
    tgeom = t_nh_model.build_nh_cartesian_geometry(tcfg)
    js = jtc.initial_state(jgeom, jcfg.constants, dtype=jnp.float64)
    start = _seed_w({k: np.asarray(v) for k, v in js.items()},
                    W_SEED["bubble"])
    want = _jax_steps(jcfg, jgeom, {k: jnp.asarray(v)
                                    for k, v in start.items()})
    return jcfg, jgeom, tcfg, tgeom, start, want


def _port_steps(tcfg, tgeom, start, nsteps=NSTEPS, **kw):
    first, step = t_nh_model.make_nh_step(tcfg, tgeom, device=CPU, **kw)
    s, c = first({k: torch.from_numpy(v.copy()) for k, v in start.items()})
    assert c == {}
    for _ in range(nsteps - 1):
        s, c = step(s, c)
    return s


@pytest.mark.parametrize("case", ["sphere", "bubble"])
def test_spex_matches_jax_make_nh_step(case, request):
    """3 SPEX steps, every field 1e-11 relative to JAX's (the tracers
    too, on the sphere)."""
    _, _, tcfg, tgeom, start, want = request.getfixturevalue(case)
    got = _port_steps(tcfg, tgeom, start)
    assert set(got) == set(want)
    for k in want:
        assert bool(torch.isfinite(got[k]).all()), k
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k


def test_fast_bands_match_jax(sphere):
    """The bands of the fast operator from the colour seeds (no autograd)
    against JAX's ``_extract_fast_bands`` of its ``fast_column_multi_jvp``
    at the seeded start, 1e-13 relative to the largest entry."""
    from tempestmodel_tpu.models import nonhydro as j_nonhydro
    from tempestmodel_tpu.models import split_explicit as j_se
    from tempestmodel_tpu.models.vertical_banded import interleave_perm
    jcfg, jgeom, tcfg, tgeom, start, _ = sphere
    nz = jcfg.nz
    q = j_nonhydro.estimate_bandwidth(jgeom, jcfg.constants)
    assert q == t_se.estimate_bandwidth(tgeom, tcfg.constants)
    js = {k: jnp.asarray(v) for k, v in start.items() if k != "Tracers"}
    x0, aux, gm, _ = j_nonhydro._implicit_aux(js, jgeom)
    perm = jnp.asarray(interleave_perm(nz))
    want = np.asarray(j_se._extract_fast_bands(
        lambda t: j_se.fast_column_multi_jvp(x0, aux, gm, jcfg.constants,
                                             nz, t),
        x0.shape, x0.dtype, q, perm, jnp.argsort(perm)))
    fg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64, device=CPU)
    d = t_engine.pack_state({k: v for k, v in start.items()
                             if k != "Tracers"}, device=CPU)
    got = t_se.fast_bands(t_se.fast_base(d, fg, tcfg.constants), fg, q)
    assert tuple(got.shape) == want.shape == (3 * nz + 1, 2 * q + 1,
                                              6 * 8 * 8)
    assert rel_err(got.numpy(), want) < 1e-13


def test_interleave_is_the_solvers_ordering():
    """The column systems' interleaving (``implicit._interleave``, batched
    over leading axes as the fast operator's colour seeds are) is
    ``interleave_perm``'s, and ``_deinterleave`` undoes it."""
    from tempestmodel_tpu_torch.fast.implicit import (_deinterleave,
                                                      _interleave)
    from tempestmodel_tpu_torch.models.vertical_banded import interleave_perm
    nz, Q = 5, 3
    rng = np.random.default_rng(0)
    rt, w, rho = (torch.from_numpy(rng.standard_normal((2, n, Q)))
                  for n in (nz, nz + 1, nz))
    x = _interleave(rt, w, rho, nz)
    perm = torch.from_numpy(interleave_perm(nz))
    for i in range(2):
        block = torch.cat([rt[i], w[i], rho[i]], dim=0)
        assert torch.equal(x[i], block[perm])
        assert all(torch.equal(a, b) for a, b in zip(
            _deinterleave(x[i], nz), (rt[i], w[i], rho[i])))


def test_spex_step_launches_its_kernels(sphere, monkeypatch):
    """The wrappers one SPEX step calls (on the CPU each runs its plain
    version): ``banded_solve`` three times a stage, the full-state DSS
    (``dss_state``, the tracers through ``dss_scalar``) twice a stage and
    twice in the nu4 tail, ``nu4_pass1/2`` once; ``plain=True`` calls no
    wrapper and gives the same bits."""
    from tempestmodel_tpu_torch.fast import dss_cuda, hyper_cuda
    _, _, tcfg, tgeom, start, _ = sphere
    calls = {}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    counting(t_se, "banded_solve")
    for name in ("dss_state", "dss_scalar", "dss_vector", "dss_scalar2",
                 "dss_uvw"):
        counting(dss_cuda, name)
    for name in ("nu4_pass1", "nu4_pass2"):
        counting(hyper_cuda, name)
    d = t_engine.pack_state(start, device=CPU)
    step, _ = t_se.make_spex_step(tcfg, tgeom, device=CPU)
    a, _ = step(d, None)
    assert calls == {"banded_solve": 15, "dss_state": 12, "dss_scalar": 12,
                     "nu4_pass1": 1, "nu4_pass2": 1}
    calls.clear()
    step, _ = t_se.make_spex_step(tcfg, tgeom, device=CPU, plain=True)
    b, _ = step(d, {"ignored": d["Rt"]})
    assert calls == {}
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_model_and_cli_run_spex(tmp_path):
    """``Model`` (the steps between output firings as one runner call)
    gives ``make_nh_step``'s state bit for bit; the CLI (``--hmethod
    SPEX``) runs the same model, and a restart from its checkpoint
    continues bit for bit."""
    from tempestmodel_tpu_torch import cli
    from tempestmodel_tpu_torch.io.output import CompositeCheckpoint
    from tempestmodel_tpu_torch.model import Model
    argv = ["--case", "umjs_pert", "--resolution", "2", "--levels", "6",
            "--dt", f"{SPHERE_DT:g}s", "--nsteps", "4", "--hmethod", "SPEX",
            "--output_dir", str(tmp_path), "--output_restart_dt",
            f"{2 * SPHERE_DT:g}s", "--device", "cpu"]
    tc, cfg, _ = cli.configure(cli.make_parser().parse_args(argv))
    assert cfg.timescheme == tt.TimestepSchemeType.SPEX
    m = Model(cfg, tc, device=CPU)
    start = {k: v.numpy().copy() for k, v in m.state.items()}
    m.go(nsteps=NSTEPS)
    want = _port_steps(cfg, m.geom, start, ref_state=m.reference)
    for k in FIELDS:
        assert torch.equal(m.state[k], want[k]), k
    m.go(nsteps=1)
    assert cli.main(argv) == 0
    saved = sorted((CompositeCheckpoint.load(str(p), device=CPU)
                    for p in tmp_path.glob("*restart*")),
                   key=lambda r: r[2])
    assert [r[2] for r in saved][-2:] == [2 * SPHERE_DT, 4 * SPHERE_DT]
    m2 = Model(cfg, tc, device=CPU)
    m2.set_state(*saved[-2])
    m2.go(nsteps=2)
    for k in FIELDS:
        assert torch.equal(m.state[k], saved[-1][0][k]), k
        assert torch.equal(m.state[k], m2.state[k]), k


@pytest.mark.parametrize("scheme", ["spex", "hs"])
def test_split_schemes_on_the_density_current_match_jax(scheme):
    """The no-flux grid the ``split_supported`` check admits: 3 steps of
    the port's ``make_nh_step`` against JAX's (the reference state of the
    sponges given to both)."""
    from test_torch_noflux import _configs, _errors
    jtc, ttc, jcfg, tcfg, jgeom, tgeom = _configs("density_current")
    jcfg = jcfg.with_(timescheme=tj.TimestepSchemeType(scheme))
    tcfg = tcfg.with_(timescheme=tt.TimestepSchemeType(scheme))
    assert jcfg.dt == 0.1 and tgeom.bc_x == "noflux"
    assert t_se.split_supported(tcfg, geom=tgeom)
    js = jtc.initial_state(jgeom, jcfg.constants)
    jref = jtc.reference_state(jgeom, jcfg.constants)
    want = _jax_steps(jcfg, jgeom, js, ref_state=jref)
    start = {k: np.asarray(v) for k, v in js.items()}
    got = _port_steps(tcfg, tgeom, start, ref_state={
        k: torch.from_numpy(np.array(v)) for k, v in jref.items()})
    got = {k: v.numpy() for k, v in got.items()}
    for k in FIELDS:
        assert np.isfinite(got[k]).all(), k
        assert np.abs(want[k] - start[k]).max() > 0.0 or k == "V", k
    errs = _errors(got, want)
    assert max(errs.values()) < 1e-11, errs


def test_split_supported_refuses_what_jax_refuses(sphere):
    _, _, tcfg, tgeom, _, _ = sphere
    assert t_se.split_supported(tcfg, has_tracers=True, geom=tgeom)
    for stag in ("CHARNEY_PHILLIPS", "LEVELS", "INTERFACES"):
        c = tcfg.with_(vertical_staggering=getattr(tt.VerticalStaggering,
                                                   stag))
        assert not t_se.split_supported(c, geom=tgeom)
        with pytest.raises(NotImplementedError, match="LOR"):
            t_se.make_spex_step(c, tgeom, device=CPU)
    # the IMEX family takes neither scheme
    assert not t_engine.fast_imex_supported(tcfg, geom=tgeom)
    assert not t_engine.fast_engine_supported(tcfg, geom=tgeom)


@pytest.mark.slow
def test_spex_bubble_converges_to_strang():
    """The port's SPEX on the bubble (tests/test_split_explicit.py's
    configuration) stays finite and approaches the Strang-HEVI solution
    as dt shrinks, with that test's bars."""
    from tempestmodel_tpu_torch.testcases.nonhydro_xz import ThermalBubble
    tc = ThermalBubble()
    base = dict(grid_kind=tt.GridKind.CARTESIAN_XZ, nex=8, ney=1, order=4,
                nz=16, ztop=tc.ztop, x_extent=tc.x_extent,
                y_extent=tc.y_extent, hyperdiffusion=False,
                vertical_solver="pallas", dtype=torch.float64)

    def run(ts, dt, T=0.8):
        cfg = tt.ModelConfig(dt=dt, timescheme=ts, **base)
        geom = t_nh_model.build_nh_cartesian_geometry(cfg)
        s = tc.initial_state(geom, cfg.constants, device=CPU)
        first, step = t_nh_model.make_nh_step(cfg, geom, device=CPU)
        s, c = first(s)
        for _ in range(round(T / dt) - 1):
            s, c = step(s, c)
        return s

    ref = run(tt.TimestepSchemeType.STRANG, 0.05)
    coarse = run(tt.TimestepSchemeType.SPEX, 0.2)
    fine = run(tt.TimestepSchemeType.SPEX, 0.05)
    for s in (coarse, fine):
        for k in ("U", "W", "Rt", "Rho"):
            assert bool(torch.isfinite(s[k]).all())
    err_c = float((coarse["Rt"] - ref["Rt"]).abs().max())
    err_f = float((fine["Rt"] - ref["Rt"]).abs().max())
    assert err_f < 0.5 * err_c
    assert err_f < 1e-3 * float(ref["Rt"].abs().max())
