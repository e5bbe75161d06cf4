"""No-flux Cartesian grids with uniform (nu2) diffusion on the port's z-first
engine vs the JAX package, float64 on the CPU.

The JAX package steps these grids on its reference-layout engine
(``nh_model.make_nh_step``): the walls' halo is a lagged shadow state that
goes through the explicit stages' combinations, and every stage adds the
uniform diffusion against the reference state.  Here: the DSS kernels'
plain forms with a halo, the zero halo and none against
``apply_dss_cartesian(halo=)`` (bit for bit), ``apply_noflux_x/y``, the
envelope predicates, and 3 steps of ``make_fast_step`` (fused and unfused)
against 3 steps of ``make_nh_step``: the Straka density current (walls in
x, nu2 300/300, Rayleigh sponges) in both layouts and the baroclinic
channel (walls in y, nu4).  The four other explicit schemes and a sphere
case with nu2 are in ``test_torch_noflux_schemes.py``.  The Straka golden
run (20 steps against the reference dump) is ``slow``.

V of an x-z slice carries roundoff only, so U and V are measured against
their common scale, as ``tests/test_torch_cartesian.py`` does."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu as tj
from tempestmodel_tpu.fast import engine as j_engine
from tempestmodel_tpu.grid import cartesian as j_cart
from tempestmodel_tpu.models import nh_model as j_nh
from tempestmodel_tpu.testcases import nonhydro_xz as j_xz
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.fast import engine as t_engine, dss_cuda
from tempestmodel_tpu_torch.grid import cartesian as t_cart
from tempestmodel_tpu_torch.models import nh_model as t_nh
from tempestmodel_tpu_torch.testcases import nonhydro_xz as t_xz

from torch_port_common import CPU, FIELDS

TOL = 1e-11
STEPS = 3

CASES = {
    # the density current at test scale: x walls, nu2, Rayleigh sponges
    "density_current": dict(
        case="DensityCurrent", kind="CARTESIAN_XZ", nex=4, ney=1, nz=8,
        dt=0.1, hyperdiffusion=False, nu=0.0, nu2=300.0,
        bc=dict(bc_x="noflux")),
    # the channel: y walls, x periodic, nu4 (the nu4 passes' zero halo)
    "channel": dict(
        case="Baroclinic3DChannel", kind="CARTESIAN_3D", nex=4, ney=2, nz=6,
        dt=100.0, hyperdiffusion=True, nu=1e15, nu2=0.0,
        bc=dict(bc_y="noflux", reference_latitude=np.pi / 4.0)),
}


def _configs(name, scheme="kgu35"):
    c = CASES[name]
    jtc, ttc = getattr(j_xz, c["case"])(), getattr(t_xz, c["case"])()
    kw = dict(nex=c["nex"], ney=c["ney"], order=4, nz=c["nz"],
              x_extent=jtc.x_extent, y_extent=jtc.y_extent, ztop=jtc.ztop,
              dt=c["dt"], hyperdiffusion=c["hyperdiffusion"],
              nu_scalar=c["nu"], nu_div=c["nu"], nu_vort=c["nu"],
              nu_uniform_scalar=c["nu2"], nu_uniform_vector=c["nu2"],
              rayleigh_damping=True)
    jcfg = tj.ModelConfig(grid_kind=getattr(tj.GridKind, c["kind"]),
                          vertical_solver="banded", dtype=jnp.float64,
                          explicit_scheme=tj.ExplicitSubScheme(scheme), **kw)
    tcfg = tt.ModelConfig(grid_kind=getattr(tt.GridKind, c["kind"]),
                          vertical_solver="pallas", dtype=torch.float64,
                          explicit_scheme=tt.ExplicitSubScheme(scheme), **kw)
    jgeom = j_nh.build_nh_cartesian_geometry(
        jcfg, ztop=jtc.ztop, rayleigh=jtc.rayleigh_strength, **c["bc"])
    tgeom = t_nh.build_nh_cartesian_geometry(
        tcfg, ztop=ttc.ztop, rayleigh=ttc.rayleigh_strength, **c["bc"])
    return jtc, ttc, jcfg, tcfg, jgeom, tgeom


def _jax_steps(jtc, jcfg, jgeom, steps=STEPS):
    s = jtc.initial_state(jgeom, jcfg.constants)
    ref = jtc.reference_state(jgeom, jcfg.constants)
    first, step = j_nh.make_nh_step(jcfg, jgeom, ref_state=ref)
    s, carry = first(s)
    for _ in range(steps - 1):
        s, carry = step(s, carry)
    return {k: np.asarray(v) for k, v in s.items()}


def _port_steps(ttc, tcfg, tgeom, steps=STEPS, **kw):
    s = ttc.initial_state(tgeom, tcfg.constants, device=CPU)
    ref = ttc.reference_state(tgeom, tcfg.constants, device=CPU)
    first, step = t_fast.make_fast_step(tcfg, tgeom, ref_state=ref,
                                        device=CPU, **kw)
    d, carry = first(t_fast.pack_state(s, device=CPU))
    for _ in range(steps - 1):
        d, carry = step(d, carry)
    return {k: v.numpy() for k, v in t_fast.unpack_state(d).items()}, carry


def _errors(got, want):
    uv = max(np.abs(want["U"]).max(), np.abs(want["V"]).max())
    out = {}
    for k in FIELDS:
        scale = uv if k in ("U", "V") else np.abs(want[k]).max()
        out[k] = float(np.abs(got[k] - want[k]).max() / max(scale, 1e-300))
    return out


@pytest.fixture(scope="module")
def runs():
    """Each case's configurations and JAX's 3 steps (one compile each)."""
    out = {}
    for name in CASES:
        jtc, ttc, jcfg, tcfg, jgeom, tgeom = _configs(name)
        out[name] = (ttc, tcfg, tgeom, jgeom, _jax_steps(jtc, jcfg, jgeom),
                     jcfg)
    return out


# ---------------------------------------------------------------------------
# the DSS plain forms with the walls' halo
# ---------------------------------------------------------------------------

def _engine_layout(f, swap):
    """(1, A, B, K) numpy -> z-first (K, 1, A, B) tensor, (a, b)-swapped
    when ``swap``."""
    z = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0)))
    return z.transpose(-2, -1).contiguous() if swap else z


def _natural(t, swap):
    t = t.transpose(-2, -1) if swap else t
    return np.moveaxis(t.numpy(), 0, -1)


@pytest.mark.parametrize("halo", ["tensor", "zero", "none"])
@pytest.mark.parametrize("where", ["density_current_swapped",
                                   "density_current_natural", "channel"])
def test_dss_plain_forms_with_a_halo_equal_jax_bit_for_bit(runs, where,
                                                           halo):
    """All five modes' plain forms (scalar, vector, uvw, scalar2, state with
    and without the Rayleigh finish and its pre-finish wall rows) against
    ``apply_dss_cartesian(halo=)`` of each field, bit for bit in the natural
    layout.  The swapped layout sums along y before x, so a node on both
    axes' element edges takes its three additions in another order: there
    the pair sums agree to roundoff and the halo average is the same
    operation on them."""
    name = where.rsplit("_", 1)[0] if where != "channel" else "channel"
    swap = where.endswith("swapped")
    ttc, tcfg, tgeom, jgeom, _, jcfg = runs[name]
    fg = t_engine.build_fast_geometry_cartesian(
        tgeom, dtype=torch.float64, device=CPU, swap_ab=swap)
    assert sum(fg.noflux) == 1
    assert fg.noflux == ((True, False) if (name == "channel") == swap
                         else (False, True))
    rng = np.random.default_rng(sum(map(ord, where + halo)))
    shape = np.asarray(jgeom.z_lev).shape
    nat = {k: rng.standard_normal(shape[:3] + (shape[3] + (k == "W"),))
           for k in FIELDS}
    hal = {k: rng.standard_normal(v.shape) for k, v in nat.items()}
    jh = {"tensor": hal, "zero": {k: 0.0 * v for k, v in hal.items()},
          "none": None}[halo]
    want = {k: np.asarray(j_cart.apply_dss_cartesian(
        jnp.asarray(v), jgeom, halo=None if jh is None else
        jnp.asarray(jh[k]))) for k, v in nat.items()}
    d = {k: _engine_layout(v, swap) for k, v in nat.items()}
    walls = {k: dss_cuda.wall_rows(_engine_layout(v, swap), fg.noflux)
             for k, v in hal.items()}
    th = {"tensor": walls, "zero": dss_cuda.ZERO_HALO, "none": None}[halo]

    def equal(got, want, what):
        if swap:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-15 * max(
                np.abs(want).max(), 1e-300), err_msg=what)
        else:
            np.testing.assert_array_equal(got, want, what)

    def part(*keys):
        """The halo argument of the launch of fields ``keys``."""
        if th is None or th is dss_cuda.ZERO_HALO:
            return th
        return th[keys[0]] if len(keys) == 1 else tuple(th[k] for k in keys)

    common = (fg.inv_mult, (), fg.p)
    kw = dict(wrap=fg.wrap, noflux=fg.noflux)
    got = {"Rt": dss_cuda.dss_scalar_plain(d["Rt"], *common, **kw,
                                           halo=part("Rt"))}
    got["U"], got["V"] = dss_cuda.dss_vector_plain(
        d["U"], d["V"], fg.inv_mult, fg.e_rot, (), fg.p, **kw,
        halo=part("U", "V"))
    got["Rho"], got["W"] = dss_cuda.dss_scalar2_plain(
        d["Rho"], d["W"][1:].contiguous(), *common, **kw,
        halo=th if th is None or th is dss_cuda.ZERO_HALO else
        (th["Rho"], th["W"][1:].contiguous()))
    for k in ("U", "V", "Rt", "Rho"):
        equal(_natural(got[k], swap), want[k], k)
    equal(_natural(got["W"], swap), want["W"][..., 1:], "W")
    # the state mode, with the Rayleigh finish and its pre-finish walls
    fac = {k: torch.rand(v.shape, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(3))
           for k, v in d.items()}
    ref = {k: torch.ones_like(v) for k, v in d.items()}
    for ray in (None, (fac, ref)):
        out = dss_cuda.dss_state_plain(d, fg.inv_mult, fg.e_rot, (), fg.p,
                                       rayleigh=ray, **kw, halo=th,
                                       walls_out=th is not None)
        if th is not None:
            out, wo = out
            for k in FIELDS:
                equal(wo[k].numpy(), dss_cuda.wall_rows(
                    _engine_layout(want[k], swap), fg.noflux).numpy(), k)
        for k in FIELDS:
            w = _engine_layout(want[k], swap)
            if ray is not None:
                w = fac[k] * w + ref[k]
            equal(out[k].numpy(), w.numpy(), k)
    # the uvw mode: the stage's W finish assembled, then the three DSS
    K = d["U"].shape[0]
    wf = {"bw1": d["W"], "bw2": None, "dW": d["W"] * 0.5,
          "dt_s": 0.25, "c00": 0.75, "c01": 0.25,
          "cax0": fg.con_a_xi_int[0].contiguous(),
          "cbx0": fg.con_b_xi_int[0].contiguous(),
          "cxx0": fg.con_xi_xi_int[0].contiguous()}
    raw = dss_cuda.w_finish_plain(d["U"], d["V"], wf)
    want_w = j_cart.apply_dss_cartesian(
        jnp.asarray(_natural(raw, swap)), jgeom,
        halo=None if jh is None else jnp.asarray(jh["W"]))
    u, v, w = dss_cuda.dss_uvw_plain(d["U"], d["V"], fg.inv_mult, fg.e_rot,
                                     (), fg.p, wf, **kw,
                                     halo=part("U", "V", "W"))
    assert w.shape[0] == K + 1
    equal(_natural(w, swap), np.asarray(want_w), "uvw W")
    equal(_natural(u, swap), want["U"], "uvw U")


def test_wrappers_check_the_halo(runs):
    ttc, tcfg, tgeom, jgeom, _, jcfg = runs["channel"]
    fg = t_engine.build_fast_geometry_cartesian(tgeom, dtype=torch.float64,
                                                device=CPU)
    x = torch.zeros((fg.nz, 1, fg.A, fg.B), dtype=torch.float64)
    common = (fg.inv_mult, (), fg.p)
    good = dss_cuda.wall_rows(x, fg.noflux)
    dss_cuda.dss_scalar(x, *common, wrap=fg.wrap, noflux=fg.noflux,
                        halo=good)
    with pytest.raises(ValueError):                 # wall rows of the wrong
        dss_cuda.dss_scalar(x, *common, wrap=fg.wrap, noflux=fg.noflux,
                            halo=good[:, :, 1:].contiguous())   # length
    with pytest.raises(ValueError):                 # walls on both axes
        dss_cuda.dss_scalar(x, *common, wrap=(False, False),
                            noflux=(True, True), halo=dss_cuda.ZERO_HALO)
    with pytest.raises(ValueError):                 # a wall that wraps
        dss_cuda.dss_scalar(x, *common, wrap=(True, True),
                            noflux=fg.noflux, halo=dss_cuda.ZERO_HALO)
    d = {k: torch.zeros((fg.nz + (k == "W"), 1, fg.A, fg.B),
                        dtype=torch.float64) for k in FIELDS}
    with pytest.raises(ValueError):                 # walls_out without halo
        dss_cuda.dss_state(d, fg.inv_mult, fg.e_rot, (), fg.p, wrap=fg.wrap,
                           walls_out=True)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_apply_noflux_matches_jax(runs, axis):
    name = "density_current" if axis == "x" else "channel"
    ttc, tcfg, tgeom, jgeom, _, jcfg = runs[name]
    rng = np.random.default_rng(7)
    shape = np.asarray(jgeom.z_lev).shape
    s = {k: rng.standard_normal(shape[:3] + (shape[3] + (k == "W"),))
         for k in FIELDS}
    jfn = getattr(j_cart, f"apply_noflux_{axis}")
    tfn = getattr(t_cart, f"apply_noflux_{axis}")
    want = jfn({k: jnp.asarray(v) for k, v in s.items()}, jgeom)
    ts = {k: torch.from_numpy(v.copy()) for k, v in s.items()}
    got = tfn(ts, tgeom)
    for k in FIELDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-14, atol=1e-14)
        np.testing.assert_array_equal(ts[k].numpy(), s[k])   # left alone
    other = getattr(t_cart, f"apply_noflux_{'y' if axis == 'x' else 'x'}")
    assert other(ts, tgeom) is ts             # no walls on the other axis


# ---------------------------------------------------------------------------
# the envelope
# ---------------------------------------------------------------------------

def test_envelope_takes_noflux_and_nu2(runs):
    for name in CASES:
        ttc, tcfg, tgeom, jgeom, _, jcfg = runs[name]
        assert t_engine.fast_engine_supported(tcfg, geom=tgeom)
        assert not t_engine.fast_engine_supported(tcfg, geom=tgeom,
                                                  has_tracers=True)
        # the JAX package's z-first engine leaves these grids to its
        # reference-layout engine; the IMEX family stays as its
        imex = tcfg.with_(timescheme=tt.TimestepSchemeType.ARS343)
        jimex = jcfg.with_(timescheme=tj.TimestepSchemeType.ARS343,
                           vertical_solver="pallas")
        assert not t_engine.fast_imex_supported(imex, geom=tgeom)
        assert t_engine.fast_imex_supported(imex, geom=tgeom) == \
            j_engine.fast_imex_supported(jimex, geom=jgeom)
    ttc, tcfg, tgeom, jgeom, _, jcfg = runs["density_current"]
    both = t_nh.build_nh_cartesian_geometry(tcfg, bc_x="noflux",
                                            bc_y="noflux")
    assert not t_engine.fast_engine_supported(tcfg, geom=both)
    sphere = tt.ModelConfig(grid_kind=tt.GridKind.CUBED_SPHERE, ne=2,
                            nz=6, nu_uniform_scalar=1e5)
    assert t_engine.fast_engine_supported(sphere)
    assert not t_engine.fast_engine_supported(sphere, has_tracers=True)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("swap", [True, False], ids=["swapped", "natural"])
def test_density_current_three_steps_match_jax(runs, swap, fused):
    ttc, tcfg, tgeom, jgeom, want, _ = runs["density_current"]
    got, carry = _port_steps(ttc, tcfg, tgeom, fused=fused, swap_ab=swap)
    errs = _errors(got, want)
    assert max(errs.values()) < TOL, errs
    # the carry is one flat dict of tensors: the implicit increments and
    # the walls' halo
    assert {"halo_" + k for k in FIELDS} <= set(carry)
    assert all(isinstance(v, torch.Tensor) for v in carry.values())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("swap", [True, False], ids=["swapped", "natural"])
def test_channel_three_steps_match_jax(runs, swap, fused):
    """The default layout is swapped (walls along a, the wrap along b);
    natural: walls along b meeting the wrap along a at the corners."""
    ttc, tcfg, tgeom, jgeom, want, _ = runs["channel"]
    got, _ = _port_steps(ttc, tcfg, tgeom, fused=fused, swap_ab=swap)
    errs = _errors(got, want)
    assert max(errs.values()) < TOL, errs
    # the jet stays O(u0) and the y walls hold V near zero against it
    assert np.abs(got["U"]).max() > 10.0


@pytest.mark.slow
def test_density_current_golden_parity():
    """The configuration of ``test_reference_parity.
    test_parity_density_current`` (nex 16, nz 32, dt 0.1 s, nu2 300/300,
    Rayleigh) for 20 steps on the port, float64, against the reference's
    dump with that test's tolerances."""
    from test_reference_parity import load_golden, assert_state_close
    golden = load_golden("densitycurrent.bin.gz")[0]
    tc = t_xz.DensityCurrent()
    cfg = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ, nex=16, ney=1,
                         order=4, nz=32, ztop=tc.ztop, x_extent=tc.x_extent,
                         y_extent=tc.y_extent, dt=0.1, hyperdiffusion=False,
                         rayleigh_damping=True, dtype=torch.float64,
                         nu_uniform_scalar=300.0, nu_uniform_vector=300.0)
    geom = t_nh.build_nh_cartesian_geometry(
        cfg, rayleigh=tc.rayleigh_strength, bc_x="noflux")
    got, _ = _port_steps(tc, cfg, geom, steps=20)
    assert_state_close(got, golden, rtol_scalar=1e-4, rtol_vel=5e-3)
