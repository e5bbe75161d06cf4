"""The port's shallow-water and advection sets against the JAX package's,
float64 on the CPU: the ``ops/sem`` and ``models/hyperdiff`` operators on
seeded fields (1e-13 relative), the five test cases' initial states,
``sw_energy`` and ``sw_potential_enstrophy`` (1e-13), ``make_sw_step`` for
each case with order-4 hyperviscosity and for Williamson 5 with order 2
and none (3 steps, 1e-11 relative per field; with a tracer:
``tests/test_torch_sw_driver.py``), and ``make_advection_step``
with a fixed and a time-dependent wind (3 steps, 1e-12, mass within
1e-12).  ne3 p4; each JAX step is compiled once, in a module-scoped
fixture.  The kernels' plain versions stand in for the kernels here."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tempestmodel_tpu as tj
import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import advection as j_adv
from tempestmodel_tpu.models import hyperdiff as j_hd
from tempestmodel_tpu.models import shallow_water as j_sw
from tempestmodel_tpu.models import sw_model as j_swm
from tempestmodel_tpu.ops import sem as j_sem
from tempestmodel_tpu.testcases import shallow_water as j_tc
from tempestmodel_tpu_torch.models import advection as t_adv
from tempestmodel_tpu_torch.models import hyperdiff as t_hd
from tempestmodel_tpu_torch.models import shallow_water as t_sw
from tempestmodel_tpu_torch.models import sw_model as t_swm
from tempestmodel_tpu_torch.ops import sem as t_sem
from tempestmodel_tpu_torch.testcases import shallow_water as t_tc

from torch_port_common import CPU, rel_err

NE, P = 3, 4
OP_TOL, STATE_TOL, STEP_TOL, ADV_TOL = 1e-13, 1e-13, 1e-11, 1e-12
NSTEPS = 3
CASES = ("Williamson2", "Williamson5", "RossbyHaurwitz", "ShallowWaterEddy",
         "BarotropicInstability")
# order-4 viscosity that the ne3 grid takes stably at dt 600 s (the CLI's
# 1e15, scaled locally by (delta / reference_length)^3.2 = 1585 here, makes
# dt * nu * k^4 of order 1 at the grid scale); order 2 is a Laplacian
NU4, NU2, DT = 1e14, 1e5, 600.0


def configs(case=None, **kw):
    """(JAX cfg, port cfg) with the test case's constants (omega = 0 for
    the eddy, as ``Model`` reads them)."""
    base = dict(ne=NE, order=P, dt=DT, nu_scalar=NU4, nu_div=NU4,
                nu_vort=NU4)
    base.update(kw)
    jc, tc = tj.ModelConfig(**base), tt.ModelConfig(**base)
    if case is not None and hasattr(case[0], "physical_constants"):
        jc = jc.with_(constants=case[0].physical_constants(jc.constants))
        tc = tc.with_(constants=case[1].physical_constants(tc.constants))
    return jc, tc


def case_pair(name):
    return getattr(j_tc, name)(), getattr(t_tc, name)()


def geometries(jc, tc, case=None):
    topo = (None, None) if case is None else (
        getattr(case[0], "topography", None),
        getattr(case[1], "topography", None))
    return (j_swm.build_sw_geometry(jc, topo[0]),
            t_swm.build_sw_geometry(tc, topo[1]))


def to_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def grid():
    jc, tc = configs()
    jg, tg = geometries(jc, tc)
    return jc, tc, jg, tg


def field(seed, *trail):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((6, NE * P, NE * P) + trail)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trail", [(), (3,)])
def test_sem_operators_match_jax(grid, trail):
    _, _, jg, tg = grid
    d = float(tg.delta)
    fa, fb = field(1, *trail), field(2, *trail)
    ja, jb = jnp.asarray(fa), jnp.asarray(fb)
    ta, tb = torch.from_numpy(fa), torch.from_numpy(fb)
    D, S = np.asarray(jg.deriv), np.asarray(jg.stiff)
    pairs = [
        (j_sem.deriv_both(ja, D, NE, NE, P, d, d),
         t_sem.deriv_both(ta, tg.deriv, NE, NE, P, d, d)),
        ([j_sem.weak_div(ja, jb, S, NE, NE, P, d, d)],
         [t_sem.weak_div(ta, tb, tg.stiff, NE, NE, P, d, d)]),
        ([j_sem.weak_grad_a(ja, S, NE, NE, P, d),
          j_sem.weak_grad_b(ja, S, NE, NE, P, d)],
         [t_sem.weak_grad_a(ta, tg.stiff, NE, NE, P, d),
          t_sem.weak_grad_b(ta, tg.stiff, NE, NE, P, d)]),
        ([j_sem.deriv_a(ja, D, NE, NE, P, d),
          j_sem.deriv_b(ja, D, NE, NE, P, d)],
         [t_sem.deriv_a(ta, tg.deriv, NE, NE, P, d),
          t_sem.deriv_b(ta, tg.deriv, NE, NE, P, d)]),
    ]
    jD, tD = j_sem.block_diag_operator(D, NE), t_sem.block_diag_operator(
        torch.from_numpy(np.asarray(tg.deriv)), NE)
    jS, tS = j_sem.block_diag_operator(S, NE), t_sem.block_diag_operator(
        tg.stiff, NE)
    assert np.array_equal(jD, tD) and np.array_equal(jS, tS)
    pairs.append((
        [j_sem.deriv_a_dense(ja, jD, d), j_sem.deriv_b_dense(ja, jD, d),
         j_sem.weak_div_dense(ja, jb, jS, jS, d, d)],
        [t_sem.deriv_a_dense(ta, tD, d), t_sem.deriv_b_dense(ta, tD, d),
         t_sem.weak_div_dense(ta, tb, tS, tS, d, d)]))
    for want, got in pairs:
        for w, g in zip(want, got):
            assert tuple(g.shape) == tuple(w.shape)
            assert rel_err(g, w) < OP_TOL


@pytest.mark.parametrize("trail", [(), (2,)])
def test_hyperdiff_operators_match_jax(grid, trail):
    _, _, jg, tg = grid
    u, v, f = field(3, *trail), field(4, *trail), field(5, *trail)
    ju, jv, jf = map(jnp.asarray, (u, v, f))
    tu, tv, tf = map(torch.from_numpy, (u, v, f))
    want = [j_hd.scalar_laplacian(jf, jg), *j_hd.curl_and_div(ju, jv, jg),
            *j_hd.vector_hyperdiff_update(ju, jv, 0.7, 1.3, jg),
            j_hd._weak_grad_a(jf, jg), j_hd._weak_grad_b(jf, jg)]
    got = [t_hd.scalar_laplacian(tf, tg), *t_hd.curl_and_div(tu, tv, tg),
           *t_hd.vector_hyperdiff_update(tu, tv, 0.7, 1.3, tg),
           t_hd._weak_grad_a(tf, tg), t_hd._weak_grad_b(tf, tg)]
    if trail:
        # a Jacobian stack with the field's trailing axis
        jac = np.asarray(jg.jac2d)[..., None] * np.linspace(0.5, 1.5,
                                                            trail[0])
        want.append(j_hd.scalar_laplacian(jf, jg, jnp.asarray(jac)))
        got.append(t_hd.scalar_laplacian(tf, tg, jac))
    for w, g in zip(want, got):
        assert rel_err(g, w) < OP_TOL
    assert t_hd.nu_local_scale(tg) == j_hd.nu_local_scale(jg)


def test_sw_statics_hold_the_geometry(grid):
    """The device statics read by the step are the geometry's arrays (the
    2-D Jacobian as the nu4 kernels' scalar Jacobian)."""
    _, _, _, tg = grid
    st = t_swm.sw_statics(tg, CPU)
    for k in ("jac2d", "con2d", "coriolis", "topo", "area2d", "inv_mult"):
        assert np.array_equal(getattr(st, k).numpy(), np.asarray(
            getattr(tg, k)))
    m = st.hyper.m2d.numpy()
    assert np.array_equal(m[4], m[6])
    assert np.array_equal(m[6], np.asarray(tg.jac2d))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_sw_statics_share_the_engines_rotations_and_matrices(dtype):
    """The vector DSS's edge rotations and the nu4 kernels' element matrices
    of ``SWStatics`` are those the z-first engine builds on the same grid,
    in the grid's dtype."""
    from tempestmodel_tpu_torch.fast import engine, hyper_cuda
    tg = t_swm.build_sw_geometry(tt.ModelConfig(ne=2, order=P, dtype=dtype))
    st = t_swm.sw_statics(tg, CPU)
    fg = engine.build_fast_geometry(tg, dtype=dtype, device=CPU)
    assert st.e_rot.dtype == dtype
    assert torch.equal(st.e_rot, fg.e_rot)
    assert np.array_equal(st.hyper.ds_host,
                          hyper_cuda.hyper_statics(fg).ds_host)


# ---------------------------------------------------------------------------
# initial states and integrals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_initial_states_and_integrals_match_jax(name):
    case = case_pair(name)
    jc, tc = configs(case)
    jg, tg = geometries(jc, tc, case)
    js = case[0].initial_state(jg, jc.constants)
    ts = case[1].initial_state(tg, tc.constants, device=CPU)
    assert set(ts) == set(js) == {"U", "V", "H"}
    for k in js:
        assert ts[k].dtype == torch.float64
        assert rel_err(ts[k], js[k]) < STATE_TOL
    assert rel_err(np.asarray(tg.topo), np.asarray(jg.topo)) <= STATE_TOL
    e_j = float(j_sw.sw_energy(js, jg, jc.constants))
    e_t = float(t_sw.sw_energy(ts, tg, tc.constants))
    assert abs(e_t - e_j) <= STATE_TOL * abs(e_j)
    zeta = np.asarray(j_hd.curl_and_div(js["U"], js["V"], jg)[0]) \
        * np.asarray(jg.jac2d)
    z_j = float(j_sw.sw_potential_enstrophy(js, jnp.asarray(zeta), jg))
    z_t = float(t_sw.sw_potential_enstrophy(ts, torch.from_numpy(zeta), tg))
    assert abs(z_t - z_j) <= STATE_TOL * abs(z_j)


def test_williamson5_topography_matches_jax():
    lon = np.linspace(0.0, 2.0 * np.pi, 37)[:, None]
    lat = np.linspace(-0.5 * np.pi, 0.5 * np.pi, 19)[None, :]
    j5, t5 = case_pair("Williamson5")
    assert np.array_equal(t5.topography(lon, lat), j5.topography(lon, lat))


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

STEP_VARIANTS = [(name, {}) for name in CASES] + [
    ("Williamson5", {"hypervis_order": 2, "nu_scalar": NU2,
                     "nu_div": NU2, "nu_vort": NU2}),
    ("Williamson5", {"hyperdiffusion": False})]
# the cases on the flat grid with Earth's constants share one step
FLAT = ("Williamson2", "RossbyHaurwitz", "BarotropicInstability")


def variant_id(v):
    name, kw = v
    return name + ("" if not kw else "-order2" if "hypervis_order" in kw
                   else "-nohypervis")


@pytest.fixture(scope="module")
def steppers():
    """Each package's step of a (grid, configuration), built once: the
    JAX step compiles at its first call only."""
    made = {}

    def get(name, kw):
        key = ("flat" if name in FLAT else name, tuple(sorted(kw.items())))
        if key not in made:
            case = case_pair(name)
            jc, tc = configs(case, **kw)
            jg, tg = geometries(jc, tc, case)
            made[key] = (jc, tc, jg, tg, j_swm.make_sw_step(jc, jg),
                         t_swm.make_sw_step(tc, tg, device=CPU))
        return made[key]

    return get


@pytest.fixture(scope="module", params=STEP_VARIANTS, ids=variant_id)
def step_pair(request, steppers):
    """3 steps of each package from the case's start: (JAX state, port
    state, port cfg, port geometry, port test case)."""
    name, kw = request.param
    case = case_pair(name)
    jc, tc, jg, tg, jstep, tstep = steppers(name, kw)
    js = case[0].initial_state(jg, jc.constants)
    ts = case[1].initial_state(tg, tc.constants, device=CPU)
    for _ in range(NSTEPS):
        js, ts = jstep(js), tstep(ts)
    return to_np(js), ts, tc, tg, case[1]


def test_sw_step_matches_jax(step_pair):
    js, ts, _, _, _ = step_pair
    assert set(ts) == set(js)
    for k in js:
        assert np.isfinite(ts[k].numpy()).all()
        assert rel_err(ts[k], js[k]) < STEP_TOL, k


def test_sw_plain_path_matches_the_wrappers_on_the_cpu(step_pair):
    """``plain=True`` (the kernels' plain versions called directly) gives
    what the wrappers give on CPU tensors, bit for bit."""
    _, _, tc, tg, case = step_pair
    ts = case.initial_state(tg, tc.constants, device=CPU)
    a = t_swm.make_sw_step(tc, tg, device=CPU)(ts)
    b = t_swm.make_sw_step(tc, tg, device=CPU, plain=True)(ts)
    for k in a:
        assert torch.equal(a[k], b[k])


# ---------------------------------------------------------------------------
# advection
# ---------------------------------------------------------------------------

ADV_DT, ADV_PERIOD = 1800.0, 12.0 * 86400.0


def bells(geom):
    """Two cosine bells, at (3pi/2, 0) and (pi/2, pi/6), (2, 6, A, B)."""
    lon, lat = np.asarray(geom.lon), np.asarray(geom.lat)
    out = []
    for lon0, lat0 in ((1.5 * np.pi, 0.0), (0.5 * np.pi, np.pi / 6.0)):
        r = np.arccos(np.clip(np.sin(lat0) * np.sin(lat) + np.cos(lat0)
                              * np.cos(lat) * np.cos(lon - lon0), -1, 1))
        out.append(np.where(r < 1.0 / 3.0,
                            0.5 * (1 + np.cos(3.0 * np.pi * r)), 0.0))
    return np.stack(out)


def solid_body(geom, constants):
    """Covariant (U, V) of solid-body rotation along the equator."""
    lat = np.asarray(geom.lat)
    u0 = 2 * np.pi * constants.earth_radius / ADV_PERIOD
    return t_tc.sphere_velocity_to_covariant(
        u0 * np.cos(lat), np.zeros_like(lat), geom, constants)


@pytest.mark.parametrize("timed", [False, True], ids=["fixed", "callable"])
def test_advection_step_matches_jax(timed):
    jc, tc = configs(dt=ADV_DT)
    jg, tg = geometries(jc, tc)
    U, V = solid_body(tg, tc.constants)
    w = 2.0 * np.pi / (2.0 * ADV_DT)
    if timed:
        def jwind(t):
            s = jnp.cos(w * t)
            return s * jnp.asarray(U), s * jnp.asarray(V)

        tU, tV = torch.from_numpy(U), torch.from_numpy(V)

        def twind(t):
            s = torch.cos(w * t)
            return s * tU, s * tV
    else:
        jwind = (jnp.asarray(U), jnp.asarray(V))
        twind = (torch.from_numpy(U), torch.from_numpy(V))
    q0 = bells(tg)
    jstep = j_adv.make_advection_step(jc, jg, jwind)
    tstep = t_adv.make_advection_step(tc, tg, twind, device=CPU)
    jq, tq = jnp.asarray(q0), torch.from_numpy(q0.copy())
    t = 0.0
    for _ in range(NSTEPS):
        jq = jstep(jq, t)
        tq = tstep(tq, torch.tensor(t, dtype=torch.float64))
        t += ADV_DT
    assert rel_err(tq, jq) < ADV_TOL
    area = np.asarray(tg.area2d)
    for i in range(q0.shape[0]):
        m0 = float((q0[i] * area).sum())
        m = float((tq[i].numpy() * area).sum())
        assert abs(m / m0 - 1.0) < 1e-12
