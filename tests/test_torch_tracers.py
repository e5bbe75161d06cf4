"""Tracer transport of the port vs the JAX package's, float64 on the CPU:
each function of ``fast/tracers.py``, the DSS and the hyperdiffusion tail
with tracers in the state, and the moist slice as a whole (3 steps of
``make_fast_step`` with three tracer species, fused and unfused, both
Jacobian modes; ``make_fast_multistep``; the kernels a moist step goes
through).

Every comparison runs on tracers made from a seed: three species of
different size, a tenth of the values small and negative, whole columns and
whole elements without positive mass.  (Two of the moist baroclinic wave's
three species are all zeros, which would hide a mix-up of species and never
reach the positivity filters.)"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu.fast import engine as j_engine, tracers as j_tracers
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.fast import engine as t_engine, tracers as t_tracers
from tempestmodel_tpu_torch.kernels import synthetic
from tempestmodel_tpu_torch.kernels.counts import launch_counts

from torch_port_common import (build_pair, CPU, perturbed_umjs_state, rel_err,
                               terrain_like_pair)

TOL = 1e-12
NTR = 3
ALL = ("U", "V", "Rt", "Rho", "W", "Tracers")


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def moist_state_numpy(jcfg, jgeom, seed):
    """The perturbed UMJS start (z-first) with three seeded species."""
    d = perturbed_umjs_state(jcfg, jgeom, seed=seed)
    A = jcfg.ne * jcfg.order
    d["Tracers"] = synthetic.random_tracers_numpy(jcfg.nz, 6, A, A, NTR,
                                                  jcfg.order, seed=seed + 1)
    return d


def both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v.copy()) for k, v in d.items()})


@pytest.fixture(scope="module")
def fgs(pair):
    """Both z-first geometries with a terrain-like metric and a 3-D Jacobian
    that varies against the 2-D one, and two moist states."""
    jcfg, jgeom, _, _ = pair
    jfg = j_engine.build_fast_geometry(jgeom, dtype=jnp.float64)
    jfg, tfg = terrain_like_pair(jfg, seed=2, vary_jac=True)
    d1, d2 = (moist_state_numpy(jcfg, jgeom, s) for s in (3, 13))
    return jfg, tfg, both(d1), both(d2)


def species_err(got, want, nz):
    got, want = np.asarray(got), np.asarray(want)
    return max(rel_err(got[i:i + nz], want[i:i + nz])
               for i in range(0, want.shape[0], nz))


def test_the_seeded_tracers_reach_every_branch_of_the_filters(fgs):
    _, tfg, (_, td), _ = fgs
    nz, p = tfg.nz, tfg.p
    t = td["Tracers"].reshape(NTR, nz, 6, tfg.A, tfg.B)
    scale = t.abs().amax(dim=(1, 2, 3, 4))
    assert float(scale[0] / scale[1]) > 5 and float(scale[1] / scale[2]) > 5
    assert 0.02 < float((t < 0).double().mean()) < 0.3
    assert bool((t.clamp_min(0).sum(dim=1) == 0).any())       # a column
    e = t.clamp_min(0).reshape(NTR, nz, 6, tfg.A // p, p, tfg.B // p, p)
    assert bool((e.sum(dim=(4, 6)) == 0).any())               # an element


def test_ntr_and_bcast_mul(fgs):
    jfg, tfg, (jd, td), _ = fgs
    assert t_tracers._ntr(td["Tracers"], tfg.nz) == NTR
    with pytest.raises(ValueError):
        t_tracers._ntr(td["W"], tfg.nz)
    got = t_tracers._bcast_mul(tfg.jac3d, td["Tracers"], NTR)
    want = j_tracers._bcast_mul(jfg.jac3d, jd["Tracers"], NTR)
    assert got.is_contiguous() and got.shape == td["Tracers"].shape
    assert rel_err(got.numpy(), want) < 1e-15


@pytest.mark.parametrize("two", [False, True], ids=["one_base", "two_base"])
def test_horizontal_update(fgs, two):
    jfg, tfg, (jd, td), (jb, tb) = fgs
    jbase = ((0.3, jd["Tracers"]), (0.7, jb["Tracers"])) if two \
        else jb["Tracers"]
    tbase = ((0.3, td["Tracers"]), (0.7, tb["Tracers"])) if two \
        else tb["Tracers"]
    # at 25 s the increment shows; at 1e7 s it is all there is
    for dt_s in (25.0, 1e7):
        want = jax.jit(lambda b, x: j_tracers.horizontal_update(
            b, x, dt_s, jfg))(jbase, jd)
        got = t_tracers.horizontal_update(tbase, td, dt_s, tfg)
        assert got.is_contiguous()
        assert species_err(got.numpy(), want, tfg.nz) < TOL


def test_tracer_band_statics(fgs):
    jfg, tfg, _, _ = fgs
    want = j_tracers._tracer_band_statics(jfg)
    got = t_tracers._tracer_band_statics(tfg)
    assert got["q"] == want["q"] == 1
    for name in ("S", "Pl_d", "Pr_d"):
        assert set(got[name]) == set(want[name]) == {-1, 0, 1}
        for o in got[name]:
            np.testing.assert_array_equal(got[name][o], want[name][o])
    st = t_tracers.tracer_statics(tfg)
    nz = tfg.nz
    assert st.q == 1 and tuple(st.S.shape) == (3 * nz, nz + 1)
    for k in range(nz):
        for d, o in enumerate((-1, 0, 1)):
            np.testing.assert_array_equal(st.S[3 * k + d].numpy(),
                                          want["S"][o][k])
            assert float(st.Pl_d[k, d, 0]) == want["Pl_d"][o][k]
    assert st.mask[:, 0].tolist() == [0.0] + [1.0] * (nz - 1) + [0.0]


def test_update_column_tracers(fgs):
    """The linear implicit column update: the Jacobian and the flux from the
    NEW W, the penalty weights from the old one (the JAX function takes its
    plain banded path on the CPU)."""
    jfg, tfg, (jd, td), _ = fgs
    w_new = np.asarray(jd["W"]) + 0.02 * np.random.default_rng(8) \
        .standard_normal(jd["W"].shape)
    dt = 100.0
    want = jax.jit(lambda x, w: j_tracers.update_column_tracers(
        x, w, jfg, dt))(jd, jnp.asarray(w_new))
    before = dict(launch_counts)
    got = t_tracers.update_column_tracers(td, torch.from_numpy(w_new), tfg,
                                          dt)
    assert dict(launch_counts) == before          # CPU tensors: no launch
    assert got.is_contiguous() and got.shape == td["Tracers"].shape
    assert species_err(got.numpy(), want, tfg.nz) < TOL
    # the update moved the tracers by more than the tolerance sees
    assert rel_err(got.numpy(), td["Tracers"].numpy()) > 1e-6
    st = t_tracers.tracer_statics(tfg)
    again = t_tracers.update_column_tracers(
        td, torch.from_numpy(w_new), tfg, dt, statics=st, plain=True)
    assert torch.equal(got, again)
    # old and new W are not interchangeable
    swapped = t_tracers.update_column_tracers(
        dict(td, W=torch.from_numpy(w_new)), td["W"], tfg, dt, statics=st)
    assert rel_err(swapped.numpy(), got.numpy()) > 1e-8


@pytest.mark.parametrize("name", ["filter_column", "filter_horizontal",
                                  "scalar_laplacian_tr"])
def test_filters_and_laplacian(fgs, name):
    jfg, tfg, (jd, td), _ = fgs
    want = getattr(j_tracers, name)(jd["Tracers"], jfg)
    got = getattr(t_tracers, name)(td["Tracers"], tfg)
    assert got.is_contiguous() and got.shape == td["Tracers"].shape
    assert bool(torch.isfinite(got).all())
    assert species_err(got.numpy(), want, tfg.nz) < TOL
    if name.startswith("filter"):
        assert float(got.min()) >= 0.0
        assert rel_err(got.numpy(), td["Tracers"].numpy()) > 1e-3
        # mass is kept where there was positive mass to keep
        area = tfg.area3d[None]
        t5 = td["Tracers"].reshape((NTR,) + tuple(tfg.area3d.shape))
        g5 = got.reshape(t5.shape)
        if name == "filter_column":
            m0, m1 = (t5 * area).sum(1), (g5 * area).sum(1)
        else:
            p = tfg.p
            shp = (NTR, tfg.nz, 6, tfg.A // p, p, tfg.B // p, p)
            m0 = (t5 * area).reshape(shp).sum((4, 6))
            m1 = (g5 * area).reshape(shp).sum((4, 6))
        keep = m0 > 0
        assert bool(keep.any()) and not bool(keep.all())
        assert float(((m1 - m0)[keep] / m0[keep]).abs().max()) < 1e-12
        assert float(m1[~keep].abs().max()) == 0.0


def test_species_do_not_mix(fgs):
    """Swapping two species of the input swaps them in the output, for every
    function that takes the flat field."""
    _, tfg, (_, td), _ = fgs
    nz = tfg.nz
    perm = torch.cat([torch.arange(nz, 2 * nz), torch.arange(0, nz),
                      torch.arange(2 * nz, 3 * nz)])
    tr = td["Tracers"]
    sw = dict(td, Tracers=tr[perm].contiguous())
    w_new = td["W"] * 1.01
    for fn in (lambda d: t_tracers.filter_column(d["Tracers"], tfg),
               lambda d: t_tracers.filter_horizontal(d["Tracers"], tfg),
               lambda d: t_tracers.scalar_laplacian_tr(d["Tracers"], tfg),
               lambda d: t_tracers.horizontal_update(d["Tracers"], d, 1e7,
                                                     tfg),
               lambda d: t_tracers.update_column_tracers(d, w_new, tfg, 50.0),
               lambda d: t_engine.apply_dss(d, tfg)["Tracers"]):
        a, b = fn(td), fn(sw)
        assert rel_err(b.numpy(), a[perm].numpy()) < 1e-14
        assert rel_err(b.numpy(), a.numpy()) > 0.1


@pytest.fixture(scope="module")
def jax_dss(fgs):
    jfg, _, (jd, _), _ = fgs
    return j_engine.apply_dss(jd, jfg)


@pytest.mark.parametrize("merge", [(), ("state",), ("scalar2",),
                                   ("state", "scalar2")],
                         ids=["separate", "state", "scalar2", "both"])
def test_apply_dss_with_tracers(fgs, jax_dss, merge):
    _, tfg, (_, td), _ = fgs
    want = jax_dss
    got = t_engine.apply_dss(td, tfg, merge=merge)
    plain = t_engine.apply_dss(td, tfg, merge=merge, plain=True)
    assert set(got) == set(want) == set(ALL)
    for k in ALL:
        assert got[k].is_contiguous(), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-13 * float(
                                       np.abs(want[k]).max()))
        assert torch.equal(got[k], plain[k]), k


def test_apply_dss_with_tracers_and_the_w_finish(pair, fgs):
    """After a deferred fused stage with tracers: (U, V, W) in one launch,
    the tracers beside it, against the JAX package's kernels in interpret
    mode."""
    from tempestmodel_tpu.fast import stage_pallas
    from tempestmodel_tpu_torch.fast import stage_cuda
    jcfg, _, tcfg, _ = pair
    jfg, tfg, (jd, td), _ = fgs
    jupd, jwf = stage_pallas.fused_stage(jd, jd, 25.0, jfg, jcfg.constants,
                                         interpret=True, defer_w=True)
    want = j_engine.apply_dss(jupd, jfg, w_finish=jwf)
    tupd, twf = stage_cuda.fused_stage(td, td, 25.0, tfg, tcfg.constants,
                                       defer_w=True)
    for merge in ((), ("scalar2",)):
        got = t_engine.apply_dss(tupd, tfg, w_finish=twf, merge=merge)
        assert set(got) == set(ALL)
        for k in ALL:
            assert rel_err(got[k].numpy(), want[k]) < TOL, k


@pytest.mark.parametrize("order", [4, 2, 0], ids=["nu4", "nu2", "none"])
def test_step_after_subcycle_with_tracers(pair, fgs, order):
    """The tail with tracers: their Laplacian beside the five fields', and
    the per-element positivity filter before the last DSS -- also when
    there is no hyperdiffusion at all."""
    jcfg, _, tcfg, _ = pair
    jfg, tfg, (jd, td), _ = fgs
    kw = dict(hypervis_order=order) if order else dict(hyperdiffusion=False)
    jc, tc = jcfg.with_(**kw), tcfg.with_(**kw)
    want = jax.jit(lambda x: j_engine.step_after_subcycle(
        x, jc.dt, jc, jfg))(jd)
    got = t_engine.step_after_subcycle(td, tc.dt, tc, tfg)
    assert set(got) == set(want) == set(ALL)
    for k in ALL:
        assert rel_err(got[k].numpy(), want[k]) < TOL, k
    assert species_err(got["Tracers"].numpy(), want["Tracers"],
                       tfg.nz) < TOL
    assert rel_err(got["Tracers"].numpy(), td["Tracers"].numpy()) > 1e-3
    if order == 4:
        # the two nu4 kernels' wrappers (their plain versions here) around
        # the same tracer code
        fused = t_engine.step_after_subcycle(td, tc.dt, tc, tfg,
                                             use_fused_hyper=True)
        for k in ALL:
            assert rel_err(fused[k].numpy(), got[k].numpy()) < TOL, k


# --- the slice as a whole ---------------------------------------------------

def _run_torch(tcfg, tgeom, d, nsteps, **kw):
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU, **kw)
    X0 = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    X, c = first(X0)
    for k in X0:                                  # the input is left alone
        np.testing.assert_array_equal(X0[k].numpy(), d[k])
    for _ in range(nsteps - 1):
        X, c = step(X, c)
    return X, c


@pytest.fixture(scope="module")
def three_steps(pair):
    """3 moist steps of JAX ``make_fast_step`` per Jacobian mode (computed at
    first use, kept for the module), and of the port per (mode, path)."""
    jcfg, jgeom, tcfg, tgeom = pair
    d = moist_state_numpy(jcfg, jgeom, seed=21)
    cache = {}

    def jax_run(mode):
        if ("jax", mode) not in cache:
            first, step = j_fast.make_fast_step(
                jcfg.with_(jacobian_mode=mode), jgeom)
            X, c = first({k: jnp.asarray(v) for k, v in d.items()})
            for _ in range(2):
                X, c = step(X, c)
            cache["jax", mode] = ({k: np.asarray(v) for k, v in X.items()},
                                  set(c))
        return cache["jax", mode]

    def torch_run(mode, fused):
        if (mode, fused) not in cache:
            cache[mode, fused] = _run_torch(
                tcfg.with_(jacobian_mode=mode), tgeom, d, 3, fused=fused)
        return cache[mode, fused]

    return jax_run, torch_run, d


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("mode", ["exact", "reference"])
def test_three_moist_steps_match_jax(three_steps, mode, fused):
    """The same perturbed moist state through 3 Strang-HEVI steps of both
    packages: 1e-11 relative on the five fields and on every species."""
    jax_run, torch_run, d = three_steps
    (want, wcarry), (got, carry) = jax_run(mode), torch_run(mode, fused)
    assert set(got) == set(want) == set(ALL)
    assert set(carry) == wcarry == {"Rt", "W", "Rho", "Tracers"}
    for k in ALL:
        assert rel_err(got[k].numpy(), want[k]) < 1e-11, k
    assert species_err(got["Tracers"].numpy(), want["Tracers"],
                       d["Rt"].shape[0]) < 1e-11
    assert float(got["Tracers"].min()) >= 0.0
    assert rel_err(got["Tracers"].numpy(), d["Tracers"]) > 1e-3


def test_moist_fused_path_matches_unfused_path(three_steps):
    _, torch_run, _ = three_steps
    (a, _), (b, _) = torch_run("exact", None), torch_run("exact", False)
    for k in ALL:
        assert rel_err(a[k].numpy(), b[k].numpy()) < 1e-11, k


def test_moist_multistep_equals_the_eager_steps(pair, three_steps):
    """``make_fast_multistep(3)`` after ``first_step``: the bits of 3 eager
    steps, the tracers and their carry included."""
    _, _, tcfg, tgeom = pair
    _, _, d = three_steps
    X0 = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    first, multi = t_fast.make_fast_multistep(tcfg, tgeom, 3, device=CPU)
    X, c = multi(*first(X0))
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU)
    E, ce = first(X0)
    for _ in range(3):
        E, ce = step(E, ce)
    assert set(X) == set(ALL) and set(c) == {"Rt", "W", "Rho", "Tracers"}
    for k in ALL:
        assert torch.equal(X[k], E[k]), k
    for k in c:
        assert torch.equal(c[k], ce[k]), k


@pytest.mark.parametrize("kw,want", [
    ({}, {"stage": 5, "uvw": 5, "update": 1, "banded": 0, "multi": 1,
          "pass1": 1, "pass2": 1, "scalar": 23, "vector": 2, "state": 0,
          "scalar2": 0}),
    ({"fused": False},
     {"stage": 0, "uvw": 0, "update": 0, "banded": 1, "multi": 1, "pass1": 0,
      "pass2": 0, "scalar": 28, "vector": 7, "state": 0, "scalar2": 0}),
    ({"dss_merge": ("state", "scalar2")},
     {"stage": 5, "uvw": 5, "update": 1, "banded": 0, "multi": 1, "pass1": 1,
      "pass2": 1, "scalar": 7, "vector": 0, "state": 2, "scalar2": 5}),
    ({"cfg": {"vertical_solver": "banded"}},
     {"stage": 5, "uvw": 5, "update": 0, "banded": 0, "multi": 1, "pass1": 1,
      "pass2": 1, "scalar": 23, "vector": 2, "state": 0, "scalar2": 0})],
    ids=["predicates", "forced_unfused", "one_launch_dss", "banded_solver"])
def test_a_moist_step_goes_through_the_wrappers(pair, three_steps,
                                                monkeypatch, kw, want):
    """Calls of the kernels' wrappers in one moist ``step`` (on the CPU each
    runs its plain version): the dry step's, plus one ``dss_scalar`` per DSS
    for the flat tracer field (5 stages + 2 in the tail) and one
    ``banded_solve_multi``; the fused stage stays one call a stage.  The
    tracer solve takes the multi-right-hand-side kernel whatever
    ``vertical_solver`` says (the JAX package chooses it by backend), while
    ``"banded"`` solves the Newton systems in plain tensor code, as the JAX
    package's ``"banded"`` does.  The fused path's DSS groups its fields as
    ``DSS_MERGE_DEFAULT`` says (the tracer field is a launch of its own
    whatever the grouping)."""
    from tempestmodel_tpu_torch.fast import (dss_cuda, hyper_cuda, implicit,
                                             implicit_cuda, stage_cuda)
    _, _, tcfg, tgeom = pair
    _, _, d = three_steps
    if "dss_merge" not in kw and kw.get("fused", True):
        for name in t_engine.DSS_MERGE_DEFAULT:
            assert name in ("state", "scalar2")
        if "state" in t_engine.DSS_MERGE_DEFAULT:
            want = dict(want, state=2, vector=0, scalar=want["scalar"] - 6)
        if "scalar2" in t_engine.DSS_MERGE_DEFAULT:
            pairs = 5 if "state" in t_engine.DSS_MERGE_DEFAULT else 7
            want = dict(want, scalar2=pairs,
                        scalar=want["scalar"] - 2 * pairs)
    calls = dict.fromkeys(want, 0)

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(stage_cuda, "fused_stage",
                        counting("stage", stage_cuda.fused_stage))
    monkeypatch.setattr(implicit_cuda, "fused_implicit_update", counting(
        "update", implicit_cuda.fused_implicit_update))
    monkeypatch.setattr(implicit, "banded_solve",
                        counting("banded", implicit.banded_solve))
    monkeypatch.setattr(t_tracers, "banded_solve_multi",
                        counting("multi", t_tracers.banded_solve_multi))
    for key, name in (("pass1", "nu4_pass1"), ("pass2", "nu4_pass2")):
        monkeypatch.setattr(hyper_cuda, name,
                            counting(key, getattr(hyper_cuda, name)))
    for key in ("uvw", "scalar", "vector", "state", "scalar2"):
        monkeypatch.setattr(dss_cuda, f"dss_{key}",
                            counting(key, getattr(dss_cuda, f"dss_{key}")))
    kw = dict(kw)
    cfg = tcfg.with_(**kw.pop("cfg", {}))
    first, step = t_fast.make_fast_step(cfg, tgeom, device=CPU, **kw)
    X = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    carry = {k: torch.zeros_like(X[k])
             for k in ("Rt", "W", "Rho", "Tracers")}
    step(X, carry)
    assert calls == want
    # first_step has one implicit half step more: one more of each solve
    calls = dict.fromkeys(want, 0)
    first(X)
    assert calls["multi"] == 2
    assert calls["update"] + calls["banded"] == \
        2 * (want["update"] + want["banded"])


def test_the_moist_baroclinic_wave_runs(pair):
    """The test case itself (species 1 and 2 start at zero) through
    ``pack_state``, ``first_step`` and a ``step``: finite, the zero species
    stay zero, and the mass of species 0 is kept."""
    from tempestmodel_tpu_torch.testcases.dcmip2016 import MoistBaroclinicWave
    _, _, tcfg, tgeom = pair
    state = MoistBaroclinicWave().initial_state(tgeom, tcfg.constants,
                                                device=CPU)
    X0 = t_fast.pack_state(state, device=CPU)
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU, ntracers=3)
    X, c = step(*first(X0))
    nz = tcfg.nz
    fg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64, device=CPU)
    for k in ALL:
        assert bool(torch.isfinite(X[k]).all()), k
    assert float(X["Tracers"][nz:].abs().max()) == 0.0
    mass0 = float((X0["Tracers"][:nz] * fg.area3d).sum())
    mass1 = float((X["Tracers"][:nz] * fg.area3d).sum())
    assert mass0 > 0.0 and abs(mass1 - mass0) / mass0 < 1e-10
    back = t_fast.unpack_state(X)
    assert tuple(back["Tracers"].shape) == tuple(state["Tracers"].shape)
    with pytest.raises(NotImplementedError):
        t_fast.make_fast_step(tcfg, tgeom, device=CPU, mesh=object())


@pytest.mark.gpu
def test_moist_kernel_path_matches_plain_path_on_the_card(pair, three_steps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    _, _, tcfg, tgeom = pair
    _, _, d = three_steps
    X0 = {k: torch.from_numpy(v.copy()).cuda() for k, v in d.items()}
    outs = []
    for kw in ({}, {"fused": False}, {"plain": True}):
        before = launch_counts["banded_solve_multi"]
        first, step = t_fast.make_fast_step(tcfg, tgeom, device="cuda", **kw)
        X, c = first(X0)
        X, c = step(X, c)
        torch.cuda.synchronize()
        assert launch_counts["banded_solve_multi"] - before == \
            (0 if kw.get("plain") else 3)
        outs.append(X)
    for other in outs[1:]:
        for k in ALL:
            assert rel_err(outs[0][k].cpu().numpy(),
                           other[k].cpu().numpy()) < 1e-11, k
    first, multi = t_fast.make_fast_multistep(tcfg, tgeom, 1, device="cuda")
    X, c = multi(*first(X0))
    for k in ALL:
        assert rel_err(X[k].cpu().numpy(), outs[0][k].cpu().numpy()) < 1e-13


@pytest.mark.gpu
def test_a_moist_banded_step_launches_the_multi_kernel_on_the_card(
        pair, three_steps):
    """With ``vertical_solver="banded"`` the tracer columns are solved by the
    ``banded_solve_multi`` kernel on the card, once per implicit half step,
    and the result is the plain path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    _, _, tcfg, tgeom = pair
    _, _, d = three_steps
    cfg = tcfg.with_(vertical_solver="banded")
    X0 = {k: torch.from_numpy(v.copy()).cuda() for k, v in d.items()}
    outs = []
    for plain in (False, True):
        before = launch_counts["banded_solve_multi"]
        first, step = t_fast.make_fast_step(cfg, tgeom, device="cuda",
                                            plain=plain)
        X, c = step(*first(X0))
        torch.cuda.synchronize()
        assert launch_counts["banded_solve_multi"] - before == \
            (0 if plain else 3)
        outs.append(X)
    for k in ALL:
        assert rel_err(outs[0][k].cpu().numpy(),
                       outs[1][k].cpu().numpy()) < 1e-11, k
