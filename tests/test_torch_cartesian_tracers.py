"""Tracers on periodic Cartesian grids, the port against the JAX package in
float64 on the CPU: two seeded species (``synthetic.random_tracers_numpy``:
species of different size, some values negative, a column and an element
without positive mass) in the 3-D thermal bubble and the Schar mountain
waves of ``tests/test_torch_cartesian.py``, 3 steps of ``make_fast_step``
on both paths (Schar in both layouts), 1e-11 relative per field and per
species.  The tracers' column solve goes through ``banded_solve_multi``'s
wrapper.  One JAX step is compiled per configuration (module-scoped)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest

from tempestmodel_tpu import fast as j_fast
from tempestmodel_tpu_torch import fast as t_fast, convert
from tempestmodel_tpu_torch.fast import tracers as t_tracers
from tempestmodel_tpu_torch.kernels import synthetic

from test_torch_cartesian import CASES, _compare, _configs
from torch_port_common import CPU

NTR = 2
_configs = functools.lru_cache(maxsize=None)(_configs)


@functools.lru_cache(maxsize=None)
def _moist_start(name):
    """The case's reference-layout start with NTR seeded species, and its
    Rayleigh reference state (or None), as numpy arrays."""
    jtc, _, jcfg, _, jgeom, _ = _configs(name)
    js = {k: np.asarray(v) for k, v in jtc.initial_state(
        jgeom, jcfg.constants, dtype=jnp.float64).items()}
    P, A, B, nz = js["Rt"].shape
    flat = synthetic.random_tracers_numpy(nz, P, A, B, NTR, jcfg.order,
                                          seed=7)
    js["Tracers"] = np.moveaxis(flat.reshape(NTR, nz, P, A, B), 1, -1).copy()
    ref = None
    if CASES[name]["rayleigh"]:
        ref = {k: np.array(v) for k, v in jtc.reference_state(
            jgeom, jcfg.constants, dtype=jnp.float64).items()}
    return js, ref


@pytest.fixture(scope="module")
def runs():
    """3 steps of JAX ``make_fast_step`` per case (its default layout) and
    of the port per (case, path, layout); computed at first use."""
    cache = {}

    def jax_run(name):
        if ("jax", name) not in cache:
            _, _, jcfg, _, jgeom, _ = _configs(name)
            js, ref = _moist_start(name)
            first, step = j_fast.make_fast_step(
                jcfg, jgeom, ref_state=None if ref is None else {
                    k: jnp.asarray(v) for k, v in ref.items()})
            X, c = first(j_fast.pack_state(js))
            for _ in range(2):
                X, c = step(X, c)
            cache["jax", name] = {k: np.asarray(v) for k, v in
                                  j_fast.unpack_state(X, jcfg.nz).items()}
        return cache["jax", name]

    def torch_run(name, fused, swap):
        key = (name, fused, swap)
        if key not in cache:
            _, _, _, tcfg, _, tgeom = _configs(name)
            js, ref = _moist_start(name)
            first, step = t_fast.make_fast_step(
                tcfg, tgeom, device=CPU, fused=fused, swap_ab=swap,
                ref_state=ref)
            X, c = first(convert.state_from_numpy(js, device=CPU))
            for _ in range(2):
                X, c = step(X, c)
            cache[key] = {k: v.numpy() for k, v in
                          t_fast.unpack_state(X).items()}
        return cache[key]

    return jax_run, torch_run


def _species_err(got, want):
    """Worst relative error of a species, each against its own scale."""
    return max(float(np.abs(g - w).max() / (np.abs(w).max() + 1e-300))
               for g, w in zip(got, want))


RUNS = ([("bubble3d", f, None) for f in (None, False)]
        + [("schar", f, w) for f in (None, False) for w in (True, False)])


@pytest.mark.parametrize("name,fused,swap", RUNS, ids=[
    f"{n}-{'fused' if f is None else 'unfused'}"
    + ("" if w is None else ("-swapped" if w else "-natural"))
    for n, f, w in RUNS])
def test_three_steps_with_tracers_match_jax(runs, name, fused, swap):
    """3 Strang-HEVI steps with two species from the same start: the five
    fields (U and V against their common scale) and every species to
    1e-11 relative of JAX ``make_fast_step``."""
    jax_run, torch_run = runs
    want, got = jax_run(name), torch_run(name, fused, swap)
    assert set(got) == set(want)
    _compare(got, want, 1e-11)
    assert got["Tracers"].shape == want["Tracers"].shape
    assert got["Tracers"].shape[0] == NTR
    assert _species_err(got["Tracers"], want["Tracers"]) < 1e-11
    js, _ = _moist_start(name)
    assert _species_err(got["Tracers"], js["Tracers"]) > 1e-8   # they moved


def test_a_cartesian_tracer_step_solves_its_columns_once(monkeypatch):
    """The implicit half step solves every species of every column in one
    call of ``banded_solve_multi`` (two in ``first_step``, which has two
    implicit solves)."""
    calls = []
    orig = t_tracers.banded_solve_multi

    def counted(bands, rhs, q):
        calls.append(tuple(rhs.shape))
        return orig(bands, rhs, q)

    monkeypatch.setattr(t_tracers, "banded_solve_multi", counted)
    _, _, _, tcfg, _, tgeom = _configs("bubble3d")
    js, _ = _moist_start("bubble3d")
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU)
    X, c = first(convert.state_from_numpy(js, device=CPU))
    step(X, c)
    nz = tcfg.nz
    ncol = int(np.prod(js["Rt"].shape[:3]))
    assert calls == [(nz, NTR, ncol)] * 3
