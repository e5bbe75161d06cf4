"""The port's Schur column solver against the JAX package's, float64 on
the CPU.

JAX's ``make_strang_step`` hands its Schur solve a half-bandwidth q = 0
(only ``"banded"`` and ``"pallas"`` get ``estimate_bandwidth``), and with
q = 0 its band extraction seeds one colouring, so the "bands" are the
Jacobian's row sums on the diagonal and every W coupling of the Schur
system is lost.  The port does not copy that: its Schur solve takes the
exact bands at the estimated q.  So the solve is held against JAX's
``nonhydro.vertical_implicit(solver="schur", q=estimate_bandwidth(...))``
called directly (1e-11), and the port's Schur solve against its own dense
one within ``tests/test_jfnk.py``'s bar; and the step reaches the banded
kernel's wrapper with the reduced system's half-bandwidth 4 vo + 5 = 9.
(The dense solver's steps are in ``test_torch_vertical_solvers.py``.)"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempestmodel_tpu_torch as tt
from tempestmodel_tpu.models import nonhydro as j_nonh
from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.fast import engine as t_engine
from tempestmodel_tpu_torch.fast import implicit as t_imp
from tempestmodel_tpu_torch.models import (nh_model as t_nh,
                                           nonhydro as t_nonh,
                                           vertical_schur)

from torch_port_common import CPU, FIELDS, build_pair, perturbed_umjs_state
from test_torch_vertical_solvers import STEPS, TOL


def _port_solve(tgeom, tcfg, d, dt, iters, solver, plain=False):
    fg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64, device=CPU) \
        if tcfg.grid_kind == tt.GridKind.CUBED_SPHERE else \
        t_engine.build_fast_geometry_cartesian(tgeom, dtype=torch.float64,
                                               device=CPU, swap_ab=False)
    q = t_nonh.estimate_bandwidth(tgeom, tcfg.constants)
    st = t_imp.statics_to_device(t_nonh.band_assembly_statics(tgeom, q),
                                 torch.float64, CPU)
    sch = vertical_schur.schur_statics(fg.nz, q, fg.vo, torch.float64, CPU)
    td = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
    return t_imp.vertical_implicit(td, fg, tcfg.constants, dt, q, st,
                                   newton_iters=iters, solver=solver,
                                   schur=sch, plain=plain), q


@pytest.fixture(scope="module")
def umjs_pair():
    return build_pair(ne=2, nz=6)


@pytest.mark.parametrize("iters", [1, 2])
def test_schur_solve_matches_jax_schur_at_the_estimated_bandwidth(umjs_pair,
                                                                 iters):
    """The perturbed UMJS start (seeded noise, W of 0.01) at ne2 p4 nz6,
    dt 300 s: the port's Schur solve against JAX's, both at the estimated
    half-bandwidth."""
    jcfg, jgeom, tcfg, tgeom = umjs_pair
    d = perturbed_umjs_state(jcfg, jgeom, seed=3)
    dt = 300.0
    q = j_nonh.estimate_bandwidth(jgeom, jcfg.constants)
    jout = j_nonh.vertical_implicit(
        {k: jnp.asarray(np.moveaxis(v, 0, -1)) for k, v in d.items()},
        jgeom, jcfg.constants, dt, solver="schur", q=q, newton_iters=iters)
    got, tq = _port_solve(tgeom, tcfg, d, dt, iters, "schur")
    assert tq == q == 4
    for k in ("Rt", "W", "Rho"):
        want = np.moveaxis(np.asarray(jout[k]), -1, 0)
        g = got[k].numpy()
        assert np.isfinite(g).all()
        assert np.abs(want - d[k]).max() > 1e-6 * np.abs(d[k]).max(), k
        err = np.abs(g - want).max() / np.abs(want).max()
        assert err < TOL, (k, err)


def test_schur_solve_within_the_bar_of_the_dense_solve():
    """``tests/test_jfnk.py``'s Schur check on the port: the thermal bubble
    (nex 8, nz 16), dt 0.5 s, 3 Newton iterations, Schur against dense to
    1e-6 of max(scale, 1)."""
    tc = tt.ModelConfig(grid_kind=tt.GridKind.CARTESIAN_XZ, nex=8, ney=1,
                        order=4, nz=16, ztop=1000.0,
                        x_extent=(0.0, 1000.0), y_extent=(-500.0, 500.0),
                        dt=0.05, dtype=torch.float64)
    from tempestmodel_tpu_torch.testcases.nonhydro_xz import ThermalBubble
    geom = t_nh.build_nh_cartesian_geometry(tc)
    s0 = ThermalBubble().initial_state(geom, tc.constants, device=CPU)
    d = {k: np.moveaxis(v.numpy(), -1, 0) for k, v in s0.items()}
    dense, _ = _port_solve(geom, tc, d, 0.5, 3, "dense")
    schur, _ = _port_solve(geom, tc, d, 0.5, 3, "schur")
    for k in ("Rt", "W", "Rho"):
        scale = float(dense[k].abs().max())
        err = float((dense[k] - schur[k]).abs().max())
        assert err < 1e-6 * max(scale, 1.0), (k, err, scale)
        assert torch.isfinite(schur[k]).all()


def test_schur_step_solves_its_reduced_system_through_the_kernel_wrapper(
        umjs_pair, monkeypatch):
    """A Schur step of ``make_fast_step`` reaches ``cuda_banded.banded_solve``
    (which launches the kernel for CUDA tensors) once an implicit solve, at
    half-bandwidth 4 vo + 5 = 9 on the 2 nz rows of the reduced system; with
    ``plain=True`` it does not; both give the same step on the CPU.  (A
    Schur step is a quasi-Newton step: 3 of them from this start differ
    from 3 dense steps by 8.7e-3 of W's scale; the bar against the dense
    solve is the test above's, with 3 Newton iterations.)"""
    _, _, tcfg, tgeom = umjs_pair
    calls = []
    real = t_imp.banded_solve

    def spy(bands, rhs, q):
        calls.append((tuple(bands.shape), q))
        return real(bands, rhs, q)

    monkeypatch.setattr(t_imp, "banded_solve", spy)
    start = TorchUMJSStart(tcfg, tgeom)
    out = {}
    for solver, plain in (("schur", False), ("schur", True)):
        del calls[:]
        first, step = t_fast.make_fast_step(
            tcfg.with_(vertical_solver=solver), tgeom, device=CPU,
            plain=plain)
        d, c = first(start())
        for _ in range(STEPS - 1):
            d, c = step(d, c)
        out[solver, plain] = d
        nz, ncol = tcfg.nz, 6 * 8 * 8
        want = [((2 * nz, 19, ncol), 9)] * (STEPS + 1) \
            if solver == "schur" and not plain else []
        assert calls == want, (solver, plain)
    for k in FIELDS:
        a, b = out["schur", False][k], out["schur", True][k]
        assert torch.equal(a, b), k
        assert torch.isfinite(a).all(), k


class TorchUMJSStart:
    """The port's UMJS start (``pert="exp"``) packed z-first, fresh at each
    call."""

    def __init__(self, tcfg, tgeom):
        from tempestmodel_tpu_torch.testcases.nonhydro_sphere import (
            BaroclinicWaveUMJS)
        self.s = BaroclinicWaveUMJS(pert="exp").initial_state(
            tgeom, tcfg.constants, dtype=torch.float64, device=CPU)

    def __call__(self):
        return t_fast.pack_state({k: v.clone() for k, v in self.s.items()},
                                 device=CPU)
