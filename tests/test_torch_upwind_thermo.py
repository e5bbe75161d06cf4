"""``upwind_thermo=False`` (the implicit Rt/Rho upwind penalty off; the
explicit U/V upwinding and W's interface upwinding stay) on the port's
z-first engine against the JAX package, float64 on the CPU: the perturbed
Jablonowski-Williamson wave at ne2 p4 nz6 from the seeded W of
``tests/test_torch_terrain_sphere.py`` (at rest the Newton Jacobian takes
the sign of a roundoff W; see there), fused (the fused implicit kernel's
plain form with zero penalty rows) and unfused, 3 steps against JAX
``make_nh_step`` with the banded solver, 1e-11 relative per field (its
step compiled once for the module); the fused kernel's table without the
penalty."""

import numpy as np
import pytest
import torch

from tempestmodel_tpu_torch import fast as t_fast
from tempestmodel_tpu_torch.fast import (engine as t_engine, implicit as t_imp,
                                         implicit_cuda)
from tempestmodel_tpu_torch.models import nonhydro as t_nonh

from torch_port_common import CPU
import test_torch_terrain_sphere as terrain
import test_torch_vertical_solvers as solvers
from test_torch_explicit_vertical import STEPS, _jax_steps


@pytest.fixture(scope="module")
def jw():
    """JW at ne2 p4 nz6 from the seeded W with ``upwind_thermo=False``, and
    JAX ``make_nh_step``'s 3 steps (the banded solver)."""
    jcfg, tcfg, jgeom, tgeom, start, ref = terrain._configs("jw")
    assert ref is None
    jcfg = jcfg.with_(upwind_thermo=False)
    tcfg = tcfg.with_(upwind_thermo=False)
    return jcfg, tcfg, jgeom, tgeom, start, _jax_steps(jcfg, jgeom, start,
                                                       None)


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
def test_no_thermo_upwind_steps_match_make_nh_step(jw, fused):
    jcfg, tcfg, jgeom, tgeom, start, want = jw
    first, step = t_fast.make_fast_step(tcfg, tgeom, device=CPU, fused=fused)
    d, c = first(t_fast.pack_state(
        {k: torch.from_numpy(v.copy()) for k, v in start.items()},
        device=CPU))
    for _ in range(STEPS - 1):
        d, c = step(d, c)
    got = {k: v.numpy() for k, v in t_fast.unpack_state(d).items()}
    solvers.assert_steps_close(got, want, start)


def test_no_thermo_upwind_table_has_zero_penalty_columns(jw):
    """Without the penalty the fused kernel's envelope holds and its table
    is the penalty table with every penalty column zero; the plain form
    leaves the penalty out of the residual."""
    _, tcfg, _, tgeom, _, _ = jw
    fg = t_engine.build_fast_geometry(tgeom, dtype=torch.float64, device=CPU)
    q = t_nonh.estimate_bandwidth(tgeom, tcfg.constants)
    ists = {}
    for up in (True, False):
        st = t_imp.statics_to_device(
            t_nonh.band_assembly_statics(tgeom, q, upwind_thermo=up),
            torch.float64, CPU)
        ists[up] = implicit_cuda.implicit_statics(st, fg)
        assert implicit_cuda.fused_supported(ists[up]) and st["q"] == 4
    on, off = ists[True].tab.numpy(), ists[False].tab.numpy()
    col, pen_cols = 0, []
    for name, offs in implicit_cuda.LAYOUT:
        if name[:2] in ("Pl", "Pr", "Wl", "Wr", "Ul", "Ur"):
            pen_cols += range(col, col + len(offs))
        col += len(offs)
    for name, offs in implicit_cuda.BAND_COLUMNS:
        if name in ("Pl_b", "Pr_b"):
            pen_cols += range(col, col + len(offs))
        col += len(offs)
    assert col == implicit_cuda.NCOLS
    keep = [i for i in range(col) if i not in pen_cols]
    assert np.abs(on[:, pen_cols]).max() > 0
    assert not off[:, pen_cols].any()
    np.testing.assert_array_equal(on[:, keep], off[:, keep])
