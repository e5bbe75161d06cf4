"""The port's IMEX with the dense, Schur and JFNK column solvers against
the JAX package's reference-layout ``make_nh_imex_step``, float64 on the
CPU: UMJS at ne2 p4 nz6, dt 100 s, ARS343, 3 steps, 1e-11 relative per
field (``torch_imex_wide``).

JAX's IMEX hands every solver but ``"banded"`` and ``"pallas"`` a
half-bandwidth q = 0 (``timestep/imex.py:94-99``).  For Schur that drops
every W coupling of the reduced system (ROADMAP's caveats), and the port
keeps its Strang choice: Schur at the estimated q.  So the Schur step is
held against JAX's IMEX with ``nonhydro.vertical_implicit`` wrapped to get
the estimated q, and one test shows that JAX's own q = 0 step differs, so
that a repair in the reference shows.  JFNK is held in float64 only (it
diverges in float32 in both packages)."""

from unittest import mock

import numpy as np
import pytest

from tempestmodel_tpu.models import nonhydro as j_nonh

from torch_port_common import FIELDS, rel_err
from torch_imex_wide import (assert_imex_matches, jax_imex, port_imex,
                             sphere_configs, sphere_start)


def _schur_at_estimated_q(jcfg, jgeom):
    """``nonhydro.vertical_implicit`` with the Schur solve at
    ``estimate_bandwidth``'s q, whatever q the caller passed."""
    original = j_nonh.vertical_implicit
    q = j_nonh.estimate_bandwidth(jgeom, jcfg.constants)
    assert q > 0

    def wrapped(*a, **kw):
        if kw.get("solver") == "schur":
            kw["q"] = q
        return original(*a, **kw)
    return wrapped


@pytest.fixture(scope="module")
def runs():
    """``get(name)``: (tcfg, tgeom, start, JAX's 3 steps), at first use:
    ``dense``, ``jfnk``, ``schur`` (the wrapped q) and ``schur_q0`` (JAX's
    own IMEX)."""
    cache = {}

    def get(name):
        if name not in cache:
            solver = name.split("_")[0]
            jcfg, tcfg, jgeom, tgeom = sphere_configs(
                "ars343", vertical_solver=solver)
            start = sphere_start(jcfg, jgeom)
            if name == "schur":
                with mock.patch.object(j_nonh, "vertical_implicit",
                                       _schur_at_estimated_q(jcfg, jgeom)):
                    want = jax_imex(jcfg, jgeom, start)
            else:
                want = jax_imex(jcfg, jgeom, start)
            cache[name] = tcfg, tgeom, start, want
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["dense", "schur", "jfnk"])
def test_imex_solver_matches_make_nh_imex_step(runs, name):
    tcfg, tgeom, start, want = runs(name)
    assert tcfg.vertical_solver == name
    assert_imex_matches(port_imex(tcfg, tgeom, start), want, start)


def test_jax_imex_schur_at_q0_is_another_step(runs):
    """JAX's own IMEX Schur step (q = 0) is not the one the port takes: W
    differs from the estimated-q step by far more than the bar."""
    _, _, _, at_q = runs("schur")
    _, _, _, own = runs("schur_q0")
    assert rel_err(own["W"], at_q["W"]) > 1e-3
    for k in FIELDS:
        assert np.isfinite(own[k]).all(), k
