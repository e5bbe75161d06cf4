"""The CPH and LEV staggerings as a whole on the sphere (UMJS ne2 p4 nz6,
dt 100 s, nu4 and the Rayleigh layer; ``test_torch_staggering.CASES``)
against the JAX package's ``make_nh_step`` with its tail assembled by rows
(``jax_tail_by_rows``): 3 steps of ``make_fast_step``, the fused choice and
``fused=False``, 1e-11 relative per field; that tail is JAX's own where
JAX's runs, and JAX's own still raises where it does not (so that a repair
in the reference shows)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tempestmodel_tpu.models import (hyperdiff as j_hd, nh_model as j_nh,
                                     nonhydro as j_nonh)

from test_torch_staggering import case_runs, check_steps, jax_tail_by_rows
from torch_port_common import FIELDS

NAMES = ["sphere_cph", "sphere_lev"]


@pytest.fixture(scope="module")
def runs():
    return case_runs()


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", NAMES)
def test_staggered_steps_match_make_nh_step(runs, name, fused):
    check_steps(runs, name, fused)


def test_tail_by_rows_is_jax_tail_where_that_runs(runs):
    """Under CPH JAX's own nu4 tail picks the right Jacobians: with the
    Rayleigh finish off, ``jax_tail_by_rows`` gives its bits."""
    (jcfg, _, jgeom, _, start, _), _ = runs("sphere_cph")
    dss = j_nh.make_sphere_dss(jgeom)
    s = {k: jnp.asarray(v) for k, v in start.items()}
    cfg = jcfg.with_(rayleigh_damping=False)
    own = j_hd.step_after_subcycle_nh(s, cfg.dt, cfg, jgeom, dss)
    ours = jax_tail_by_rows(s, cfg.dt, cfg, jgeom, dss)
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(ours[k]),
                                      np.asarray(own[k]), k)


def test_jax_tail_still_fails_under_lev(runs):
    """The JAX package's nu4 tail under LEV, and its Rayleigh finish under
    LEV and CPH, raise on the shapes (the port picks by rows instead)."""
    (jcfg, _, jgeom, _, start, ref), _ = runs("sphere_lev")
    dss = j_nh.make_sphere_dss(jgeom)
    s = {k: jnp.asarray(v) for k, v in start.items()}
    with pytest.raises(TypeError, match="incompatible shapes"):
        j_hd.step_after_subcycle_nh(s, jcfg.dt, jcfg.with_(
            rayleigh_damping=False), jgeom, dss)
    for name in ("sphere_lev", "sphere_cph"):
        (jcfg, _, jgeom, _, start, ref), _ = runs(name)
        s = {k: jnp.asarray(v) for k, v in start.items()}
        r = {k: jnp.asarray(v) for k, v in ref.items()}
        with pytest.raises(TypeError, match="incompatible shapes"):
            j_nonh.apply_rayleigh(s, jgeom, r, jcfg.dt)
