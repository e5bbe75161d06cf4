"""How far roundoff moves 3 Strang-HEVI steps over terrain, in the JAX
package and in the port, float64 on the CPU (ne2 p4 nz6, the set-up of
``tests/test_torch_terrain_sphere.py``).

From rest, where the wind runs along the terrain, the contravariant vertical
velocity at the interfaces is roundoff and the implicit Jacobian takes its
sign for the upwind terms, so one Newton iterate depends on roundoff.  For
each case and start (at rest, with a seeded W of 100 and of 1e4 covariant)
this prints the worst relative field error, per field, of: each package
against itself with the start perturbed by 1e-15 relative, and the port
against JAX.  With ``--ne30`` it also prints the JAX package's path
predicates (``sep_ok``, the nu4 kernels) for ``MountainRossby3D`` at ne30
p4 L30 in float32 and float64 (host geometry only).

    JAX_PLATFORMS=cpu python tests/torch_terrain_roundoff.py [--ne30]

About five minutes: one JAX compile a case."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_terrain_sphere as base  # noqa: E402
from tempestmodel_tpu import fast as j_fast  # noqa: E402
from tempestmodel_tpu_torch import fast as t_fast, convert  # noqa: E402
from torch_port_common import CPU, FIELDS, rel_err  # noqa: E402


def perturbed(start, eps, seed=1):
    rng = np.random.default_rng(seed)
    return {k: v * (1.0 + eps * rng.standard_normal(v.shape))
            for k, v in start.items()}


def main():
    for name in ("schar", "jw"):
        jcfg, tcfg, jgeom, tgeom, start, ref = base._configs(name)
        rest = dict(start, W=np.zeros_like(start["W"]))
        jfirst, jstep = j_fast.make_fast_step(
            jcfg, jgeom, ref_state=None if ref is None else {
                k: jnp.asarray(v) for k, v in ref.items()})
        tfirst, tstep = t_fast.make_fast_step(tcfg, tgeom, ref_state=ref,
                                              device=CPU)

        def jax_run(s0):
            X, c = jfirst(j_fast.pack_state(
                {k: jnp.asarray(v) for k, v in s0.items()}))
            for _ in range(2):
                X, c = jstep(X, c)
            return {k: np.asarray(v) for k, v in
                    j_fast.unpack_state(X, jcfg.nz).items()}

        def torch_run(s0):
            X, c = tfirst(convert.state_from_numpy(s0, device=CPU))
            for _ in range(2):
                X, c = tstep(X, c)
            return {k: v.numpy() for k, v in t_fast.unpack_state(X).items()}

        for label, s0 in (("rest", rest),
                          ("W 100", base.seeded_w(rest, 100.0)),
                          ("W 1e4", base.seeded_w(rest, 1.0e4))):
            j0, j1 = jax_run(s0), jax_run(perturbed(s0, 1e-15))
            t0, t1 = torch_run(s0), torch_run(perturbed(s0, 1e-15))
            for what, a, b in (("jax vs jax 1e-15", j1, j0),
                               ("port vs port 1e-15", t1, t0),
                               ("port vs jax", t0, j0)):
                errs = {k: float(f"{rel_err(a[k], b[k]):.2e}")
                        for k in FIELDS}
                print(f"{name:6s} {label:6s} {what:20s} {errs}", flush=True)
    if "--ne30" in sys.argv[1:]:
        import tempestmodel_tpu as tj
        from tempestmodel_tpu.fast import engine as j_engine, hyper_pallas
        from tempestmodel_tpu.models import nh_model as j_nh
        from tempestmodel_tpu.testcases.nonhydro_sphere import (
            MountainRossby3D)
        tc = MountainRossby3D()
        for dt in (jnp.float32, jnp.float64):
            cfg = tj.ModelConfig(grid_kind=tj.GridKind.CUBED_SPHERE, ne=30,
                                 order=4, nz=30, ztop=tc.ztop, dt=100.0,
                                 rayleigh_damping=True, dtype=dt)
            c = cfg.constants
            geom = j_nh.build_nh_sphere_geometry(
                cfg, ztop=tc.ztop, rayleigh=tc.rayleigh_strength,
                topography=lambda lon, lat: tc.topography(lon, lat, c))
            fg = j_engine.build_fast_geometry(geom, dtype=dt)
            print(f"MountainRossby3D ne30 L30 {dt.__name__}: sep_ok "
                  f"{fg.sep_ok}, nu4 kernels "
                  f"{hyper_pallas.supported(fg, cfg)}", flush=True)


if __name__ == "__main__":
    main()
