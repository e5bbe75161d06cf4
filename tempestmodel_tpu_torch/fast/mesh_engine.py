"""The z-first engine over a device mesh.

Counterpart of the JAX package's ``_make_fast_step_mesh``
(``fast/engine.py:1071-1214``): the whole Strang step runs per shard on a
rectangular block ``(K, 6, a, b)`` of every field, ``a = A/mx`` and
``b = A/my``, and all communication is the routed exchange of
``fast/mesh_dss.py``.  The per-shard step is the single-device engine's own
code (``engine._strang_fns``, ``engine._setup_on``, the same kernels at the
block's extents); only its ``FastGeometry`` (the whole grid's, sliced to the
block, with the block's horizontal operators) and its DSS differ.  The
transports are ``parallel.mesh.ShardMesh`` (every shard in this process,
one CUDA graph for the sharded step when they share a device) and
``parallel.mesh.DistMesh`` (a shard a rank of a ``torch.distributed``
group; eager).

The path predicates are evaluated once on the whole grid, as the JAX
package does, so that no shard takes another path than its neighbours:
``sep_ok`` (the separable metric), the nu4 kernels' predicate (whose
Jacobian comparison could differ shard by shard over terrain), the fused
stage and the W fold.  Unlike the JAX package, the fused stage is not
limited to ``a % 8 == 0`` (that is the TPU kernel's tile): at ne30 on a
2 x 2 mesh (a = 60) the JAX package runs its stage unfused and this one
runs the kernel; the two agree to rounding.  The W fold hands the stage's
deferred W finish to the DSS, which finishes W in tensor code before the
exchange (the JAX package's "no fused W slot"); no DSS kernel runs on a
mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .._device import np_dtype, resolve_device
from ..config import GridKind, VerticalStaggering, ModelConfig
from . import engine, mesh_dss

# the FastGeometry fields with a horizontal extent (..., A, B): sliced to a
# shard's block; every other field is the whole grid's (the operators, the
# edge tables that the host routing reads)
HORIZONTAL = ("c2_aa", "c2_ab", "c2_ba", "c2_bb", "jac2d", "fj", "inv_mult",
              "jac3d", "jac3d_int", "con_a_xi", "con_b_xi", "con_xi_xi",
              "con_a_xi_int", "con_b_xi_int", "con_xi_xi_int", "deriv_r_a",
              "deriv_r_b", "deriv_r_xi_int", "rayleigh_lev", "rayleigh_int",
              "area3d", "sep_ca", "sep_cb", "sep_e", "sep_f", "sep_da",
              "sep_db", "sep_jacl")


def mesh_supported(cfg: ModelConfig, mesh) -> bool:
    """The JAX package's ``fast_engine_supported(cfg, mesh=mesh)``: the
    cubed sphere, the LOR staggering, Strang, the banded column solvers, no
    uniform diffusion, ``upwind_thermo``, not ``explicit_vertical``, and
    ``mesh.shape`` splitting ``ne * order`` into blocks of whole
    elements."""
    from ..config import TimestepSchemeType
    ok = (cfg.grid_kind == GridKind.CUBED_SPHERE
          and cfg.vertical_staggering == VerticalStaggering.LORENZ
          and cfg.timescheme == TimestepSchemeType.STRANG
          and not cfg.explicit_vertical
          and cfg.vertical_solver in ("banded", "pallas")
          and cfg.nu_uniform_scalar == 0.0
          and cfg.nu_uniform_vector == 0.0
          and cfg.upwind_thermo)
    if not ok:
        return False
    A = cfg.ne * cfg.order
    try:
        mx, my = mesh.shape["x"], mesh.shape["y"]
    except (KeyError, AttributeError, TypeError):
        return False
    return (A % mx == 0 and A % my == 0
            and (A // mx) % cfg.order == 0 and (A // my) % cfg.order == 0)


def local_geometry(fg, mx: int, my: int, ix: int, iy: int,
                   device=None):
    """The ``FastGeometry`` of shard ``(ix, iy)`` of an ``(mx, my)`` mesh:
    ``fg`` (the whole grid's) with ``A = a``, ``B = b``, the block-diagonal
    operators of ``a / p`` and ``b / p`` elements, every ``HORIZONTAL`` field
    sliced to the block (contiguous), the rest as it is; all on ``device``
    (default: ``fg``'s)."""
    dev = fg.inv_mult.device if device is None else torch.device(device)
    A, B, p = fg.A, fg.B, fg.p
    a, b = A // mx, B // my
    sa, sb = slice(ix * a, (ix + 1) * a), slice(iy * b, (iy + 1) * b)
    f64 = np.float64
    D = np.asarray(fg.DA_elem, f64)
    S = np.asarray(fg.S_elem, f64)
    npdt = np_dtype(fg.inv_mult.dtype)

    def c(x):
        return torch.as_tensor(np.ascontiguousarray(x, npdt), device=dev)

    repl = {}
    for f in dataclasses.fields(fg):
        v = getattr(fg, f.name)
        if not isinstance(v, torch.Tensor):
            continue
        if f.name in HORIZONTAL:
            repl[f.name] = v[..., sa, sb].to(dev).contiguous()
        else:
            repl[f.name] = v.to(dev)
    return dataclasses.replace(
        fg, A=a, B=b,
        DA=c(np.kron(np.eye(a // p), D.T) / fg.delta),
        Sd=c(np.kron(np.eye(a // p), S) / fg.delta),
        DA_b=c(np.kron(np.eye(b // p), D.T) / fg.delta),
        Sd_b=c(np.kron(np.eye(b // p), S) / fg.delta),
        **{k: v for k, v in repl.items()
           if k not in ("DA", "Sd", "DA_b", "Sd_b")})


def mesh_dss_fn(dss_state, fg):
    """The per-shard ``dss_fn`` of the Strang step: the stage's deferred W
    finish in tensor code first (the exchange's payload has no fused W
    slot), the mesh DSS of every field, then the Rayleigh finish on the five
    dynamics fields only (tracers ride in the payload after W and are never
    damped).  A cubed-sphere block has no walls: no halo."""
    def dss_fn(d, rayleigh=None, w_finish=None, halo=None, walls_out=False):
        if halo is not None or walls_out:
            raise ValueError("a mesh runs the cubed sphere: no walls, no "
                             "halo")
        if w_finish is not None:
            d = dict(d, W=engine.w_finish_xla(d, w_finish))
        out = dss_state(d, fg.inv_mult)
        if rayleigh is not None:
            out = dict(out, **engine.apply_rayleigh(
                {k: out[k] for k in engine.FIELDS}, *rayleigh))
        return out
    return dss_fn


@dataclasses.dataclass
class MeshParts:
    """The sharded Strang stepper and its pieces (``mesh_parts``)."""
    mesh: Any
    fg: Any             # the whole grid's FastGeometry
    shards: dict        # rank -> engine.StrangParts of this process's shards
    ntracers: int
    first_fn: Any       # first_fn(ds) -> (ds, cs) on sharded states
    step_fn: Any        # step_fn(ds, cs) -> (ds, cs)

    def run(self, fn, *sharded):
        """``fn(rank, *per_shard_args)`` on every shard of this process in
        lockstep; the results in the sharded form (a ``ShardMesh``: a list
        in rank order, or a tuple of lists for tuple results)."""
        return spmd(self.mesh, fn, *sharded)


def spmd(mesh, fn, *sharded):
    from ..parallel.mesh import ShardMesh
    out = mesh.run(fn, *sharded)
    if isinstance(mesh, ShardMesh) and out and isinstance(out[0], tuple):
        return tuple(list(x) for x in zip(*out))
    return out


def shard_devices(mesh, device=None) -> dict:
    """rank -> device of this process's shards."""
    from ..parallel.mesh import ShardMesh
    if isinstance(mesh, ShardMesh):
        return dict(enumerate(mesh.devices))
    return {mesh.rank: resolve_device(device)}


def mesh_parts(cfg, geom, ref_state, mesh, device=None, plain=False,
               fused=None, dss_merge=None, ntracers: int = 0) -> MeshParts:
    """The sharded Strang stepper (``make_fast_step(mesh=)``) and its
    per-shard pieces.  ``dss_merge`` names launch groupings of the DSS
    kernels, which do not run on a mesh: it is accepted and not read."""
    if not mesh_supported(cfg, mesh):
        raise NotImplementedError(
            "configuration outside the mesh engine's envelope (see "
            "fast_engine_supported(cfg, mesh=mesh); ROADMAP queue 1 item 1: "
            "mesh outside the z-first envelope)")
    from . import hyper_cuda
    devs = shard_devices(mesh, device)
    mx, my = mesh.shape["x"], mesh.shape["y"]
    fg = engine.build_fast_geometry(geom, dtype=cfg.dtype,
                                    device=next(iter(devs.values())))
    rayleigh = engine._rayleigh_terms(cfg, geom, ref_state, fg)
    fused = fused is None or bool(fused)
    # the path predicates, once on the whole grid
    lap_ok = hyper_cuda.laplacians_supported(fg)
    hyper = (lap_ok, lap_ok and hyper_cuda.supported(fg, cfg))
    use_fused_stage = engine.stage_path(cfg, fg, fused)
    use_wfold = use_fused_stage and engine.wfold_rows(geom)
    dss_state = mesh_dss.make_state_dss_mesh(
        fg.dss_links, fg.e_rot.detach().cpu().numpy(), mx, my, fg.A, fg.p,
        fg.nz, overlap=cfg.halo_overlap)
    shards = {}
    for r, dev in devs.items():
        ix, iy = mesh.coords(r)
        fgl = local_geometry(fg, mx, my, ix, iy, dev)
        ray = None
        if rayleigh is not None:
            sa = slice(ix * fgl.A, (ix + 1) * fgl.A)
            sb = slice(iy * fgl.B, (iy + 1) * fgl.B)
            ray = tuple({k: v[..., sa, sb].to(dev).contiguous()
                         for k, v in part.items()} for part in rayleigh)
        dss_fn = mesh_dss_fn(dss_state, fgl)
        s = engine._setup_on(cfg, geom, fgl, ray, None, plain, fused, None,
                             hyper=hyper, dss_fn=dss_fn)
        stage_fn = engine.bind_stage(fgl, cfg.constants, plain) \
            if use_fused_stage else None
        first_fn, step_fn = engine._strang_fns(
            cfg, fgl, ray, dss_fn, s.implicit_fn, stage_fn=stage_fn,
            use_wfold=use_wfold, hyper_fns=s.hyper_fns)
        shards[r] = engine.StrangParts(fg=fgl, setup=s, stage_fn=stage_fn,
                                       use_wfold=use_wfold,
                                       first_fn=first_fn, step_fn=step_fn)
    nz = fg.nz

    def species(d):
        got = d["Tracers"].shape[0] // nz if "Tracers" in d else 0
        if got != ntracers:
            raise ValueError(f"the mesh step was made for ntracers="
                             f"{ntracers}, the state carries {got}")

    def first_one(r, d):
        species(d)
        return shards[r].first_fn(d)

    def step_one(r, d, c):
        species(d)
        return shards[r].step_fn(d, c)

    def first(ds):
        return spmd(mesh, first_one, ds)

    def step(ds, cs):
        return spmd(mesh, step_one, ds, cs)

    return MeshParts(mesh=mesh, fg=fg, shards=shards, ntracers=ntracers,
                     first_fn=first, step_fn=step)


def mesh_fns(cfg, geom, ref_state, mesh, device, plain, fused, dss_merge,
             ntracers: int = 0):
    """``(first_fn, step_fn, fg)`` of the sharded step (``fg``: the whole
    grid's geometry)."""
    mp = mesh_parts(cfg, geom, ref_state, mesh, device, plain, fused,
                    dss_merge, ntracers)
    return mp.first_fn, mp.step_fn, mp.fg
