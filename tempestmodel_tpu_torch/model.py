"""Top-level model driver: component registry + main time loop.

Counterpart of the JAX package's ``model.py``, an analog of the reference
``Model`` class (``src/atm/Model.{h,cpp}``): owns the grid/geometry, the
timestep scheme, the test case, the output managers and the workflow
(physics) processes; ``go()`` is the ``Model::Go()`` main loop
(``Model.cpp:316-518``) with per-phase timers and output scheduling;
``compute_error_norms()`` is ``Model::ComputeErrorNorms`` (``:695-782``).

The steps run on the z-first engine (``fast/engine``): Strang-HEVI where
``fast_engine_supported`` holds, an IMEX-ARK scheme where
``imex_supported`` holds (no carry), the split-explicit (SPEX) and
HighSpeed (HS) steps where ``split_supported`` holds
(``models/split_explicit``, ``models/highspeed``; no carry).
``cfg.fuse_pallas=False`` runs Strang, ERK and IMEX on the engine's unfused
path (no fused stage, implicit or nu4 kernel; the DSS as separate
launches), as the JAX package runs them on its reference-layout engine;
SPEX and HS have one path.  The z-first state and the carry stay
resident on the device; ``model.state`` is unpacked to the reference
layout only when it is read.  ``go`` runs the steps between two firings of
any hook as one replay of a CUDA graph of that many steps
(``engine.graph_runner``; a plain loop on the CPU), so a run without hooks
costs what a direct replay does.  On a grid with no-flux walls the carry
also holds the walls' halo (``halo_U``, ...: the engine's flat dict of
tensors), so a restart continues bit for bit from either checkpoint format.
The shallow-water equation set runs its own step (``models/sw_model``) the
same way: the 2-D state stays resident and the steps between two firings
are one graph (its carry is empty).  With ``mesh=`` (a ``parallel.mesh``
transport) the Strang step runs sharded (``fast/mesh_engine``): the
resident state and carry are the shards' (one graph of every shard's steps
on a ``ShardMesh``, a loop on a ``DistMesh``), and ``state`` and ``carry``
gather on read.  ``profile_phases`` times the five phases of the
reference's FunctionTimer taxonomy one by one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ._device import resolve_device, OnDevice
from .config import ModelConfig, EquationSet, GridKind, TimestepSchemeType
from .fast import engine
from .io.diagnostics import error_norms
from .models import nh_model, sw_model
from .utils.timeobj import parse_duration_seconds
from .utils.timers import Timers

# the longest run of steps one CUDA graph holds (a run between two hook
# firings that is longer replays it more than once)
GRAPH_STEPS = 50
# graphs kept per model (one per run length met); the oldest goes first
GRAPHS_KEPT = 4

_MESH_ROADMAP = ("is not ported yet (ROADMAP queue 1 item 1: mesh outside "
                 "the z-first envelope; the JAX package runs it on its "
                 "reference-layout mesh path)")

_NOT_PORTED = ("is not ported yet (ROADMAP queue 1 item 2: tracers on "
               "no-flux grids, with uniform diffusion or on the explicit "
               "vertical path of a Strang or ERK step, walls on both axes, "
               "and under the CPH, LEV and INT staggerings tracers, no-flux "
               "walls and uniform diffusion); SPEX and HS take the LOR "
               "staggering only, as in the JAX package")


class WorkflowProcess:
    """Periodic in-loop hook (reference ``WorkflowProcess.h:30-70``).

    Subclass and override ``perform(model, t) -> new_state`` (an update of
    the state dict).  ``interval`` seconds of model time between firings
    (0 = every step).
    """

    def __init__(self, interval: float = 0.0):
        self.interval = float(interval)
        self._last = None

    def is_ready(self, t: float) -> bool:
        if self.interval <= 0.0:
            return True
        if self._last is None:
            self._last = t
            return False
        return t - self._last >= self.interval - 1e-9

    def first_due(self, times) -> int:
        """Index into ``times`` (the model times of the coming steps, in
        order) of the first at which ``is_ready`` would hold if it were
        asked at each in turn, without arming the timer; ``len(times)``
        when none.  A subclass that overrides ``is_ready`` is taken to be
        due at the first."""
        if type(self).is_ready is not WorkflowProcess.is_ready \
                or self.interval <= 0.0:
            return 0
        last = self._last
        for i, t in enumerate(times):
            if last is None:
                last = t
            elif t - last >= self.interval - 1e-9:
                return i
        return len(times)

    def fire(self, model, t: float):
        self._last = t
        return self.perform(model, t)

    def perform(self, model, t: float):
        raise NotImplementedError


def _snapshot(state):
    """Per key: the object and, for a tensor, its in-place version."""
    return {k: (v, getattr(v, "_version", None)) for k, v in state.items()}


def _unchanged(state, snap) -> bool:
    return (set(state) == set(snap)
            and all(state[k] is v and ver is not None
                    and state[k]._version == ver
                    for k, (v, ver) in snap.items()))


class Model:
    """One configured model run.

    ``device``: where the state and the steps live (default ``cuda``;
    raises when absent; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, cfg: ModelConfig, testcase=None, topography=None,
                 rayleigh=None, output_managers: Sequence = (),
                 workflow_processes: Sequence[WorkflowProcess] = (),
                 verbose: bool = False, mesh=None, device=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        # test-case physical-constants override (the reference's
        # TestCase::EvaluatePhysicalConstants hook, TestCase.h:103-110)
        if testcase is not None and hasattr(testcase, "physical_constants"):
            import dataclasses as _dc
            cfg = _dc.replace(
                cfg, constants=testcase.physical_constants(cfg.constants))
        self.cfg = cfg
        self.testcase = testcase
        self.output_managers = list(output_managers)
        self.workflow_processes = list(workflow_processes)
        self.timers = Timers(device=self.device)
        self.verbose = verbose
        self.step_count = 0
        self.time = 0.0
        self._carry = None       # the carry as given, or the engine's own
        self._carry_view = None  # its gathered form on a mesh
        # registry of named user 2-D diagnostic fields (P, A, B), written
        # by workflow processes and emitted by ReferenceOutput (analog of
        # UserDataMeta, ``UserDataMeta.h:35+``)
        self.user_data = {}

        if topography is None and testcase is not None:
            topography = getattr(testcase, "topography", None)
        if rayleigh is None and testcase is not None:
            rayleigh = getattr(testcase, "rayleigh_strength", None)
            if rayleigh is not None and not getattr(
                    testcase, "rayleigh", False):
                rayleigh = None
        ztop = getattr(testcase, "ztop", None)
        self._runs = {}          # run length -> graph_runner
        self._d = None           # resident state (z-first; 2-D for SW)
        self._c = None           # resident carry (engine layout)
        self._carry_seen = None  # the self.carry that _c stands for
        self._snap = {}          # snapshot of _zl when _d matched it
        self._zl = None          # reference-layout state, None when stale
        self.reference = None
        self._sw = cfg.equation_set == EquationSet.SHALLOW_WATER
        self._graphs = True      # the runs are CUDA graphs on the card
        self._parts = None       # the pieces profile_phases times
        if self._sw:
            if mesh is not None:
                raise NotImplementedError(
                    f"the shallow-water set on a device mesh {_MESH_ROADMAP}")
            self._init_sw(cfg, testcase, topography)
            return
        if cfg.grid_kind == GridKind.CUBED_SPHERE:
            self.geom = nh_model.build_nh_sphere_geometry(
                cfg, topography=topography, ztop=ztop, rayleigh=rayleigh)
        else:
            self.geom = nh_model.build_nh_cartesian_geometry(
                cfg, topography=topography, ztop=ztop, rayleigh=rayleigh,
                bc_x=getattr(testcase, "bc_x", "periodic"),
                bc_y=getattr(testcase, "bc_y", "periodic"),
                reference_latitude=getattr(
                    testcase, "reference_latitude", 0.0))
        # the geometry's arrays as tensors on the device, for the
        # diagnostics, the output managers and the physics
        self.geom_dev = OnDevice(self.geom, self.device)

        if testcase is not None:
            self._zl, self.reference = self._staggered_states(cfg, testcase)
        has_tr = self._zl is not None and "Tracers" in self._zl

        ts = cfg.timescheme
        # SPEX and HS: their own self-starting steps (carry {}); the JAX
        # package's Model sends HS to its IMEX factory, which refuses it
        # ("not an IMEX scheme"): here both run as its make_nh_step does
        self._split = ts in (TimestepSchemeType.SPEX, TimestepSchemeType.HS)
        self._imex = ts not in (TimestepSchemeType.STRANG,
                                TimestepSchemeType.ERK,
                                TimestepSchemeType.SPEX,
                                TimestepSchemeType.HS)
        # fuse_pallas=False: the engine's unfused path
        fused = None if cfg.fuse_pallas else False
        if mesh is not None:
            from .fast import mesh_engine
            if self._split or self._imex or not engine.fast_engine_supported(
                    cfg, has_tracers=has_tr, mesh=mesh, geom=self.geom):
                raise NotImplementedError(
                    f"this configuration on a device mesh (outside "
                    f"fast_engine_supported(cfg, mesh=mesh), the JAX "
                    f"package's z-first mesh envelope) {_MESH_ROADMAP}")
            ntr = self._zl["Tracers"].shape[0] if has_tr else 0
            self._parts = mesh_engine.mesh_parts(
                cfg, self.geom, self.reference, mesh, self.device, False,
                fused, None, ntracers=ntr)
            first, step = self._parts.first_fn, self._parts.step_fn
            fg = self._parts.fg
            self._graphs = mesh.graphs
        elif self._split:
            from .models.split_explicit import split_supported
            if not split_supported(cfg, has_tracers=has_tr, geom=self.geom):
                raise NotImplementedError(
                    f"this {ts.name} configuration (outside "
                    f"split_supported: the LOR staggering on the z-first "
                    f"engine's grids) {_NOT_PORTED}")
            first, step, fg = nh_model._step_fns(cfg, self.geom,
                                                 self.reference, self.device)
        elif not self._imex:
            if not engine.fast_engine_supported(cfg, has_tracers=has_tr,
                                                geom=self.geom):
                raise NotImplementedError(
                    f"this configuration (outside fast_engine_supported) "
                    f"{_NOT_PORTED}")
            first, step, fg = engine._fast_fns(
                cfg, self.geom, self.reference, None, self.device, False,
                fused, None, None)
        else:
            if not engine.imex_supported(cfg, has_tracers=has_tr,
                                         geom=self.geom):
                raise NotImplementedError(
                    f"this IMEX configuration (outside imex_supported) "
                    f"{_NOT_PORTED}")
            body, fg = engine._imex_body(cfg, self.geom, self.reference,
                                         self.device, False, None, None,
                                         fused)

            def first(d):
                return body(d), {}

            def step(d, carry):
                return body(d), carry
        self._swapped = fg.ab_swapped
        self._first = (engine._natural_layout(first) if self._swapped
                       else first)
        self._step = step

    def _staggered_states(self, cfg, testcase):
        """The test case's initial and reference states in the
        configuration's staggering (JAX ``model.py:119-135``): a case whose
        ``initial_state`` takes ``stagger`` evaluates the fields where they
        live, any other is converted (``nonhydro.convert_stagger``).  The
        reference state (Rayleigh's target, the error norms') is converted
        too: the JAX package keeps it in the Lorenz form, which its
        Rayleigh finish cannot take under the other staggerings."""
        import inspect
        from .models.nonhydro import convert_stagger
        stagger = cfg.vertical_staggering.value
        kw = {}
        if stagger != "LOR" and "stagger" in inspect.signature(
                testcase.initial_state).parameters:
            kw["stagger"] = stagger
        state = testcase.initial_state(self.geom, cfg.constants,
                                       dtype=cfg.dtype, device=self.device,
                                       **kw)
        if not kw:
            state = convert_stagger(state, self.geom, stagger)
        ref = None
        if hasattr(testcase, "reference_state"):
            ref = convert_stagger(testcase.reference_state(
                self.geom, cfg.constants, dtype=cfg.dtype,
                device=self.device), self.geom, stagger)
        return state, ref

    def _init_sw(self, cfg, testcase, topography):
        """The shallow-water set (JAX ``model.py:99-105``): its own step,
        ``(state, {}) -> (state, {})``, on the 2-D state; no carry."""
        if cfg.nz > 1:
            raise ValueError(
                "equation_set=SHALLOW_WATER with nz > 1: set "
                "equation_set=PRIMITIVE_NONHYDRO for 3-D runs")
        self.geom = sw_model.build_sw_geometry(cfg, topography)
        self.geom_dev = OnDevice(self.geom, self.device)
        if testcase is not None:
            self._zl = testcase.initial_state(
                self.geom, cfg.constants, dtype=cfg.dtype, device=self.device)
            if hasattr(testcase, "reference_state"):
                self.reference = testcase.reference_state(
                    self.geom, cfg.constants, dtype=cfg.dtype,
                    device=self.device)
        sw_step = sw_model.make_sw_step(cfg, self.geom, device=self.device)
        self._imex = self._split = False
        self._swapped = False

        def step(d, carry):
            return sw_step(d), carry

        self._step = step

    # ------------------------------------------------------------------
    @property
    def state(self):
        """The state in the reference layout (z-last tensors on the
        device), unpacked from the resident z-first state at the first read
        after a step."""
        if self._zl is None and self._d is not None:
            d = self._d if self.mesh is None else self.mesh.gather(self._d)
            self._zl = dict(d) if self._sw else engine.unpack_state(d)
            self._snap = _snapshot(self._zl)
        return self._zl

    @state.setter
    def state(self, value):
        # a hook that replaces the dict, replaces a key or changes a tensor
        # in place leaves _zl unlike its snapshot: the next step repacks
        self._zl = value

    @property
    def carry(self):
        """The Strang carry as the engine keeps it (z-first; None before the
        first step), or as it was given (``set_state``); on a mesh the
        engine's carry is gathered at its first read after a step."""
        c = self._carry
        if self.mesh is not None and c is not None \
                and c is self._carry_seen:
            if self._carry_view is None:
                self._carry_view = self.mesh.gather(c)
            return self._carry_view
        return c

    @carry.setter
    def carry(self, value):
        self._carry = value
        self._carry_view = None

    def set_state(self, state, carry=None, time=0.0, step=0):
        self.state = state
        self.carry = carry
        self.time = time
        self.step_count = step

    def restart_from(self, path, perturb: bool = False):
        """Resume from a ``CompositeCheckpoint`` file (the port's or the
        JAX package's, either format).

        ``perturb``: re-apply the test case's perturbation to the restored
        state (the reference's ``--perturb_restart``, ``Model.cpp:250-257``
        -> ``Grid::EvaluateTestCase_Perturbation``).
        """
        from .io.output import CompositeCheckpoint
        state, carry, t, step = CompositeCheckpoint.load(path,
                                                         device=self.device)
        if perturb:
            if not hasattr(self.testcase, "apply_perturbation"):
                raise ValueError(
                    f"test case {type(self.testcase).__name__} has no "
                    "perturbation (apply_perturbation method)")
            state = self.testcase.apply_perturbation(
                state, self.geom, self.cfg.constants)
            carry = None      # carryover combination is stale after a kick
        self.set_state(state, carry, t, step)

    # ------------------------------------------------------------------
    def _pack_carry(self, carry):
        """A carry given from outside (a restart) as the engine keeps it:
        the z-first carry as it is, a reference-layout one (told apart by
        the shape of its Rho: (P, A, B, nz) there, (nz, P, A, B) or the
        swapped (nz, P, B, A) in the engine) packed."""
        if not carry:
            return {}         # the explicit vertical path's
        nz = self.cfg.nz
        P, A, B = self.geom.jac3d.shape[:3]
        rho = tuple(carry["Rho"].shape)
        if rho == (P, A, B, nz) and rho not in ((nz, P, A, B),
                                                 (nz, P, B, A)):
            out = {}
            for k, v in carry.items():
                v = torch.as_tensor(v).to(self.device)
                if k == "Tracers":
                    ntr, P, A, B, nzz = v.shape
                    out[k] = v.movedim(-1, 1).reshape(ntr * nzz, P, A, B)
                else:
                    out[k] = v.movedim(-1, 0).contiguous()
            return out
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in carry.items()}

    def _shard(self, d):
        return d if self.mesh is None else self.mesh.shard(d)

    def _pack_sw(self, state):
        """The shallow-water state as the step keeps it: contiguous tensors
        on the device (fresh where the given one was not)."""
        return {k: torch.as_tensor(v).to(self.device).contiguous()
                for k, v in state.items()}

    def _run(self, n: int):
        """The runner of ``n`` steps (one CUDA graph on the card)."""
        if n not in self._runs:
            if len(self._runs) >= GRAPHS_KEPT:
                del self._runs[next(iter(self._runs))]
            run = engine.graph_runner(self._step, n, graph=self._graphs)
            self._runs[n] = (engine._natural_layout(run) if self._swapped
                             else run)
        return self._runs[n]

    def _advance(self, n: int):
        """``n`` steps from the resident state: ``first_step`` where there
        is no carry (Strang), then one run of the rest."""
        self._resident()
        if self._imex or self._sw or self._split:
            self._c = {}      # no carry: a restart's (zero) carry is unused
        elif self._carry is None:
            self._c = None
        elif self._carry is not self._carry_seen:
            self._c = self._shard(self._pack_carry(self._carry))
        d, c, left = self._d, self._c, n
        if c is None:
            d, c = self._first(d)
            left -= 1
        if left:
            d, c = self._run(left)(d, c)
        self._d, self._c = d, c
        self._zl, self._snap = None, {}
        if not (self._imex or self._sw or self._split):
            self.carry = self._carry_seen = c
        self.step_count += n
        for _ in range(n):
            self.time += self.cfg.dt

    def _resident(self):
        """The resident state (z-first; sharded on a mesh), packed again
        from ``state`` where that was replaced or changed since."""
        if self._zl is not None and not _unchanged(self._zl, self._snap):
            self._d = (self._pack_sw(self._zl) if self._sw
                       else self._shard(engine.pack_state(
                           self._zl, device=self.device)))
            self._snap = _snapshot(self._zl)
        return self._d

    def _coming_times(self, n: int):
        """Model times after each of the next ``n`` steps, summed as the
        loop sums them."""
        out, t = [], self.time
        for _ in range(n):
            t += self.cfg.dt
            out.append(t)
        return out

    def go(self, end_time=None, nsteps: Optional[int] = None):
        """Main loop: steps + workflow hooks + scheduled output.

        ``end_time``: duration string or seconds; or pass ``nsteps``.  The
        steps up to the next firing of any hook run as one call of the
        runner (the timers count them as that many "Step" entries); the
        hooks are asked after every step as in the JAX package's loop, in
        the same order and at the same model times.
        """
        if nsteps is None:
            if end_time is None:
                raise ValueError("need end_time or nsteps")
            nsteps = int(round(parse_duration_seconds(end_time)
                               / self.cfg.dt))

        for om in self.output_managers:
            if om.is_output_needed(self.time):
                om.manage_output(self, self.time)

        hooks = self.workflow_processes + self.output_managers
        with self.timers.time("Loop"):
            done = 0
            while done < nsteps:
                times = self._coming_times(min(nsteps - done, GRAPH_STEPS))
                k = min([len(times)] + [h.first_due(times) + 1
                                        for h in hooks])
                with self.timers.time("Step", count=k):
                    self._advance(k)
                done += k
                # the questions the step-by-step loop asks after the steps
                # before the last of the run (none is due: they may arm a
                # timer)
                for t in times[:k - 1]:
                    for wp in self.workflow_processes:
                        if wp.is_ready(t):
                            raise RuntimeError(f"{wp!r} fired off schedule")
                    for om in self.output_managers:
                        if om.is_output_needed(t):
                            raise RuntimeError(f"{om!r} fired off schedule")
                for wp in self.workflow_processes:
                    if wp.is_ready(self.time):
                        with self.timers.time("WorkflowProcess"):
                            self.state = wp.fire(self, self.time)
                for om in self.output_managers:
                    if om.is_output_needed(self.time):
                        with self.timers.time("Output"):
                            om.manage_output(self, self.time)
        if self.verbose:
            self.timers.report()
        return self.state

    # ------------------------------------------------------------------
    def profile_phases(self, reps: int = 5):
        """Per-phase timing in the reference FunctionTimer taxonomy
        (``Model.cpp:520-689``; the JAX package's ``profile_phases``):
        ``{phase: ms}`` over the model's current state (z-first, sharded on
        a mesh), which it leaves unchanged.  Each phase is called on its own:

        - ``HorizontalStep``: one explicit stage (base and evaluation state
          both the state, the full dt) through the fused stage kernel where
          the model's path takes it, else ``engine.horizontal_tendency``;
        - ``VerticalStepExplicit``: ``implicit.vertical_explicit_tendency``;
        - ``VerticalStepImplicit``: the implicit solve at ``0.5 * dt`` with
          the model's solver (under CPH, LEV and INT the dense staggered
          solve), tracers included;
        - ``Communicate``: the DSS of the state (the mesh DSS on a mesh);
        - ``StepAfterSubCycle``: ``engine.step_after_subcycle``, the nu4
          tail with its two DSS and the Rayleigh finish.

        The pieces are those of the model's Strang path (made once, at the
        first call; an IMEX, SPEX or HS model times the Strang pieces of
        its configuration).  Each phase runs once first (which builds its
        kernels), then ``reps`` times: timed by CUDA events on the card, by
        ``time.perf_counter`` after a synchronize on the CPU.  Standalone
        timings over-count what a whole step shares: use them to rank
        phases.  The shallow-water set raises ``ValueError``."""
        import time as _time
        from .fast import implicit as fimp
        if self._sw:
            raise ValueError("phase profile targets the nonhydro step")
        cfg, constants, dt = self.cfg, self.cfg.constants, self.cfg.dt
        if self._parts is None:
            self._parts = engine.strang_parts(
                cfg, self.geom, self.reference, self.device, False,
                None if cfg.fuse_pallas else False, None, None)
        parts = self._parts
        d = self._resident()
        if d is None:
            raise ValueError("the model has no state")
        if self.mesh is None and parts.fg.ab_swapped:
            d = engine._swap_ab_state(d)

        def phases(p):
            s = p.setup
            return {
                "HorizontalStep": (
                    (lambda x: p.stage_fn(x, x, dt, defer_w=p.use_wfold))
                    if p.stage_fn is not None else
                    (lambda x: engine.horizontal_tendency(x, p.fg,
                                                          constants))),
                "VerticalStepExplicit":
                    lambda x: fimp.vertical_explicit_tendency(
                        x, p.fg, constants, s.saux),
                "VerticalStepImplicit":
                    lambda x: s.implicit_fn(x, 0.5 * dt),
                "Communicate": lambda x: s.dss_fn(x),
                "StepAfterSubCycle":
                    lambda x: engine.step_after_subcycle(
                        x, dt, cfg, p.fg, rayleigh=s.rayleigh,
                        dss_fn=s.dss_fn,
                        use_fused_hyper=s.hyper_fns is not None,
                        hyper_fns=s.hyper_fns),
            }

        if self.mesh is None:
            table = phases(parts)
            calls = {k: (lambda f=f: f(d)) for k, f in table.items()}
        else:
            tables = {r: phases(p) for r, p in parts.shards.items()}
            calls = {k: (lambda k=k: parts.run(
                lambda r, x: tables[r][k](x), d)) for k in tables[
                    next(iter(tables))]}
        cuda = self.device.type == "cuda"
        out = {}
        for name, call in calls.items():
            call()                                  # warm-up: builds
            if cuda:
                torch.cuda.synchronize(self.device)
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                for _ in range(reps):
                    call()
                ev1.record()
                ev1.synchronize()
                out[name] = ev0.elapsed_time(ev1) / reps
            else:
                t0 = _time.perf_counter()
                for _ in range(reps):
                    call()
                out[name] = (_time.perf_counter() - t0) / reps * 1e3
        return out

    # ------------------------------------------------------------------
    def compute_error_norms(self, reference=None):
        """L1/L2/Linf error vs the test case reference state."""
        ref = reference if reference is not None else self.reference
        if ref is None:
            raise ValueError("no reference state available")
        if "Rho" in self.state:
            return error_norms(self.state, ref, self.geom_dev.area3d,
                               self.geom_dev.area3d_int)
        return error_norms(self.state, ref, self.geom_dev.area2d)
