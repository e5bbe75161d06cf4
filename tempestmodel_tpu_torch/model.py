"""Top-level model driver: component registry + main time loop.

Counterpart of the JAX package's ``model.py``, an analog of the reference
``Model`` class (``src/atm/Model.{h,cpp}``): owns the grid/geometry, the
timestep scheme, the test case, the output managers and the workflow
(physics) processes; ``go()`` is the ``Model::Go()`` main loop
(``Model.cpp:316-518``) with per-phase timers and output scheduling;
``compute_error_norms()`` is ``Model::ComputeErrorNorms`` (``:695-782``).

The steps run on the z-first engine (``fast/engine``): Strang-HEVI where
``fast_engine_supported`` holds, an IMEX-ARK scheme where
``fast_imex_supported`` holds.  The z-first state and the carry stay
resident on the device; ``model.state`` is unpacked to the reference
layout only when it is read.  ``go`` runs the steps between two firings of
any hook as one replay of a CUDA graph of that many steps
(``engine.graph_runner``; a plain loop on the CPU), so a run without hooks
costs what a direct replay does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ._device import resolve_device, OnDevice
from .config import (ModelConfig, EquationSet, GridKind, TimestepSchemeType,
                     VerticalStaggering)
from .fast import engine
from .io.diagnostics import error_norms
from .models import nh_model
from .utils.timeobj import parse_duration_seconds
from .utils.timers import Timers

# the longest run of steps one CUDA graph holds (a run between two hook
# firings that is longer replays it more than once)
GRAPH_STEPS = 50
# graphs kept per model (one per run length met); the oldest goes first
GRAPHS_KEPT = 4

_NOT_PORTED = ("is not ported yet (ROADMAP queue 1 item 2: shallow water, "
               "the reference-layout engine for the configurations outside "
               "the z-first engine, IMEX with tracers)")


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
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP queue 1 item 3)")
        if cfg.equation_set == EquationSet.SHALLOW_WATER:
            raise NotImplementedError(f"the shallow-water model {_NOT_PORTED}")
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
        self.carry = None
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
        if cfg.vertical_staggering != VerticalStaggering.LORENZ:
            raise NotImplementedError(
                f"{cfg.vertical_staggering.value} staggering {_NOT_PORTED}")

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

        self._zl = None          # reference-layout state, None when stale
        self.reference = None
        if testcase is not None:
            self._zl = testcase.initial_state(
                self.geom, cfg.constants, dtype=cfg.dtype, device=self.device)
            if hasattr(testcase, "reference_state"):
                self.reference = testcase.reference_state(
                    self.geom, cfg.constants, dtype=cfg.dtype,
                    device=self.device)
        has_tr = self._zl is not None and "Tracers" in self._zl

        self._imex = cfg.timescheme not in (TimestepSchemeType.STRANG,
                                            TimestepSchemeType.ERK,
                                            TimestepSchemeType.SPEX)
        if not self._imex:
            if not (cfg.fuse_pallas and engine.fast_engine_supported(
                    cfg, has_tracers=has_tr, geom=self.geom)):
                raise NotImplementedError(
                    f"this configuration (outside fast_engine_supported) "
                    f"{_NOT_PORTED}")
            first, step, fg = engine._fast_fns(
                cfg, self.geom, self.reference, None, self.device, False,
                None, None, None)
        else:
            if not (cfg.fuse_pallas and engine.fast_imex_supported(
                    cfg, has_tracers=has_tr, geom=self.geom)):
                raise NotImplementedError(
                    f"this IMEX configuration (outside fast_imex_supported) "
                    f"{_NOT_PORTED}")
            body, fg = engine._imex_body(cfg, self.geom, self.reference,
                                         self.device, False, None, None)

            def first(d):
                return body(d), {}

            def step(d, carry):
                return body(d), carry
        self._swapped = fg.ab_swapped
        self._first = (engine._natural_layout(first) if self._swapped
                       else first)
        self._step = step
        self._runs = {}          # run length -> graph_runner
        self._d = None           # resident z-first state (natural layout)
        self._c = None           # resident carry (engine layout)
        self._carry_seen = None  # the self.carry that _c stands for
        self._snap = {}          # snapshot of _zl when _d matched it

    # ------------------------------------------------------------------
    @property
    def state(self):
        """The state in the reference layout (z-last tensors on the
        device), unpacked from the resident z-first state at the first read
        after a step."""
        if self._zl is None and self._d is not None:
            self._zl = engine.unpack_state(self._d)
            self._snap = _snapshot(self._zl)
        return self._zl

    @state.setter
    def state(self, value):
        # a hook that replaces the dict, replaces a key or changes a tensor
        # in place leaves _zl unlike its snapshot: the next step repacks
        self._zl = value

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
        its W axis, as the JAX package does) packed."""
        nz = self.cfg.nz
        w = carry["W"]
        if w.shape[-1] == nz + 1 and w.shape[0] != nz + 1:
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

    def _run(self, n: int):
        """The runner of ``n`` steps (one CUDA graph on the card)."""
        if n not in self._runs:
            if len(self._runs) >= GRAPHS_KEPT:
                del self._runs[next(iter(self._runs))]
            run = engine.graph_runner(self._step, n)
            self._runs[n] = (engine._natural_layout(run) if self._swapped
                             else run)
        return self._runs[n]

    def _advance(self, n: int):
        """``n`` steps from the resident state: ``first_step`` where there
        is no carry (Strang), then one run of the rest."""
        if self._zl is not None and not _unchanged(self._zl, self._snap):
            self._d = engine.pack_state(self._zl, device=self.device)
            self._snap = _snapshot(self._zl)
        if self._imex:
            self._c = {}
        elif self.carry is None:
            self._c = None
        elif self.carry is not self._carry_seen:
            self._c = self._pack_carry(self.carry)
        d, c, left = self._d, self._c, n
        if c is None:
            d, c = self._first(d)
            left -= 1
        if left:
            d, c = self._run(left)(d, c)
        self._d, self._c = d, c
        self._zl, self._snap = None, {}
        if not self._imex:
            self.carry = self._carry_seen = c
        self.step_count += n
        for _ in range(n):
            self.time += self.cfg.dt

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
        """Per-phase timing in the reference FunctionTimer taxonomy.  It
        times the reference-layout operators phase by phase, which are not
        ported yet (ROADMAP queue 1 item 2)."""
        raise NotImplementedError(
            "profile_phases needs the reference-layout operators, which are "
            "not ported yet (ROADMAP queue 1 item 2)")

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
