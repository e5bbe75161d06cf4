"""Per-phase wall-clock timers with device synchronization.

Analog of the reference ``FunctionTimer`` RAII group timers
(``src/base/FunctionTimer.{h,cpp}``) and the end-of-run report
(``src/atm/Model.cpp:520-689``): named groups accumulate total time and
entry counts; ``report()`` prints mean/min/max per group.  CUDA launches
return before the card finishes, so a scope on a CUDA device ends with
``torch.cuda.synchronize`` of that device: without it a scope would time
the launches only.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class FunctionTimerGroup:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = 0.0

    def add(self, dt: float, count: int = 1):
        """``count`` entries that took ``dt`` seconds together (min and max
        see their mean)."""
        self.total += dt
        self.count += count
        self.min = min(self.min, dt / count)
        self.max = max(self.max, dt / count)


class Timers:
    """Named phase timers ("Loop", "Step", "WorkflowProcess", "Output").

    ``device``: the device whose work a scope waits for at its end (a CUDA
    device is synchronized; a CPU device needs nothing).  ``sync=False``
    times the host only."""

    def __init__(self, sync: bool = True, device=None):
        self.groups = defaultdict(FunctionTimerGroup)
        self.sync = sync
        self.device = None if device is None else torch.device(device)

    @contextlib.contextmanager
    def time(self, name: str, sync_value=None, count: int = 1):
        """Time the scope as ``count`` entries of ``name``.  ``sync_value``:
        a tensor whose device the scope waits for instead of the timers'
        device."""
        t0 = time.perf_counter()
        yield
        if self.sync:
            dev = (sync_value.device if isinstance(sync_value, torch.Tensor)
                   else self.device)
            if dev is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.groups[name].add(time.perf_counter() - t0, count)

    def report(self, printer=print):
        printer("TIME  NAME                         MEAN(us)       "
                "COUNT     MIN(us)     MAX(us)")
        for name in sorted(self.groups):
            g = self.groups[name]
            mean = g.total / max(g.count, 1) * 1e6
            printer(f"      {name:<26} {mean:12.1f} {g.count:11d} "
                    f"{g.min * 1e6:11.1f} {g.max * 1e6:11.1f}")

    def as_dict(self):
        return {k: {"total_s": g.total, "count": g.count}
                for k, g in self.groups.items()}
