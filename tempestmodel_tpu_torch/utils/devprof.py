"""Device-side phase timing via the PyTorch profiler.

Counterpart of the JAX package's ``utils/devprof.py``.  A phase's wall
clock on a GPU counts the host's launches as well as the card's work, so
phase ranking uses the device trace instead: run the phase once to warm it
up, then once under ``torch.profiler`` and sum the duration of every kernel
event on the device timeline (operator events only repeat their kernels'
time and are left out).
"""

from __future__ import annotations

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def device_time_ms(fn, *args):
    """(device_ms, n_kernels) for one invocation of ``fn(*args)``, after
    one warm-up invocation.  Without a CUDA device the trace holds no
    device events: (0.0, 0)."""
    from torch.profiler import profile, ProfilerActivity

    fn(*args)
    _sync()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn(*args)
        _sync()
    total_us, n = 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total_us += e.time_range.elapsed_us()
        n += 1
    return total_us / 1000.0, n
