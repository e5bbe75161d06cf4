"""Timing of kernels on the card with CUDA events.

Used by ``chip_smoke.py`` and ``kernels/tune_dss.py``; nothing on the model's
path imports it."""

from __future__ import annotations

import torch


def hold_device(ms: float = 10.0) -> None:
    """Keep the card busy for about ``ms`` so that the launches enqueued
    after it wait in the stream: events around them then bracket device
    time only, not the host's launch rate."""
    spin = getattr(torch.cuda, "_sleep", None)
    if spin is not None:
        spin(int(ms * 1.7e6))                  # cycles at ~1.7 GHz
    else:
        a = torch.empty((8192, 8192), device="cuda")
        torch.matmul(a, a)


def time_cuda(fn, arg_sets, reps: int, warmup: int = 2,
              queued: bool = False) -> float:
    """Mean milliseconds of ``fn(*args)`` by CUDA events, cycling through
    ``arg_sets`` so that successive launches read different buffers (sets
    that together exceed the 50 MB L2 make every launch find its inputs
    cold, as a caller inside the step does).  ``queued``: enqueue the
    launches behind a busy device, so a single-kernel ``fn`` is timed on the
    device alone."""
    n = len(arg_sets)
    for i in range(warmup):
        fn(*arg_sets[i % n])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        hold_device()
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % n])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
