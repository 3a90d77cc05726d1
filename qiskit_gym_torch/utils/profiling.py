"""Timing and tracing: the port's counterparts of the JAX package's
`utils/profiling.py`.

- `timed`: wall-clock a block, waiting at its end for the work queued on
  every visible CUDA device (`torch.cuda.synchronize` on each), so that
  asynchronous launches are inside the time.
- `device_trace`: a `torch.profiler` trace of the CPU and, where present,
  the CUDA activity of a block, written as a Chrome trace (`trace.json`,
  viewable in Perfetto or chrome://tracing) or, with `tensorboard=True`, for
  TensorBoard's profiler plugin. The profiler object is yielded, so a caller
  can read `key_averages()` or `events()` after the block.
- `benchmark`: best-of-N wall time after warm-up runs, synchronized the same
  way.

On a machine without CUDA they are the same functions without the
synchronize.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def synchronize_all() -> None:
    """Wait for the work queued on every visible CUDA device."""
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


@contextlib.contextmanager
def timed(label: str = "", sink: Optional[list] = None):
    """Wall-clock a block; appends (label, seconds) to `sink`, else
    prints."""
    t0 = time.perf_counter()
    yield
    synchronize_all()
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.append((label, dt))
    else:
        print(f"[timed] {label}: {dt * 1e3:.2f} ms")


@contextlib.contextmanager
def device_trace(logdir: str, tensorboard: bool = False):
    """Capture a trace of the block into `logdir`."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(logdir) if tensorboard else None
    with profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof
        synchronize_all()
    if not tensorboard:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def benchmark(fn: Callable, *args, repeats: int = 3, warmup: int = 1
              ) -> float:
    """Best-of-`repeats` wall seconds of fn(*args), after `warmup` calls,
    each waiting for the devices before the clock is read."""
    for _ in range(warmup):
        fn(*args)
    synchronize_all()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        synchronize_all()
        best = min(best, time.perf_counter() - t0)
    return best
