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
- `span`: the program's own spans, named at its layer boundaries (a
  `synth` call holds `synth.encode`, `solve` and `synth.circuit`; `solve`
  holds `solve.state`, `collect` and `solve.rank`; a `train_step` holds
  `collect_packed`, `gae` and `fit`, and `fit` one `update` per Adam step;
  each collector step is a `rollout.step` holding `policy` and `env.step`).
  `spanned(name)` is the same span around every call of a function.
  Off by default: then `span` returns one shared no-op context, reads no
  clock and never synchronizes. On while a `torch.profiler` profile is
  active, or inside `recording()`: each span then keeps its name, id,
  parent's id, call id (the id of its root span: one `synth` or
  `train_step`), and its start and end in ns on the profiler's clock (the
  Unix clock of `time.time_ns`), in a bounded buffer that `spans()` reads.
  A root span also keeps the change of each counter registered with
  `counter` over its interval (`counters`), and `note` sets values on the
  innermost open span (`notes`). Under a profiler each span opens
  `record_function("qgt.<name>")` as well, so `device_trace`'s Chrome trace
  names the program's layers. Spans are host-only: they launch nothing and
  read nothing from the device. One thread.

On a machine without CUDA they are the same functions without the
synchronize.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler


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


# ------------------------------------------------------------------- spans
SPAN_BUFFER = 1 << 17   # spans kept; the oldest go first
_buffer: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_open: List["Span"] = []   # the spans entered and not yet left
_ids = itertools.count(1)
_recording = 0
_counters: Dict[str, Callable[[], int]] = {}
_OFF = contextlib.nullcontext()


def counter(name: str, read: Callable[[], int]) -> None:
    """Register the counter `name`, read by `read()`: a root span keeps
    its change over the span's interval."""
    _counters[name] = read


class Span:
    """One span: `name`, `id`, `parent` (the enclosing span's id, None for
    a root), `call` (its root's id), `start` and `end` (ns, Unix clock),
    for a root `counters` (each registered counter's change over the
    span), and the values `note` set on it (`notes`)."""

    __slots__ = ("name", "id", "parent", "call", "start", "end", "counters",
                 "notes", "_annotation", "_base")

    def __init__(self, name: str, id: int, parent: Optional[int] = None,
                 call: Optional[int] = None, start: int = 0,
                 end: Optional[int] = None,
                 counters: Optional[Dict[str, int]] = None,
                 notes: Optional[Dict[str, object]] = None):
        self.name, self.id, self.parent, self.call = name, id, parent, call
        self.start, self.end, self.counters = start, end, counters
        self.notes = notes
        self._annotation = self._base = None

    def __enter__(self):
        outer = _open[-1] if _open else None
        if outer is None:
            self.call = self.id
            self._base = {k: read() for k, read in _counters.items()}
        else:
            self.parent, self.call = outer.id, outer.call
        if _profiler._is_profiler_enabled:
            self._annotation = _profiler.record_function(f"qgt.{self.name}")
            self._annotation.__enter__()
        _open.append(self)
        _buffer.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _open.pop()
        if self._base is not None:
            self.counters = {k: _counters[k]() - v
                             for k, v in self._base.items()}
            self._base = None
        return False


def span(name: str):
    """A span named `name` around a block (`with span("solve"): ...`),
    recorded while a profiler runs or inside `recording()`; otherwise the
    shared no-op context."""
    if _recording or _profiler._is_profiler_enabled:
        return Span(name, next(_ids))
    return _OFF


def spanned(name: str):
    """A decorator: `span(name)` around every call of the function."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def note(**values) -> None:
    """Set `values` on the innermost open span, where one records."""
    if _open:
        top = _open[-1]
        top.notes = {**(top.notes or {}), **values}


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with no profiler running."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most SPAN_BUFFER of them)."""
    return list(_buffer)


def clear_spans() -> None:
    """Forget the recorded spans."""
    _buffer.clear()
