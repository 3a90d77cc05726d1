#!/usr/bin/env python
"""What the program's own spans (`qiskit_gym_torch.utils.profiling`) cost
and read, on one cell of `BENCHMARK.json` at its full size:

- the off cost of a span (`with span(...)` with nothing recording, and
  what `@spanned` adds to a call) and the on cost under `recording()`, ns
  a span, over a tight loop;
- the per-call time of the cell's closed loop with `recording()` off and
  on, in alternating blocks of calls on one run of the cell (one seed);
- the span metrics of `portbench/metrics/` read from the spans of the
  `recording()` blocks, and from those of the cell's traced stretch
  under `torch.profiler`, with the traced calls' own time;
- whether every `qgt.<name>` event of the profiler's trace lines up with
  its span (the gaps at both ends, ns).

Usage (on a CUDA card; `--device cpu` rehearses it at the sizes given by
`--override key=value`):

    python3 probes/span_probe.py --workload pauli27.synth_wide \
        --seed 2147483901 --blocks 8 --calls 4 --out runs/spans.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from qiskit_gym_torch.utils import profiling  # noqa: E402

SPAN_METRICS = {"synth": ["env_step_host_us.synth"],
                "ppo_train": ["collect_step_host_us.train",
                              "update_step_host_us.train"]}


def loop_ns(n: int, on: bool, root: bool = False) -> float:
    """ns a `with span(...)` costs over an empty loop, recording `on`: a
    span inside an open one, or a `root` span (which reads the counters
    at both ends)."""
    def spans():
        for _ in range(n):
            with profiling.span("probe"):
                pass

    if not root:
        inner = spans

        def spans():
            with profiling.span("outer"):
                inner()

    def empty():
        for _ in range(n):
            pass

    best = []
    for fn in (empty, spans):
        times = []
        for _ in range(5):
            profiling.clear_spans()
            if on:
                with profiling.recording():
                    t0 = time.perf_counter_ns()
                    fn()
                    t1 = time.perf_counter_ns()
            else:
                t0 = time.perf_counter_ns()
                fn()
                t1 = time.perf_counter_ns()
            times.append((t1 - t0) / n)
        best.append(min(times))
    profiling.clear_spans()
    return best[1] - best[0]


def spanned_ns(n: int) -> float:
    """ns that `@spanned` adds to a call of an empty function, with
    nothing recording."""
    def plain():
        pass

    marked = profiling.spanned("probe")(plain)
    best = []
    for fn in (plain, marked):
        times = []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            times.append((time.perf_counter_ns() - t0) / n)
        best.append(min(times))
    return best[1] - best[0]


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "n": len(xs)}


def one_call(run, kind, i):
    if kind == "synth":
        t0, t1, _, _ = run.call(i)
        return t1 - t0
    t0 = time.perf_counter()
    run.algo.train_step(run.T, run.B, run.difficulty)
    return time.perf_counter() - t0


def record(run, kind, t0, t1, busy=()):
    if kind == "ppo_train":
        run.epochs = run.algo.config.num_epochs
        run.minibatches = run.algo.config.num_minibatches
    rec = run.record()
    rec.trace = SimpleNamespace(t0=t0, t1=t1, busy=list(busy))
    return rec


def by_name(spans) -> dict:
    """Mean µs a call-level span takes, and its self time (less the part
    that its child spans cover), by name."""
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        if s.end is None:
            continue
        inner = sum(k.end - k.start for k in kids.get(s.id, ()))
        t = out.setdefault(s.name, [0, 0, 0])
        t[0] += 1
        t[1] += s.end - s.start
        t[2] += s.end - s.start - inner
    return {k: {"n": n, "mean_us": a / n / 1e3, "self_us": b / n / 1e3}
            for k, (n, a, b) in sorted(out.items())}


def read_metrics(cell, kind, rec) -> dict:
    return {m: cell.reader(m).read(rec) for m in SPAN_METRICS[kind]}


def alignment(events, t0, t1) -> dict:
    """Gaps between each span inside [t0, t1] and its profiler event,
    matched by name in order of start."""
    theirs = {}
    for e in events:
        if not str(e.device_type()).endswith("CUDA") and \
                e.name().startswith("qgt."):
            s = e.start_ns()
            if t0 <= s <= t1:
                theirs.setdefault(e.name()[4:], []).append(
                    (s, s + e.duration_ns()))
    mine = {}
    for s in profiling.spans():
        if s.end is not None and t0 <= s.start and s.end <= t1:
            mine.setdefault(s.name, []).append((s.start, s.end))
    pairs, unmatched = [], {}
    for name in sorted(set(mine) | set(theirs)):
        a, b = sorted(mine.get(name, [])), sorted(theirs.get(name, []))
        if len(a) != len(b):
            unmatched[name] = [len(a), len(b)]
            continue
        pairs += [(s0, abs(s0 - s1), abs(e0 - e1))
                  for (s0, e0), (s1, e1) in zip(a, b)]
    pairs.sort()
    gaps = [g for _, *two in pairs for g in two]
    later = [g for _, *two in pairs[1:] for g in two]
    return {"spans": sum(len(v) for v in mine.values()),
            "events": sum(len(v) for v in theirs.values()),
            "unmatched": unmatched,
            "gap_ns_median": statistics.median(gaps) if gaps else None,
            "gap_ns_max": max(gaps) if gaps else None,
            "gap_ns_max_after_first": max(later) if later else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--blocks", type=int, default=8)
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    cuda = a.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("span_probe: no CUDA card", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    overrides = {k: json.loads(v) for k, v in
                 (o.split("=", 1) for o in a.override)}
    out = {"workload": a.workload, "seed": a.seed, "device": (
        torch.cuda.get_device_name(0) if cuda else "cpu"),
        "torch": torch.__version__,
        "off_ns_per_span": loop_ns(200_000, False),
        "off_ns_per_spanned_call": spanned_ns(200_000),
        "on_ns_per_span": loop_ns(50_000, True),
        "on_ns_per_root_span": loop_ns(20_000, True, root=True)}
    cell = harness.Cell(ROOT, a.workload)
    kind = cell.traffic["driver"]
    if cuda:
        from qiskit_gym_torch.ops import cuda_lib

        cuda_lib.build()
    ctx = SimpleNamespace(cell=cell, seed=a.seed, device=a.device, sync=sync,
                          overrides=overrides, plant=None)
    run = cell.driver().setup(ctx)
    run.window(0.0)
    sync()
    i = len(run.calls)

    # alternating blocks: off, on, on, off, off, on, ...
    times = {"off": [], "on": []}
    on_spans, on_all = [], []
    for b in range(a.blocks):
        on = (b % 4) in (1, 2)
        profiling.clear_spans()
        t0 = time.time_ns()
        for _ in range(a.calls):
            if on:
                with profiling.recording():
                    dt = one_call(run, kind, i)
            else:
                dt = one_call(run, kind, i)
            times["on" if on else "off"].append(dt)
            i += 1
        t1 = time.time_ns()
        if on:
            on_spans.append(read_metrics(cell, kind,
                                         record(run, kind, t0, t1)))
            roots = [s for s in profiling.spans() if s.parent is None]
            on_all += profiling.spans()
            out["spans_per_call"] = len(profiling.spans()) / len(roots)
    out["call_s"] = {k: quartiles(v) for k, v in times.items()}
    out["on_cost_share"] = (out["call_s"]["on"]["median"]
                            / out["call_s"]["off"]["median"] - 1)
    out["recording_metrics"] = on_spans
    out["recording_by_name"] = by_name(on_all)

    # the cell's traced stretch, its raw events kept
    kept = []
    real = harness.Trace

    def keeping(events, *args):
        events = list(events)
        kept.append(events)
        return real(events, *args)

    harness.Trace = keeping
    profiling.clear_spans()
    traces = []
    t0 = time.perf_counter()
    try:
        run.traced(traces)
    finally:
        harness.Trace = real
    traced_s = time.perf_counter() - t0
    tr = traces[0]
    rec = record(run, kind, tr.t0, tr.t1, tr.busy)
    rec.trace = tr
    out["profiler_metrics"] = read_metrics(cell, kind, rec)
    if kind == "synth":
        out["profiler_metrics"]["frontend_idle_ms.synth"] = cell.reader(
            "frontend_idle_ms.synth").read(rec)
    out["traced"] = {"calls": run.trace_calls, "seconds": traced_s,
                     "window_s": tr.window_s, "busy_s": tr.busy_s,
                     "s_per_call": tr.window_s / run.trace_calls}
    out["alignment"] = alignment(kept[0], tr.t0, tr.t1)
    out["profiler_by_name"] = by_name(
        [s for s in profiling.spans() if s.end is not None
         and tr.t0 <= s.start and s.end <= tr.t1])
    line = json.dumps(out)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
