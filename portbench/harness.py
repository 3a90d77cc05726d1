"""What every cell shares: finding a cell's files by name, the statistics of
the window, the spans the traced run records, the reading of the
profiler's trace, and the check that no JAX module was loaded.

A cell of `BENCHMARK.json` names a configuration, whose `file` is a JSON
under `portbench/configs/`, and a traffic mix, `portbench/traffic/<name>.json`,
which names its driver, `portbench/drivers/<driver>.py`. A per-layer metric
is read by `portbench/metrics/<metric>.py`'s `read(run)`. So a later change
adds a configuration, a mix or a metric by adding files and entries only.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Sequence

FORBIDDEN = ("jax", "jaxlib", "flax", "qiskit_gym_tpu")


# ---------------------------------------------------------------- discovery
class Cell:
    """One workload of `BENCHMARK.json` with its configuration and traffic
    files read, under the checkout `root`."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = by_name[name]
        self.name = name
        cfg = {c["name"]: c for c in self.bench["configs"]}[
            self.workload["config"]]
        self.config = json.loads((self.root / cfg["file"]).read_text())
        self.traffic = json.loads(
            (self.root / "portbench" / "traffic"
             / f"{self.workload['traffic']}.json").read_text())
        self.chips = int(self.workload["chips"])

    def path(self, rel: str) -> Path:
        return self.root / rel

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self.name
                in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"] if m["moves"] in e2e
                and self.name in m.get("workloads", [self.name])]

    def driver(self) -> ModuleType:
        return load_module(self.root / "portbench" / "drivers"
                           / f"{self.traffic['driver']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "portbench" / "metrics"
                           / f"{metric}.py")


def load_module(path: Path) -> ModuleType:
    """A module from its file, by path (metric names hold dots)."""
    name = "portbench_loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- statistics
def whole_call_rate(calls: Sequence[tuple], start: float) -> float:
    """Calls a second: the whole calls over the time from the window's start
    to the end of the last of them. `calls` are (start, end) pairs, every
    one started inside the window."""
    return len(calls) / (calls[-1][1] - start)


# -------------------------------------------------------------------- spans
class Spans:
    """Host-clock spans around calls into the program, by name. A span
    waits for the card at its start and its end, so the device work it
    launched falls inside it. For the traced run only: the provisional
    stand-in for spans inside the program."""

    def __init__(self, sync):
        self.sync = sync
        self.times: Dict[str, List[float]] = {}
        self._undo: List = []

    def wrap(self, owner, attr: str, name: str) -> None:
        from torch.profiler import record_function

        inner = getattr(owner, attr)
        times = self.times.setdefault(name, [])

        def spanned(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            with record_function(f"portbench.{name}"):
                out = inner(*args, **kwargs)
                self.sync()
            times.append(time.perf_counter() - t0)
            return out

        setattr(owner, attr, spanned)
        self._undo.append((owner, attr, inner))

    def close(self) -> None:
        for owner, attr, inner in reversed(self._undo):
            setattr(owner, attr, inner)
        self._undo.clear()


# -------------------------------------------------------------------- trace
def kernel_base(name: str) -> str:
    """A device kernel's bare identifier: 'void qgt::fused_step_kernel<2,
    false, true>(qgt::StepArgs)' -> 'fused_step_kernel'; a mangled name
    ('_Z17fused_step_kernel7StepArgs') -> its identifier."""
    m = re.match(r"_Z(?:N\d*)?(\d+)", name)
    if m:
        start = m.end()
        return name[start:start + int(m.group(1))]
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^(void|static)\s+", "", name.strip())
    return re.split(r"[(<\s]", name)[0].split("::")[-1]


class Trace:
    """The device activity of a profiled stretch: kernels, copies and sets
    on the card, with the harness's spans from the host."""

    def __init__(self, events, window_name: str = "portbench.trace"):
        dev, spans, win = [], [], None
        for e in events:
            on_card = str(e.device_type()).endswith("CUDA")
            if on_card and not e.is_user_annotation():
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name()))
            elif (not on_card and e.is_user_annotation()
                  and e.name().startswith("portbench.")):
                if e.name() == window_name:
                    win = (e.start_ns(), e.start_ns() + e.duration_ns())
                else:
                    spans.append((e.start_ns(), e.start_ns()
                                  + e.duration_ns(), e.name()[10:]))
        if win is None:
            raise RuntimeError("the trace holds no traced window")
        self.t0, self.t1 = win
        self.ops = sorted(d for d in dev if d[1] > self.t0 and d[0] < self.t1)
        self.spans = spans
        self.window_s = (self.t1 - self.t0) * 1e-9
        merged: List[list] = []
        for s, e, _ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy = merged
        self.busy_s = sum(e - s for s, e in merged) * 1e-9

    def count(self, base: str) -> int:
        return sum(1 for o in self.ops if kernel_base(o[2]) == base)

    def seconds(self, base: str) -> float:
        return 1e-9 * sum(o[1] - o[0] for o in self.ops
                          if kernel_base(o[2]) == base)

    def kernels(self) -> int:
        """Device kernels (not copies or sets)."""
        return sum(1 for o in self.ops if not o[2].startswith("Mem"))

    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for s, e, n in self.ops:
            key = kernel_base(n)[:64] or n[:64]
            by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0] + [x for b in self.busy for x in b] + [self.t1]
        gaps = []
        for i in range(0, len(edges) - 1, 2):
            s, e = edges[i], edges[i + 1]
            if e > s:
                gaps.append((e - s, s, e))
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:top]:
            mid = (s + e) / 2
            inside = [sp for sp in self.spans if sp[0] <= mid <= sp[1]]
            host = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside \
                else "outside spans"
            nxt = next((kernel_base(o[2]) for o in self.ops if o[0] >= e),
                       "end of window")
            out.append([f"{host}, before {nxt}"[:96], length * 1e-9])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}


@contextlib.contextmanager
def profiled(sync, sink: list):
    """Profile the block on the CPU and the card; append its `Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        with record_function("portbench.trace"):
            yield
            sync()
    sink.append(Trace(prof.profiler.kineto_results.events()))


# ------------------------------------------------------------------ imports
def forbidden_modules(names: Sequence[str] = None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`qiskit_gym_torch` is not `qiskit_gym_tpu`)."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
