"""Run one cell of BENCHMARK.json once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the kernels' build, the artifact, the traffic, one warm-up call at
the cell's own size) is timed as `setup_s`; then the cell's driver runs its
closed loop for `--seconds`. With `--trace 0` the result holds the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics: the window runs
with spans, then a few more calls under the profiler. After the window the
program's state is freed and the plain reference judges what the timed path
produced. The last line of standard output is the result as one JSON object;
the numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

Exits with 2, printing no result, without a CUDA card (or with fewer than
the cell asks for), without the program beside this folder, or once a JAX
module has been loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def use_checkout_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    caches = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(caches / sub)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", overrides=None,
             plant=None) -> dict:
    """One run of the cell; the result as a dict. `device` "cpu", the
    traffic `overrides` and a `plant` (called on the driver's run before
    its first call) serve the CPU tests only."""
    import torch

    from portbench import harness

    cell = harness.Cell(root, workload)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ctx = SimpleNamespace(cell=cell, seed=seed, device=device, sync=sync,
                          overrides=dict(overrides or {}), plant=plant)
    t0 = time.perf_counter()
    if cuda:
        from qiskit_gym_torch.ops import cuda_lib

        cuda_lib.build()
    run = cell.driver().setup(ctx)
    sync()
    setup_s = time.perf_counter() - t0

    spans = harness.Spans(sync) if trace else None
    run.window(seconds, spans)
    took = [t1 - t0 for t0, t1 in run.calls]
    if len(took) > 1:
        q = statistics.quantiles(took, n=4)
        print(f"window: {len(took)} calls, seconds each: median "
              f"{statistics.median(took)!r}, quartiles {q[0]!r} {q[2]!r}",
              file=sys.stderr)
    traces = []
    if trace:
        launched = run.traced(traces)
        spans.close()
        for kernel, n in launched.items():
            seen = traces[0].count(kernel)
            if seen != n:
                names = sorted({o[2][:80] for o in traces[0].ops})[:40]
                raise RuntimeError(
                    f"the trace holds {seen} launches of {kernel} where the "
                    f"program counted {n}: no share is read from it. Device "
                    f"names in the trace: {names}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = run.check()
    attempted, failed = run.counts()

    metrics = {}
    if trace:
        rec = run.record()
        rec.trace = traces[0]
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(run.end_to_end(), setup_s=setup_s)
        for m in cell.end_to_end():
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = traces[0].busy_s
        dev["window_s"] = traces[0].window_s
        result["breakdown"] = traces[0].breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    use_checkout_caches(ROOT)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print("portbench: this cell needs "
              f"{chips[args.workload]} CUDA card(s)", file=sys.stderr)
        return 2
    try:
        import qiskit_gym_torch
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    if ROOT not in Path(qiskit_gym_torch.__file__).resolve().parents:
        print("portbench: qiskit_gym_torch is not this checkout's",
              file=sys.stderr)
        return 2

    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    from portbench import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if Path(q or ".").resolve() != HERE]
    sys.exit(main())
