"""Readings that set the limits of `correct`: the program's, the control's
and the faults', on the chip at a cell's own size, many seeds in one
process.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 5] [--out FILE]

For each seed the cell's set-up runs, then a short window at the cell's own
load (at least the calls the reference reads), then the program's state is
freed.
Printed per seed, as one JSON line: the program's readings against the
float32 reference ("program"), the reference computed in bfloat16 in the
program's place ("control"), and for training the reference with every
minibatch's mean over its first half ("half_batch"). The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(root: Path, workload: str, seed: int, device: str = "cuda",
             overrides=None, seconds: float = 5.0) -> dict:
    import torch

    from portbench import harness

    cell = harness.Cell(root, workload)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ctx = SimpleNamespace(cell=cell, seed=seed, device=device, sync=sync,
                          overrides=dict(overrides or {}), plant=None)
    run = cell.driver().setup(ctx)
    run.window(seconds)
    run.release()
    gc.collect()
    out = {"seed": seed, "checks": {n: v for n, v, _ in run.check()},
           "program": run.compare(torch.float32),
           "control": run.compare(torch.bfloat16)}
    if not hasattr(run, "sample"):
        out["half_batch"] = run.compare(torch.float32, half_batch=True)
    del run
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from portbench.run import use_checkout_caches

    use_checkout_caches(ROOT)
    from qiskit_gym_torch.ops import cuda_lib

    cuda_lib.build()
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(ROOT, args.workload, seed,
                                   seconds=args.seconds))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if Path(q or ".").resolve() != HERE]
    sys.exit(main())
