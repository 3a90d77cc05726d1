"""Brevity finetune of a small PPO artifact, gated on the head-to-head.

Port of the JAX package's `scripts/finetune_brevity.py`. PPO training
continues from the shipped weights in bursts of `iterations` learn()
iterations, cycling difficulties 8/16/24; after each burst the live
weights are scored on the head-to-head protocol itself (seeded random
circuit targets, 100-lane portfolio solve, verified mean 2q at the full
solve rate; `optimal_bc.score`). A burst's weights are kept only when
strictly better, and the artifact is written only when the best beats the
shipped score, so a run that plateaus never regresses it.

Usage: python -m qiskit_gym_torch.tools.finetune_brevity [stem] [minutes]
       [--out DIR] [--device cuda|cpu]
stem in {lf_5_line, clifford_3q_custom, perm_grid_3x3}. Evidence rows go
to `<out>/evidence.jsonl`, the learn() logs under `<out>/learn/`, an
improved artifact to `<out>/<stem>.{json,pt}` (default out:
runs/torch/<stem>_brevity).
"""

from __future__ import annotations

import argparse
import os

from qiskit_gym_torch.examples._common import Evidence, artifact, out_dir

from .bench_quality import load
from .optimal_bc import CHECKERS, burst_loop, score

DIFFICULTIES = (8, 16, 24)


def run(rls, stem: str, minutes: float = 40.0, out=None,
        iterations: int = 3, num_targets: int = 48,
        difficulties=DIFFICULTIES) -> dict:
    """Bursts of PPO on `rls` (the artifact `stem`, loaded by the caller,
    possibly cut to size) for `minutes`; returns the final evidence row."""
    out = out_dir(out, f"{stem}_brevity")
    log = Evidence(out, "evidence.jsonl")
    check, depths = CHECKERS[stem]
    algo = rls.algorithm

    def measure():
        return score(rls, depths, check, num_targets)

    base = measure()
    log({"phase": "baseline", "solve": base[0], "mean_2q": round(base[1], 3)})

    def burst(i):
        d = difficulties[i % len(difficulties)]
        rls.learn(initial_difficulty=d, num_iterations=iterations,
                  tb_path=os.path.join(out, "learn"))
        return {"difficulty": d}

    best, best_params = burst_loop(burst, measure, lambda: algo.params,
                                   base, minutes, log)
    if best[1] < base[1] and best[0] >= base[0]:
        algo.best_params = best_params
        rls.trained_with = (
            f"{stem}: brevity finetune (qiskit_gym_torch.tools."
            f"finetune_brevity): mean 2q on the seeded head-to-head protocol "
            f"{base[1]:.2f} -> {best[1]:.2f} at solve {best[0]:.2f}. Prior "
            "provenance: " + (rls.trained_with or "none recorded"))
        rls.save(*artifact(out, stem), best=True)
        return log({"phase": "final", "shipped": True,
                    "mean_2q": round(best[1], 3), "solve": best[0]})
    return log({"phase": "final", "shipped": False,
                "note": "no snapshot beat the shipped weights"})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("stem", nargs="?", default="lf_5_line",
                   choices=sorted(CHECKERS))
    p.add_argument("minutes", nargs="?", type=float, default=40.0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(load(args.stem, args.device), args.stem, args.minutes, args.out)


if __name__ == "__main__":
    main()
