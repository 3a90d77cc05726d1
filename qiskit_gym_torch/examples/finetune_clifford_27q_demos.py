"""Matrix-env demonstration bootstrap, on a real weakness.

`clifford_heavy_hex_27q`'s frontier rows (d24 = 0.84 at 10 sampled
searches, measured with the JAX package) are the weakest of the shipped
matrix-env artifacts. This run measures whether `generate_demos_matrix`
(reversed-scramble plans, rl/demos.py) is a real training lever there:

1. load the shipped PPO artifact's policy,
2. behavior-clone it on matrix demos spanning difficulties 12-36 (past
   the d24/d32 frontier) with the AZ loss (fit_demos),
3. measure argmax + sampled best-of-10 evals at 16/24/32 before/after,
   keeping the best-by-eval@24 snapshot.

Evidence rows go to the run's evidence.jsonl. If the lift is real, the
refit weights are written as clifford_heavy_hex_27q.pt into the run
directory.

Usage: python -m qiskit_gym_torch.examples.finetune_clifford_27q_demos
       [minutes] [--out DIR]   (default 20 minutes,
       runs/torch/clifford_27q_demo_bc)
"""

from __future__ import annotations

import os
import time

from qiskit_gym_torch.envs import CliffordGym
from qiskit_gym_torch.rl import (AlphaZeroConfig, BasicPolicyConfig,
                                 EvalConfig, RLSynthesis)
from qiskit_gym_torch.rl.demos import fit_demos, generate_demos_matrix
from qiskit_gym_torch.utils.serialization import save_params

from ._common import (Evidence, demo_corpus, out_dir, parser, read_config,
                      shipped)

SOURCE = "clifford_heavy_hex_27q"
CORPUS_SEED = 20260819
DIFFICULTIES = range(12, 37, 2)
PER_DIFF = 400


def build(device=None) -> RLSynthesis:
    """An AlphaZero stack around the shipped PPO artifact's env and
    weights: BC runs through the AZ loss (one-hot demo visits +
    return-to-go values), and the evals are the two presets `measure`
    reads (the default mcts_100 preset, 100 sims x 27q x 3 difficulties,
    would cost much and is not read)."""
    src = read_config(SOURCE)
    env = CliffordGym.from_json(src["env"], device=device)
    evals = {"ppo_deterministic": EvalConfig(),
             "ppo_10": EvalConfig(deterministic=False, num_searches=10)}
    cfg = AlphaZeroConfig(num_episodes=8, num_mcts_searches=4, lr=1e-4,
                          evals=evals, diff_metric="ppo_deterministic")
    return RLSynthesis(env, cfg, BasicPolicyConfig.from_json(src["policy"]),
                       model_path=shipped(SOURCE, ".pt"), seed=3)


def corpus(rls, log):
    return demo_corpus(rls, generate_demos_matrix, CORPUS_SEED,
                       DIFFICULTIES, PER_DIFF, log, "12..36 step 2")


def measure(algo, tag: str, log) -> dict:
    row = {"phase": "eval", "tag": tag}
    for d in (16, 24, 32):
        ev = algo.run_evals(d)
        row[f"argmax@{d}"] = round(ev["ppo_deterministic"], 4)
        row[f"best10@{d}"] = round(ev["ppo_10"], 4)
    log(row)
    return row


def run(rls: RLSynthesis, minutes: float = 20.0, out=None, demos=None):
    """BC bursts of 2 epochs x 64 minibatches, measured every 3 bursts and
    at the end. Returns the lift in best-of-10 @ d24. `demos` (prepared)
    replaces the recipe's own corpus, for runs cut to size."""
    out = out_dir(out, "clifford_27q_demo_bc")
    log = Evidence(out, "evidence.jsonl")
    algo = rls.algorithm
    if demos is None:
        demos = corpus(rls, log)
    base = measure(algo, "shipped", log)
    best = dict(base)
    best_params = algo.params
    t0 = time.time()
    burst = 0
    while time.time() - t0 < 60 * minutes:
        m = fit_demos(algo, demos, epochs=2, num_minibatches=64)
        burst += 1
        if burst % 3 == 0 or time.time() - t0 >= 60 * minutes:
            row = measure(algo, f"bc_burst_{burst}", log)
            row["loss"] = round(float(m["loss"]), 4)
            if row["best10@24"] > best["best10@24"] or (
                row["best10@24"] == best["best10@24"]
                and row["best10@32"] > best.get("best10@32", 0)
            ):
                best = row
                best_params = algo.params

    lift = best["best10@24"] - base["best10@24"]
    log({"phase": "final", "lift_best10@24": round(lift, 4),
         "base": {k: v for k, v in base.items() if "@" in k},
         "best": {k: v for k, v in best.items() if "@" in k}})
    if lift > 0.02:
        path = os.path.join(out, SOURCE + ".pt")
        save_params(best_params, path)
        print(f"refit weights (+{lift:.3f} best-of-10 @ d24) -> {path}",
              flush=True)
    else:
        print(f"no material lift ({lift:+.3f}); weights not written",
              flush=True)
    return lift


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=20.0)
    args = p.parse_args(argv)
    run(build(), args.minutes, args.out)


if __name__ == "__main__":
    main()
