"""Demo-BC finetune of `pauli_heavy_hex_27q` (PPO), gated on its own rows.

Port of the JAX package's `scripts/finetune_pauli_ppo.py`. A planner-demo
corpus (`rl/demos.generate_demos` on the spec env: Clifford-regime
scrambles below the rotation onset `pauli_diff_scale`, plus a band above
it for rotation retention) is cloned into the shipped PPO weights through
the AlphaZero loss (`fit_demos` on the card), in bursts. Every burst is
scored in memory on the artifact's own protocol: verified synth at depths
4 and 8 (`cliff_ck`, 32 lanes, seeds 99 + depth). A burst is kept when it
raises the d8 row without dropping d4 by more than 0.02; the best is
written only if the sampled best-of-10 evals (difficulties 4, 8, 14, 128
episodes) of it stay within 0.03 of the shipped weights' too.

Usage: python -m qiskit_gym_torch.tools.finetune_pauli_ppo [minutes]
       [--out DIR] [--device cuda|cpu]
Evidence rows go to `<out>/evidence.jsonl`, an improved artifact to
`<out>/pauli_heavy_hex_27q.{json,pt}` (default out:
runs/torch/pauli_ppo_bc).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from qiskit_gym_torch.examples._common import Evidence, artifact, out_dir
from qiskit_gym_torch.rl import fit_demos, generate_demos
from qiskit_gym_torch.rl.demos import prepare_demos

from .bench_quality import cliff_ck, eval_artifact, load, synth_quality
from .optimal_bc import bc_stack

STEM = "pauli_heavy_hex_27q"
CORPUS_SEED = 20260821
PER_DIFF = 900
EVAL_DIFFICULTIES = (4, 8, 14)


def corpus(rls, per_diff: int = PER_DIFF, log=print):
    """The planner-demo corpus: difficulties 2 .. scale - 1 and scale ..
    2 scale step 2 (scale = the env's pauli_diff_scale), `per_diff`
    episodes each, from the spec env seeded with CORPUS_SEED."""
    spec = rls.env.spec
    spec.rng = np.random.default_rng(CORPUS_SEED)
    scale = int(getattr(rls.env, "pauli_diff_scale", 16))
    difficulties = list(range(2, scale)) + list(range(scale, 2 * scale + 1,
                                                      2))
    t0 = time.time()
    demos = generate_demos(spec, difficulties, per_diff)
    log({"phase": "corpus", "episodes": demos["episodes"],
         "steps": int(demos["action"].shape[0]),
         "difficulties": f"2..{2 * scale}", "seed": CORPUS_SEED,
         "gen_seconds": round(time.time() - t0, 1)})
    return demos


def run(rls, minutes: float = 40.0, out=None, demos=None,
        num_targets: int = 24,
        num_episodes: int = 128, num_minibatches: int = 32) -> dict:
    """BC bursts on `rls` (the shipped PPO artifact, possibly cut to
    size) for `minutes`; `demos` (raw or prepared) replaces the corpus.
    Returns the final evidence row."""
    out = out_dir(out, "pauli_ppo_bc")
    log = Evidence(out, "evidence.jsonl")
    algo = bc_stack(rls, lr=1e-4, seed=11)
    if demos is None:
        demos = corpus(rls, log=log)
    demos = prepare_demos(algo, demos)

    def synth_rows():
        return synth_quality(STEM, [4, 8], num_targets=num_targets,
                             check=cliff_ck, rls=rls)

    def eval_rows():
        return eval_artifact(STEM, list(EVAL_DIFFICULTIES),
                             num_episodes=num_episodes, rls=rls)

    base_sy, base_ev = synth_rows(), eval_rows()
    log({"phase": "baseline", "synth": base_sy, "evals": base_ev})
    best, best_params = base_sy, algo.params
    t0 = time.time()
    burst = 0
    while time.time() - t0 < 60 * minutes:
        m = fit_demos(algo, demos, epochs=1,
                      num_minibatches=num_minibatches)
        rls.algorithm.params = algo.params   # score through the PPO artifact
        sy = synth_rows()
        burst += 1
        keep = (sy[0]["solve_rate"] >= best[0]["solve_rate"] - 0.02
                and sy[1]["solve_rate"] > best[1]["solve_rate"])
        if keep:
            best, best_params = sy, algo.params
        log({"phase": "burst", "burst": burst,
             "bc_loss": round(float(m["loss"]), 4), "synth": sy,
             "kept": keep, "minutes": round((time.time() - t0) / 60, 1)})

    shipped_d8 = base_sy[1]["solve_rate"]
    if not (best[1]["solve_rate"] > shipped_d8 and best[0]["solve_rate"]
            >= base_sy[0]["solve_rate"] - 0.02):
        return log({"phase": "final", "shipped": False,
                    "note": "no snapshot improved the d8 synth row"})
    rls.algorithm.params = best_params
    ev = eval_rows()
    if not all(g["solve_rate"] >= b["solve_rate"] - 0.03
               for g, b in zip(ev, base_ev)):
        return log({"phase": "final", "shipped": False, "evals": ev,
                    "note": "synth improved but evals regressed >3pts"})
    rls.algorithm.best_params = best_params
    rls.trained_with = (
        f"{STEM}: planner-demo BC finetune (qiskit_gym_torch.tools."
        f"finetune_pauli_ppo): verified synth d8 {shipped_d8:.2f} -> "
        f"{best[1]['solve_rate']:.2f} at d4 {best[0]['solve_rate']:.2f}. "
        "Prior provenance: " + (rls.trained_with or "none recorded"))
    rls.save(*artifact(out, STEM), best=True)
    return log({"phase": "final", "shipped": True, "synth": best,
                "evals": ev})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("minutes", nargs="?", type=float, default=40.0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(load(STEM, args.device), args.minutes, args.out)


if __name__ == "__main__":
    main()
