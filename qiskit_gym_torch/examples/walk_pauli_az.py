"""Curriculum-walk continuation for an amplified Pauli AZ artifact.

The BC amplifier (train_pauli_bc) jumps straight to the 2*scale gate and
camps there; on the deep-scramble scale-16 artifact that left mcts_100@32
at ~0.5 without ever clearing the 0.85 promotion gate (measured with the
JAX package). This recipe takes the other route the curriculum was built
for (the reference's one-difficulty promotions on a diff_threshold gate):
start just past the last easily proven difficulty and WALK, one
gate-proven promotion at a time, with a demo refit between learn() bursts
as the entropy-collapse anchor.

Every `best_difficulty` this run reports is promotion-gated (mcts_100 >=
0.85 at that difficulty) — unlike the amplifier's camp phase, nothing is
claimed that the gate did not prove. The best-by-gate snapshot is saved as
`<stem>.json/.pt` in the run directory (default runs/torch/<stem>_walk)
with a `trained_with` provenance note, beside `metrics.jsonl`, the
checkpoints and the evidence rows (`evidence.jsonl`).

Usage: python -m qiskit_gym_torch.examples.walk_pauli_az <artifact-stem>
       [minutes] [start_diff] [--out DIR]
e.g.   python -m qiskit_gym_torch.examples.walk_pauli_az \
           az_pauli_heavy_hex_27q 55 18
"""

from __future__ import annotations

import time

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import (POLICIES, RLSynthesis, fit_demos,
                                 generate_demos)

from ._common import (Evidence, artifact, demo_corpus, newest, out_dir,
                      parser, proof_rows, read_config)
from .train_pauli_bc import az_config, corpus_plan, scale_of

CORPUS_SEED = 20260820


def build(stem: str, out=None, device=None) -> RLSynthesis:
    full = read_config(stem)
    env = PauliGym.from_json(full["env"], device=device)
    pol_cls = full["policy_cls"].split(".")[-1]
    pol = POLICIES[pol_cls].from_json(full["policy"])
    pol = pol.with_updates(policy_cls=full["policy_cls"])
    rls = RLSynthesis(env, az_config(), pol, model_path=newest(out, stem))
    rls.trained_with = full.get("trained_with")
    # best-snapshot defense: never ship worse-than-loaded weights; but only
    # gate-proven promotions may raise best_difficulty
    rls.algorithm.best_params = rls.algorithm.params
    rls.algorithm.best_difficulty = 0
    return rls


def corpus(rls, log, per_diff=None):
    """The walk's demo corpus (train_pauli_bc's plan of 2 .. 6*scale, the
    walk's own seed), prepared on the device. `per_diff` cuts the plan's
    episodes per difficulty, for runs cut to size (tests, the smoke)."""
    scale = scale_of(rls)
    difficulties, planned = corpus_plan(scale)
    return demo_corpus(rls, generate_demos, CORPUS_SEED, difficulties,
                       per_diff or planned, log,
                       f"2..{6 * scale} step {max(1, scale // 4)}")


def burst(rls, demos, difficulty: int, run_dir: str,
          iterations: int = 2) -> tuple:
    """One step of the walk: learn() for `iterations` from `difficulty`
    (each iteration's mcts_100 gate may promote by one), then a demo refit
    of 1 epoch x 32 minibatches. Returns (difficulty reached, refit
    metrics)."""
    rls.learn(initial_difficulty=difficulty, num_iterations=iterations,
              tb_path=run_dir)
    difficulty = int(getattr(rls.env, "difficulty", difficulty))
    return difficulty, fit_demos(rls.algorithm, demos, epochs=1,
                                 num_minibatches=32)


def run(rls: RLSynthesis, stem: str, minutes: float = 55.0, start=None,
        out=None, demos=None) -> int:
    """The walk: baseline eval at `start` (default scale + 2), bursts until
    the budget less the proof reserve is spent, the gate-proven snapshot
    saved after each burst that has one, and the final proof rows.
    `demos` (prepared) replaces the recipe's own corpus."""
    out = out_dir(out, f"{stem}_walk")
    log = Evidence(out, "evidence.jsonl")
    algo = rls.algorithm
    budget_s = 60 * minutes
    # reserve the tail of the budget so the final proof rows always land
    proof_reserve_s = min(0.25 * budget_s, 20 * 60.0)
    scale = scale_of(rls)
    start = scale + 2 if start is None else start
    if demos is None:
        demos = corpus(rls, log)

    base = algo.run_evals(start).get("mcts_100", 0.0)
    log({"phase": "walk", "burst": 0, "difficulty": start,
         f"mcts_100@{start}": round(base, 4),
         "note": "loaded-artifact baseline at the walk start"})

    t0 = time.time()
    difficulty = start
    n = 0
    prior_provenance = rls.trained_with
    while time.time() - t0 < budget_s - proof_reserve_s:
        difficulty, m = burst(rls, demos, difficulty, out)
        n += 1
        log({"phase": "walk", "burst": n, "iter": algo.iteration,
             "difficulty": difficulty,
             "best_difficulty": algo.best_difficulty,
             "bc_loss": round(float(m["loss"]), 4),
             "minutes": round((time.time() - t0) / 60, 1)})
        if algo.best_difficulty > 0:
            # append to the prior provenance chain rather than replacing it
            rls.trained_with = (
                f"{stem}: curriculum walk (qiskit_gym_torch.examples."
                f"walk_pauli_az) from difficulty {start}; every promotion "
                f"gate-proven (mcts_100 >= 0.85); best proven difficulty "
                f"{algo.best_difficulty}; ships the best-by-gate snapshot "
                f"(evidence: the run's evidence.jsonl). Prior provenance: "
                + (prior_provenance or "none recorded"))
            rls.save(*artifact(out, stem), best=True)

    proof = proof_rows(algo, (scale, 2 * scale, 3 * scale,
                              max(algo.best_difficulty, start)))
    log({"phase": "final", "best_difficulty": algo.best_difficulty,
         "stopped_at_difficulty": difficulty, **proof})
    print(f"walk stopped at difficulty {difficulty} "
          f"(gate-proven best {algo.best_difficulty})")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("stem")
    p.add_argument("minutes", nargs="?", type=float, default=55.0)
    p.add_argument("start", nargs="?", type=int, default=None)
    args = p.parse_args(argv)
    run(build(args.stem, args.out), args.stem, args.minutes, args.start,
        args.out)


if __name__ == "__main__":
    main()
