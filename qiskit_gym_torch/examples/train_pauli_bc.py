"""Generic BC-bootstrap amplifier for any shipped Pauli AZ artifact.

The recipe proven on the 303-action flagship (mcts_100@8 0.18 -> 1.00 in
the BC phase, curriculum then to best_difficulty 15, measured with the JAX
package), generalized so the weak Pauli frontiers — e.g.
`az_pauli_heavy_hex_27q_dense` (0.23 @ d8) and the scale-16
`az_pauli_heavy_hex_27q` (0.12 @ d16) — can be attacked with one command:

  python -m qiskit_gym_torch.examples.train_pauli_bc <artifact-stem>
      [minutes] [bc_minutes] [--out DIR]

e.g. python -m qiskit_gym_torch.examples.train_pauli_bc \
         az_pauli_heavy_hex_27q_dense 180 25

Phases (train_pauli_27q_full_bc is the flagship original):
1. corpus: constructively planned + verified demo episodes from the env's
   own reset distribution, spanning 2 .. 6*scale (well past the frontier);
   difficulty stride scales with `pauli_diff_scale` to keep the corpus
   ~20-35k episodes regardless of the artifact's difficulty semantics.
2. BC: behavior-clone to an eval plateau, keeping the best-by-gate
   (mcts_100 @ 2*scale) snapshot.
3. AZ + expert replay: resume self-play at 2*scale with a demo refit
   between learn() bursts (entropy-collapse anchor).

The env, policy shape, and warm-start weights come from the shipped
artifact json/pt; the refit, `metrics.jsonl`, checkpoints and the evidence
rows (`evidence.jsonl`) go to the run directory (default
runs/torch/<stem>_bc), and a rerun with the same directory resumes its
`train_state.pt`. The curriculum follows the reference's one-difficulty
promotions on a diff_threshold gate.
"""

from __future__ import annotations

import time

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import (POLICIES, AlphaZeroConfig, RLSynthesis,
                                 fit_demos, generate_demos)

from ._common import (Evidence, artifact, demo_corpus, find_train_state,
                      newest, out_dir, parser, proof_rows, read_config,
                      run_path)

CORPUS_SEED = 20260819


def corpus_plan(scale: int):
    """(difficulties, episodes per difficulty) of the demo corpus: 2 ..
    6*scale with a stride that keeps it at ~20-35k episodes."""
    stride = max(1, scale // 4)
    difficulties = list(range(2, 6 * scale + 1, stride))
    per_diff = max(600, min(1500, 33000 // len(difficulties)))
    return difficulties, per_diff


def az_config() -> AlphaZeroConfig:
    return AlphaZeroConfig(num_episodes=512, num_mcts_searches=96,
                           num_epochs=4, lr=3e-4,
                           root_noise_eps=0.25, temperature_drop=12,
                           diff_replay=4, episode_packing=True,
                           pack_pool_slots=4)


def scale_of(rls) -> int:
    return int(getattr(rls.env, "pauli_diff_scale", 4))


def warm_start_or_resume(rls, run_dir: str, difficulty: int) -> None:
    """Restore the run's training state if `run_dir` holds one; else seed
    the best-snapshot defense with the warm start itself, so a plateaued
    run can never overwrite the artifact with worse-than-shipped params,
    at `difficulty`."""
    algo, env = rls.algorithm, rls.env
    snap = find_train_state(run_dir)
    if snap is not None:
        algo.restore_training_state(snap)
        print(f"resumed iter {algo.iteration} difficulty {env.difficulty}",
              flush=True)
        return
    algo.best_params = algo.params
    algo.best_difficulty = difficulty
    env.difficulty = difficulty
    print(f"warm-started from shipped snapshot @ difficulty {difficulty}",
          flush=True)


def build(stem: str, out=None, device=None) -> RLSynthesis:
    full = read_config(stem)
    env = PauliGym.from_json(full["env"], device=device)
    pol_cls = full["policy_cls"].split(".")[-1]
    pol = POLICIES[pol_cls].from_json(full["policy"])
    pol = pol.with_updates(policy_cls=full["policy_cls"])
    rls = RLSynthesis(env, az_config(), pol, model_path=newest(out, stem))
    # carry any existing provenance through resaves, then describe this run
    rls.trained_with = (
        f"{stem}: BC-bootstrap amplification "
        f"(qiskit_gym_torch.examples.train_pauli_bc — planner-demo BC to an "
        f"eval plateau, then AZ + expert replay; best-by-eval snapshot "
        f"ships; evidence: the run's evidence.jsonl). Prior provenance: "
        + (full.get("trained_with") or "none recorded"))
    warm_start_or_resume(rls, run_path(out, f"{stem}_bc"), scale_of(rls))
    return rls


def bc_phase(rls, demos, gate_diff: int, probe_diff: int, minutes: float,
             log, save_paths) -> float:
    """Behavior-clone to an eval plateau: bursts of 4 epochs x 96
    minibatches, the mcts_100 gate at `gate_diff` (and the never-trained
    `probe_diff`) every 4 bursts, the best-by-gate snapshot kept, then the
    artifact saved. Returns the best gate value."""
    algo = rls.algorithm
    t0 = time.time()
    best_gate = algo.run_evals(gate_diff).get("mcts_100", 0.0)
    log({"phase": "bc", "burst": 0,
         f"mcts_100@{gate_diff}": round(best_gate, 4),
         "note": "warm-start baseline"})
    burst = 0
    while time.time() - t0 < 60 * minutes:
        m = fit_demos(algo, demos, epochs=4, num_minibatches=96)
        burst += 1
        if burst % 4 == 0 or time.time() - t0 >= 60 * minutes:
            eg = algo.run_evals(gate_diff)
            ep = algo.run_evals(probe_diff)
            log({"phase": "bc", "burst": burst,
                 "loss": round(float(m["loss"]), 4),
                 f"argmax@{gate_diff}": eg.get("ppo_deterministic"),
                 f"mcts_100@{gate_diff}": eg.get("mcts_100"),
                 f"argmax@{probe_diff}": ep.get("ppo_deterministic"),
                 f"mcts_100@{probe_diff}": ep.get("mcts_100"),
                 "minutes": round((time.time() - t0) / 60, 1)})
            if eg.get("mcts_100", 0.0) >= best_gate:
                best_gate = eg["mcts_100"]
                algo.best_params = algo.params
                algo.best_difficulty = max(algo.best_difficulty, gate_diff)
    rls.save(*save_paths, best=True)
    log({"phase": "bc_done", "bursts": burst,
         f"best_mcts_100@{gate_diff}": round(best_gate, 4),
         "minutes": round((time.time() - t0) / 60, 1)})
    return best_gate


def az_phase(rls, demos, difficulty: int, minutes: float, run_dir: str,
             log, save_paths) -> int:
    """AZ + expert replay: learn() bursts of 2 iterations with a demo
    refit between them, which anchors the policy on solved plans at every
    difficulty while self-play probes the frontier. Returns the difficulty
    reached."""
    algo, env = rls.algorithm, rls.env
    t0 = time.time()
    while time.time() - t0 < 60 * minutes:
        rls.learn(initial_difficulty=difficulty, num_iterations=2,
                  tb_path=run_dir)
        difficulty = int(getattr(env, "difficulty", difficulty))
        m = fit_demos(algo, demos, epochs=1, num_minibatches=32)
        log({"phase": "az", "iter": algo.iteration,
             "difficulty": difficulty,
             "best_difficulty": algo.best_difficulty,
             "bc_loss": round(float(m["loss"]), 4),
             "minutes": round((time.time() - t0) / 60, 1)})
        rls.save(*save_paths, best=True)
    return difficulty


def run(rls: RLSynthesis, stem: str, minutes: float = 180.0,
        bc_minutes: float = 25.0, out=None, demos=None) -> int:
    """The three phases. `demos` (prepared) replaces the recipe's own
    corpus, for runs cut to size."""
    out = out_dir(out, f"{stem}_bc")
    log = Evidence(out, "evidence.jsonl")
    algo, env = rls.algorithm, rls.env
    scale = scale_of(rls)
    gate_diff = 2 * scale          # the frontier the BC phase is graded on
    probe_diff = 3 * scale         # never trained on during BC
    paths = artifact(out, stem)
    if demos is None:
        difficulties, per_diff = corpus_plan(scale)
        demos = demo_corpus(rls, generate_demos, CORPUS_SEED, difficulties,
                            per_diff, log,
                            f"2..{6 * scale} step {max(1, scale // 4)}")
    if algo.iteration == 0:   # a resumed run (snapshots from iteration 1
        # on) has had its BC phase
        bc_phase(rls, demos, gate_diff, probe_diff, bc_minutes, log, paths)
    difficulty = max(int(getattr(env, "difficulty", 1)), gate_diff)
    difficulty = az_phase(rls, demos, difficulty, minutes, out, log, paths)
    proof = proof_rows(algo, (gate_diff, probe_diff,
                              max(algo.best_difficulty, probe_diff)))
    log({"phase": "final", "best_difficulty": algo.best_difficulty,
         "stopped_at_difficulty": difficulty, **proof})
    print(f"stopped at difficulty {difficulty} "
          f"(best proven {algo.best_difficulty})")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("stem")
    p.add_argument("minutes", nargs="?", type=float, default=180.0)
    p.add_argument("bc_minutes", nargs="?", type=float, default=25.0)
    args = p.parse_args(argv)
    run(build(args.stem, args.out), args.stem, args.minutes,
        args.bc_minutes, args.out)


if __name__ == "__main__":
    main()
