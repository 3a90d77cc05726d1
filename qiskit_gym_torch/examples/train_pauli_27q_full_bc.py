"""27q heavy-hex FULL-gateset Pauli: demonstration-bootstrapped curriculum.

The difficulty-8 plateau is priors-bound (MCTS-96 argmax 0.09 vs MCTS-512
0.19, measured with the JAX package — a 5x bigger tree only doubles the
solve rate). Self-play cannot amplify plans the policy never proposes, so
this run supplies them directly:

- phase 1 (BC): behavior-clone on constructively solved episodes from the
  env's own reset distribution (rl/demos.py), spanning difficulties 2-24 —
  well past the frontier — to an eval plateau, keeping the best-by-eval
  snapshot.
- phase 2 (AZ + expert replay): resume AlphaZero self-play with a
  demo-refit between learn() bursts, so the tree amplifies the cloned
  priors while the demos anchor against the entropy-collapse wall.

Target: proven best_difficulty >= 12 at pauli_diff_scale=4 (3-rotation
episodes) with >= 0.85 on the mcts_100 eval. Every phase appends an
evidence row to the run's evidence.jsonl.

Usage: python -m qiskit_gym_torch.examples.train_pauli_27q_full_bc
       [minutes] [bc_minutes] [--out DIR]
       (defaults 300 / 45, runs/torch/az_pauli_27q_full_bc; resumes the
       run directory's train_state.pt exactly when present, else
       warm-starts from the shipped az_pauli_heavy_hex_27q_full snapshot)
"""

from __future__ import annotations

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import BasicPolicyConfig, RLSynthesis, generate_demos

from ._common import (HEAVY_HEX_27, Evidence, artifact, both_directions,
                      demo_corpus, newest, out_dir, parser, proof_rows,
                      run_path)
from .train_pauli_bc import (CORPUS_SEED, az_config, az_phase, bc_phase,
                             warm_start_or_resume)

STEM = "az_pauli_heavy_hex_27q_full"
RUN = "az_pauli_27q_full_bc"


def build(out=None, device=None) -> RLSynthesis:
    env = PauliGym.from_coupling_map(both_directions(HEAVY_HEX_27),
                                     max_rotations=5,
                                     pauli_diff_scale=4, depth_slope=4,
                                     pauli_layer_reward=0.05, device=device)
    rls = RLSynthesis(env, az_config(), BasicPolicyConfig(),
                      model_path=newest(out, STEM))
    warm_start_or_resume(rls, run_path(out, RUN), 8)
    return rls


def run(rls: RLSynthesis, minutes: float = 300.0, bc_minutes: float = 45.0,
        out=None, demos=None) -> int:
    """Corpus, BC (unless resumed), AZ + expert replay, proof rows.
    `demos` (prepared) replaces the recipe's own corpus, for runs cut to
    size."""
    out = out_dir(out, RUN)
    log = Evidence(out, "evidence.jsonl")
    algo, env = rls.algorithm, rls.env
    paths = artifact(out, STEM)
    if demos is None:
        demos = demo_corpus(rls, generate_demos, CORPUS_SEED, range(2, 25),
                            1500, log, "2..24")
    if algo.iteration == 0:   # a resumed run has had its BC phase
        # argmax policy eval (cheap) tracks progress; the expensive
        # mcts_100 gate is sampled at checkpoints
        bc_phase(rls, demos, 8, 12, bc_minutes, log, paths)
    difficulty = max(int(getattr(env, "difficulty", 1)), 8)
    difficulty = az_phase(rls, demos, difficulty, minutes, out, log, paths)
    proof = proof_rows(algo, (8, 12, max(algo.best_difficulty, 12)))
    log({"phase": "final", "best_difficulty": algo.best_difficulty,
         "stopped_at_difficulty": difficulty, **proof})
    print(f"stopped at difficulty {difficulty} "
          f"(best proven {algo.best_difficulty})")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=300.0)
    p.add_argument("bc_minutes", nargs="?", type=float, default=45.0)
    args = p.parse_args(argv)
    run(build(args.out), args.minutes, args.bc_minutes, args.out)


if __name__ == "__main__":
    main()
