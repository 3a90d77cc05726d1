"""Train a twin of the reference's `clifford_3q_custom` artifact (PPO).

The reference's clifford artifact uses a custom gateset (CX both
directions + SWAPs + H/S on qubit 0 only) that `clifford_3q_line` does not
match. This trains weights on the reference's exact env config: the env
section of the shipped `clifford_3q_custom.json`, which holds the
reference's gateset verbatim, so the saved artifact is byte-compatible
with the reference schema and a comparison isolates weight quality.

Usage: python -m qiskit_gym_torch.examples.train_clifford_3q_custom
       [minutes] [--out DIR]   (default 30 minutes,
       runs/torch/clifford_3q_custom; continues from the run directory's
       weights where an earlier run saved them, else the shipped ones)
"""

from __future__ import annotations

import time

from qiskit_gym_torch.envs import CliffordGym
from qiskit_gym_torch.rl import BasicPolicyConfig, PPOConfig, RLSynthesis

from ._common import artifact, newest, out_dir, parser, read_config

STEM = "clifford_3q_custom"


def build(out=None, device=None) -> RLSynthesis:
    env = CliffordGym.from_json(read_config(STEM)["env"], device=device)
    # reference-default knobs (same as the shipped clifford_3q_line config)
    cfg = PPOConfig(num_episodes=1024, num_epochs=10)
    pol = BasicPolicyConfig()  # 512/[256] — the reference's shape
    rls = RLSynthesis(env, cfg, pol, model_path=newest(out, STEM))
    rls.trained_with = (
        "clifford_3q_custom: trained on the reference's exact env config "
        "(the gateset copied verbatim from the reference's "
        "clifford_3q_custom.json) with reference-default PPO knobs, by "
        "qiskit_gym_torch.examples.train_clifford_3q_custom")
    return rls


def run(rls: RLSynthesis, minutes: float = 30.0, out=None) -> int:
    out = out_dir(out, STEM)
    algo = rls.algorithm
    budget_s = 60 * minutes
    t0 = time.time()
    while time.time() - t0 < budget_s:
        rls.learn(initial_difficulty=max(1, algo.best_difficulty),
                  num_iterations=5, tb_path=out)
        print(f"iter {algo.iteration} best_difficulty "
              f"{algo.best_difficulty} ({(time.time() - t0) / 60:.1f} min)",
              flush=True)
        if algo.best_difficulty > 0:
            rls.save(*artifact(out, STEM), best=True)
        if algo.best_difficulty >= 32:
            break
    print(f"done: best_difficulty {algo.best_difficulty}")
    return algo.best_difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=30.0)
    args = p.parse_args(argv)
    run(build(args.out), args.minutes, args.out)


if __name__ == "__main__":
    main()
