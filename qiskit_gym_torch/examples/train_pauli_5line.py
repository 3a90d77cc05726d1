"""Train the shipped pauli_5_line artifact (PPO).

A 5-qubit line reaches the rotation regime fast (rotations appear at
difficulty >= pauli_diff_scale = 16), exercising the full Pauli-network
machinery: rotation tracking, trivial-sweep rewards, packed solutions.

Sparse-reward note (measured on the 27q cold start): with ent_coef=0.01
the entropy bonus overwhelms the policy gradient once collection success
drops near zero and the policy pins at uniform; 0.002 keeps the argmax
signal alive.

Usage: python -m qiskit_gym_torch.examples.train_pauli_5line [minutes]
       [--out DIR]   (default 25 minutes, runs/torch/pauli_5_line)
"""

from __future__ import annotations

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import BasicPolicyConfig, PPOConfig, RLSynthesis

from ._common import artifact, curriculum_loop, out_dir, parser

LINE_5 = [(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2), (3, 4), (4, 3)]
STEM = "pauli_5_line"


def build(device=None) -> RLSynthesis:
    env = PauliGym.from_coupling_map(LINE_5, max_rotations=4, device=device)
    cfg = PPOConfig(
        num_episodes=2048, num_epochs=4, num_minibatches=16,
        episode_packing=True, pack_pool_slots=8,
        lr=3e-4, ent_coef=0.002,
    )
    rls = RLSynthesis(env, cfg, BasicPolicyConfig())
    rls.algorithm.fixed_horizon = True
    return rls


def run(rls: RLSynthesis, minutes: float = 25.0, out=None) -> int:
    out = out_dir(out, STEM)
    difficulty = curriculum_loop(rls, minutes, 1, 5, out,
                                 artifact(out, STEM))
    print(f"saved at difficulty {difficulty} "
          f"after {rls.algorithm.iteration} iterations")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=25.0)
    args = p.parse_args(argv)
    run(build(), args.minutes, args.out)


if __name__ == "__main__":
    main()
