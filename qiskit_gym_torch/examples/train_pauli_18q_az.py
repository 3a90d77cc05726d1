"""18q line Pauli: MCTS-assisted crossing of the rotation onset.

At 18 qubits PPO seeds rotation-onset successes at only ~0.1% of episodes
and cannot amplify them. AlphaZero self-play warm-started from the PPO
policy's pre-onset snapshot multiplies the seed rate ~70x (the tree
searches 96 alternatives per move, guided by the sweep bonus), and with
enough fitting pressure (lr 3e-4, 4 epochs) the policy internalizes it:
measured with the JAX package, 8% -> 85%+ collection success and a
difficulty 4 -> 7 curriculum crossing within 45 minutes.

Starts from the shipped pauli_18_line artifact (train_pauli_line 18 stops
pre-onset, best = difficulty 3).

Usage: python -m qiskit_gym_torch.examples.train_pauli_18q_az [minutes]
       [--out DIR]   (default 45 minutes, runs/torch/az_pauli_18_line)
"""

from __future__ import annotations

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import (AlphaZeroConfig, BasicPolicyConfig,
                                 RLSynthesis)

from ._common import (artifact, curriculum_loop, out_dir, parser,
                      read_config, shipped)

SOURCE, STEM = "pauli_18_line", "az_pauli_18_line"


def build(device=None) -> RLSynthesis:
    env = PauliGym.from_json(read_config(SOURCE)["env"], device=device)
    cfg = AlphaZeroConfig(num_episodes=512, num_mcts_searches=96,
                          num_epochs=4, lr=3e-4,
                          root_noise_eps=0.25, temperature_drop=8)
    return RLSynthesis(env, cfg, BasicPolicyConfig(),
                       model_path=shipped(SOURCE, ".pt"))


def run(rls: RLSynthesis, minutes: float = 45.0, out=None) -> int:
    out = out_dir(out, STEM)
    # start just below the rotation onset (scale 4)
    difficulty = curriculum_loop(rls, minutes, 3, 2, out,
                                 artifact(out, STEM))
    print(f"stopped at difficulty {difficulty}")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=45.0)
    args = p.parse_args(argv)
    run(build(), args.minutes, args.out)


if __name__ == "__main__":
    main()
