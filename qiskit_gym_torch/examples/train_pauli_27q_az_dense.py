"""27q heavy-hex Pauli: MCTS-assisted crossing of the rotation onset.

The 18q recipe (train_pauli_18q_az) at 27 qubits: PPO seeds rotation-onset
successes at only ~0.2% and stalls; 96-sim AlphaZero self-play
warm-started from the pre-onset PPO snapshot seeds at 7% and, with lr 3e-4
+ 4 fitting epochs, amplifies 7% -> 85%+ and cascades the curriculum from
difficulty 4 to 8 (rotation budget 2) within ~70 min (measured with the
JAX package).

Starts from the shipped pauli_heavy_hex_27q_dense artifact
(train_pauli_27q_dense 12 stops pre-onset).

Usage: python -m qiskit_gym_torch.examples.train_pauli_27q_az_dense
       [minutes] [--out DIR]   (default 75 minutes,
       runs/torch/az_pauli_27q_dense)
"""

from __future__ import annotations

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import (AlphaZeroConfig, BasicPolicyConfig,
                                 RLSynthesis)

from ._common import (artifact, curriculum_loop, out_dir, parser,
                      read_config, shipped)

SOURCE, STEM = "pauli_heavy_hex_27q_dense", "az_pauli_heavy_hex_27q_dense"


def build(device=None) -> RLSynthesis:
    env = PauliGym.from_json(read_config(SOURCE)["env"], device=device)
    cfg = AlphaZeroConfig(num_episodes=512, num_mcts_searches=96,
                          num_epochs=4, lr=3e-4,
                          root_noise_eps=0.25, temperature_drop=8)
    return RLSynthesis(env, cfg, BasicPolicyConfig(),
                       model_path=shipped(SOURCE, ".pt"))


def run(rls: RLSynthesis, minutes: float = 75.0, out=None) -> int:
    out = out_dir(out, "az_pauli_27q_dense")
    # start just below the rotation onset (scale 4)
    difficulty = curriculum_loop(rls, minutes, 3, 2, out,
                                 artifact(out, STEM))
    print(f"stopped at difficulty {difficulty}")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=75.0)
    args = p.parse_args(argv)
    run(build(), args.minutes, args.out)


if __name__ == "__main__":
    main()
