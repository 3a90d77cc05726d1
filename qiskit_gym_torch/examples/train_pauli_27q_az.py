"""AZ/MCTS fine-tune of the 27q heavy-hex Pauli policy.

PPO alone plateaus at the rotation-onset wall (difficulty 16: the first
rotation appears alongside 16 tableau scrambles; collection success pins at
zero). The proven recipe from the Clifford artifact — warm-start AZ
self-play from the PPO policy with Dirichlet root noise and a temperature
drop — lets MCTS *search* find solutions the policy can't sample, then
bootstraps policy/value from them.

Usage: python -m qiskit_gym_torch.examples.train_pauli_27q_az [minutes]
       [--out DIR]   (default 45 minutes, runs/torch/az_pauli_heavy_hex_27q)
"""

from __future__ import annotations

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import (AlphaZeroConfig, BasicPolicyConfig,
                                 RLSynthesis)

from ._common import (artifact, curriculum_loop, out_dir, parser,
                      read_config, shipped)

SOURCE, STEM = "pauli_heavy_hex_27q", "az_pauli_heavy_hex_27q"


def build(device=None) -> RLSynthesis:
    env = PauliGym.from_json(read_config(SOURCE)["env"], device=device)
    cfg = AlphaZeroConfig(
        num_episodes=256, num_mcts_searches=48, num_epochs=2, lr=1e-4,
        root_noise_eps=0.25, temperature_drop=16,
    )
    return RLSynthesis(env, cfg, BasicPolicyConfig(),
                       model_path=shipped(SOURCE, ".pt"))


def run(rls: RLSynthesis, minutes: float = 45.0, out=None) -> int:
    out = out_dir(out, STEM)
    # restart just below the wall so self-play re-derives success and the
    # curriculum carries it through the rotation regime
    difficulty = curriculum_loop(rls, minutes, 14, 2, out,
                                 artifact(out, STEM))
    print(f"stopped at difficulty {difficulty} "
          f"after {rls.algorithm.iteration} iterations")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=45.0)
    args = p.parse_args(argv)
    run(build(), args.minutes, args.out)


if __name__ == "__main__":
    main()
