"""12q line Pauli-network PPO into the rotation regime.

Mid-scale rotation-regime artifact: large enough to be beyond toy scale
(the 5q artifact), small enough that the joint skill — clean rotations AND
restore the tableau — is discoverable by exploration within hours (27q cold
starts stall). Restricted (H, S, Sdg, CX) basis keeps the action space at
58.

Usage: python -m qiskit_gym_torch.examples.train_pauli_12q [minutes]
       [--out DIR]   (default 60 minutes, runs/torch/pauli_12_line)
"""

from __future__ import annotations

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import BasicPolicyConfig, PPOConfig, RLSynthesis

from ._common import artifact, curriculum_loop, line, out_dir, parser

N = 12
STEM = "pauli_12_line"


def build(device=None) -> RLSynthesis:
    env = PauliGym.from_coupling_map(line(N),
                                     basis_gates=("H", "S", "Sdg", "CX"),
                                     max_rotations=5,
                                     pauli_diff_scale=4, depth_slope=4,
                                     pauli_layer_reward=0.05, device=device)
    cfg = PPOConfig(
        num_episodes=2048, num_epochs=4, num_minibatches=16,
        episode_packing=True, pack_pool_slots=8,
        lr=3e-4, ent_coef=0.002,
    )
    rls = RLSynthesis(env, cfg, BasicPolicyConfig())
    rls.algorithm.fixed_horizon = True
    return rls


def run(rls: RLSynthesis, minutes: float = 60.0, out=None) -> int:
    out = out_dir(out, STEM)
    difficulty = curriculum_loop(rls, minutes, 1, 5, out,
                                 artifact(out, STEM))
    print(f"saved at difficulty {difficulty} "
          f"after {rls.algorithm.iteration} iterations")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=60.0)
    args = p.parse_args(argv)
    run(build(), args.minutes, args.out)


if __name__ == "__main__":
    main()
