"""Train the shipped pauli_heavy_hex_27q artifact (PPO).

Recipe = the 27q Clifford one (large action space: minibatched epochs +
episode packing + fixed horizon). The curriculum difficulty feeds both the
tableau scramble count and the rotation budget (difficulty //
pauli_diff_scale rotations).

Usage: python -m qiskit_gym_torch.examples.train_pauli_27q [minutes]
       [--out DIR]   (default 30 minutes, runs/torch/pauli_heavy_hex_27q)
"""

from __future__ import annotations

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import BasicPolicyConfig, PPOConfig, RLSynthesis

from ._common import (HEAVY_HEX_27, artifact, both_directions,
                      curriculum_loop, out_dir, parser)

STEM = "pauli_heavy_hex_27q"


def build(device=None) -> RLSynthesis:
    # both directions: with a one-direction edge list success caps near the
    # H/S fraction of scrambles (~30%, measured; see both_directions)
    env = PauliGym.from_coupling_map(both_directions(HEAVY_HEX_27),
                                     max_rotations=5, device=device)
    # ent_coef: 0.01 pins the policy at uniform on this cold start (entropy
    # bonus overwhelms the near-zero-success policy gradient; measured —
    # entropy sat at ln(num_actions) for 260 iterations); 0.002 learns.
    cfg = PPOConfig(
        num_episodes=2048, num_epochs=4, num_minibatches=16,
        episode_packing=True, pack_pool_slots=8,
        lr=3e-4, ent_coef=0.002,
    )
    rls = RLSynthesis(env, cfg, BasicPolicyConfig())
    rls.algorithm.fixed_horizon = True
    return rls


def run(rls: RLSynthesis, minutes: float = 30.0, out=None) -> int:
    out = out_dir(out, STEM)
    difficulty = curriculum_loop(rls, minutes, 1, 5, out,
                                 artifact(out, STEM))
    print(f"saved at difficulty {difficulty} "
          f"after {rls.algorithm.iteration} iterations")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=30.0)
    args = p.parse_args(argv)
    run(build(), args.minutes, args.out)


if __name__ == "__main__":
    main()
