"""27q heavy-hex Pauli PPO with a DENSE rotation curriculum.

At the parity default `pauli_diff_scale=16`, the first rotation appears at
difficulty 16 — alongside 16 tableau scrambles — and both PPO and 48-sim AZ
hit a zero-success wall: the post-scramble rotation column is an
arbitrary-weight Pauli and the solve reward is all-or-nothing.
`pauli_diff_scale=4` is the same env family (reference-exposed knob) with
rotations from difficulty 4: the policy practices rotation cleanup on
4-scramble tableaus first, and rotation count grows every 4 levels instead
of every 16.

Usage: python -m qiskit_gym_torch.examples.train_pauli_27q_dense [minutes]
       [--out DIR]   (default 60 minutes,
       runs/torch/pauli_heavy_hex_27q_dense)
"""

from __future__ import annotations

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import BasicPolicyConfig, PPOConfig, RLSynthesis

from ._common import (HEAVY_HEX_27, artifact, both_directions,
                      curriculum_loop, out_dir, parser)

STEM = "pauli_heavy_hex_27q_dense"


def build(device=None) -> RLSynthesis:
    # pauli_layer_reward: the per-swept-rotation bonus is the ONLY
    # intermediate signal in rotation episodes (solve reward is
    # all-or-nothing); the 0.01 default gave no measurable bridge at 27q
    # (succ pinned at 0 through difficulty 4), 0.25 makes cleaning
    # rotations itself worth pursuing during exploration.
    # The recipe that carried the 12q artifact through the rotation regime
    # (difficulty 12+ in 9 minutes):
    # - depth_slope=4: budget 4d — d scrambles + ~3 cleanup ops need ~d+3
    #   OPTIMAL actions; the default 2d budget starves exploration.
    # - pauli_layer_reward=0.05: intermediate signal for cleaning without
    #   sweep-bonus farming out-gradienting the solve reward (0.25 did:
    #   success entered at 1.2%, then decayed to zero).
    # - restricted (H, S, Sdg, CX) basis: 137 actions instead of 303.
    # - pauli_diff_scale=4: rotation onset at difficulty 4 (4 scrambles),
    #   growing every 4 levels.
    env = PauliGym.from_coupling_map(both_directions(HEAVY_HEX_27),
                                     basis_gates=("H", "S", "Sdg", "CX"),
                                     max_rotations=5,
                                     pauli_diff_scale=4, depth_slope=4,
                                     pauli_layer_reward=0.05, device=device)
    # ent_coef 0.0005: at 27q the rotation-onset success seed is tiny
    # (~0.3% of episodes) and 0.002 entropy pressure extinguishes it before
    # PPO can amplify (12q seeds at >5% and survives 0.002).
    cfg = PPOConfig(
        num_episodes=2048, num_epochs=4, num_minibatches=16,
        episode_packing=True, pack_pool_slots=8,
        lr=3e-4, ent_coef=0.0005,
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
