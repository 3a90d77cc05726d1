"""Train an Nq line Pauli-network policy into the rotation regime.

Generalizes train_pauli_12q (the proven dense-rotation recipe): restricted
H/S/Sdg/CX basis, rotations from difficulty 4, depth budget 4d, 0.05 sweep
bonus. Writes pauli_<N>_line.json/.pt into the run directory.

Cold-start scale frontier (measured with the JAX package): 12q reaches
difficulty 37 in an hour; 27q seeds successes at only ~0.2% of episodes at
the rotation onset and PPO cannot amplify them.

Usage: python -m qiskit_gym_torch.examples.train_pauli_line [qubits]
       [minutes] [--out DIR]   (defaults 12, 60, runs/torch/pauli_<N>_line)
"""

from __future__ import annotations

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.rl import BasicPolicyConfig, PPOConfig, RLSynthesis

from ._common import artifact, curriculum_loop, line, out_dir, parser


def build(n: int = 12, device=None) -> RLSynthesis:
    env = PauliGym.from_coupling_map(line(n),
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
    name = f"pauli_{rls.env.config['num_qubits']}_line"
    out = out_dir(out, name)
    difficulty = curriculum_loop(rls, minutes, 1, 5, out,
                                 artifact(out, name))
    print(f"saved at difficulty {difficulty} "
          f"after {rls.algorithm.iteration} iterations")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("qubits", nargs="?", type=int, default=12)
    p.add_argument("minutes", nargs="?", type=float, default=60.0)
    args = p.parse_args(argv)
    run(build(args.qubits), args.minutes, args.out)


if __name__ == "__main__":
    main()
