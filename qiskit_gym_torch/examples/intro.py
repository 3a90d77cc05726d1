"""Tour of qiskit-gym-torch (the port of the JAX package's examples/intro.py).

Run:  python -m qiskit_gym_torch.examples.intro [--out DIR]   (on the card;
the section functions take device="cpu" for the plain-PyTorch path)

Covers: building gyms from coupling maps, manual Gymnasium stepping,
PPO training with the difficulty curriculum, synthesis + round-trip
verification, config/checkpoint persistence, and Pauli-network
(Clifford + rotation) synthesis with a shipped artifact. Section 2 saves
its artifact into the run directory (default runs/torch/intro).
"""

from __future__ import annotations

import os

from qiskit_gym_torch.envs import (
    CliffordGym,
    LinearFunctionGym,
    PermutationGym,
    gym_adapter,
)
from qiskit_gym_torch.quantum import (
    Circuit,
    allclose_up_to_global_phase,
    circuit_unitary,
    linear_from_circuit,
    permutation_pattern,
)
from qiskit_gym_torch.rl import (
    BasicPolicyConfig,
    EvalConfig,
    PPOConfig,
    RLSynthesis,
)

from ._common import GRID_3X3, LINE_3, out_dir, parser, shipped

PATTERN = [1, 0, 2, 3, 4, 5, 6, 8, 7]


def manual_stepping(device=None):
    print("=== 1. Manual stepping through the Gymnasium adapter ===")
    env = LinearFunctionGym.from_coupling_map(LINE_3, difficulty=2,
                                              device=device)
    genv = gym_adapter(env)
    obs, _ = genv.reset(seed=7)
    print("observation (GF(2) matrix):\n", obs)
    total = 0.0
    while not genv._spec_env.is_final():
        obs, reward, done, _, _ = genv.step(genv.action_space.sample())
        total += reward
    print("episode return:", round(total, 4), "| solved:", genv._spec_env.success)


def build(device=None) -> RLSynthesis:
    """Section 2's stack: PPO on 3x3-grid permutation routing."""
    env = PermutationGym.from_coupling_map(GRID_3X3, max_depth=64,
                                           device=device)
    cfg = PPOConfig(
        num_episodes=256, num_epochs=4,
        evals={"ppo_deterministic": EvalConfig(num_episodes=64),
               "ppo_10": EvalConfig(num_episodes=32, deterministic=False,
                                    num_searches=10)},
    )
    return RLSynthesis(env, cfg, BasicPolicyConfig())


def run(rls: RLSynthesis, out=None):
    """Section 2 after `build`: train, synthesize `PATTERN` and verify it,
    save into the run directory and load back. Returns the synthesized
    circuit."""
    out = out_dir(out, "intro")
    rls.learn(initial_difficulty=1, num_iterations=10)
    print("difficulty reached:", rls.env.difficulty)

    out_circ = rls.synth(PATTERN, num_searches=200)
    assert out_circ is not None, "synthesis failed"
    got = permutation_pattern(linear_from_circuit(out_circ)).tolist()
    print("target:", PATTERN, "| synthesized implements:", got,
          "| swaps used:", len(out_circ))
    assert got == PATTERN

    paths = (os.path.join(out, "perm_grid_3x3.json"),
             os.path.join(out, "perm_grid_3x3.pt"))
    rls.save(*paths)
    rls2 = RLSynthesis.from_config_json(*paths, device=rls.env.device)
    assert rls2.synth(PATTERN, num_searches=200) is not None
    print("save/load round-trip ok")
    return out_circ


def train_and_synth(device=None, out=None):
    print("\n=== 2. PPO on 3x3-grid permutation routing ===")
    rls = build(device)
    run(rls, out)
    return rls


def clifford_phase_exact(device=None):
    """Returns whether the synthesized circuit equals the target's unitary
    up to a global phase, or None when the untrained search missed."""
    print("\n=== 3. Clifford synthesis is exact incl. phases ===")
    env = CliffordGym.from_coupling_map(LINE_3, basis_gates=("H", "S", "CX"),
                                        max_depth=24, device=device)
    cfg = PPOConfig(num_episodes=64, num_epochs=2,
                    evals={"ppo_deterministic": EvalConfig(num_episodes=32)})
    rls = RLSynthesis(env, cfg, BasicPolicyConfig(embedding_size=128,
                                                  common_layers=[64]))
    target = Circuit(3).h(0).cx(0, 1).s(1).cx(1, 2)
    out = rls.synth(target, num_searches=1024)
    if out is None:
        print("(stochastic search missed — rerun or train first)")
        return None
    exact = allclose_up_to_global_phase(circuit_unitary(out),
                                        circuit_unitary(target))
    print("unitary-exact (up to global phase):", exact)
    return exact


def pauli_network_synthesis(device=None):
    """Returns whether the circuit synthesized by the shipped
    `pauli_5_line` artifact equals the target up to a global phase."""
    print("\n=== 4. Pauli-network synthesis (shipped artifact) ===")
    cfg = shipped("pauli_5_line")
    if not os.path.exists(cfg):
        print("(pauli_5_line artifact not present — skipping)")
        return None
    rls = RLSynthesis.from_config_json(cfg, cfg[:-5] + ".pt", device=device)
    target = Circuit(5).h(0).cx(0, 1).rz(0.7, 1).cx(1, 2).rx(0.3, 2)
    out = rls.synth(target, deterministic=True, num_searches=1)
    if out is None:
        out = rls.synth(target, num_searches=32)
    exact = out is not None and allclose_up_to_global_phase(
        circuit_unitary(out), circuit_unitary(target))
    print("rotation circuit unitary-exact (up to global phase):", exact)
    return exact


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    manual_stepping()
    train_and_synth(out=args.out)
    clifford_phase_exact()
    pauli_network_synthesis()


if __name__ == "__main__":
    main()
