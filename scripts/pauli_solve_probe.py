#!/usr/bin/env python3
"""Solved rates of the shipped PPO Pauli artifacts on seeded targets, on the
CPU, in either package.

    JAX_PLATFORMS=cpu python scripts/pauli_solve_probe.py jax   [artifact ...]
    python scripts/pauli_solve_probe.py torch [artifact ...]

For each artifact of `chip_smoke.PAULI_TARGETS` (default: all five) it makes
the targets `chip_smoke.py` serves on the card (the same seed, count, depth
and number of rotations: Clifford gates of the env's gateset with rx/ry/rz
rotations among them), calls `RLSynthesis.synth(target, num_searches=100)`
and prints solved/attempted and the gate counts of each returned circuit.
The torch side runs with `device="cpu"` and verifies every circuit; the JAX
side is the reference whose counts set the floors in `chip_smoke.py`. What it
prints are success counts of CPU runs, not times.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib imports only at module level)

MODELS = os.path.join(ROOT, "examples", "models")


def main() -> int:
    side = sys.argv[1] if len(sys.argv) > 1 else "torch"
    names = sys.argv[2:] or list(chip_smoke.PAULI_TARGETS)
    if side == "jax":
        from qiskit_gym_tpu.quantum import Circuit
        from qiskit_gym_tpu.rl.synthesis import RLSynthesis

        def load(*paths):
            return RLSynthesis.from_config_json(*paths)
    else:
        from qiskit_gym_torch.quantum import Circuit
        from qiskit_gym_torch.rl import RLSynthesis

        def load(*paths):
            return RLSynthesis.from_config_json(*paths, device="cpu")

    for name in names:
        count, depth, nrot, _ = chip_smoke.PAULI_TARGETS[name]
        rls = load(os.path.join(MODELS, name + ".json"),
                   os.path.join(MODELS, name + ".pt"))
        if side == "jax":
            np.random.seed(0)   # the JAX solve seeds its key from numpy
        n = rls.env.config["num_qubits"]
        rng = np.random.default_rng(chip_smoke.PAULI_SEED)
        solved, sizes = 0, []
        for _ in range(count):
            qc = Circuit(n)
            for gate in chip_smoke.pauli_target_gates(rls.env.gateset, n,
                                                      rng, depth, nrot):
                qc.append(*gate)
            out = rls.synth(qc, num_searches=100)
            if out is None:
                sizes.append(None)
                continue
            if side == "torch" and not chip_smoke.verify_pauli(out, qc):
                raise AssertionError(f"{name}: wrong circuit")
            solved += 1
            sizes.append((len(out), out.num_2q_gates()))
        print(f"{side} {name}: solved {solved}/{count} at depth {depth} with "
              f"{nrot} rotations, num_searches=100; (gates, 2q gates) per "
              f"target: {sizes}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
