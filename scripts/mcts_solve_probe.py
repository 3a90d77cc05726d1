#!/usr/bin/env python3
"""Solved counts of the shipped AlphaZero artifacts on `chip_smoke.py`'s
seeded targets, on the CPU, in either package: by policy search and by MCTS.

    JAX_PLATFORMS=cpu python scripts/mcts_solve_probe.py jax   [artifact ...]
    python scripts/mcts_solve_probe.py torch [artifact ...]

For each artifact of `chip_smoke.AZ_TARGETS` (default: all seven) it makes
the targets that `chip_smoke.py` serves on the card (same seed, count, gates
and rotations), calls `RLSynthesis.synth(target, num_searches=100)` on every
one and, on the first `mcts_count`, `synth(target, num_searches=
AZ_MCTS_LANES, num_mcts_searches=sims)`. It prints solved/attempted for both
and the 2q-gate count of every returned circuit. The JAX side builds the
same circuits in its own quantum layer; its counts set the floors in
`chip_smoke.py`. The torch side runs with `device="cpu"` and verifies every
circuit. What it prints are success counts of CPU runs, not times.
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
    names = sys.argv[2:] or list(chip_smoke.AZ_TARGETS)
    if side == "jax":
        from qiskit_gym_tpu.quantum import Circuit
        from qiskit_gym_tpu.rl.synthesis import RLSynthesis

        def load(*paths):
            return RLSynthesis.from_config_json(*paths)
    else:
        from qiskit_gym_torch.rl import RLSynthesis

        def load(*paths):
            return RLSynthesis.from_config_json(*paths, device="cpu")

    for name in names:
        spec = chip_smoke.AZ_TARGETS[name]
        rls = load(os.path.join(MODELS, name + ".json"),
                   os.path.join(MODELS, name + ".pt"))
        # the targets come from the port's quantum layer; the JAX side gets
        # the same gate lists in its own circuit class
        torch_env = rls.env
        if side == "jax":
            from qiskit_gym_torch.envs import SYNTH_ENVS

            np.random.seed(0)   # the JAX solve seeds its key from numpy
            torch_env = SYNTH_ENVS[rls.env.cls_name].from_json(
                rls.env.to_json(), device="cpu")
        targets = chip_smoke.az_targets(torch_env, name)
        if side == "jax":
            rebuilt = []
            for qc in targets:
                jqc = Circuit(qc.num_qubits)
                for gate in qc:
                    jqc.append(gate[0], tuple(gate[1]), tuple(gate[2]))
                rebuilt.append(jqc)
            targets = rebuilt
        for mode, count, kw in (
                ("policy", spec["count"], dict(num_searches=100)),
                ("mcts", spec["mcts_count"],
                 dict(num_searches=chip_smoke.AZ_MCTS_LANES,
                      num_mcts_searches=spec["sims"]))):
            if not count:
                continue
            solved, two_q = 0, []
            for qc in targets[:count]:
                out = rls.synth(qc, **kw)
                if out is None:
                    two_q.append(None)
                    continue
                if side == "torch" and not chip_smoke.verify_any(
                        torch_env, out, qc):
                    raise AssertionError(f"{name}: wrong circuit ({mode})")
                solved += 1
                two_q.append(out.num_2q_gates())
            print(f"{side} {name} {mode}: solved {solved}/{count} at "
                  f"{spec['gates']} gates + {spec['rotations']} rotations, "
                  f"{kw}; 2q gates per target: {two_q}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
