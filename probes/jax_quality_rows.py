#!/usr/bin/env python
"""Eval rows of the JAX package's quality tool for given artifacts.

`bench_quality.py`'s table leaves out two shipped artifacts,
`pauli_18_line` and `pauli_heavy_hex_27q_dense`. This runs the same
`eval_artifact` (sampled best-of-10, seeds 1234 + difficulty) on them, or
on the stems given, so that the port's rows for them
(`qiskit_gym_torch.tools.bench_quality.EXTRA_EVAL_SPECS`, 128 episodes)
have a JAX row to be held against: 512 episodes by default, since one
128-episode draw spreads by more than its binomial error between seeds
(`probes/eval_seed_probe.py`). At difficulties 4 and 8 the JAX tool
solves 0.00-0.02 of these artifacts' targets. Prints one JSON line a
row.

Usage: JAX_PLATFORMS=cpu python probes/jax_quality_rows.py
       [stem:d1,d2 ...] [--episodes N]   (~10 min on the CPU)
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.chdir(os.path.join(os.path.dirname(__file__), ".."))

import bench_quality  # noqa: E402

DEFAULT = ["pauli_18_line:2,3", "pauli_heavy_hex_27q_dense:2,3"]


def main():
    args = sys.argv[1:]
    episodes = 512
    if "--episodes" in args:
        i = args.index("--episodes")
        episodes = int(args[i + 1])
        del args[i:i + 2]
    import jax

    platform = jax.devices()[0].platform
    for spec in args or DEFAULT:
        stem, diffs = spec.split(":")
        rows = bench_quality.eval_artifact(
            stem, [int(d) for d in diffs.split(",")], num_episodes=episodes)
        for row in rows:
            print(json.dumps({"artifact": stem, "episodes": episodes,
                              "platform": platform, **row}), flush=True)


if __name__ == "__main__":
    main()
