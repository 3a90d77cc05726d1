#!/usr/bin/env python
"""One quality-table synth row (MCTS or policy path) in the JAX package or
the port, over several seeds of the solve's own randomness, with every
target's 2q count: how far one row's mean 2q spreads.

The targets are the row's own (`bench_quality.synth_quality`): random
circuits of `depth` gates from the artifact's gateset, numpy
default_rng(99 + depth), each synthesized with `num_searches` lanes (and
`--mcts N` simulations a move) and verified (permutation pattern for
permutation artifacts, else the Clifford tableau). Seed k seeds the
solve: numpy's global state (JAX draws its key from it) or the port
algorithm's generator.

Usage: [JAX_PLATFORMS=cpu] python probes/synth_seed_probe.py jax|torch
       <artifact> <depth> <targets> <seed,seed,...>
       [--searches S] [--mcts N] [--device cpu|cuda]
"""
import argparse
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import numpy as np  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("side", choices=["jax", "torch"])
    p.add_argument("artifact")
    p.add_argument("depth", type=int)
    p.add_argument("targets", type=int)
    p.add_argument("seeds")
    p.add_argument("--searches", type=int, default=4)
    p.add_argument("--mcts", type=int, default=0)
    p.add_argument("--device", default="cpu")
    a = p.parse_args()
    if a.side == "jax":
        import bench_quality as bq
        from qiskit_gym_tpu.quantum import (Clifford, linear_from_circuit,
                                            permutation_pattern)
        from qiskit_gym_tpu.rl import RLSynthesis

        rls = RLSynthesis.from_config_json(
            f"examples/models/{a.artifact}.json",
            f"examples/models/{a.artifact}.pt")

        def reseed(seed):
            np.random.seed(seed)
    else:
        import torch
        from qiskit_gym_torch.quantum import (Clifford, linear_from_circuit,
                                              permutation_pattern)
        from qiskit_gym_torch.tools import bench_quality as bq

        rls = bq.load(a.artifact, a.device)

        def reseed(seed):
            rls.algorithm.generator = torch.Generator(
                device=rls.algorithm.device).manual_seed(seed)

    def check(out, t):
        if "perm" in a.artifact:
            return (permutation_pattern(linear_from_circuit(out)).tolist()
                    == permutation_pattern(linear_from_circuit(t)).tolist())
        return np.array_equal(Clifford(out).tableau, Clifford(t).tableau)

    means = []
    for seed in (int(x) for x in a.seeds.split(",")):
        reseed(seed)
        rng = np.random.default_rng(99 + a.depth)
        counts = []
        t0 = time.time()
        for _ in range(a.targets):
            target = bq._random_target(rls, a.depth, rng, 0)
            out = rls.synth(target, num_searches=a.searches,
                            num_mcts_searches=a.mcts)
            counts.append(sum(1 for g in out if len(g[1]) == 2)
                          if out is not None and check(out, target)
                          else None)
        good = [c for c in counts if c is not None]
        means.append(float(np.mean(good)) if good else float("nan"))
        print(f"{a.side} {a.artifact} d{a.depth} seed {seed}: solved "
              f"{len(good)}/{a.targets}, mean 2q {means[-1]:.4f}, per "
              f"target {counts} ({time.time() - t0:.0f} s)", flush=True)
    print(f"{a.side} {a.artifact} d{a.depth}: mean 2q over seeds "
          f"{np.mean(means):.4f}, min {min(means):.4f}, max "
          f"{max(means):.4f}", flush=True)


if __name__ == "__main__":
    main()
