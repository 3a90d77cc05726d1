"""Sims-vs-priors probe: is the plateau search-bound or priors-bound?

Port of the JAX package's `scripts/probe_sims_vs_priors.py`. It measures
argmax single-search MCTS evals of the shipped full-gateset 27q Pauli
artifact at several simulation budgets and difficulties. If a K times
bigger tree lifts the solve rate by much less than K times, the binding
constraint is the policy priors (what the demonstration bootstrap
targets), not search depth. Each difficulty d is seeded with 4321 + d.

Usage: python -m qiskit_gym_torch.tools.probe_sims_vs_priors [tag]
       [episodes] [--out FILE] [--device cuda|cpu]

Writes one JSON document to `--out` (default
runs/torch/probe_sims_vs_priors_<tag>.json) and nothing else.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .bench_quality import eval_lanes, load
from .vs_reference import hw_tag

ARTIFACT = "az_pauli_heavy_hex_27q_full"
DIFFICULTIES = (8, 12)
SIMS = (96, 256, 512)


def run(tag: str = "port", episodes: int = 32, out=None, device=None,
        difficulties=DIFFICULTIES, sims=SIMS) -> dict:
    """The rows of every (difficulty, simulations) pair, written with the
    run's description to `out`; returns the document."""
    out = out or os.path.join("runs", "torch",
                              f"probe_sims_vs_priors_{tag}.json")
    algo = load(ARTIFACT, device).algorithm
    rows = []
    for difficulty in difficulties:
        for n_sims in sims:
            g = torch.Generator(device=algo.device).manual_seed(
                4321 + difficulty)
            t0 = time.time()
            success, _ = eval_lanes(algo, difficulty, episodes, mcts=n_sims,
                                    deterministic=True, generator=g)
            rows.append({"difficulty": difficulty, "sims": n_sims,
                         "argmax_solve_rate": float(success.mean()),
                         "episodes": episodes,
                         "seconds": round(time.time() - t0, 1)})
            print(rows[-1], flush=True)
    doc = {
        "artifact": ARTIFACT,
        "tag": tag,
        "mode": "argmax single-search MCTS eval (deterministic)",
        "hardware": hw_tag(algo.device),
        "seed": "torch.Generator().manual_seed(4321 + difficulty)",
        "rows": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote {out}")
    return doc


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tag", nargs="?", default="port")
    p.add_argument("episodes", nargs="?", type=int, default=32)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.tag, args.episodes, args.out, args.device)


if __name__ == "__main__":
    main()
