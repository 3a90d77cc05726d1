"""Measure the MCTS tree-depth cap at deep horizons.

Port of the JAX package's `scripts/probe_depth_cap.py`. `rl/az.py` caps
the selection depth at min(T, 32); this probe drives `collect_mcts`
directly with search_depth 32 against 64 on env-drawn scrambles (the
argmax eval semantics of the quality tables) and reports solve rate, mean
2q over the solved lanes and seconds for each setting, so that the cap
cites a measurement. Each difficulty d is seeded with 1234 + d, and both
caps start from the same reset and draws.

Usage: python -m qiskit_gym_torch.tools.probe_depth_cap [num_episodes]
       [--out FILE] [--device cuda|cpu]

Rows are appended to `--out` (default runs/torch/depth_cap.jsonl) and
printed; nothing else is written.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .bench_quality import eval_lanes, load

CASES = (
    # (artifact stem, difficulties, mcts sims)
    ("az_pauli_heavy_hex_27q", (24, 32), 96),
    ("az_perm_heavy_hex_27q", (32,), 96),
)
CAPS = (32, 64)
OUT = os.path.join("runs", "torch", "depth_cap.jsonl")


def score(success: np.ndarray, cnots: np.ndarray) -> dict:
    """The JAX probe's row arithmetic: the solved share of the lanes and
    the mean 2q count over the solved lanes (None if none is solved)."""
    return {"solve_rate": round(float(success.mean()), 4),
            "mean_2q": (round(float(cnots[success].mean()), 2)
                        if success.any() else None)}


def run(cases=CASES, episodes: int = 64, out: str = OUT,
        device=None) -> list:
    """One row a (case, difficulty, cap), appended to `out` as it is made."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    rows = []
    for stem, diffs, sims in cases:
        algo = load(stem, device).algorithm
        core = algo.core
        for diff in diffs:
            T = min(core.depth_slope * diff, core.max_depth)
            for cap in CAPS:
                g = torch.Generator(device=algo.device).manual_seed(
                    1234 + diff)
                t0 = time.time()
                success, cnots = eval_lanes(
                    algo, diff, episodes, mcts=sims, deterministic=True,
                    generator=g, search_depth=min(T, cap))
                row = {"t": round(time.time(), 1), "artifact": stem,
                       "difficulty": diff, "cap": cap, "horizon": T,
                       "sims": sims, "episodes": episodes,
                       **score(success, cnots),
                       "seconds": round(time.time() - t0, 1)}
                with open(out, "a") as f:
                    f.write(json.dumps(row) + "\n")
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("episodes", nargs="?", type=int, default=64)
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(episodes=args.episodes, out=args.out, device=args.device)


if __name__ == "__main__":
    main()
