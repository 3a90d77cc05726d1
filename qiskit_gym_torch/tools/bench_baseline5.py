"""BASELINE config #5 at its stated scale.

Port of the JAX package's `bench_baseline5.py`: "27q heavy-hex permutation
routing, AlphaZero synth with 1000-search batched MCTS", the reference's
AlphaZero defaults (`num_mcts_searches=1000`, PUCT C=1.41) driven through
`RLSynthesis.synth(target, num_searches=100, num_mcts_searches=1000)` on
the shipped `az_perm_heavy_hex_27q` artifact.

Every move of every lane runs a 1000-simulation batched MCTS on the card;
the 100 lanes run as one batch and the best verified solution is kept.
The targets are those of the JAX script: a host random walk of
`difficulty` gateset SWAPs (seeds 1234 + difficulty). Reports solve rate,
2q (= 3 CX a SWAP) counts and seconds a target.

Usage: python -m qiskit_gym_torch.tools.bench_baseline5 [--quick]
       [--targets N] [--difficulties D ...] [--note TEXT] [--out FILE]
       [--device cuda|cpu]

--quick is 3 targets at difficulty 16 (default: 8 targets at 8, 16, 32).
With --out, the section replaces an earlier copy of it in FILE (or is
appended); nothing else is written.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from qiskit_gym_torch.quantum import linear_from_circuit, permutation_pattern

from .bench_quality import load

ARTIFACT = "az_perm_heavy_hex_27q"
NUM_SEARCHES = 100
NUM_MCTS = 1000
MARKER = "\n## BASELINE config #5"


def targets(env, difficulty: int, count: int):
    """`count` permutations, each a random walk of `difficulty` SWAPs over
    the env's gateset from the identity (the env's own reset distribution,
    reproducible on the host), seeded with 1234 + difficulty."""
    n = env.config["num_qubits"]
    rng = np.random.default_rng(1234 + difficulty)
    out = []
    for _ in range(count):
        perm = np.arange(n)
        for _ in range(difficulty):
            _, (a, b) = env.gateset[rng.integers(len(env.gateset))]
            perm[[a, b]] = perm[[b, a]]
        out.append(perm.tolist())
    return out


def run(rls, difficulties, num_targets: int, log=print):
    """One row a difficulty: verified solve rate, mean SWAPs and 2q gates
    of the verified solutions, and mean wall seconds a target."""
    rows = []
    for difficulty in difficulties:
        ok, cx, secs = 0, [], []
        for perm in targets(rls.env, difficulty, num_targets):
            t0 = time.time()
            out = rls.synth(perm, num_searches=NUM_SEARCHES,
                            num_mcts_searches=NUM_MCTS)
            secs.append(time.time() - t0)
            if out is None:
                continue
            if permutation_pattern(linear_from_circuit(out)).tolist() != perm:
                continue
            ok += 1
            cx.append(3 * len(out))   # SWAP = 3 CX
        rows.append({
            "difficulty": difficulty,
            "solve_rate": ok / num_targets,
            "mean_swaps": float(np.mean(cx)) / 3 if cx else float("nan"),
            "mean_2q": float(np.mean(cx)) if cx else float("nan"),
            "mean_seconds": float(np.mean(secs)),
        })
        log(rows[-1])
    return rows


def format_section(rows, note=None) -> str:
    lines = ["", "## BASELINE config #5: 27q heavy-hex permutation, AZ synth",
             f"with the reference defaults (num_searches={NUM_SEARCHES} "
             "episode lanes,",
             f"num_mcts_searches={NUM_MCTS} sims/decision, C=1.41), "
             "verified", "round-trips only, qiskit_gym_torch."]
    if note:
        lines += ["", note]
    lines += ["",
              "| difficulty | verified solve rate | mean SWAPs | mean 2q "
              "| seconds/target |", "|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['difficulty']} | {r['solve_rate']:.2f} | "
                     f"{r['mean_swaps']:.1f} | {r['mean_2q']:.1f} | "
                     f"{r['mean_seconds']:.1f} |")
    return "\n".join(lines) + "\n"


def write_section(path: str, section: str) -> None:
    """Replace the config #5 section of `path` (always its last one), or
    append it."""
    prev = ""
    if os.path.exists(path):
        with open(path) as f:
            prev = f.read()
    if MARKER in prev:
        prev = prev[:prev.index(MARKER)]
    with open(path, "w") as f:
        f.write(prev + section)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--targets", type=int, default=None)
    p.add_argument("--difficulties", type=int, nargs="+", default=None)
    p.add_argument("--note", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    num_targets = args.targets or (3 if args.quick else 8)
    difficulties = args.difficulties or ([16] if args.quick else [8, 16, 32])
    rls = load(ARTIFACT, args.device)
    rows = run(rls, difficulties, num_targets)
    section = format_section(rows, args.note)
    print(section)
    if args.out:
        write_section(args.out, section)
    return rows


if __name__ == "__main__":
    main()
