"""What the recipes share: the coupling maps they repeat, where the shipped
artifacts are read from, where a run writes, and its evidence rows."""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

from qiskit_gym_torch.rl.demos import prepare_demos

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS = os.path.join(REPO, "examples", "models")

HEAVY_HEX_27 = [
    (0, 1), (1, 2), (1, 4), (2, 3), (3, 5), (4, 7), (5, 8), (6, 7), (7, 10),
    (8, 9), (8, 11), (10, 12), (11, 14), (12, 13), (12, 15), (13, 14),
    (14, 16), (15, 18), (16, 19), (17, 18), (18, 21), (19, 20), (19, 22),
    (21, 23), (22, 25), (23, 24), (24, 25), (25, 26),
]
GRID_3X3 = [(0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 8),
            (0, 3), (3, 6), (1, 4), (4, 7), (2, 5), (5, 8)]
LINE_3 = [(0, 1), (1, 2)]


def both_directions(edges):
    """`edges` and each edge reversed. The Pauli env's reset scramble
    applies Clifford-convention CX row ops while its step gates use the
    network (transposed) convention, so undoing a scrambled CX(a, b) takes
    the CX(b, a) action, which a one-direction map lacks."""
    return list(edges) + [(b, a) for a, b in edges]


def line(n: int):
    """The n-qubit line, both directions."""
    return both_directions([(i, i + 1) for i in range(n - 1)])


def shipped(stem: str, ext: str = ".json") -> str:
    return os.path.join(MODELS, stem + ext)


def read_config(stem: str) -> dict:
    with open(shipped(stem)) as f:
        return json.load(f)


def run_path(out: Optional[str], run_name: str) -> str:
    """The directory a run writes into: `out`, or `runs/torch/<run_name>`
    below the working directory (the JAX scripts used `runs/<run_name>`)."""
    return out or os.path.join("runs", "torch", run_name)


def out_dir(out: Optional[str], run_name: str) -> str:
    """`run_path`, created if missing."""
    path = run_path(out, run_name)
    os.makedirs(path, exist_ok=True)
    return path


def artifact(out: str, stem: str):
    """(json, pt) paths of the artifact `stem` in the run directory."""
    return os.path.join(out, stem + ".json"), os.path.join(out, stem + ".pt")


def newest(out: Optional[str], stem: str) -> str:
    """The weights a recipe continues from: the run directory's own
    `<stem>.pt` where an earlier run wrote one, else the shipped one (the
    JAX recipes read and wrote the shipped file itself)."""
    if out is not None and os.path.exists(artifact(out, stem)[1]):
        return artifact(out, stem)[1]
    return shipped(stem, ".pt")


def find_train_state(run_dir: str) -> Optional[str]:
    """The resumable snapshot in `run_dir`: the port's `train_state.pt`, or
    a JAX package run's `train_state.msgpack`; None if neither is there."""
    for name in ("train_state.pt", "train_state.msgpack"):
        path = os.path.join(run_dir, name)
        if os.path.exists(path):
            return path
    return None


def curriculum_loop(rls, minutes: float, start: int, iterations: int,
                    run_dir: str, save_paths) -> int:
    """The recipes' outer loop until `minutes` are spent: `iterations` of
    learn() from the difficulty reached so far, a progress line, and the
    artifact saved (the best-by-gate snapshot; an interrupted run keeps its
    latest). Returns the difficulty reached."""
    budget_s = 60 * minutes
    t0 = time.time()
    difficulty = start
    while time.time() - t0 < budget_s:
        rls.learn(initial_difficulty=difficulty, num_iterations=iterations,
                  tb_path=run_dir)
        difficulty = int(getattr(rls.env, "difficulty", difficulty))
        print(f"[{(time.time() - t0) / 60:5.1f} min] iter "
              f"{rls.algorithm.iteration} difficulty {difficulty}",
              flush=True)
        rls.save(*save_paths, best=True)
    return difficulty


def demo_corpus(rls, generate, seed: int, difficulties, per_diff: int,
                log, label: str):
    """A demo corpus of `generate` (generate_demos or
    generate_demos_matrix) on the gym's spec env, seeded with `seed`,
    logged as a "corpus" evidence row and packed onto the algorithm's
    device (one upload, reused all run)."""
    spec = rls.env.spec
    spec.rng = np.random.default_rng(seed)
    t0 = time.time()
    demos = generate(spec, list(difficulties), per_diff)
    row = {"phase": "corpus", "episodes": demos["episodes"],
           "steps": int(demos["action"].shape[0])}
    if "attempts" in demos:
        row["attempts"] = demos["attempts"]
    log({**row, "difficulties": label, "episodes_per_difficulty": per_diff,
         "seed": seed, "gen_seconds": round(time.time() - t0, 1)})
    return prepare_demos(rls.algorithm, demos)


def proof_rows(algo, difficulties) -> dict:
    """mcts_100 at each difficulty, measured on the best-by-gate snapshot
    (what the artifact ships); the live weights are put back after."""
    live = algo.params
    if algo.best_params is not None:
        algo.params = algo.best_params
    proof = {f"mcts_100@{d}": algo.run_evals(d).get("mcts_100")
             for d in sorted(set(difficulties))}
    algo.params = live
    return proof


class Evidence:
    """Appends one JSON row per event to `<out>/<name>` and prints it."""

    def __init__(self, out: str, name: str):
        self.path = os.path.join(out, name)

    def __call__(self, row: dict) -> dict:
        row = {"t": round(time.time(), 1), **row}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        return row


def parser(doc: str) -> argparse.ArgumentParser:
    """A parser for a recipe's command line: its positional arguments, to
    which the caller adds, and `--out`."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--out", default=None,
                   help="run directory (default runs/torch/<run name>)")
    return p
