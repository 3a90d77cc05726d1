"""The AZ-flagship weight graft into `pauli_heavy_hex_27q` (PPO), measured.

Port of the JAX package's `scripts/graft_pauli_ppo.py`.
`pauli_heavy_hex_27q` (PPO) and `az_pauli_heavy_hex_27q` (AZ) share the
same env config and policy architecture, so the AZ flagship's weights load
as the PPO artifact's. This measures the PPO artifact's own quality
protocol (policy-path synth round-trips at depths 4 and 8, and the
sampled best-of-10 evals at 4, 8 and 14; no MCTS anywhere) under (a) its
shipped weights and (b) the flagship's, through `tools/bench_quality`, in
memory: no file is swapped. With --ship, the graft is written as an
artifact into the run directory if it wins on every row (within 0.02) and
on the sum of the synth rows.

Usage: python -m qiskit_gym_torch.tools.graft_pauli_ppo [--ship]
       [--out DIR] [--device cuda|cpu]
Evidence rows go to `<out>/evidence.jsonl` (default out:
runs/torch/pauli_ppo_graft).
"""

from __future__ import annotations

import argparse

from qiskit_gym_torch.examples._common import (Evidence, artifact, out_dir,
                                               read_config, shipped)
from qiskit_gym_torch.utils.serialization import load_params

from .bench_quality import cliff_ck, eval_artifact, load, synth_quality

STEM = "pauli_heavy_hex_27q"
DONOR = "az_pauli_heavy_hex_27q"


def measure(rls, tag: str, log, num_episodes: int = 128,
            num_targets: int = 24):
    """The PPO artifact's eval and synth rows with the weights `rls`
    holds."""
    ev = eval_artifact(STEM, [4, 8, 14], num_episodes=num_episodes, rls=rls)
    sy = synth_quality(STEM, [4, 8], num_targets=num_targets, check=cliff_ck,
                       rls=rls)
    log({"tag": tag, "evals": ev, "synth": sy})
    return ev, sy


def graft_wins(base, graft) -> bool:
    """The graft dominates: every row within 0.02 of the shipped weights'
    solve rate, and a higher sum of the synth rows."""
    (base_ev, base_sy), (graft_ev, graft_sy) = base, graft
    return all(g["solve_rate"] >= b["solve_rate"] - 0.02
               for g, b in zip(graft_ev + graft_sy, base_ev + base_sy)) and \
        sum(g["solve_rate"] for g in graft_sy) > \
        sum(b["solve_rate"] for b in base_sy)


def run(rls, out=None, ship: bool = False, num_episodes: int = 128,
        num_targets: int = 24) -> dict:
    """Both measurements on `rls` (the shipped PPO artifact); its own
    weights are put back after the graft's. Returns the last row."""
    out = out_dir(out, "pauli_ppo_graft")
    log = Evidence(out, "evidence.jsonl")
    own, own_best = rls.algorithm.params, rls.algorithm.best_params
    base = measure(rls, "ppo_shipped", log, num_episodes, num_targets)
    rls.algorithm.params = load_params(shipped(DONOR, ".pt"))
    try:
        graft = measure(rls, "az_grafted", log, num_episodes, num_targets)
        wins = graft_wins(base, graft)
        if ship and wins:
            rls.algorithm.best_params = rls.algorithm.params
            rls.trained_with = (
                f"{STEM}: weight graft from the AZ flagship (qiskit_gym_"
                "torch.tools.graft_pauli_ppo: same env config and policy "
                "architecture; measured better on the PPO artifact's own "
                "synth/eval protocol). Donor provenance: "
                + (read_config(DONOR).get("trained_with") or "none"))
            rls.save(*artifact(out, STEM), best=True)
    finally:
        rls.algorithm.params = own
        rls.algorithm.best_params = own_best
    if not ship:
        return log({"tag": "measured", "graft_wins": wins})
    if wins:
        return log({"tag": "shipped", "note": "graft wins, artifact "
                    f"written to {out}; donor {DONOR}"})
    return log({"tag": "not_shipped",
                "note": "graft did not dominate; PPO weights kept"})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ship", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(load(STEM, args.device), args.out, args.ship)


if __name__ == "__main__":
    main()
