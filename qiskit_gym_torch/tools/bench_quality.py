"""Solve quality of the shipped artifacts: success rate and 2q-gate counts.

Port of the JAX package's `bench_quality.py`, with its two tables:
- evals: for each artifact, reset seeded targets at each difficulty on the
  device, run the configured solve on every lane (policy rollouts sampled
  best-of-N, or a batched MCTS a move with argmax over the visits), and
  report the solve rate and the mean 2q count of the best solution of
  each solved target;
- synth: random in-gateset circuits as targets of `RLSynthesis.synth`,
  every returned circuit verified (permutation, GF(2), tableau, unitary or
  statevector equality), solve rate and mean 2q count of the verified.
Every row carries its provenance: measurement mode, hardware, round tag.

Usage: python -m qiskit_gym_torch.tools.bench_quality [--out FILE]
       [--only SUBSTR] [--round TAG] [--synth-only | --evals-only]
       [--device cuda|cpu]

The tables go to `--out` (default runs/torch_quality.md); with `--only`,
`--synth-only` or `--evals-only` and an existing file, only the rows
measured are replaced in it. `--only` matches artifact stems by
substring; '=stem' matches one stem exactly (az_pauli_heavy_hex_27q is a
prefix of its _dense/_full siblings). The BASELINE config #5 section
comes from `tools/bench_baseline5.py --out FILE`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from qiskit_gym_torch.examples._common import shipped
from qiskit_gym_torch.quantum import (Circuit, Statevector,
                                      allclose_up_to_global_phase,
                                      circuit_unitary)
from qiskit_gym_torch.rl import RLSynthesis, collect_mcts
from qiskit_gym_torch.rl.rollout import collect

from .vs_reference import _cliff_ck, _lf_ck, _perm_ck, hw_tag

OUT = os.path.join("runs", "torch_quality.md")
C_PUCT = 1.41


def _only_matches(only, name):
    """--only filter: substring by default; '=stem' for an exact match
    (az_pauli_heavy_hex_27q is a prefix of its _dense/_full siblings)."""
    if not only:
        return True
    if only.startswith("="):
        return name == only[1:]
    return only in name


def _progress(name, rows):
    print(f"[quality] {name}: " + "; ".join(
        f"d{r['difficulty']}={r['solve_rate']:.2f}/{r['mean_2q']:.1f}"
        for r in rows), file=sys.stderr, flush=True)


def load(name: str, device=None) -> RLSynthesis:
    """The shipped artifact `name` with its weights."""
    return RLSynthesis.from_config_json(shipped(name), shipped(name, ".pt"),
                                        device=device)


def eval_mode(num_searches: int, mcts: int, deterministic: bool) -> str:
    if mcts > 0:
        return (f"MCTS-{mcts} argmax" if deterministic
                else f"MCTS-{mcts} sampled") + (
            f" x{num_searches}" if num_searches > 1 else "")
    return ("argmax" if deterministic else "sampled") + (
        f" best-of-{num_searches}" if num_searches > 1 else "")


def eval_lanes(algo, difficulty: int, num_episodes: int,
               num_searches: int = 1, mcts: int = 0,
               deterministic: bool = False,
               generator: Optional[torch.Generator] = None,
               scramble_override: Optional[torch.Tensor] = None, **draws):
    """The lane run of one eval row: `num_episodes` targets reset at
    `difficulty` (drawn from `generator`, or the injected
    `scramble_override` [E, K]), each tried on `num_searches` adjacent
    lanes for T = min(depth_slope * difficulty, max_depth) moves, by the
    policy (sampled unless `deterministic`) or with `mcts` > 0 by a
    `mcts`-simulation search a move. `draws` inject the collector's noise
    (`collect`'s gumbel/flips, `collect_mcts`'s root_gamma, sim_flips,
    ...). Returns (success bool [E*S], n_cnots int [E*S]) on the host."""
    core = algo.core
    T = min(core.depth_slope * difficulty, core.max_depth)
    state = core.reset(num_episodes, difficulty, generator=generator,
                       scramble_override=scramble_override)
    if num_searches > 1:
        state = type(state)(*(x.repeat_interleave(num_searches, dim=0)
                              for x in state))
    if mcts > 0:
        # deterministic=True is eval mode (argmax over the visit counts),
        # as the artifacts' own mcts_100 gate; sampling the visits is
        # self-play exploration and under-reports short horizons
        final, _ = collect_mcts(core, algo.policy, state, T, num_sims=mcts,
                                c_puct=C_PUCT, deterministic=deterministic,
                                generator=generator, **draws)
    else:
        final, _ = collect(core, algo.policy, state, T,
                           deterministic=deterministic, generator=generator,
                           **draws)
    return final.success.cpu().numpy(), final.n_cnots.cpu().numpy()


def rows_from_lanes(success, n_cnots, num_episodes: int, num_searches: int,
                    mode: str) -> dict:
    """One row from the lanes of `eval_lanes`: a target is solved when any
    of its lanes is, and its 2q count is the fewest among its successful
    lanes."""
    success = np.asarray(success).reshape(num_episodes, num_searches)
    cnots = np.asarray(n_cnots).reshape(num_episodes, num_searches)
    solved = success.any(axis=1)
    masked = np.where(success, cnots, np.iinfo(np.int32).max)
    best = masked.min(axis=1)[solved]
    return {"solve_rate": float(solved.mean()),
            "mean_2q": float(best.mean()) if solved.any() else float("nan"),
            "mode": mode}


def eval_artifact(name, difficulties, num_episodes=256, num_searches=10,
                  mcts: int = 0, deterministic: bool = False, device=None,
                  rls: Optional[RLSynthesis] = None):
    """The eval rows of `name` (or of the weights of `rls`, which is
    measured in memory) at `difficulties`, each seeded with 1234 + d."""
    rls = load(name, device) if rls is None else rls
    algo = rls.algorithm
    mode = eval_mode(num_searches, mcts, deterministic)
    rows = []
    for diff in difficulties:
        g = torch.Generator(device=algo.device)
        g.manual_seed(1234 + diff)
        success, cnots = eval_lanes(algo, diff, num_episodes, num_searches,
                                    mcts, deterministic, g)
        rows.append({"difficulty": diff, **rows_from_lanes(
            success, cnots, num_episodes, num_searches, mode)})
    _progress(name, rows)
    return rows


def _random_target(rls, depth, rng, rotations=0):
    """A random circuit composed from the artifact env's own gateset
    (in the group by construction), plus rotations for Pauli envs."""
    gs = rls.env.gateset
    n = rls.env.config["num_qubits"]
    qc = Circuit(n)
    for _ in range(depth):
        name, qs = gs[rng.integers(len(gs))]
        qc.append(name.lower(), tuple(int(q) for q in qs))
    for _ in range(rotations):
        axis = ["rx", "ry", "rz"][rng.integers(3)]
        qc.append(axis, (int(rng.integers(n)),), (float(rng.uniform(-2, 2)),))
    return qc


def synth_quality(name, depths, num_targets=24, num_searches=32,
                  rotations=0, check=None, mcts=0, device=None,
                  rls: Optional[RLSynthesis] = None):
    """User-facing quality: random circuit targets (seeds 99 + depth)
    through synth(), each output verified by `check`. `mcts` > 0 takes the
    MCTS solve path (`num_mcts_searches` simulations a move)."""
    rls = load(name, device) if rls is None else rls
    mode = (f"synth MCTS-{mcts}, {num_searches} lanes" if mcts > 0
            else f"synth, {num_searches} lanes")
    rows = []
    for depth in depths:
        rng = np.random.default_rng(99 + depth)
        ok, cx = 0, []
        for _ in range(num_targets):
            target = _random_target(rls, depth, rng, rotations)
            out = rls.synth(target, num_searches=num_searches,
                            num_mcts_searches=mcts)
            if out is None:
                continue
            if check is not None and not check(out, target):
                continue
            ok += 1
            cx.append(sum(1 for g in out if len(g[1]) == 2))
        rows.append({
            "difficulty": depth,
            "solve_rate": ok / num_targets,
            "mean_2q": float(np.mean(cx)) if cx else float("nan"),
            "mode": mode,
        })
    _progress(f"synth:{name}", rows)
    return rows


# ------------------------------------------------------------ the checkers
perm_ck, lf_ck, cliff_ck = _perm_ck, _lf_ck, _cliff_ck


def unitary_ck(out, t):
    return allclose_up_to_global_phase(circuit_unitary(out),
                                       circuit_unitary(t))


def sv_ck(out, t):
    """Random-state evolution equal up to global phase (scales to qubit
    counts where the whole unitary is out of reach)."""
    nq = t.num_qubits
    r = np.random.default_rng(1)
    psi = r.normal(size=2 ** nq) + 1j * r.normal(size=2 ** nq)
    psi /= np.linalg.norm(psi)
    a = Statevector(nq, psi).apply_circuit(out).data
    b = Statevector(nq, psi).apply_circuit(t).data
    k = int(np.argmax(np.abs(b)))
    return np.allclose(a * (b[k] / a[k]), b, atol=1e-7)


# ---------------------------------------------- the tables (as the JAX one)
EVAL_SPECS = {
    "perm_grid_3x3 (PPO, 10 searches)": (
        "perm_grid_3x3", dict(difficulties=[4, 8, 16, 24])),
    "lf_5_line (PPO, 10 searches)": (
        "lf_5_line", dict(difficulties=[4, 8, 16, 24])),
    "clifford_3q_line (PPO, 10 searches)": (
        "clifford_3q_line", dict(difficulties=[4, 8, 16, 24])),
    "clifford_3q_custom (PPO, 10 searches)": (
        "clifford_3q_custom", dict(difficulties=[4, 8, 16, 24])),
    "perm_heavy_hex_27q (PPO, 10 searches)": (
        "perm_heavy_hex_27q",
        dict(difficulties=[8, 16, 32], num_episodes=128)),
    "clifford_heavy_hex_27q (PPO, 10 searches)": (
        "clifford_heavy_hex_27q",
        dict(difficulties=[8, 16, 24], num_episodes=128)),
    "pauli_5_line (PPO, 10 searches)": (
        "pauli_5_line",
        dict(difficulties=[16, 32, 64, 128], num_episodes=128)),
    "pauli_12_line (PPO, 10 searches)": (
        "pauli_12_line", dict(difficulties=[4, 8, 16, 24],
                              num_episodes=128)),
    "pauli_heavy_hex_27q (PPO, 10 searches)": (
        "pauli_heavy_hex_27q", dict(difficulties=[4, 8, 14],
                                    num_episodes=128)),
    "az_pauli_18_line (MCTS-64, argmax)": (
        "az_pauli_18_line", dict(difficulties=[4, 6, 8, 12],
                                 num_episodes=64,
                                 num_searches=1, mcts=64,
                                 deterministic=True)),
    "az_perm_grid_3x3 (MCTS-64, argmax)": (
        "az_perm_grid_3x3", dict(difficulties=[4, 8, 16],
                                 num_episodes=64, num_searches=1,
                                 mcts=64, deterministic=True)),
    "az_perm_heavy_hex_27q (MCTS-96, argmax)": (
        "az_perm_heavy_hex_27q", dict(difficulties=[4, 8],
                                      num_episodes=64, num_searches=1,
                                      mcts=96, deterministic=True)),
    "az_clifford_heavy_hex_27q (MCTS-48, argmax)": (
        "az_clifford_heavy_hex_27q", dict(difficulties=[8, 16, 32],
                                          num_episodes=64,
                                          num_searches=1, mcts=48,
                                          deterministic=True)),
    "az_pauli_heavy_hex_27q (MCTS-96, argmax)": (
        "az_pauli_heavy_hex_27q", dict(difficulties=[4, 8, 16, 24, 32],
                                       num_episodes=64, num_searches=1,
                                       mcts=96, deterministic=True)),
    "az_pauli_heavy_hex_27q_dense (MCTS-96, argmax)": (
        "az_pauli_heavy_hex_27q_dense", dict(difficulties=[4, 8, 16],
                                             num_episodes=64,
                                             num_searches=1, mcts=96,
                                             deterministic=True)),
    "az_pauli_heavy_hex_27q_full (MCTS-96, argmax)": (
        "az_pauli_heavy_hex_27q_full", dict(difficulties=[4, 6, 8, 12],
                                            num_episodes=64,
                                            num_searches=1, mcts=96,
                                            deterministic=True)),
}
# The two shipped artifacts that the JAX package's table leaves out, with
# the settings of the other PPO Pauli rows; the port's table adds them.
# Their difficulties are where the JAX package's own eval_artifact solves
# part of the targets (probes/jax_quality_rows.py on the CPU: at 4 and 8
# it solves 0.00-0.02 of them).
EXTRA_EVAL_SPECS = {
    "pauli_18_line (PPO, 10 searches)": (
        "pauli_18_line", dict(difficulties=[2, 3], num_episodes=128)),
    "pauli_heavy_hex_27q_dense (PPO, 10 searches)": (
        "pauli_heavy_hex_27q_dense", dict(difficulties=[2, 3],
                                          num_episodes=128)),
}

SYNTH_SPECS = {
    "perm_grid_3x3": ("perm_grid_3x3",
                      dict(depths=[4, 8], check=perm_ck)),
    "lf_5_line": ("lf_5_line", dict(depths=[4, 8], check=lf_ck)),
    "clifford_3q_line": ("clifford_3q_line",
                         dict(depths=[4, 8], check=cliff_ck)),
    "clifford_3q_custom": ("clifford_3q_custom",
                           dict(depths=[4, 8], check=cliff_ck)),
    "pauli_5_line (2 rotations)": (
        "pauli_5_line", dict(depths=[3, 6], rotations=2,
                             check=unitary_ck)),
    "pauli_12_line (2 rotations)": (
        "pauli_12_line", dict(depths=[3, 6], rotations=2,
                              check=unitary_ck)),
    "pauli_heavy_hex_27q (Clifford regime)": (
        "pauli_heavy_hex_27q", dict(depths=[4, 8], check=cliff_ck)),
    "az_pauli_18_line (2 rotations)": (
        "az_pauli_18_line", dict(depths=[3], rotations=2,
                                 num_targets=12, check=sv_ck)),
    # the MCTS-path synth round-trips (the way the AZ artifacts were
    # trained to be used: num_mcts_searches > 0 a decision)
    "az_pauli_18_line (2 rot, MCTS-32, 4 searches)": (
        "az_pauli_18_line", dict(depths=[3], rotations=2,
                                 num_targets=12, num_searches=4,
                                 mcts=32, check=sv_ck)),
    "az_pauli_heavy_hex_27q (MCTS-32, 4 searches)": (
        "az_pauli_heavy_hex_27q", dict(depths=[4, 8], num_targets=12,
                                       num_searches=4, mcts=32,
                                       check=cliff_ck)),
    # wide-lane mode: how much the multi-lane search recovers on shallow
    # targets
    "az_pauli_heavy_hex_27q (MCTS-96, 64 lanes)": (
        "az_pauli_heavy_hex_27q", dict(depths=[4, 8], num_targets=12,
                                       num_searches=64, mcts=96,
                                       check=cliff_ck)),
    "az_perm_grid_3x3 (MCTS-32, 4 searches)": (
        "az_perm_grid_3x3", dict(depths=[4, 8], num_targets=12,
                                 num_searches=4, mcts=32,
                                 check=perm_ck)),
    # the full 303-action gateset artifact: Clifford-regime round-trips
    # verified by tableau equality (27q statevectors are out of reach)
    "az_pauli_heavy_hex_27q_full (MCTS-32, 4 searches)": (
        "az_pauli_heavy_hex_27q_full", dict(depths=[4, 8],
                                            num_targets=12,
                                            num_searches=4, mcts=32,
                                            check=cliff_ck)),
}


def _patch_rows(path, table_rows):
    """Replace the rows of the named artifacts in an existing table file,
    in place (same label = same measurement semantics). `table_rows` maps
    artifact label -> list of formatted '| ... |' lines."""
    with open(path) as f:
        lines = f.read().splitlines(True)
    for label, new_lines in table_rows.items():
        prefix = f"| {label} |"
        idxs = [i for i, ln in enumerate(lines) if ln.startswith(prefix)]
        payload = [ln + "\n" for ln in new_lines]
        if idxs:
            first = idxs[0]
            lines = [ln for i, ln in enumerate(lines)
                     if not ln.startswith(prefix)]
            lines[first:first] = payload
        else:
            # append after the last table row of the file's first table
            last = max(i for i, ln in enumerate(lines)
                       if ln.startswith("| "))
            lines[last + 1:last + 1] = payload
    with open(path, "w") as f:
        f.write("".join(lines))


def format_rows(label, rows, prov):
    return [f"| {label} | {r['difficulty']} | {r['solve_rate']:.2f} | "
            f"{r['mean_2q']:.1f} | {prov(r['mode'])} |" for r in rows]


def format_tables(report: dict, synth_report: dict, prov) -> str:
    """The markdown of both tables, in the JAX package's layout."""
    lines = ["# Solve quality (shipped artifacts, qiskit_gym_torch)", "",
             "Scrambles drawn by the env at each difficulty; solve rate over",
             "fresh targets; 2q count = best solution per solved target.",
             "Provenance: measurement mode · hardware · round.", "",
             "| artifact | difficulty | solve rate | mean 2q gates "
             "| provenance |", "|---|---|---|---|---|"]
    for label, rows in report.items():
        lines += format_rows(label, rows, prov)
    lines += ["", "## synth() round-trips (random in-gateset circuit targets,",
              "verified outputs only: permutation / GF(2) / tableau /",
              "unitary / statevector equality as appropriate)", "",
              "| artifact | target depth | verified solve rate "
              "| mean 2q gates | provenance |",
              "|---|---|---|---|---|"]
    for label, rows in synth_report.items():
        lines += format_rows(label, rows, prov)
    return "\n".join(lines) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=OUT)
    p.add_argument("--only", default=None)
    p.add_argument("--round", default="port")
    group = p.add_mutually_exclusive_group()
    group.add_argument("--synth-only", action="store_true")
    group.add_argument("--evals-only", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    t0 = time.time()
    hw = hw_tag(args.device)

    def prov(mode):
        return f"{mode} · {hw} · {args.round}"

    report = {}
    if not args.synth_only:
        for label, (name, kw) in {**EVAL_SPECS, **EXTRA_EVAL_SPECS}.items():
            if _only_matches(args.only, name):
                report[label] = eval_artifact(name, device=args.device, **kw)
    synth_report = {}
    if not args.evals_only:
        for label, (name, kw) in SYNTH_SPECS.items():
            if _only_matches(args.only, name):
                synth_report[label] = synth_quality(name, device=args.device,
                                                    **kw)
    text = format_tables(report, synth_report, prov)
    print(text)
    print(f"(total {time.time() - t0:.0f}s)", file=sys.stderr)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    partial = args.only or args.synth_only or args.evals_only
    if partial and os.path.exists(args.out):
        _patch_rows(args.out, {
            label: format_rows(label, rows, prov) for label, rows in
            list(report.items()) + list(synth_report.items())})
    else:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
