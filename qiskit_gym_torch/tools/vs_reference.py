"""Head-to-head: our shipped artifacts against a reference's shipped weights.

Port of the JAX package's `bench_vs_reference.py`. Both sides' weights are
loaded through `RLSynthesis.from_config_json` and evaluated on the same
seeded targets with the same search budget through the same solve engine,
so weight quality is the only variable.

Protocol, per config pair and target depth:
- targets are random circuits composed from the REFERENCE artifact's own
  gateset (seeds 4242 + depth), so every target is reachable in its action
  space;
- each side runs `synth(target, num_searches=100)` with its own env and
  weights;
- outputs are verified (permutation / GF(2) / tableau equality) before
  counting: solve rate over all targets, mean 2q count over verified
  solutions; `opt_2q` is the exact minimum from `optimal_bc`'s distance
  tables where the config's group is enumerable.

The reference's weights are not part of this repository: `--ref-models`
names the directory that holds them (`<stem>.json` and `<stem>.pt`).

Usage: python -m qiskit_gym_torch.tools.vs_reference --ref-models DIR
       [--targets N] [--searches N] [--round TAG]
       [--out FILE] [--device cuda|cpu]

With `--out`, the section is written into FILE (replacing an earlier copy
of it); nothing else is written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from qiskit_gym_torch.quantum import (Circuit, Clifford, linear_from_circuit,
                                      permutation_pattern)
from qiskit_gym_torch.examples._common import MODELS as OUR_MODELS
from qiskit_gym_torch.rl import RLSynthesis
from qiskit_gym_torch.utils.device import resolve_device

SECTION_MARKER = "## Head-to-head vs the reference's shipped weights"


def _perm_ck(out, t):
    return permutation_pattern(linear_from_circuit(out)).tolist() == \
        permutation_pattern(linear_from_circuit(t)).tolist()


def _lf_ck(out, t):
    return np.array_equal(linear_from_circuit(out), linear_from_circuit(t))


def _cliff_ck(out, t):
    return np.array_equal(Clifford(out).tableau, Clifford(t).tableau)


PAIRS = [
    # (reference stem, our stem, checker, target depths)
    ("perm_square_3x3", "perm_grid_3x3", _perm_ck, [4, 8, 16]),
    ("lf_5_line", "lf_5_line", _lf_ck, [4, 8, 16]),
    ("clifford_3q_custom", "clifford_3q_custom", _cliff_ck, [4, 8, 16]),
]


def _random_target(gateset, num_qubits, depth, rng):
    qc = Circuit(num_qubits)
    for _ in range(depth):
        name, qs = gateset[rng.integers(len(gateset))]
        qc.append(name.lower(), tuple(int(q) for q in qs))
    return qc


def _count_2q(circ):
    return sum(1 for g in circ if len(g[1]) == 2)


def _optimal_table(our_stem, env):
    """Exact minimal-2q lookup over the config's whole reachable group
    (`optimal_bc.exact_min_2q_table`), or None for a config whose group is
    not enumerated."""
    from .optimal_bc import FAMILIES, exact_min_2q_table

    if our_stem not in FAMILIES:
        print(f"[vs-ref] no optimal table for {our_stem}: not one of "
              f"{sorted(FAMILIES)}", file=sys.stderr)
        return None
    return exact_min_2q_table(our_stem, env)


def _load(models: str, stem: str, device):
    return RLSynthesis.from_config_json(
        os.path.join(models, stem + ".json"),
        os.path.join(models, stem + ".pt"), device=device)


def run_pair(ref_stem, our_stem, check, depths, ref_models: str,
             our_models: str = OUR_MODELS, num_targets: int = 24,
             num_searches: int = 100, device=None):
    """The rows of one config pair: `ref_stem` loaded from `ref_models`,
    `our_stem` from `our_models`, each side synthesizing the same targets.
    """
    ref = _load(ref_models, ref_stem, device)
    ours = _load(our_models, our_stem, device)
    ref_gs = ref.env.gateset
    nq = ref.env.config["num_qubits"]
    min_2q = _optimal_table(our_stem, ours.env)
    rows = []
    for depth in depths:
        rng = np.random.default_rng(4242 + depth)
        stats = {"ref": [0, []], "ours": [0, []]}
        opts = []
        for _ in range(num_targets):
            target = _random_target(ref_gs, nq, depth, rng)
            if min_2q is not None:
                # the env solves get_state(target) down to the identity and
                # the action path is the circuit, so the state's exact
                # group distance is the least realizable 2q count
                opts.append(min_2q(ours.env.get_state(target)))
            for side, rls in (("ref", ref), ("ours", ours)):
                out = rls.synth(target, num_searches=num_searches)
                if out is None or not check(out, target):
                    continue
                stats[side][0] += 1
                stats[side][1].append(_count_2q(out))
        row = {"config": ref_stem, "depth": depth,
               "opt_2q": float(np.mean(opts)) if opts else float("nan")}
        for side in ("ref", "ours"):
            ok, cx = stats[side]
            row[f"{side}_solve"] = ok / num_targets
            row[f"{side}_2q"] = float(np.mean(cx)) if cx else float("nan")
        rows.append(row)
        print(f"[vs-ref] {ref_stem} d{depth}: opt {row['opt_2q']:.1f}  "
              f"ref {row['ref_solve']:.2f}/{row['ref_2q']:.1f}  "
              f"ours {row['ours_solve']:.2f}/{row['ours_2q']:.1f}",
              file=sys.stderr, flush=True)
    return rows


def format_section(all_rows, round_tag, hw, num_targets, num_searches):
    lines = [
        SECTION_MARKER, "",
        "Both sides' shipped weights evaluated on the same seeded targets",
        "(random circuits from the REFERENCE artifact's own gateset: its",
        "home field) with the same budget: synth(num_searches="
        f"{num_searches}),",
        f"{num_targets} targets per depth, verified outputs only, through",
        "the same solve engine of qiskit_gym_torch. The `optimal 2q` column",
        "is the exact minimum over the config's fully enumerated state",
        "group (qiskit_gym_torch.tools.optimal_bc: BFS / 0-1 Dial BFS over",
        "all reachable states), the floor for both sides on these targets.",
        f"Provenance: {hw} · {round_tag} · seeds 4242+depth.", "",
        "| config | target depth | optimal 2q | ref solve | ref 2q "
        "| ours solve | ours 2q |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in all_rows:
        lines.append(
            f"| {r['config']} | {r['depth']} | "
            f"{r.get('opt_2q', float('nan')):.1f} | "
            f"{r['ref_solve']:.2f} | {r['ref_2q']:.1f} | "
            f"{r['ours_solve']:.2f} | {r['ours_2q']:.1f} |")
    return "\n".join(lines) + "\n"


def write_section(path, section):
    """Write the section into `path`, replacing an earlier copy (from the
    marker up to the next '## ' heading); a new or empty file gets the
    section alone."""
    text = ""
    if os.path.exists(path):
        with open(path) as f:
            text = f.read()
    if SECTION_MARKER in text:
        start = text.index(SECTION_MARKER)
        after = text.find("\n## ", start + 1)
        tail = "" if after < 0 else text[after + 1:]
        text = text[:start] + section + tail
    elif text.strip():
        text = text.rstrip("\n") + "\n\n" + section
    else:
        text = section
    with open(path, "w") as f:
        f.write(text)


def hw_tag(device) -> str:
    """The hardware a row was measured on: the card's name, or CPU."""
    import torch

    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "CPU"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ref-models", required=True,
                   help="directory of the reference's <stem>.json/.pt")
    p.add_argument("--targets", type=int, default=24)
    p.add_argument("--searches", type=int, default=100)
    p.add_argument("--round", default="port")
    p.add_argument("--out", default=None,
                   help="file to write the section into")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    t0 = time.time()
    all_rows = []
    for ref_stem, our_stem, check, depths in PAIRS:
        all_rows += run_pair(ref_stem, our_stem, check, depths,
                             args.ref_models,
                             num_targets=args.targets,
                             num_searches=args.searches, device=args.device)
    section = format_section(all_rows, args.round, hw_tag(args.device),
                             args.targets, args.searches)
    print(section)
    print(json.dumps({"rows": all_rows}))
    print(f"(total {time.time() - t0:.0f}s)", file=sys.stderr)
    if args.out:
        write_section(args.out, section)


if __name__ == "__main__":
    main()
