"""The general traffic generator of the synthesis mixes: random in-gateset
circuits, drawn from the numbers of a traffic file.

The pool of targets is drawn once from the traffic file's `pool_seed`, so
every run's seed sees the same work; `--seed` only orders it (each pass
over the pool in a fresh permutation) and picks the calls whose lanes the
reference reads.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Gate = Tuple[str, Tuple[int, ...], Tuple[float, ...]]


def random_target(rng: np.random.Generator, gateset, n: int, depth: int,
                  rotations: int) -> List[Gate]:
    """`depth` gates of the gateset, uniformly, with `rotations` rx/ry/rz
    rotations of angles in [0.1, 3.0) placed after distinct gates."""
    after = set(rng.choice(depth, size=min(rotations, depth),
                           replace=False).tolist())
    gates: List[Gate] = []
    for i in range(depth):
        name, qs = gateset[int(rng.integers(len(gateset)))]
        gates.append((name.lower(), tuple(int(q) for q in qs), ()))
        if i in after:
            gates.append((("rx", "ry", "rz")[int(rng.integers(3))],
                          (int(rng.integers(n)),),
                          (float(rng.uniform(0.1, 3.0)),)))
    return gates


def pool(gateset: Sequence, n: int, traffic: dict, size: int = None
         ) -> List[List[Gate]]:
    """The traffic's pool of targets, plus one more at its end for the
    warm-up call."""
    rng = np.random.default_rng(int(traffic["pool_seed"]))
    size = int(traffic["pool"]) if size is None else size
    return [random_target(rng, gateset, n, int(traffic["depth"]),
                          int(traffic.get("rotations", 0)))
            for _ in range(size + 1)]


def order(seed: int, size: int, passes: int) -> List[int]:
    """Pool indices for `passes` passes, each a permutation drawn from
    `seed`."""
    rng = np.random.default_rng(seed)
    return [int(k) for _ in range(passes) for k in rng.permutation(size)]
