"""Static per-action metrics tables compiled from a gateset at env build.

`MetricsTables` holds the per-action circuit-cost descriptors used by the
closed-form metrics update (see spec/metrics.py for the dense-layers proof);
gate-application tables live in ops/matrix_env.py (full GF(2) gate matrices
+ the rank-2 decomposition used by the Pallas kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from qiskit_gym_torch.spec.gates import Gate

# action type codes for metrics
MT_1Q, MT_CX, MT_CZ, MT_SWAP = 0, 1, 2, 3


@dataclass(frozen=True)
class MetricsTables:
    """Per-action metrics descriptors: type code + the two qubits."""

    mtype: np.ndarray  # int32 [A]
    q1: np.ndarray     # int32 [A]
    q2: np.ndarray     # int32 [A]  (== q1 for 1q gates)

    @classmethod
    def build(cls, gateset: Sequence[Gate]) -> "MetricsTables":
        mtype, q1, q2 = [], [], []
        for name, qs in gateset:
            if name == "CX":
                mtype.append(MT_CX); q1.append(qs[0]); q2.append(qs[1])
            elif name == "CZ":
                mtype.append(MT_CZ); q1.append(qs[0]); q2.append(qs[1])
            elif name == "SWAP":
                mtype.append(MT_SWAP); q1.append(qs[0]); q2.append(qs[1])
            else:
                mtype.append(MT_1Q); q1.append(qs[0]); q2.append(qs[0])
        return cls(
            np.asarray(mtype, np.int32),
            np.asarray(q1, np.int32),
            np.asarray(q2, np.int32),
        )


def build_permutation_tables(gateset: Sequence[Gate], num_qubits: int) -> np.ndarray:
    """tau[a] = transposition permutation of action a (identity for non-SWAP)."""
    A = len(gateset)
    tau = np.tile(np.arange(num_qubits, dtype=np.int32), (A, 1))
    for a, (name, qs) in enumerate(gateset):
        if name == "SWAP":
            q1, q2 = qs
            tau[a, [q1, q2]] = tau[a, [q2, q1]]
    return tau
