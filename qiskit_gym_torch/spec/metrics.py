"""Incremental circuit-cost metrics (reward shaping).

Semantics match the reference tracker (reference rust/src/envs/metrics.rs:19-184):
per-qubit ASAP layering with gate decompositions SWAP -> 3xCX and
CZ -> 1q + CX + 1q for costing purposes.

Layer-set representation note: the reference stores the set of occupied layer
indices in HashSets; because every insert is `max(involved last-layers) + 1`
and last-layers start at -1, the occupied set is always dense {0..max}, so
|layers| == max(last_gates) + 1 (and likewise for CNOT layers). This closed
form is what the TPU kernels use; `tests/test_spec_envs.py` proves the
equivalence against a literal set-based tracker on random gate sequences.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .gates import Gate


@dataclass
class MetricsWeights:
    n_cnots: float = 0.01
    n_layers_cnots: float = 0.0
    n_layers: float = 0.0
    n_gates: float = 0.0001

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, float]]) -> "MetricsWeights":
        w = cls()
        if d:
            for k, v in d.items():
                if hasattr(w, k):
                    setattr(w, k, float(v))
        return w

    def as_array(self) -> np.ndarray:
        return np.array(
            [self.n_cnots, self.n_layers_cnots, self.n_layers, self.n_gates],
            dtype=np.float32,
        )


class MetricsTracker:
    """Tracks (n_cnots, n_layers_cnots, n_layers, n_gates) incrementally."""

    def __init__(self, num_qubits: int):
        self.num_qubits = num_qubits
        self.reset()

    def reset(self):
        self.n_cnots = 0
        self.n_gates = 0
        self.last_gates = np.full(self.num_qubits, -1, dtype=np.int64)
        self.last_cxs = np.full(self.num_qubits, -1, dtype=np.int64)

    @property
    def n_layers(self) -> int:
        return int(self.last_gates.max()) + 1 if self.num_qubits else 0

    @property
    def n_layers_cnots(self) -> int:
        return int(self.last_cxs.max()) + 1 if self.num_qubits else 0

    def snapshot(self) -> np.ndarray:
        return np.array(
            [self.n_cnots, self.n_layers_cnots, self.n_layers, self.n_gates],
            dtype=np.int64,
        )

    def _single(self, q: int):
        if q >= self.num_qubits:
            return
        self.n_gates += 1
        self.last_gates[q] += 1

    def _cx(self, c: int, t: int):
        if c == t or c >= self.num_qubits or t >= self.num_qubits:
            return
        self.n_cnots += 1
        self.n_gates += 1
        layer = max(self.last_gates[c], self.last_gates[t]) + 1
        self.last_gates[c] = self.last_gates[t] = layer
        cx_layer = max(self.last_cxs[c], self.last_cxs[t]) + 1
        self.last_cxs[c] = self.last_cxs[t] = cx_layer

    def apply_gate(self, gate: Gate):
        name, qs = gate
        if name == "CX":
            self._cx(qs[0], qs[1])
        elif name == "SWAP":
            self._cx(qs[0], qs[1])
            self._cx(qs[1], qs[0])
            self._cx(qs[0], qs[1])
        elif name == "CZ":
            self._single(qs[1])
            self._cx(qs[0], qs[1])
            self._single(qs[1])
        else:
            self._single(qs[0])

    def penalty(self, previous: np.ndarray, weights: MetricsWeights) -> float:
        """Weighted saturating delta vs a previous snapshot."""
        delta = np.maximum(self.snapshot() - previous, 0).astype(np.float32)
        return float((weights.as_array() * delta).sum())
