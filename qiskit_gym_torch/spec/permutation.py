"""Permutation (SWAP-routing) spec env.

State is a permutation vector; SWAP(q1, q2) exchanges the two entries
(reference rust/src/envs/permutation.rs:29-257). Observation is the one-hot
n x n permutation matrix with row i set at column state[i].
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .base import BaseSpecEnv
from .gates import Gate
from .symmetry import compute_twists_square


class PermutationSpecEnv(BaseSpecEnv):
    def _init_state(self):
        self.state = np.arange(self.num_qubits, dtype=np.int64)

    def _apply_gate(self, gate: Gate):
        name, (q1, q2) = gate[0], gate[1]
        if name == "SWAP":
            self.state[[q1, q2]] = self.state[[q2, q1]]

    def _apply_scramble_gate(self, gate: Gate):
        # Only SWAP moves the permutation; other gates are no-ops even in reset.
        self._apply_gate(gate)

    def _invert_state(self):
        inv = np.empty_like(self.state)
        inv[self.state] = np.arange(self.num_qubits)
        self.state = inv

    def solved(self) -> bool:
        return bool((self.state == np.arange(self.num_qubits)).all())

    def obs_shape(self) -> List[int]:
        n = self.num_qubits
        return [n, n]

    def _dense_obs(self) -> np.ndarray:
        n = self.num_qubits
        obs = np.zeros((n, n), dtype=np.int8)
        obs[np.arange(n), self.state] = 1
        return obs

    def get_state(self) -> np.ndarray:
        return self.state.copy()

    def _set_state_impl(self, state: Sequence[int]):
        arr = np.asarray(state, dtype=np.int64)
        if arr.shape != (self.num_qubits,):
            raise ValueError(f"Expected permutation of length {self.num_qubits}")
        self.state = arr.copy()

    def _compute_twists(self):
        return compute_twists_square(self.num_qubits, self.gateset)
