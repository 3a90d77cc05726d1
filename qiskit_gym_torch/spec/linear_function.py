"""Linear-function (CNOT-network) spec env.

State is an n x n GF(2) matrix; CX(q1, q2) does row q2 ^= row q1, SWAP swaps
rows (reference rust/src/envs/linear_function.rs:29-364). Solved == identity.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from qiskit_gym_torch.quantum.linear import gf2_inverse

from .base import BaseSpecEnv
from .gates import Gate
from .symmetry import compute_twists_square


class LinearFunctionSpecEnv(BaseSpecEnv):
    def _init_state(self):
        self.mat = np.eye(self.num_qubits, dtype=np.uint8)

    def _apply_gate(self, gate: Gate):
        name, qs = gate
        if name == "CX":
            q1, q2 = qs
            self.mat[q2] ^= self.mat[q1]
        elif name == "SWAP":
            q1, q2 = qs
            self.mat[[q1, q2]] = self.mat[[q2, q1]]
        # 1q gates are no-ops on a linear function

    def _invert_state(self):
        self.mat = gf2_inverse(self.mat)

    def solved(self) -> bool:
        return bool(np.array_equal(self.mat, np.eye(self.num_qubits, dtype=np.uint8)))

    def obs_shape(self) -> List[int]:
        n = self.num_qubits
        return [n, n]

    def _dense_obs(self) -> np.ndarray:
        return self.mat.astype(np.int8)

    def get_state(self) -> np.ndarray:
        return self.mat.copy()

    def _set_state_impl(self, state: Sequence[int]):
        arr = (np.asarray(state).reshape(self.num_qubits, self.num_qubits) > 0)
        self.mat = arr.astype(np.uint8)

    def _compute_twists(self):
        return compute_twists_square(self.num_qubits, self.gateset)
