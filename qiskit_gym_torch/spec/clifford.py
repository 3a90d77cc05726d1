"""Clifford synthesis spec env (phase-less symplectic tableau).

State is the 2n x 2n GF(2) matrix M = qiskit_tableau[:, :-1].T; generator row
ops (reference rust/src/envs/clifford.rs:84-133, re-derived from the
left-multiplication of each gate's symplectic matrix):

    H(q):    swap rows q, n+q
    S(q):    row n+q ^= row q          (Sdg identical mod global phase)
    SX(q):   row q   ^= row n+q        (SXdg identical)
    CX(c,t): row t   ^= row c ;  row n+c ^= row n+t
    CZ(a,b): row n+a ^= row b ;  row n+b ^= row a
    SWAP:    swap rows a,b and n+a,n+b
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from qiskit_gym_torch.quantum.linear import gf2_inverse

from .base import BaseSpecEnv
from .gates import Gate
from .symmetry import compute_twists_clifford


class CliffordSpecEnv(BaseSpecEnv):
    def _init_state(self):
        self.mat = np.eye(2 * self.num_qubits, dtype=np.uint8)

    def _apply_gate(self, gate: Gate):
        n = self.num_qubits
        name, qs = gate
        m = self.mat
        if name == "H":
            (q,) = qs
            m[[q, n + q]] = m[[n + q, q]]
        elif name in ("S", "Sdg"):
            (q,) = qs
            m[n + q] ^= m[q]
        elif name in ("SX", "SXdg"):
            (q,) = qs
            m[q] ^= m[n + q]
        elif name == "CX":
            c, t = qs
            m[t] ^= m[c]
            m[n + c] ^= m[n + t]
        elif name == "CZ":
            a, b = qs
            m[n + a] ^= m[b]
            m[n + b] ^= m[a]
        elif name == "SWAP":
            a, b = qs
            m[[a, b]] = m[[b, a]]
            m[[n + a, n + b]] = m[[n + b, n + a]]

    def _invert_state(self):
        self.mat = gf2_inverse(self.mat)

    def solved(self) -> bool:
        dim = 2 * self.num_qubits
        return bool(np.array_equal(self.mat, np.eye(dim, dtype=np.uint8)))

    def obs_shape(self) -> List[int]:
        dim = 2 * self.num_qubits
        return [dim, dim]

    def _dense_obs(self) -> np.ndarray:
        return self.mat.astype(np.int8)

    def get_state(self) -> np.ndarray:
        return self.mat.copy()

    def _set_state_impl(self, state: Sequence[int]):
        dim = 2 * self.num_qubits
        self.mat = (np.asarray(state).reshape(dim, dim) > 0).astype(np.uint8)

    def _compute_twists(self):
        return compute_twists_clifford(self.num_qubits, self.gateset)
