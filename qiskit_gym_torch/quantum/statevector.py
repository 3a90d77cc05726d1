"""Dense statevector simulator — the ground-truth oracle for tests.

Little-endian like qiskit: qubit 0 is the least-significant bit of the basis
index. Intended for small n (tests use n <= 8).
"""

from __future__ import annotations

import numpy as np

from .circuit import Circuit

_SQ = 1 / np.sqrt(2.0)

_H = np.array([[_SQ, _SQ], [_SQ, -_SQ]], dtype=complex)
_S = np.diag([1, 1j]).astype(complex)
_SDG = np.diag([1, -1j]).astype(complex)
_SX = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]], dtype=complex)
_SXDG = _SX.conj().T
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]], dtype=complex)
_Z = np.diag([1, -1]).astype(complex)
_I = np.eye(2, dtype=complex)

_FIXED_1Q = {"h": _H, "s": _S, "sdg": _SDG, "sx": _SX, "sxdg": _SXDG,
             "x": _X, "y": _Y, "z": _Z, "id": _I}
_AXIS = {"rx": _X, "ry": _Y, "rz": _Z}


def _rot(name: str, theta: float) -> np.ndarray:
    a = _AXIS[name]
    return np.cos(theta / 2) * _I - 1j * np.sin(theta / 2) * a


class Statevector:
    def __init__(self, num_qubits: int, data: np.ndarray | None = None):
        self.num_qubits = num_qubits
        if data is None:
            self.data = np.zeros(2**num_qubits, dtype=complex)
            self.data[0] = 1.0
        else:
            self.data = np.asarray(data, dtype=complex).copy()

    def _apply_1q(self, mat: np.ndarray, q: int):
        psi = self.data.reshape(2 ** (self.num_qubits - q - 1), 2, 2**q)
        # middle axis is qubit q (little-endian)
        self.data = np.einsum("ab,ibj->iaj", mat, psi).reshape(-1)

    def _apply_2q(self, mat4: np.ndarray, q1: int, q2: int):
        n = self.num_qubits
        psi = self.data.reshape([2] * n)  # axis k = qubit n-1-k
        a1, a2 = n - 1 - q1, n - 1 - q2
        m = mat4.reshape(2, 2, 2, 2)  # [out1, out2, in1, in2]
        psi = np.moveaxis(psi, (a1, a2), (0, 1))
        psi = np.einsum("abcd,cd...->ab...", m, psi)
        psi = np.moveaxis(psi, (0, 1), (a1, a2))
        self.data = psi.reshape(-1)

    def apply_gate(self, name: str, qubits, params=()):
        name = name.lower()
        if name in _FIXED_1Q:
            self._apply_1q(_FIXED_1Q[name], qubits[0])
        elif name in _AXIS:
            self._apply_1q(_rot(name, params[0]), qubits[0])
        elif name == "cx":
            c, t = qubits
            # |c t> basis with c as first tensor factor of mat4
            m = np.eye(4, dtype=complex)[[0, 1, 3, 2]]  # flip t when c=1
            self._apply_2q(m, c, t)
        elif name == "cz":
            m = np.diag([1, 1, 1, -1]).astype(complex)
            self._apply_2q(m, qubits[0], qubits[1])
        elif name == "swap":
            m = np.eye(4, dtype=complex)[[0, 2, 1, 3]]
            self._apply_2q(m, qubits[0], qubits[1])
        else:
            raise ValueError(f"Unknown gate {name}")
        return self

    def apply_circuit(self, circuit: Circuit):
        for name, qubits, params in circuit:
            self.apply_gate(name, qubits, params)
        return self


def circuit_unitary(circuit: Circuit) -> np.ndarray:
    """Full unitary (2^n x 2^n) by applying the circuit to each basis state."""
    n = circuit.num_qubits
    dim = 2**n
    cols = []
    for b in range(dim):
        sv = Statevector(n)
        sv.data[:] = 0
        sv.data[b] = 1.0
        cols.append(sv.apply_circuit(circuit).data)
    return np.stack(cols, axis=1)


def allclose_up_to_global_phase(u: np.ndarray, v: np.ndarray, atol: float = 1e-8) -> bool:
    u = np.asarray(u)
    v = np.asarray(v)
    if u.shape != v.shape:
        return False
    idx = np.unravel_index(np.argmax(np.abs(u)), u.shape)
    if np.abs(v[idx]) < atol:
        return False
    ph = u[idx] / v[idx]
    if not np.isclose(np.abs(ph), 1.0, atol=1e-6):
        return False
    return np.allclose(u, ph * v, atol=atol)
