"""GF(2) linear functions of CX/SWAP circuits + helpers.

Semantics match the reference env (reference rust/src/envs/linear_function.rs:62-83):
applying CX(c, t) maps the matrix L by row t ^= row c; SWAP swaps rows. For a
circuit built this way from the identity, L maps basis state |v> -> |L v| ...
precisely: the output bit t becomes v_t ^ v_c, i.e. out = L @ v over GF(2).
"""

from __future__ import annotations

import numpy as np

from .circuit import Circuit
from .clifford import Clifford


def linear_from_circuit(circuit: Circuit) -> np.ndarray:
    """n x n GF(2) matrix (uint8) of a CX/SWAP(/X-free) linear circuit."""
    n = circuit.num_qubits
    mat = np.eye(n, dtype=np.uint8)
    for name, qubits, _ in circuit:
        if name == "cx":
            c, t = qubits
            mat[t] ^= mat[c]
        elif name == "swap":
            a, b = qubits
            mat[[a, b]] = mat[[b, a]]
        elif name == "id":
            continue
        else:
            raise ValueError(f"Gate '{name}' is not a linear-function gate")
    return mat


def linear_from_clifford(clifford: Clifford) -> np.ndarray:
    """Extract the GF(2) matrix of a Clifford that is a linear function.

    For a CX/SWAP-only Clifford, the destabilizer X-block transposed equals the
    circuit-built matrix (X_i -> prod X_j^{L[j][i]} under conjugation).
    """
    n = clifford.num_qubits
    destab_x = clifford.tableau[:n, :n]
    destab_z = clifford.tableau[:n, n : 2 * n]
    stab_x = clifford.tableau[n:, :n]
    if destab_z.any() or stab_x.any():
        raise ValueError("Clifford is not a linear function (has Hadamard/phase parts)")
    return destab_x.T.astype(np.uint8)


def permutation_pattern(linear: np.ndarray) -> np.ndarray:
    """Pattern p with linear[i, p[i]] = 1 for a permutation matrix."""
    linear = np.asarray(linear)
    if not (linear.sum(axis=0) == 1).all() or not (linear.sum(axis=1) == 1).all():
        raise ValueError("Matrix is not a permutation")
    return np.argmax(linear, axis=1)


def gf2_inverse(mat: np.ndarray) -> np.ndarray:
    """Gauss–Jordan inverse over GF(2) (uint8 in/out)."""
    mat = np.asarray(mat, dtype=np.uint8) & 1
    n = mat.shape[0]
    work = mat.copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        if not work[col, col]:
            pivots = np.nonzero(work[col + 1 :, col])[0]
            if len(pivots) == 0:
                raise ValueError("Matrix is singular over GF(2)")
            p = col + 1 + pivots[0]
            work[[col, p]] = work[[p, col]]
            inv[[col, p]] = inv[[p, col]]
        rows = np.nonzero(work[:, col])[0]
        rows = rows[rows != col]
        work[rows] ^= work[col]
        inv[rows] ^= inv[col]
    return inv
