"""Phase-tracking Clifford tableau (Aaronson–Gottesman style).

Layout matches qiskit's `Clifford.tableau` so the env state encodings used by
the reference Python bridge (reference src/qiskit_gym/envs/synthesis.py:206-209,
254-258, 452) carry over verbatim:

    tableau: bool[2n, 2n+1]
      rows    0..n-1   destabilizers (images of X_i under conjugation)
      rows    n..2n-1  stabilizers   (images of Z_i)
      columns 0..n-1   X bits, n..2n-1 Z bits, 2n phase bit

Row r with bits (x, z, s) represents the Pauli (-1)^s * canonical(x, z) where
canonical(x, z) is the Hermitian Pauli string with Ys where x&z.

Appending a gate g to the circuit updates every row P -> g P gdg using the
standard update rules; `to_circuit` synthesizes a circuit via pairwise
(destabilizer, stabilizer) reduction, and `adjoint`/`compose` are
circuit-mediated (exact, O(n^3) — construction/solve-time only, never in the
TPU hot path).
"""

from __future__ import annotations

import numpy as np

from .circuit import Circuit
from .pauli import Pauli


class Clifford:
    __slots__ = ("tableau", "num_qubits")

    def __init__(self, data):
        if isinstance(data, Clifford):
            self.tableau = data.tableau.copy()
            self.num_qubits = data.num_qubits
            return
        if isinstance(data, Circuit):
            cf = Clifford.identity(data.num_qubits)
            cf.append_circuit(data)
            self.tableau = cf.tableau
            self.num_qubits = cf.num_qubits
            return
        arr = np.asarray(data, dtype=bool)
        if arr.ndim != 2 or arr.shape[0] % 2 != 0:
            raise ValueError(f"Bad tableau shape {arr.shape}")
        n = arr.shape[0] // 2
        if arr.shape[1] == 2 * n:  # phase column omitted -> zero phases
            arr = np.concatenate([arr, np.zeros((2 * n, 1), bool)], axis=1)
        if arr.shape[1] != 2 * n + 1:
            raise ValueError(f"Bad tableau shape {arr.shape}")
        self.tableau = arr.copy()
        self.num_qubits = n

    # ------------------------------------------------------------ properties
    @classmethod
    def identity(cls, n: int) -> "Clifford":
        t = np.zeros((2 * n, 2 * n + 1), dtype=bool)
        t[:, :-1] = np.eye(2 * n, dtype=bool)
        return cls(t)

    @property
    def x(self) -> np.ndarray:
        return self.tableau[:, : self.num_qubits]

    @property
    def z(self) -> np.ndarray:
        return self.tableau[:, self.num_qubits : 2 * self.num_qubits]

    @property
    def phase(self) -> np.ndarray:
        return self.tableau[:, -1]

    @property
    def destab_phase(self) -> np.ndarray:
        return self.tableau[: self.num_qubits, -1]

    @property
    def stab_phase(self) -> np.ndarray:
        return self.tableau[self.num_qubits :, -1]

    def symplectic(self) -> np.ndarray:
        """The phase-less 2n x 2n part."""
        return self.tableau[:, :-1].copy()

    def row_pauli(self, r: int) -> Pauli:
        x = self.x[r].copy()
        z = self.z[r].copy()
        num_y = int(np.count_nonzero(x & z))
        return Pauli(x, z, (2 * int(self.phase[r]) + num_y) % 4)

    def copy(self) -> "Clifford":
        return Clifford(self)

    def __eq__(self, other) -> bool:
        return isinstance(other, Clifford) and np.array_equal(self.tableau, other.tableau)

    def __repr__(self):
        return f"Clifford(num_qubits={self.num_qubits})"

    def is_identity(self) -> bool:
        return bool(
            np.array_equal(self.tableau[:, :-1], np.eye(2 * self.num_qubits, dtype=bool))
            and not self.phase.any()
        )

    # ---------------------------------------------------------- gate appends
    # Standard tableau update rules (each row conjugated by the gate).
    def _h(self, q: int):
        n = self.num_qubits
        x, z, p = self.tableau[:, q], self.tableau[:, n + q], self.tableau[:, -1]
        p ^= x & z
        self.tableau[:, q], self.tableau[:, n + q] = z.copy(), x.copy()

    def _s(self, q: int):
        n = self.num_qubits
        x, z, p = self.tableau[:, q], self.tableau[:, n + q], self.tableau[:, -1]
        p ^= x & z
        z ^= x

    def _sdg(self, q: int):
        n = self.num_qubits
        x, z, p = self.tableau[:, q], self.tableau[:, n + q], self.tableau[:, -1]
        p ^= x & ~z
        z ^= x

    def _sx(self, q: int):
        n = self.num_qubits
        x, z, p = self.tableau[:, q], self.tableau[:, n + q], self.tableau[:, -1]
        p ^= ~x & z
        x ^= z

    def _sxdg(self, q: int):
        n = self.num_qubits
        x, z, p = self.tableau[:, q], self.tableau[:, n + q], self.tableau[:, -1]
        p ^= x & z
        x ^= z

    def _cx(self, c: int, t: int):
        n = self.num_qubits
        xc, zc = self.tableau[:, c], self.tableau[:, n + c]
        xt, zt = self.tableau[:, t], self.tableau[:, n + t]
        self.tableau[:, -1] ^= xc & zt & ~(xt ^ zc)
        xt ^= xc
        zc ^= zt

    def _cz(self, a: int, b: int):
        self._h(b)
        self._cx(a, b)
        self._h(b)

    def _swap(self, a: int, b: int):
        self._cx(a, b)
        self._cx(b, a)
        self._cx(a, b)

    def _x(self, q: int):
        self.tableau[:, -1] ^= self.tableau[:, self.num_qubits + q]

    def _z(self, q: int):
        self.tableau[:, -1] ^= self.tableau[:, q]

    def _y(self, q: int):
        self._x(q)
        self._z(q)

    def _id(self, q: int):
        pass

    def append_gate(self, name: str, qubits) -> "Clifford":
        getattr(self, f"_{name.lower()}")(*qubits)
        return self

    def append_circuit(self, circuit: Circuit) -> "Clifford":
        for name, qubits, _ in circuit:
            self.append_gate(name, qubits)
        return self

    # ----------------------------------------------------------- composition
    def compose(self, other) -> "Clifford":
        """Return other AFTER self (qiskit convention: self.compose(other))."""
        out = self.copy()
        if isinstance(other, Circuit):
            out.append_circuit(other)
        else:
            out.append_circuit(Clifford(other).to_circuit())
        return out

    def adjoint(self) -> "Clifford":
        cf = Clifford.identity(self.num_qubits)
        cf.append_circuit(self.to_circuit().inverse())
        return cf

    def evolve_pauli(self, pauli: Pauli) -> Pauli:
        """Image C P Cdg from the tableau rows (no circuit synthesis)."""
        n = self.num_qubits
        out = Pauli.identity(n)
        out.phase = pauli.phase
        # P = (-i)^p (prod_i Z_i^{z_i}) (prod_i X_i^{x_i}); images multiply in
        # the same order. Z_i image = stabilizer row n+i; X_i image = destab row i.
        for i in range(n):
            if pauli.z[i]:
                out = out.compose(self.row_pauli(n + i))
        for i in range(n):
            if pauli.x[i]:
                out = out.compose(self.row_pauli(i))
        # base Z^z X^x of the input contributes no extra reordering phase:
        # it was already accounted for in `pauli.phase`.
        return out

    # ------------------------------------------------------------- synthesis
    def to_circuit(self) -> Circuit:
        """Aaronson–Gottesman-style synthesis.

        Reduces a working copy to the identity by appending gates; per qubit i
        the destabilizer row is reduced to X_i, then (through an H(i) frame
        flip) the stabilizer row to Z_i; a final X/Z layer clears phases. The
        inverted reversed gate list is the circuit for self.
        """
        work = self.copy()
        n = self.num_qubits
        gates: list = []

        def emit(name, *qubits):
            work.append_gate(name, qubits)
            gates.append((name, qubits))

        def reduce_row_to_xi(r: int, i: int):
            # Make row r equal X_i using gates on qubits >= i.
            xr = lambda j: bool(work.x[r, j])
            zr = lambda j: bool(work.z[r, j])
            if not any(xr(j) for j in range(i, n)):
                j = next(j for j in range(i, n) if zr(j))
                emit("h", j)
            if not xr(i):
                j = next(j for j in range(i + 1, n) if xr(j))
                emit("swap", i, j)
            for j in range(i + 1, n):
                if xr(j):
                    emit("cx", i, j)
            if zr(i):
                emit("s", i)
            for j in range(i + 1, n):
                if zr(j):
                    emit("cz", i, j)

        for i in range(n):
            reduce_row_to_xi(i, i)       # destabilizer row i -> X_i
            emit("h", i)                 # frame flip: X_i <-> Z_i
            reduce_row_to_xi(n + i, i)   # stabilizer row i -> X_i (in flipped frame)
            emit("h", i)                 # flip back: destab X_i, stab Z_i

        for i in range(n):
            if work.destab_phase[i]:
                emit("z", i)
            if work.stab_phase[i]:
                emit("x", i)

        assert work.is_identity(), "Clifford synthesis failed to reach identity"

        inv_name = {"h": "h", "s": "sdg", "cx": "cx", "cz": "cz", "swap": "swap",
                    "x": "x", "z": "z"}
        qc = Circuit(n)
        for name, qubits in reversed(gates):
            qc.append(inv_name[name], qubits)
        return qc
