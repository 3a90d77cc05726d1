"""Pauli operators in symplectic (x, z, phase) representation.

Conventions (chosen to be interoperable with the reference encodings —
reference rust/src/pauli/pauli.rs:39-133 and qiskit's Pauli):

    P = (-i)^phase * prod_q Z_q^{z[q]} X_q^{x[q]}

- ``x``/``z`` are boolean numpy arrays indexed by qubit (qubit 0 = rightmost
  character of a label, little-endian).
- ``phase`` is the exponent of (-i) modulo 4 of the *base* Z^z X^x product;
  a Y on one qubit contributes Y = -i Z X, i.e. +1 to ``phase``.
- The *label* coefficient exponent (what "+", "-i", "-", "i" encode) is
  ``(phase - count_y) % 4`` since each Y absorbs one factor of (-i).
"""

from __future__ import annotations

import re

import numpy as np

_LABEL_RE = re.compile(r"^(?P<coeff>[+-]?[ij1]?)(?P<pauli>[IXYZ]*)$")
_COEFF_TO_PHASE = {"": 0, "-i": 1, "-": 2, "i": 3}
_PHASE_TO_COEFF = {0: "", 1: "-i", 2: "-", 3: "i"}


class Pauli:
    __slots__ = ("x", "z", "phase")

    def __init__(self, x, z, phase: int = 0):
        self.x = np.asarray(x, dtype=bool).copy()
        self.z = np.asarray(z, dtype=bool).copy()
        if self.x.shape != self.z.shape or self.x.ndim != 1:
            raise ValueError("x and z must be 1-D arrays of equal length")
        self.phase = int(phase) % 4

    # ------------------------------------------------------------ label i/o
    @classmethod
    def from_label(cls, label: str) -> "Pauli":
        m = _LABEL_RE.match(label)
        if m is None:
            raise ValueError(f"Invalid Pauli label: {label!r}")
        coeff = m.group("coeff").replace("1", "").replace("+", "").replace("j", "i")
        if coeff not in _COEFF_TO_PHASE:
            raise ValueError(f"Invalid Pauli coefficient in label: {label!r}")
        phase = _COEFF_TO_PHASE[coeff]
        chars = m.group("pauli")[::-1]  # little-endian: qubit 0 = last char
        x = np.array([c in "XY" for c in chars], dtype=bool)
        z = np.array([c in "ZY" for c in chars], dtype=bool)
        num_y = int(np.count_nonzero(x & z))
        return cls(x, z, (phase + num_y) % 4)

    @classmethod
    def identity(cls, n: int) -> "Pauli":
        return cls(np.zeros(n, bool), np.zeros(n, bool), 0)

    @classmethod
    def single(cls, n: int, qubit: int, axis: str, phase: int = 0) -> "Pauli":
        """A single-qubit X/Y/Z on `qubit`; `phase` is the label coefficient exponent."""
        x = np.zeros(n, bool)
        z = np.zeros(n, bool)
        axis = axis.upper()
        if axis in ("X", "Y"):
            x[qubit] = True
        if axis in ("Z", "Y"):
            z[qubit] = True
        return cls(x, z, (phase + (axis == "Y")) % 4)

    @property
    def num_qubits(self) -> int:
        return len(self.x)

    def num_y(self) -> int:
        return int(np.count_nonzero(self.x & self.z))

    def coeff_phase(self) -> int:
        """Label coefficient as an exponent of (-i), in {0,1,2,3}."""
        return (self.phase - self.num_y()) % 4

    def to_label(self) -> str:
        chars = []
        for q in range(self.num_qubits - 1, -1, -1):
            xq, zq = self.x[q], self.z[q]
            chars.append("Y" if (xq and zq) else "X" if xq else "Z" if zq else "I")
        return _PHASE_TO_COEFF[self.coeff_phase()] + "".join(chars)

    # ------------------------------------------------------------- algebra
    def adjoint(self) -> "Pauli":
        """Dagger: conjugates the coefficient (i <-> -i); base is Hermitian-per-factor.

        (Z^z X^x)^dagger = X^x Z^z = (-1)^{x.z} Z^z X^x, so the base-phase maps
        p -> (-p + 2*(x.z)) mod 4... derived directly: P^dag has coefficient
        conj((-i)^c) = (-i)^{-c} on the same Hermitian Pauli string.
        """
        c = self.coeff_phase()
        return Pauli(self.x, self.z, ((-c) % 4 + self.num_y()) % 4)

    def compose(self, other: "Pauli") -> "Pauli":
        """Product self * other (operator product, self applied after)."""
        if self.num_qubits != other.num_qubits:
            raise ValueError("Pauli size mismatch")
        # (-i)^p1 Z^z1 X^x1 (-i)^p2 Z^z2 X^x2 : move X^x1 across Z^z2 -> (-1)^{x1.z2}
        extra = 2 * int(np.count_nonzero(self.x & other.z))
        return Pauli(
            self.x ^ other.x,
            self.z ^ other.z,
            (self.phase + other.phase + extra) % 4,
        )

    def commutes_with(self, other: "Pauli") -> bool:
        return int(np.count_nonzero(self.x & other.z)) % 2 == int(
            np.count_nonzero(self.z & other.x)
        ) % 2

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Pauli)
            and np.array_equal(self.x, other.x)
            and np.array_equal(self.z, other.z)
            and self.phase == other.phase
        )

    def __hash__(self):
        return hash((self.x.tobytes(), self.z.tobytes(), self.phase))

    def __repr__(self):
        return f"Pauli({self.to_label()!r})"

    def copy(self) -> "Pauli":
        return Pauli(self.x, self.z, self.phase)

    # --------------------------------------------------- Clifford conjugation
    # In-place updates P -> G P Gdg for each generator gate. Phase bookkeeping
    # derived from the base representation (cf. reference pauli.rs:83-110,
    # which these match bit-for-bit).
    def evolve_h(self, q: int):
        xq, zq = self.x[q], self.z[q]
        self.x[q], self.z[q] = zq, xq
        self.phase = (self.phase + 2 * int(xq and zq)) % 4

    def evolve_s(self, q: int):
        xq = self.x[q]
        self.z[q] ^= xq
        self.phase = (self.phase + int(xq)) % 4

    def evolve_sdg(self, q: int):
        self.evolve_s(q)
        self.evolve_s(q)
        self.evolve_s(q)

    def evolve_sx(self, q: int):
        self.evolve_h(q)
        self.evolve_s(q)
        self.evolve_h(q)

    def evolve_sxdg(self, q: int):
        self.evolve_sx(q)
        self.evolve_sx(q)
        self.evolve_sx(q)

    def evolve_cx(self, ctrl: int, trgt: int):
        self.x[trgt] ^= self.x[ctrl]
        self.z[ctrl] ^= self.z[trgt]

    def evolve_cz(self, a: int, b: int):
        self.evolve_h(b)
        self.evolve_cx(a, b)
        self.evolve_h(b)

    def evolve_swap(self, a: int, b: int):
        self.evolve_cx(a, b)
        self.evolve_cx(b, a)
        self.evolve_cx(a, b)

    def evolve_x(self, q: int):
        # X P X: flips sign iff P anticommutes with X_q, i.e. z[q]
        self.phase = (self.phase + 2 * int(self.z[q])) % 4

    def evolve_z(self, q: int):
        self.phase = (self.phase + 2 * int(self.x[q])) % 4

    def evolve_y(self, q: int):
        self.phase = (self.phase + 2 * int(self.x[q] ^ self.z[q])) % 4

    def evolve_gate(self, name: str, qubits) -> "Pauli":
        getattr(self, f"evolve_{name.lower()}")(*qubits)
        return self

    def evolve_circuit(self, circuit) -> "Pauli":
        """P -> U P Udg for the whole circuit (gates applied in order)."""
        for name, qubits, _params in circuit:
            if name == "id":
                continue
            self.evolve_gate(name, qubits)
        return self
