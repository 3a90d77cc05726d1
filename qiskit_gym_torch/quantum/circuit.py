"""Minimal quantum circuit IR.

A circuit is an ordered list of instructions ``(name, qubits, params)``. The
gate vocabulary covers everything the synthesis envs emit (the reference
gateset: H, S, Sdg, SX, SXdg, CX, CZ, SWAP — cf. reference
rust/src/envs/common.rs:19-29) plus the Pauli layer (X, Y, Z) and the
parametric rotations (RX, RY, RZ) needed by the Pauli-network family.

Qubit convention matches qiskit: qubit 0 is the least-significant bit of a
computational basis index (little-endian).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

GATES_1Q = ("h", "s", "sdg", "sx", "sxdg", "x", "y", "z", "id")
GATES_2Q = ("cx", "cz", "swap")
ROTATION_GATES = ("rx", "ry", "rz")
CLIFFORD_GATES = GATES_1Q + GATES_2Q

_INVERSE = {
    "h": "h", "x": "x", "y": "y", "z": "z", "id": "id",
    "s": "sdg", "sdg": "s", "sx": "sxdg", "sxdg": "sx",
    "cx": "cx", "cz": "cz", "swap": "swap",
    "rx": "rx", "ry": "ry", "rz": "rz",  # angle negated separately
}

_ARITY = {}
for _g in GATES_1Q + ROTATION_GATES:
    _ARITY[_g] = 1
for _g in GATES_2Q:
    _ARITY[_g] = 2


class Instruction(Tuple):
    """(name, qubits, params) — plain tuple subclass for ergonomic access."""

    __slots__ = ()

    def __new__(cls, name: str, qubits: Tuple[int, ...], params: Tuple[float, ...] = ()):
        return super().__new__(cls, (name, qubits, params))

    @property
    def name(self) -> str:
        return self[0]

    @property
    def qubits(self) -> Tuple[int, ...]:
        return self[1]

    @property
    def params(self) -> Tuple[float, ...]:
        return self[2]


class Circuit:
    """An ordered gate list on ``num_qubits`` qubits."""

    def __init__(self, num_qubits: int):
        if num_qubits < 0:
            raise ValueError("num_qubits must be >= 0")
        self.num_qubits = int(num_qubits)
        self.data: List[Instruction] = []

    # ---------------------------------------------------------------- append
    def append(self, name: str, qubits: Sequence[int], params: Sequence[float] = ()):
        name = name.lower()
        if name not in _ARITY:
            raise ValueError(f"Unknown gate '{name}'")
        qubits = tuple(int(q) for q in qubits)
        if len(qubits) != _ARITY[name]:
            raise ValueError(f"Gate '{name}' expects {_ARITY[name]} qubits, got {qubits}")
        for q in qubits:
            if not (0 <= q < self.num_qubits):
                raise ValueError(f"Qubit {q} out of range for {self.num_qubits}-qubit circuit")
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"Duplicate qubits in {name}{qubits}")
        self.data.append(Instruction(name, qubits, tuple(float(p) for p in params)))
        return self

    # one method per gate, mirroring the reference user surface
    def h(self, q): return self.append("h", (q,))
    def s(self, q): return self.append("s", (q,))
    def sdg(self, q): return self.append("sdg", (q,))
    def sx(self, q): return self.append("sx", (q,))
    def sxdg(self, q): return self.append("sxdg", (q,))
    def x(self, q): return self.append("x", (q,))
    def y(self, q): return self.append("y", (q,))
    def z(self, q): return self.append("z", (q,))
    def id(self, q): return self.append("id", (q,))
    def cx(self, c, t): return self.append("cx", (c, t))
    def cz(self, a, b): return self.append("cz", (a, b))
    def swap(self, a, b): return self.append("swap", (a, b))
    def rx(self, theta, q): return self.append("rx", (q,), (theta,))
    def ry(self, theta, q): return self.append("ry", (q,), (theta,))
    def rz(self, theta, q): return self.append("rz", (q,), (theta,))

    # ------------------------------------------------------------- transforms
    def inverse(self) -> "Circuit":
        out = Circuit(self.num_qubits)
        for name, qubits, params in reversed(self.data):
            inv = _INVERSE[name]
            if name in ROTATION_GATES:
                out.append(inv, qubits, tuple(-p for p in params))
            else:
                out.append(inv, qubits, params)
        return out

    def compose(self, other: "Circuit") -> "Circuit":
        """Return a new circuit: self followed by other."""
        if other.num_qubits > self.num_qubits:
            raise ValueError("Cannot compose a wider circuit onto a narrower one")
        out = self.copy()
        out.data.extend(other.data)
        return out

    def copy(self) -> "Circuit":
        out = Circuit(self.num_qubits)
        out.data = list(self.data)
        return out

    def copy_empty(self) -> "Circuit":
        return Circuit(self.num_qubits)

    # -------------------------------------------------------------- analysis
    def count_ops(self) -> dict:
        counts: dict = {}
        for name, _, _ in self.data:
            counts[name] = counts.get(name, 0) + 1
        return counts

    def num_2q_gates(self) -> int:
        return sum(1 for name, _, _ in self.data if name in GATES_2Q)

    def depth(self) -> int:
        level = [0] * max(self.num_qubits, 1)
        d = 0
        for _, qubits, _ in self.data:
            l = max(level[q] for q in qubits) + 1
            for q in qubits:
                level[q] = l
            d = max(d, l)
        return d

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self):
        return iter(self.data)

    def __repr__(self) -> str:
        body = "; ".join(
            f"{name}{'(' + ','.join(f'{p:g}' for p in params) + ')' if params else ''} {list(qubits)}"
            for name, qubits, params in self.data
        )
        return f"Circuit({self.num_qubits}q: {body})"

    # ---------------------------------------------------------- construction
    @classmethod
    def from_gate_list(
        cls, gate_list: Iterable[Tuple[str, Sequence[int]]], num_qubits: int | None = None
    ) -> "Circuit":
        """Build from [(NAME, (qubits...)), ...] as stored in env gatesets."""
        gate_list = list(gate_list)
        if num_qubits is None:
            num_qubits = max(max(qs) for _, qs in gate_list) + 1
        qc = cls(num_qubits)
        for name, qubits in gate_list:
            qc.append(name, qubits)
        return qc
