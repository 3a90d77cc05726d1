"""Optional qiskit bridge (active only where qiskit is importable).

Port of the JAX package's `quantum/qiskit_interop.py`: converts qiskit
QuantumCircuit / Clifford / PermutationGate / LinearFunction objects to the
port's types and back, so users can hand their qiskit objects straight to
`get_state()`/`synth()` and export results. qiskit itself is imported only
inside these functions.
"""

from __future__ import annotations

import numpy as np

from .circuit import Circuit
from .clifford import Clifford

_SUPPORTED = {"h", "s", "sdg", "sx", "sxdg", "x", "y", "z", "id",
              "cx", "cz", "swap", "rx", "ry", "rz"}


def _require_qiskit():
    try:
        import qiskit  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "qiskit is not installed; pass qiskit_gym_torch.quantum types "
            "(Circuit, Clifford, a permutation pattern or a GF(2) matrix) "
            "instead") from exc


def from_qiskit(obj):
    """qiskit object -> the port's type (Circuit, Clifford, a permutation
    pattern list or an int GF(2) matrix)."""
    _require_qiskit()
    from qiskit import QuantumCircuit
    from qiskit.circuit.library.generalized_gates import (LinearFunction,
                                                          PermutationGate)
    from qiskit.quantum_info import Clifford as QkClifford

    if isinstance(obj, QuantumCircuit):
        qc = Circuit(obj.num_qubits)
        for inst in obj.data:
            name = inst.operation.name.lower()
            qubits = [obj.find_bit(q).index for q in inst.qubits]
            if name not in _SUPPORTED:
                raise ValueError(
                    f"Unsupported gate {name!r} in qiskit circuit")
            qc.append(name, qubits,
                      tuple(float(p) for p in inst.operation.params))
        return qc
    if isinstance(obj, QkClifford):
        return Clifford(np.asarray(obj.tableau, dtype=bool))
    if isinstance(obj, PermutationGate):
        return list(obj.pattern)
    if isinstance(obj, LinearFunction):
        return np.asarray(obj.linear).astype(int)
    raise TypeError(f"Cannot convert {type(obj)} from qiskit")


def to_qiskit(circuit: Circuit):
    """The port's Circuit -> a qiskit QuantumCircuit."""
    _require_qiskit()
    from qiskit import QuantumCircuit

    qc = QuantumCircuit(circuit.num_qubits)
    for name, qubits, params in circuit:
        getattr(qc, name)(*(list(params) + list(qubits)))
    return qc
