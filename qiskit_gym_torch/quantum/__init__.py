"""Standalone quantum-info layer (numpy, no qiskit dependency).

Copied from the JAX package: the circuit IR and operator algebra the
synthesis API needs — `Circuit`, `Clifford` (full phase-tracking tableau),
`Pauli`, GF(2) linear-function helpers and a dense `Statevector` simulator
used as the ground-truth oracle in tests.
"""

from .circuit import Circuit, GATES_1Q, GATES_2Q, CLIFFORD_GATES, ROTATION_GATES
from .pauli import Pauli
from .clifford import Clifford
from .linear import (
    linear_from_circuit,
    permutation_pattern,
    linear_from_clifford,
    gf2_inverse,
)
from .statevector import Statevector, circuit_unitary, allclose_up_to_global_phase

__all__ = [
    "Circuit",
    "Clifford",
    "Pauli",
    "Statevector",
    "GATES_1Q",
    "GATES_2Q",
    "CLIFFORD_GATES",
    "ROTATION_GATES",
    "linear_from_circuit",
    "permutation_pattern",
    "linear_from_clifford",
    "gf2_inverse",
    "circuit_unitary",
    "allclose_up_to_global_phase",
]
