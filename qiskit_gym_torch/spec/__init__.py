"""Numpy single-env executable specification (copied from the JAX package).

Mirrors the reference native env semantics for the three matrix families
and the Pauli network; the batched torch cores in `qiskit_gym_torch.ops` are
held against the same semantics.
"""

from .gates import Gate, parse_gateset, gate_arity
from .metrics import MetricsTracker, MetricsWeights
from .symmetry import (
    coupling_automorphisms,
    build_action_perm,
    compute_twists_square,
    compute_twists_clifford,
    compute_qubit_perms,
)
from .permutation import PermutationSpecEnv
from .linear_function import LinearFunctionSpecEnv
from .clifford import CliffordSpecEnv
from .pauli_env import (PauliSpecEnv, PauliNetwork, ROTATION_MARKER,
                        encode_rotation, decode_solution, graph_distances)

SPEC_ENVS = {
    "PermutationEnv": PermutationSpecEnv,
    "LinearFunctionEnv": LinearFunctionSpecEnv,
    "CliffordEnv": CliffordSpecEnv,
    "PauliNetworkEnv": PauliSpecEnv,
}

__all__ = [
    "Gate",
    "parse_gateset",
    "gate_arity",
    "MetricsTracker",
    "MetricsWeights",
    "coupling_automorphisms",
    "build_action_perm",
    "compute_twists_square",
    "compute_twists_clifford",
    "compute_qubit_perms",
    "PermutationSpecEnv",
    "LinearFunctionSpecEnv",
    "CliffordSpecEnv",
    "PauliSpecEnv",
    "PauliNetwork",
    "ROTATION_MARKER",
    "encode_rotation",
    "decode_solution",
    "graph_distances",
    "SPEC_ENVS",
]
