"""User-facing synthesis gyms (constructor surface mirrors the reference)."""

from .adapters import (
    GymnasiumEnv,
    VectorGymnasiumEnv,
    gym_adapter,
    vector_gym_adapter,
)
from .synthesis import (
    BaseSynthesisEnv,
    CliffordGym,
    LinearFunctionGym,
    PauliGym,
    PermutationGym,
    SYNTH_ENVS,
    ONE_Q_GATES,
    TWO_Q_GATES,
    decode_pauli_solution,
)

__all__ = [
    "BaseSynthesisEnv",
    "CliffordGym",
    "LinearFunctionGym",
    "PauliGym",
    "PermutationGym",
    "SYNTH_ENVS",
    "ONE_Q_GATES",
    "TWO_Q_GATES",
    "decode_pauli_solution",
    "gym_adapter",
    "GymnasiumEnv",
    "vector_gym_adapter",
    "VectorGymnasiumEnv",
]
