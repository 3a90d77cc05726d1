"""Batched env cores on torch tensors and the hand-written kernels they run.

`MatrixEnvCore` / `PermutationEnvCore` step a batch of GF(2) matrix states,
bitpacked by default or dense int8 with `bitpack=False`. On a bitpacked CUDA
state each step is one launch of kernel B1 (module `fused_step`,
csrc/fused_step.cu); module `metrics_kernel` is kernel B2 (csrc/metrics.cu);
module `rowop_step` is kernel B3 (csrc/rowop_step.cu), the dense row-op step,
a function beside the core. `PauliEnvCore` (module `pauli`) steps the
Clifford + rotation network state, its metrics through kernel B2 and the
rest of the step through module `pauli_step` (csrc/pauli_step.cu), and
observes it through module `pauli_observe` (csrc/pauli_observe.cu). For CPU
tensors every wrapper runs its plain PyTorch version. Module `bitops` holds
the packed bit-matrix primitives (pack, unpack, butterfly bit-transpose,
popcount).
"""

from .bitops import bit_transpose, pack_bits, packed_identity, unpack_bits
from .matrix_env import MatrixEnvCore, MatrixEnvState
from .pauli import PauliEnvCore, PauliEnvState
from .permutation import PermutationEnvCore, PermutationEnvState
from .tables import MT_1Q, MT_CX, MT_CZ, MT_SWAP, MetricsTables

__all__ = [
    "pack_bits",
    "unpack_bits",
    "bit_transpose",
    "packed_identity",
    "MatrixEnvCore",
    "MatrixEnvState",
    "PermutationEnvCore",
    "PermutationEnvState",
    "PauliEnvCore",
    "PauliEnvState",
    "MetricsTables",
    "MT_1Q",
    "MT_CX",
    "MT_CZ",
    "MT_SWAP",
]
