"""Batched env cores on torch tensors and the hand-written kernels they run.

`MatrixEnvCore` / `PermutationEnvCore` step a batch of bitpacked GF(2)
matrix states. On a CUDA state each step is one launch of kernel B1
(module `fused_step`, csrc/fused_step.cu); module `metrics_kernel` is
kernel B2 (csrc/metrics.cu). For CPU tensors every wrapper runs its plain
PyTorch version.
"""

from .matrix_env import MatrixEnvCore, MatrixEnvState
from .permutation import PermutationEnvCore, PermutationEnvState
from .tables import MT_1Q, MT_CX, MT_CZ, MT_SWAP, MetricsTables

__all__ = [
    "MatrixEnvCore",
    "MatrixEnvState",
    "PermutationEnvCore",
    "PermutationEnvState",
    "MetricsTables",
    "MT_1Q",
    "MT_CX",
    "MT_CZ",
    "MT_SWAP",
]
