"""Batched permutation (SWAP-routing) env in PyTorch.

Port of the JAX package's `ops/permutation.py`: a thin specialization of
MatrixEnvCore (kind='permutation'). The state is the one-hot permutation
matrix M[i, s(i)] = 1, the observation the reference env exposes, and its
inverse is the tracked inverse buffer. `perm_vector` recovers the int
vector form.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from qiskit_gym_torch.utils.device import DeviceLike

from .matrix_env import MatrixEnvCore, MatrixEnvState

# the state type is shared
PermutationEnvState = MatrixEnvState


class PermutationEnvCore(MatrixEnvCore):
    def __init__(
        self,
        num_qubits: int,
        gateset: Sequence,
        depth_slope: int = 2,
        max_depth: int = 128,
        metrics_weights: Optional[dict] = None,
        add_inverts: bool = True,
        scramble_cap: int = 256,
        device: DeviceLike = None,
    ):
        super().__init__(
            num_qubits=num_qubits,
            gateset=gateset,
            kind="permutation",
            depth_slope=depth_slope,
            max_depth=max_depth,
            metrics_weights=metrics_weights,
            add_inverts=add_inverts,
            scramble_cap=scramble_cap,
            device=device,
        )

    def set_state(self, perms: np.ndarray) -> MatrixEnvState:
        """Permutation vectors [B, n] (or [n]) -> one-hot matrix state."""
        perms = np.asarray(perms, dtype=np.int64)
        if perms.ndim == 1:
            perms = perms[None]
        B, n = perms.shape
        dense = np.zeros((B, n, n), dtype=np.int8)
        dense[np.arange(B)[:, None], np.arange(n)[None, :], perms] = 1
        return super().set_state(dense)

    def perm_vector(self, state: MatrixEnvState) -> torch.Tensor:
        """int32 [B, n]: s(i) = argmax_j M[i, j]."""
        return torch.argmax(self.dense(state), dim=2).to(torch.int32)
