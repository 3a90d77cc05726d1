"""Checkpoint serialization: the `.pt` state-dict format.

`.pt` is the format the reference ships and the JAX package reads and
writes. The JAX package's other two formats (flax msgpack and orbax
directories) are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from qiskit_gym_torch.models.torch_io import (load_torch_checkpoint,
                                              save_torch_checkpoint)


def _not_ported(path: str):
    return NotImplementedError(
        f"{path!r}: only .pt checkpoints are supported so far; the msgpack "
        "and orbax formats are still to be ported (ROADMAP A11)")


def save_params(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    if not path.endswith(".pt"):
        raise _not_ported(path)
    save_torch_checkpoint(state_dict, path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    if not path.endswith(".pt"):
        raise _not_ported(path)
    return load_torch_checkpoint(path)
