"""Policy networks (torch.nn) and `.pt` checkpoint interop."""

from .policies import BasicPolicy, Conv1dPolicy, PolicyBundle, make_policy
from .torch_io import (adam_state_from_optax, load_torch_checkpoint,
                       params_from_jax, save_torch_checkpoint)

__all__ = [
    "BasicPolicy",
    "Conv1dPolicy",
    "PolicyBundle",
    "make_policy",
    "adam_state_from_optax",
    "load_torch_checkpoint",
    "params_from_jax",
    "save_torch_checkpoint",
]
