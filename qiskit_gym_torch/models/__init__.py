"""Policy networks (torch.nn), `.pt` checkpoint interop and the action-head
graft between gatesets."""

from .policies import BasicPolicy, Conv1dPolicy, PolicyBundle, make_policy
from .torch_io import (adam_state_from_optax, load_torch_checkpoint,
                       params_from_jax, params_to_jax,
                       save_torch_checkpoint)
from .transfer import graft_action_head

__all__ = [
    "BasicPolicy",
    "Conv1dPolicy",
    "PolicyBundle",
    "make_policy",
    "adam_state_from_optax",
    "graft_action_head",
    "load_torch_checkpoint",
    "params_from_jax",
    "params_to_jax",
    "save_torch_checkpoint",
]
