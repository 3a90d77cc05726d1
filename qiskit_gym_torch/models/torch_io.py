"""`.pt` state-dict load/save, and carrying flax weights across.

The reference persists policies as flat torch state dicts with keys
`embeddings.{weight,bias}`, `common.{i}.*`, `action.{i}.*`, `value.{i}.*`
(examples/models/*.pt), which are exactly `BasicPolicy`'s own names here;
`Conv1dPolicy` adds `conv.{weight,bias}`.

`params_from_jax` is the inverse of the JAX package's checkpoint import
(`models/torch_io.py:load_torch_checkpoint` there): it maps a flax
param tree (numpy arrays, Dense kernels [in, out]) to a state dict (Linear
weights [out, in]; a Conv kernel [k, in, out] to a Conv1d weight
[out, in, k]). `adam_state_from_optax` carries optax Adam's moments
across the same way. Both take plain nested dicts of numpy arrays and import
nothing of JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pt` state dict, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_torch_checkpoint(state_dict: Dict[str, torch.Tensor],
                          path: str) -> None:
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def _torch_key(name: str, n_policy: int, n_value: int) -> str:
    """flax layer name -> torch module path."""
    if name in ("embeddings", "conv"):
        return name
    if name.startswith("common_"):
        return f"common.{name.split('_')[1]}"
    if name.startswith("policy_"):
        return f"action.{name.split('_')[1]}"
    if name == "action_out":
        return f"action.{n_policy}"
    if name == "value_out":
        return f"value.{n_value}"
    if name.startswith("value_"):
        return f"value.{name.split('_')[1]}"
    raise KeyError(f"Unrecognized flax layer name {name!r}")


def params_from_jax(flax_params: dict) -> Dict[str, torch.Tensor]:
    """Flax params ({'params': {layer: {'kernel', 'bias'}}} or the inner
    dict) -> a torch state dict for `BasicPolicy` or `Conv1dPolicy` (every
    kernel with its axes reversed)."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    n_policy = sum(1 for k in p if k.startswith("policy_"))
    n_value = sum(1 for k in p if k.startswith("value_") and k != "value_out")
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in p.items():
        key = _torch_key(name, n_policy, n_value)
        kernel = np.asarray(leaf["kernel"], dtype=np.float32)
        sd[key + ".weight"] = torch.from_numpy(kernel.T.copy())
        sd[key + ".bias"] = torch.from_numpy(
            np.asarray(leaf["bias"], dtype=np.float32).copy())
    return sd


def adam_state_from_optax(optimizer: torch.optim.Adam, module: torch.nn.Module,
                          mu: dict, nu: dict, count: int) -> None:
    """Load optax Adam's state into `optimizer`, which optimizes `module`
    (a `BasicPolicy` or `Conv1dPolicy`): `mu` and `nu` are the first and
    second moment trees (flax layout, numpy leaves), `count` the number of
    steps taken."""
    exp_avg, exp_avg_sq = params_from_jax(mu), params_from_jax(nu)
    for name, p in module.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": exp_avg[name].to(p.device),
            "exp_avg_sq": exp_avg_sq[name].to(p.device),
        }
