"""Device mesh and the rules that split env lanes and policy weights over it.

Port of the JAX package's `parallel/mesh.py`. Env rollouts are
embarrassingly parallel over the lane batch, so the lanes are split into
contiguous blocks over the mesh's 'dp' axis, one block per process; the
policies are small MLPs, replicated on every process (or, with mp > 1,
their hidden Linears tensor-sharded over 'mp'). Where the JAX package
writes sharding constraints and lets XLA insert the collectives, the port
calls them itself, in the few places that need them:

- every process draws the same global noise and keeps its lanes' block, so
  a run over N processes makes the single process's draws;
- the packed pool's refill rotates lanes across blocks: the refill slot is
  gathered over 'dp' before the roll (`gather_lanes`);
- a loss divides its local masked sums by the global valid count
  (`psum`), and the gradient is summed over 'dp' before the optimizer
  step, which then is the single-process step on the same lanes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor


def make_mesh(n_devices: Optional[int] = None, mp: int = 1,
              axis_names: Sequence[str] = ("dp", "mp")):
    """A 2-D `DeviceMesh` (dp = processes // mp, mp) over every process of
    the initialized group (parallel.distributed.initialize), on CUDA under
    NCCL and on the CPU under gloo. `n_devices`, if given, must be the
    process count: one process drives one card."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "qiskit_gym_torch.parallel.initialize() first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{n} processes (one card each)")
    if n % mp != 0:
        raise ValueError(f"{n} devices not divisible by mp={mp}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // mp, mp),
                            mesh_dim_names=tuple(axis_names))


# ------------------------------------------------------------------- lanes
# The size of a mesh axis is read by its index: slicing a DeviceMesh by
# name (mesh["dp"]) builds a new mesh on the host each time, and the lane
# helpers run several times an env step (scripts/dp_overhead_probe.py
# times both).
def dp_coords(mesh):
    """(this process's index on 'dp', the size of 'dp')."""
    return mesh.get_local_rank("dp"), dp_size(mesh)


def dp_size(mesh) -> int:
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("dp"))


def shard_lanes(mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This process's contiguous block of the global lanes on `axis` (all
    of them without a mesh)."""
    if mesh is None:
        return x
    rank, size = dp_coords(mesh)
    B = x.shape[axis]
    if B % size:
        raise ValueError(f"{B} lanes do not split over dp={size}")
    return x.narrow(axis, rank * (B // size), B // size)


def shard_env_state(mesh, state, batch_axis: int = 0):
    """Every field of an env state (or any NamedTuple of tensors) cut to this
    process's block of lanes on `batch_axis` (0 for a live [B, ...] state, 1
    for a [slots, B, ...] packed pool); `state` itself without a mesh."""
    if mesh is None:
        return state
    return type(state)(*(shard_lanes(mesh, x, batch_axis) for x in state))


def gather_lanes(mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The global lanes: every process's block of `x`, joined on `axis` in
    'dp' order (the inverse of shard_lanes); `x` itself without a mesh."""
    size = dp_size(mesh)
    if size == 1:
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire.contiguous(), group=mesh.get_group("dp"))
    out = torch.cat(parts, dim=axis)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def gather_env_state(mesh, state, batch_axis: int = 0):
    if dp_size(mesh) == 1:
        return state
    return type(state)(*(gather_lanes(mesh, x, batch_axis) for x in state))


def psum(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over 'dp' (no gradient flows through it); `x` itself
    where 'dp' has one process."""
    if dp_size(mesh) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.get_group("dp"))
    return out


def all_reduce_grads(mesh, params) -> None:
    """Sum the gradients of `params` over 'dp', in place, in one flat
    collective."""
    from torch._utils import (_flatten_dense_tensors,
                              _unflatten_dense_tensors)

    if dp_size(mesh) == 1:
        return
    grads = [_local(p.grad) for p in params if p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.get_group("dp"))
    for g, f in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(f)


def _local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor, or the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective: every process of its
    mesh must call it), or the tensor itself."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def distribute_like(value: torch.Tensor, like: torch.Tensor
                    ) -> torch.Tensor:
    """A whole tensor (the same on every process) laid out as `like`: with
    a DTensor's mesh and placements, else on its device."""
    value = value.to(device=like.device, dtype=like.dtype)
    if isinstance(like, DTensor):
        return distribute_tensor(value, like.device_mesh, like.placements)
    return value


def load_into(module: nn.Module, state_dict) -> None:
    """`module.load_state_dict(state_dict, strict=True)` for whole tensors,
    also where the module's weights are tensor-sharded DTensors."""
    own = dict(module.named_parameters())
    if set(own) != set(state_dict):
        raise KeyError(f"state dict keys differ from the module's: "
                       f"{sorted(set(own) ^ set(state_dict))}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(distribute_like(state_dict[name], p))


# ------------------------------------------------------------------ params
def replicate(mesh, tree):
    """Every process's copy of `tree` (a tensor, or a dict, list, tuple or
    NamedTuple of tensors) set to that of the mesh's first process."""
    src = int(mesh.mesh.reshape(-1)[0])

    def bcast(x):
        if isinstance(x, torch.Tensor):
            out = x.detach().clone().contiguous()
            dist.broadcast(out, src=src)
            return out
        if isinstance(x, dict):
            return {k: bcast(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(bcast(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(bcast(v) for v in x)
        return x

    return bcast(tree)


_HEADS = ("action", "value")


def _hidden_linears(module: nn.Module):
    """The policy's hidden Linears (embeddings, common.*, the hidden layers
    of both heads); the two output layers stay replicated."""
    out = {}
    for name, m in module.named_modules():
        if not isinstance(m, nn.Linear):
            continue
        parts = name.split(".")
        if parts[0] in _HEADS:
            last = len(getattr(module, parts[0])) - 1
            if int(parts[1]) == last:
                continue  # an output head: its out dim is tiny
        out[name] = m
    return out


def shard_params(mesh, module: nn.Module) -> nn.Module:
    """Place a policy net on the mesh, in place: every weight replicated
    from the mesh's first process, and with mp > 1 the hidden Linears
    tensor-sharded over 'mp' (output features split, the output gathered
    whole before the next layer), the output heads replicated. Returns
    `module` (untouched without a mesh)."""
    if mesh is None:
        return module
    src = int(mesh.mesh.reshape(-1)[0])
    with torch.no_grad():
        for p in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(p.data, src=src)
    if mesh.size(mesh.mesh_dim_names.index("mp")) > 1:
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                       parallelize_module)

        plan = {name: ColwiseParallel(output_layouts=Replicate())
                for name in _hidden_linears(module)}
        parallelize_module(module, mesh["mp"], plan)
    return module
