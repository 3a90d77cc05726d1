"""Full training-state checkpointing (resume-capable).

Port of the JAX package's `rl/checkpoint.py`. The weights-only `.pt`
checkpoints restart an interrupted run's optimizer, random stream and
curriculum from scratch; a training snapshot also carries the Adam state,
the generator state, the iteration count and the curriculum difficulty, so
`learn()` continues where it stopped. One file written with `torch.save`
(`train_state.pt`), swapped in atomically.

The algorithm object gives `params`, `optimizer`, `generator`, `iteration`,
`env.difficulty`, `best_difficulty` and `best_params`. A snapshot restores
onto the kind of device it was taken on (a CUDA generator's state does not
load into a CPU generator).

`restore_training_state` also reads the JAX package's `train_state.msgpack`
(flax msgpack: the flax params, optax Adam's leaves flat, the PRNG key, the
counters), so a run started under JAX resumes in the port: params and
`best_params` through `params_from_jax`, the Adam moments and step count
through `adam_state_from_optax`. The threefry key has no torch counterpart;
the port's generator is seeded from the key's data, so the draws after the
resume are the port's own.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from qiskit_gym_torch.models.torch_io import (adam_state_from_optax,
                                              params_from_jax)
from qiskit_gym_torch.parallel.distributed import is_primary
from qiskit_gym_torch.parallel.mesh import (distribute_like, full_tensor,
                                            load_into)
from qiskit_gym_torch.utils import flax_msgpack


def _cpu(state_dict):
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def _whole_optimizer_state(optimizer) -> dict:
    """optimizer.state_dict() with every DTensor as its whole tensor (a
    collective when mp > 1 shards the weights)."""
    sd = optimizer.state_dict()
    sd["state"] = {i: {k: full_tensor(v) if isinstance(v, torch.Tensor)
                       else v for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def _place_optimizer_state(optimizer) -> None:
    """Lay the moments of tensor-sharded weights out as their weights."""
    for p, st in optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                st[k] = distribute_like(st[k], p)


def save_training_state(algo, path: str) -> None:
    """Write the snapshot. Under a mesh every process calls this (whole
    tensors are gathered where mp > 1 shards them) and the primary one
    writes."""
    payload = {
        "params": _cpu(algo.params),
        "opt": _whole_optimizer_state(algo.optimizer),
        "generator": algo.generator.get_state(),
        "iteration": int(algo.iteration),
        "difficulty": int(getattr(algo.env, "difficulty", 1)),
        "best_difficulty": int(getattr(algo, "best_difficulty", 0)),
    }
    if getattr(algo, "best_params", None) is not None:
        payload["best_params"] = _cpu(algo.best_params)
    if not is_primary():
        return
    # atomic swap: a kill mid-write (the very case this snapshot exists for)
    # must not truncate the only copy
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".tmp")
    # mkstemp creates 0600; restore the umask-derived permissions so that
    # other users and tools can read the snapshot after the swap
    umask = os.umask(0)
    os.umask(umask)
    os.fchmod(fd, 0o666 & ~umask)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _leaf_paths(tree, prefix=()):
    """Leaf paths of a nested dict in JAX's flattening order (sorted keys
    at every level)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


def _unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _restore_jax(algo, payload: dict) -> None:
    """A JAX package snapshot: optax.adam's state flattens to [count, mu
    leaves..., nu leaves...], each moment tree shaped as the params."""
    paths = list(_leaf_paths(payload["params"]))
    opt = payload["opt"]
    P = len(paths)
    if len(opt) != 1 + 2 * P:
        raise ValueError(
            f"optimizer state has {len(opt)} leaves; optax.adam over {P} "
            f"params has {1 + 2 * P}")
    leaves = [opt[str(i)] for i in range(len(opt))]
    load_into(algo.policy.module, params_from_jax(payload["params"]))
    adam_state_from_optax(algo.optimizer, algo.policy.module,
                          _unflatten(paths, leaves[1:1 + P]),
                          _unflatten(paths, leaves[1 + P:]), int(leaves[0]))
    _place_optimizer_state(algo.optimizer)
    key = [int(w) for w in np.asarray(payload["key"]).reshape(-1)[:2]]
    algo.generator.manual_seed(((key[0] << 32) | key[-1]) & (2 ** 63 - 1))
    algo.iteration = int(payload["iteration"])
    algo.env.difficulty = int(payload["difficulty"])
    algo.best_difficulty = int(payload.get("best_difficulty", 0))
    if "best_params" in payload:
        algo.best_params = {k: v.to(algo.device) for k, v in
                            params_from_jax(payload["best_params"]).items()}


def restore_training_state(algo, path: str) -> None:
    """Restore in place, from the port's `train_state.pt` or the JAX
    package's `train_state.msgpack`. The algorithm must be constructed with
    the same policy and config first; the optimizer state moves to the
    device of the weights it belongs to."""
    with open(path, "rb") as f:
        head = f.read(4)
        if head != b"PK\x03\x04":  # not a torch.save zip: flax msgpack
            _restore_jax(algo, flax_msgpack.unpackb(head + f.read()))
            return
    payload = torch.load(path, map_location="cpu", weights_only=True)
    load_into(algo.policy.module, payload["params"])
    algo.optimizer.load_state_dict(payload["opt"])
    _place_optimizer_state(algo.optimizer)
    algo.generator.set_state(payload["generator"])
    algo.iteration = int(payload["iteration"])
    algo.env.difficulty = int(payload["difficulty"])
    algo.best_difficulty = int(payload.get("best_difficulty", 0))
    if "best_params" in payload:
        algo.best_params = {k: v.to(algo.device)
                            for k, v in payload["best_params"].items()}
