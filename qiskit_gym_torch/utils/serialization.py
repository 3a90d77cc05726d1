"""Checkpoint serialization: the three on-disk formats of the JAX package's
`utils/serialization.py`, for the port's state dicts.

- `.pt`: torch state dicts, the format the reference ships
  (examples/models/*.pt), through models/torch_io.py.
- A `.orbax` suffix, a trailing-slash path, or an existing directory: the
  sharding-aware directory format. The JAX package writes orbax there; the
  port writes `torch.distributed.checkpoint` (DCP), its PyTorch
  counterpart, with `async_checkpointer()` for saves that overlap training.
  A directory that orbax wrote cannot be read without orbax and tensorstore,
  which the port does not use: loading one raises and says so.
- Anything else: flax msgpack, read and written by the port's own codec
  (utils/flax_msgpack.py) in the flax layout the JAX package writes
  (`{"params": {layer: {"kernel", "bias"}}}`), so either package reads the
  other's files.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Dict, Optional

import torch

from qiskit_gym_torch.models.torch_io import (load_torch_checkpoint,
                                              params_from_jax, params_to_jax,
                                              save_torch_checkpoint)

from . import flax_msgpack

StateDict = Dict[str, torch.Tensor]
# files that orbax writes into a checkpoint directory (any version)
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt",
                  "checkpoint", "_sharding")


def _is_dir_path(path: str) -> bool:
    # explicit markers work for not-yet-existing save targets too; a bare
    # existing directory is also the directory format for loading
    return (path.endswith(".orbax") or path.endswith(os.sep)
            or os.path.isdir(path))


def _refuse_orbax(path: str) -> None:
    if os.path.exists(os.path.join(path, ".metadata")):
        return  # torch.distributed.checkpoint
    found = [m for m in _ORBAX_MARKERS if os.path.exists(os.path.join(path, m))]
    if found:
        raise ValueError(
            f"{path!r} was written by orbax ({', '.join(found)}); reading it "
            "needs orbax and tensorstore, which the PyTorch port does not "
            "use. Re-save it from the JAX package as msgpack "
            "(save_params(params, 'x.msgpack')) or .pt and load that.")
    raise FileNotFoundError(f"{path!r} holds no torch.distributed.checkpoint "
                            "(no .metadata file)")


def _dcp_template(path: str) -> StateDict:
    """Empty CPU tensors for every tensor a DCP directory holds."""
    from torch.distributed.checkpoint import FileSystemReader

    meta = FileSystemReader(path).read_metadata().state_dict_metadata
    return {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
            for k, m in meta.items()}


@contextlib.contextmanager
def _quiet():
    """Without a process group DCP saves and loads as one process, and
    warns that it does."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", module="torch.distributed")
        yield


def _check_template(got: StateDict, template: StateDict, path: str
                    ) -> StateDict:
    if set(got) != set(template):
        raise KeyError(f"{path!r}: keys {sorted(set(got) ^ set(template))} "
                       "are in only one of the file and the template")
    out = {}
    for k, t in template.items():
        if tuple(got[k].shape) != tuple(t.shape):
            raise ValueError(f"{path!r}: {k} has shape {tuple(got[k].shape)}"
                             f", the template {tuple(t.shape)}")
        out[k] = got[k].to(device=t.device, dtype=t.dtype)
    return out


def save_params(state_dict: StateDict, path: str) -> None:
    if path.endswith(".pt"):
        save_torch_checkpoint(state_dict, path)
        return
    if _is_dir_path(path):
        import torch.distributed.checkpoint as dcp

        with _quiet():
            dcp.save({k: v.detach() for k, v in state_dict.items()},
                     checkpoint_id=os.path.abspath(path))
        return
    with open(path, "wb") as f:
        f.write(flax_msgpack.packb(params_to_jax(state_dict)))


def load_params(path: str, template: Optional[StateDict] = None
                ) -> StateDict:
    """A state dict from any of the three formats. With `template` (a state
    dict) the result has the template's keys, shapes, dtypes and devices,
    and a mismatch raises."""
    if path.endswith(".pt"):
        out = load_torch_checkpoint(path)
    elif _is_dir_path(path):
        import torch.distributed.checkpoint as dcp

        _refuse_orbax(path)
        out = _dcp_template(path)
        with _quiet():
            dcp.load(out, checkpoint_id=os.path.abspath(path))
    else:
        with open(path, "rb") as f:
            out = params_from_jax(flax_msgpack.unpackb(f.read()))
    return out if template is None else _check_template(out, template, path)


class _AsyncCheckpointer:
    """`save(path, state_dict)` returns at once while DCP writes in the
    background; `wait_until_finished()` blocks until every save is on
    disk (the JAX package's orbax AsyncCheckpointer call shape)."""

    def __init__(self):
        self._pending = []

    def save(self, path: str, state_dict: StateDict) -> None:
        import torch.distributed.checkpoint as dcp

        # a copy on the host, so that training may update the live tensors
        # while the write runs
        snapshot = {k: v.detach().to("cpu", copy=True)
                    for k, v in state_dict.items()}
        with _quiet():
            self._pending.append(dcp.async_save(
                snapshot, checkpoint_id=os.path.abspath(path)))

    def wait_until_finished(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()


def async_checkpointer() -> _AsyncCheckpointer:
    """A checkpointer for non-blocking training checkpoints in the directory
    format: save() returns at once and serialization overlaps the next
    train step; call .wait_until_finished() before reading it back."""
    return _AsyncCheckpointer()
