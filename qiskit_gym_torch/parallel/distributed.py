"""Process-group setup for data parallelism over env lanes.

Port of the JAX package's `parallel/distributed.py`. The JAX package runs
one controller over every chip of a slice and calls
`jax.distributed.initialize()` only to cross hosts. The PyTorch idiom is one
process per card: `torchrun --nproc-per-node N script.py` (or any launcher
that gives each process its rank) and `initialize()` before any collective,
with NCCL on the card and gloo on the CPU. `make_mesh` (parallel/mesh.py)
then spans every process, env lanes are split over its 'dp' axis, and the
gradients are summed over it once per update; env steps never communicate.

Nothing is silent: a backend that fails to come up raises (NCCL is never
swapped for gloo behind the caller's back).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _init_method(address: Optional[str]) -> Optional[str]:
    if address is None or "://" in address:
        return address
    return f"tcp://{address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    store=None,
) -> None:
    """Join the process group (a no-op for a single process).

    With no arguments, a process started by `torchrun` (WORLD_SIZE, RANK
    and MASTER_ADDR in its environment) joins through the environment, and
    a lone process does nothing. Explicit arguments serve any other
    launcher: `coordinator_address` ("host:port" or an init URL such as
    "tcp://localhost:29500" or "file:///path"), or a `store` (a
    `torch.distributed.Store`, such as a FileStore), with `num_processes`
    and `process_id`. `backend` defaults to "nccl" where CUDA is available
    and "gloo" elsewhere; under NCCL each process takes card LOCAL_RANK
    (else its rank modulo the card count).

    Safe to call twice with the same arguments (the second call is
    ignored); a repeat call with different explicit arguments raises, since
    the first initialization cannot be undone."""
    args = (coordinator_address, num_processes, process_id, backend, store)
    prev = getattr(initialize, "_args", None)
    if prev is not None:
        if args == prev or all(a is None for a in args):
            return
        if dist.is_initialized():
            raise RuntimeError(
                f"torch.distributed already initialized with {prev}; "
                f"cannot re-initialize with {args}")
        # the previous call was a single-process no-op: nothing was
        # initialized, so honor the explicit request
    if dist.is_initialized():
        initialize._args = args
        return
    explicit = coordinator_address is not None or store is not None
    if not explicit and "WORLD_SIZE" not in os.environ:
        initialize._args = args  # a lone process: nothing to coordinate
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if explicit:
        world = int(num_processes if num_processes is not None
                    else os.environ.get("WORLD_SIZE", 1))
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
    else:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=None if store is not None else (
            _init_method(coordinator_address) or "env://"),
        store=store, world_size=world, rank=rank)
    initialize._args = args


def shutdown() -> None:
    """Leave the process group (so that a process can exit cleanly) and
    forget the arguments of `initialize`."""
    if dist.is_initialized():
        dist.destroy_process_group()
    initialize._args = None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that should own logging and checkpoint writes."""
    return not dist.is_initialized() or dist.get_rank() == 0
