"""Data parallelism over env lanes with torch.distributed (one process per
card), policy weights replicated or, with mp > 1, tensor-sharded."""

from .distributed import initialize, is_primary, process_count, shutdown
from .mesh import (gather_lanes, make_mesh, psum, replicate, shard_env_state,
                   shard_lanes, shard_params)

__all__ = ["make_mesh", "shard_env_state", "shard_params", "replicate",
           "shard_lanes", "gather_lanes", "psum",
           "initialize", "is_primary", "process_count", "shutdown"]
