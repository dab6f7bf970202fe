"""Sharding over the ranks of a ``torch.distributed`` process group: the
counterpart of the reference's MPI domain decomposition (and of the JAX
package's device-mesh sharding)."""

from .dryrun import dryrun_multichip
from .launch import run_ranks
from .sharding import (
    DeviceMesh,
    make_device_mesh,
    shard_packed_state,
    shard_problem,
    whole_packed_state,
)

__all__ = [
    "DeviceMesh",
    "dryrun_multichip",
    "make_device_mesh",
    "run_ranks",
    "shard_packed_state",
    "shard_problem",
    "whole_packed_state",
]
