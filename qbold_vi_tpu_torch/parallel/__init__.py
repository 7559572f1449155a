"""Data parallelism over processes (torch.distributed): the counterpart
of ``qbold_vi_tpu/parallel``. ``mesh`` holds the process group and the
row layouts; ``multihost`` spawns ranks and certifies the sharded paths
against a single process; ``dryrun`` runs them on a tiny configuration."""

from . import mesh
from .mesh import (DATA_AXIS, Mesh, all_gather_rows, all_reduce_sum,
                   host_local_rows, initialize_distributed, make_mesh,
                   replicate, shard_batch, shard_batch_local)

__all__ = [
    "mesh",
    "DATA_AXIS",
    "Mesh",
    "all_gather_rows",
    "all_reduce_sum",
    "host_local_rows",
    "initialize_distributed",
    "make_mesh",
    "replicate",
    "shard_batch",
    "shard_batch_local",
]
