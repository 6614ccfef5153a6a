"""Data parallelism over GPUs: the process group as the data mesh (port of
crocoddyl_tpu/parallel/mesh.py)."""

from .mesh import (DataMesh, batched_solve_fn, data_mesh, dryrun_multichip,
                   fleet_metrics, gather, host_local_batch, init_distributed,
                   replicate, shard_batch, sharded_solve_x0, spawn)

__all__ = ["DataMesh", "batched_solve_fn", "data_mesh", "dryrun_multichip",
           "fleet_metrics", "gather", "host_local_batch", "init_distributed",
           "replicate", "shard_batch", "sharded_solve_x0", "spawn"]
