"""Data parallelism over torch.distributed (counterpart of
ingp_tpu/parallel/): `World`, its shards and collectives (mesh.py), and
the process-group plumbing (distributed.py)."""
from .distributed import (all_gather_metrics, broadcast_int,
                          init_distributed, is_main_process)
from .mesh import (World, all_reduce_max, all_reduce_mean, barrier,
                   broadcast_tree, gather_rows, make_mesh, shard_batch,
                   world_from_group)

__all__ = ["World", "all_gather_metrics", "all_reduce_max",
           "all_reduce_mean", "barrier", "broadcast_int", "broadcast_tree",
           "gather_rows", "init_distributed", "is_main_process",
           "make_mesh", "shard_batch", "world_from_group"]
