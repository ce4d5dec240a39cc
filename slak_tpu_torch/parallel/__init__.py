"""Data parallel with SyncBN and the channel-parallel eval: port of
``slak_tpu/parallel/``."""

from slak_tpu_torch.parallel.mesh import (DATA_AXIS, all_reduce_,
                                          axis_group, init_distributed, rank,
                                          replicate, shard_batch, world)
from slak_tpu_torch.parallel.tp import make_tp_apply

__all__ = ["DATA_AXIS", "all_reduce_", "axis_group", "init_distributed",
           "rank", "replicate", "shard_batch", "world", "make_tp_apply"]
