from heybuddy_tpu_torch.parallel.mesh import (
    distributed_init,
    get_mesh,
    batch_sharding,
    replicated,
    shard_batch,
    pad_batch_to_multiple,
)

__all__ = [
    "distributed_init",
    "get_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "pad_batch_to_multiple",
]
