"""Data- and tensor-parallel layouts on ``torch.distributed`` (port of
``transformer4sed_tpu/parallel``)."""

from transformer4sed_tpu_torch.parallel.mesh import (
    Mesh,
    device_prefetch,
    make_2d_mesh,
    make_mesh,
    put_batch,
    require_devices,
    shard_train_step,
)
from transformer4sed_tpu_torch.parallel.multihost import (
    ProcessShardedBatchSampler,
    gather_clip_scores,
    gather_objects,
    is_primary,
    make_global_batch,
    maybe_initialize,
    shard_batch_indices,
    shard_eval_items,
)
from transformer4sed_tpu_torch.parallel.partition import (
    TP_RULES,
    gather_state_dict,
    partition_specs,
    shard_params,
    tp_flash_attention,
)

__all__ = [
    "make_mesh",
    "require_devices",
    "shard_train_step",
    "put_batch",
    "device_prefetch",
    "TP_RULES",
    "make_2d_mesh",
    "partition_specs",
    "shard_params",
    "ProcessShardedBatchSampler",
    "gather_clip_scores",
    "gather_objects",
    "is_primary",
    "make_global_batch",
    "maybe_initialize",
    "shard_batch_indices",
    "shard_eval_items",
    "Mesh",
    "gather_state_dict",
    "tp_flash_attention",
]
