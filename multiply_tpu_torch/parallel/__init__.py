"""Several devices: ray data-parallel training over `torch.distributed`
(counterpart of `multiply_tpu/parallel/`)."""

from .sharding import (
    RAY_AXIS,
    RayGroup,
    close_ray_group,
    init_ray_group,
    launch,
    replicate,
    shard_batch,
    shard_noise,
    shard_rays,
    shard_render_inputs,
    sharded_train_step,
)

__all__ = [
    "RAY_AXIS", "RayGroup", "close_ray_group", "init_ray_group", "launch", "replicate", "shard_batch",
    "shard_noise", "shard_rays", "shard_render_inputs", "sharded_train_step",
]
