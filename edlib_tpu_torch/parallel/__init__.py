"""Sharded alignment on a grid of devices: the API of edlib_tpu.parallel.

A DeviceGrid (make_alignment_mesh) takes the place of the JAX package's
device mesh; the sharded reduces, sweeps and carry pipelines run the port's
kernels on each shard's device and merge on the grid's first device.
"""

from edlib_tpu_torch.parallel.dist import (
    DeviceGrid,
    make_alignment_mesh,
    shard_target_slices,
    sharded_hw_locations,
    sharded_hw_search,
    sharded_nw_pipeline,
    sharded_reduce_dp,
    sharded_reduce_pipeline,
    sharded_sweep_dp,
)
from edlib_tpu_torch.parallel.pipeline import (
    pipelined_sweep_summaries,
    split_target_segments,
)

__all__ = [
    "DeviceGrid",
    "make_alignment_mesh",
    "shard_target_slices",
    "sharded_hw_locations",
    "sharded_hw_search",
    "sharded_nw_pipeline",
    "sharded_reduce_pipeline",
    "sharded_reduce_dp",
    "sharded_sweep_dp",
    "pipelined_sweep_summaries",
    "split_target_segments",
]
