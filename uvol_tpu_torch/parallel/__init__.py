"""Multi-device runs on `torch.distributed` (counterpart of `uvol_tpu.parallel`)."""

from uvol_tpu_torch.parallel.mesh import (  # noqa: F401
    BLOCK_AXIS,
    FRAME_AXIS,
    all_gather_in_rank_order,
    all_sum_in_rank_order,
    axis_rank,
    axis_size,
    bucket_frames_by_count,
    initialize_distributed,
    make_mesh,
    mesh_device,
    mesh_is_multiprocess,
    pad_frames_to_mesh,
    replicate_to_host,
    shard_frames,
)
from uvol_tpu_torch.parallel.ranks import run_ranks  # noqa: F401
