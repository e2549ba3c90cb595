"""Codebook learning by k-means over frame-sharded blocks — counterpart
of `uvol_tpu/models/codebook.py` (U2).

The reference's assignment is one bf16 matmul with float32 accumulation
(the MXU's form) and its update a one-hot matmul of sums and counts,
reduced over the frame axis with `psum`. Here:

  - `kmeans_assign` rounds both operands to bf16 and takes the product
    of those values in full float32 (`torch.matmul` on bf16 tensors
    would return bf16 and round the dots a second time);
  - `kmeans_update` takes the per-cluster sums and counts through the
    fixed-order segment sum (`etc1s_cuda.segment_sum`: the kernel on a
    card, its twin on the CPU), and the sums across ranks through
    `parallel.mesh.all_sum_in_rank_order`, so every rank holds the same
    codebook bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from uvol_tpu_torch._device import require_full_f32
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern
from uvol_tpu_torch.parallel.mesh import FRAME_AXIS, all_sum_in_rank_order

Tensor = torch.Tensor


def kmeans_assign(blocks: Tensor, codebook: Tensor) -> Tensor:
    """blocks [B, D], codebook [K, D] → assignments [B] int64: the first
    minimum of |c|^2 - 2 b.c, the dots of the bf16-rounded operands in
    float32."""
    require_full_f32()
    b = blocks.to(torch.bfloat16).to(torch.float32)
    c = codebook.to(torch.bfloat16).to(torch.float32)
    dots = b @ c.T
    cf = codebook.to(torch.float32)
    c2 = (cf * cf).sum(1)
    return torch.argmin(c2[None, :] - 2.0 * dots, 1)


def kmeans_update(blocks: Tensor, codebook: Tensor, *, mesh=None,
                  axis: str = FRAME_AXIS) -> Tuple[Tensor, Tensor]:
    """One Lloyd iteration on this rank's blocks [B, D]; with a mesh the
    sums, counts, distortion and block count are summed over its `axis`
    (the reference's four `psum`s). Returns (new codebook [K, D] f32,
    mean distortion, a 0-d f32 tensor); an empty cluster keeps its
    codeword."""
    k, d = codebook.shape
    x = blocks.to(torch.float32)
    assign = kmeans_assign(blocks, codebook)
    red = kern.segment_sum(assign, k, torch.cat([x, x.new_ones((x.shape[0], 1))], 1))
    sums, counts = red[:, :d], red[:, d]
    diff = x - codebook.to(torch.float32)[assign]
    distortion = (diff * diff).sum()
    n = torch.tensor(float(x.shape[0]), device=x.device)
    if mesh is not None:
        sums, counts, distortion, n = (all_sum_in_rank_order(mesh, t, axis)
                                       for t in (sums, counts, distortion, n))
    new_codebook = torch.where(counts[:, None] > 0,
                               sums / torch.clamp(counts, min=1.0)[:, None],
                               codebook.to(torch.float32))
    return new_codebook, distortion / torch.clamp(n, min=1.0)


def make_sharded_train_step(mesh, axis: str = FRAME_AXIS):
    """The training step over frame-sharded blocks: `step(local_blocks,
    codebook)` takes this rank's blocks [..., D] (its frame slice,
    `parallel.mesh.shard_frames`) and the replicated codebook [K, D], and
    returns (new codebook, mean distortion), the same on every rank."""

    def step(local_blocks: Tensor, codebook: Tensor):
        flat = local_blocks.reshape(-1, local_blocks.shape[-1])
        return kmeans_update(flat, codebook, mesh=mesh, axis=axis)

    return step
