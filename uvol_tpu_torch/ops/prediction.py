"""Delta prediction (PyTorch), counterpart of `uvol_tpu/ops/prediction.py`.

Only the plain successive-difference pair is ported so far; the
parallelogram scan comes with a later slice (ROADMAP.md).

`dim` is the vertex axis: -2 for the reference's interleaved
`[..., N, D]` rows, -1 for the sequence codec's planar `[F, C, N]`.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def delta_encode(values: Tensor, dim: int = -2) -> Tensor:
    """Successive differences along the vertex axis `dim`; the first row
    is kept."""
    first = torch.zeros_like(values.narrow(dim, 0, 1))
    return torch.diff(values, dim=dim, prepend=first)


def delta_decode(residuals: Tensor, dtype: Optional[torch.dtype] = None,
                 dim: int = -2) -> Tensor:
    """Inverse of `delta_encode`: cumulative sum along `dim` in `dtype`
    (default: the input's). Without an explicit dtype `torch.cumsum`
    would promote int32 to int64, where the reference wraps in int32."""
    return torch.cumsum(residuals, dim=dim, dtype=dtype or residuals.dtype)
