"""Prediction transforms (PyTorch), counterpart of `uvol_tpu/ops/prediction.py`:
the successive-difference pair and the parallelogram pair.

`dim` is the vertex axis of the delta pair: -2 for the reference's
interleaved `[..., N, D]` rows, -1 for the sequence codec's planar
`[F, C, N]`.

`parallelogram_encode` is a gather in plain PyTorch. Its gathers are
`jnp.take_along_axis`'s: an index >= N reads the fill value (the type's
minimum) rather than a row. `parallelogram_decode` is the scan, U5
(`ops/mesh_cuda.py`); the scan's gathers clamp an index >= N to N - 1
instead, as XLA's do, so the pair is each other's inverse only for
indices below N. Integer sums wrap as the reference's int32 sums do.
"""

from __future__ import annotations

from typing import Optional

import torch

from uvol_tpu_torch.ops import mesh_cuda

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


def _wrap(v: Tensor, dtype: torch.dtype) -> Tensor:
    """int64 sums → `dtype` with two's-complement wrapping (int64 wraps by
    itself)."""
    bits = torch.iinfo(dtype).bits
    if bits < 64:
        v = ((v + (1 << (bits - 1))) & ((1 << bits) - 1)) - (1 << (bits - 1))
    return v.to(dtype)


def parallelogram_encode(values: Tensor, pred_indices: Tensor, *,
                         first_delta: bool = True) -> Tensor:
    """Residuals under parallelogram prediction: values [..., N, D] int,
    pred_indices [..., N, 3] int (a, b, c) with pred = v[a] + v[b] - v[c]
    where a >= 0, else the previous vertex (0 for vertex 0). Negative b, c
    read row 0. `first_delta` changes nothing, as in the reference (vertex
    0 always predicts from zero)."""
    n = values.shape[-2]
    fill = torch.iinfo(values.dtype).min
    wide = values.to(torch.int64)

    def take(i: Tensor) -> Tensor:
        i = i.clamp(min=0).to(torch.int64)[..., None]
        got = torch.take_along_dim(wide, i.clamp(max=max(n - 1, 0)), dim=-2)
        return torch.where(i < n, got, fill)

    a, b, c = pred_indices.unbind(-1)
    par = _wrap(take(a) + take(b) - take(c), values.dtype).to(torch.int64)
    prev = torch.roll(wide, 1, dims=-2)
    prev.narrow(-2, 0, min(n, 1)).zero_()
    pred = torch.where((a >= 0)[..., None], par, prev)
    return _wrap(wide - pred, values.dtype)


def parallelogram_decode(residuals: Tensor, pred_indices: Tensor, *,
                         first_delta: bool = True) -> Tensor:
    """Inverse of `parallelogram_encode` (for indices below N): the scan
    over vertices, each step gathering its corners from the decoded prefix
    (zeros beyond it). residuals [..., N, D] int32, pred_indices
    [..., N, 3] int32 → [..., N, D] int32. U5 on the card, its twin on the
    CPU. `first_delta` changes nothing, as in the reference."""
    return mesh_cuda.parallelogram_decode(residuals, pred_indices)
