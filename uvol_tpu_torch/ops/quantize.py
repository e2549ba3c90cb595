"""Attribute quantization (PyTorch), counterpart of `uvol_tpu/ops/quantize.py`.

Same Draco range-quantization semantics and the same float32 op order
as the reference, so the integers it produces are identical. Functions
take one frame `[N, D]` or a padded batch `[F, N, D]`; bounds are per
frame over a validity mask.

Divisions by or of a Python number go through `_device.true_div`, so
the quotients are IEEE on both devices.

Integer symbols stay int32 on the device: zigzag writes the uint32 bit
pattern into an int32 tensor, and the unsigned view is taken only at the
numpy boundary (`symbols_to_numpy`), because PyTorch's uint32 supports
few operations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from uvol_tpu_torch._device import true_div

Tensor = torch.Tensor


class QuantizedAttr(NamedTuple):
    """Quantized integers plus the transform needed to dequantize."""

    values: Tensor  # int32, same leading shape as input
    min_value: Tensor  # [..., D] float32 per-frame minimum
    range_value: Tensor  # [...] float32 scalar per frame (max component range)


def compute_quantization_transform(
    x: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Per-frame min and max-range over valid rows.

    `x`: [..., N, D]; `mask`: [..., N] bool. Returns (min [..., D],
    range [...]); range is the largest per-component extent, and a
    degenerate frame's range 0 becomes 1."""
    if mask is None:
        mn = x.amin(dim=-2)
        mx = x.amax(dim=-2)
    else:
        big = torch.finfo(x.dtype).max
        m = mask[..., None]
        mn = torch.where(m, x, big).amin(dim=-2)
        mx = torch.where(m, x, -big).amax(dim=-2)
    rng = (mx - mn).amax(dim=-1)
    rng = torch.where(rng <= 0, torch.ones_like(rng), rng)
    return mn, rng


def quantize(x: Tensor, qbits: int, *, mask: Optional[Tensor] = None) -> QuantizedAttr:
    """q = clip(floor((v - min) * (1 / delta) + 0.5), 0, 2^qbits - 1) with
    delta = range / (2^qbits - 1); rows outside `mask` are 0."""
    min_value, range_value = compute_quantization_transform(x, mask)
    max_q = (1 << qbits) - 1
    delta = true_div(range_value, max_q)
    inv = true_div(1.0, delta)[..., None, None]
    q = torch.floor((x - min_value[..., None, :]) * inv + 0.5)
    q = torch.clamp(q, 0, max_q).to(torch.int32)
    if mask is not None:
        q = torch.where(mask[..., None], q, 0)
    return QuantizedAttr(q, min_value, range_value)


def dequantize(q: QuantizedAttr, qbits: int) -> Tensor:
    delta = true_div(q.range_value, (1 << qbits) - 1)
    return dequantize_scaled(q.values, q.min_value, delta)


def dequantize_scaled(values: Tensor, min_value: Tensor, scale: Tensor) -> Tensor:
    """min + values * scale per frame: `values` [..., N, D] int32,
    `min_value` [..., D], `scale` [...] = range / (2^qbits - 1). The
    product is rounded before the add (no FMA)."""
    return min_value[..., None, :] + values.to(torch.float32) * scale[..., None, None]


def zigzag_encode(v: Tensor) -> Tensor:
    """Signed int32 → zigzag symbols 0,-1,1,-2 → 0,1,2,3 as the uint32 bit
    pattern in int32: `(v >> 31) ^ (v << 1)` (shift is arithmetic)."""
    v = v.to(torch.int32)
    return (v >> 31) ^ (v << 1)


def zigzag_decode(u: Tensor) -> Tensor:
    """Inverse of `zigzag_encode` on int32 bit patterns: the logical
    shift is `(u >> 1) & 0x7FFFFFFF`, the sign comes from bit 0."""
    u = u.to(torch.int32)
    return ((u >> 1) & 0x7FFFFFFF) ^ -(u & 1)


def symbols_to_numpy(t: Tensor) -> np.ndarray:
    """int32 symbol tensor → numpy uint32 with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def symbols_from_numpy(a: np.ndarray, device=None) -> Tensor:
    """numpy uint32 symbols → int32 tensor with the same bits."""
    a = np.require(a, np.uint32, ["C", "W"]).view(np.int32)
    return torch.from_numpy(a).to(device)
