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

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from uvol_tpu_torch._device import f32, true_div, xla_norm3

Tensor = torch.Tensor


class QuantizedAttr(NamedTuple):
    """Quantized integers plus the transform needed to dequantize."""

    values: Tensor  # int32, same leading shape as input
    min_value: Tensor  # [..., D] float32 per-frame minimum
    range_value: Tensor  # [...] float32 scalar per frame (max component range)


def masked_min_max(x: Tensor, mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Per-frame minimum and maximum over valid rows: `x` [..., N, D],
    `mask` [..., N] bool → (min [..., D], max [..., D]). A padded row
    counts as +-float max, so a frame without a valid row gives those.

    The minimum goes onto the wire as its bits, so the sign of a zero
    extreme is fixed: -0.0 < +0.0, as XLA orders them in the reference.
    `torch.amin`/`amax` return whichever zero they met first or last."""
    zero, minus = x == 0, torch.signbit(x)
    neg_zero, pos_zero = zero & minus, zero & ~minus
    if mask is None:
        mn = x.amin(dim=-2)
        mx = x.amax(dim=-2)
    else:
        big = torch.finfo(x.dtype).max
        m = mask[..., None]
        mn = torch.where(m, x, big).amin(dim=-2)
        mx = torch.where(m, x, -big).amax(dim=-2)
        neg_zero, pos_zero = neg_zero & m, pos_zero & m
    mn = torch.where((mn == 0) & neg_zero.any(dim=-2), -0.0, mn)
    mx = torch.where((mx == 0) & pos_zero.any(dim=-2), 0.0, mx)
    return mn, mx


def quantization_range(mn: Tensor, mx: Tensor) -> Tensor:
    """[..., D] bounds → [...] range: the largest per-component extent;
    a degenerate frame's range <= 0 becomes 1."""
    rng = (mx - mn).amax(dim=-1)
    return torch.where(rng <= 0, torch.ones_like(rng), rng)


def compute_quantization_transform(
    x: Tensor, mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Per-frame min and max-range over valid rows.

    `x`: [..., N, D]; `mask`: [..., N] bool. Returns (min [..., D],
    range [...]): `masked_min_max`, then `quantization_range`."""
    mn, mx = masked_min_max(x, mask)
    return mn, quantization_range(mn, mx)


def quantize(x: Tensor, qbits: int, *, mask: Optional[Tensor] = None,
             min_value: Optional[Tensor] = None,
             range_value: Optional[Tensor] = None) -> QuantizedAttr:
    """q = clip(floor((v - min) * (1 / delta) + 0.5), 0, 2^qbits - 1) with
    delta = range / (2^qbits - 1); rows outside `mask` are 0. With both
    `min_value` [..., D] and `range_value` [...] given, that transform is
    used and none is computed."""
    if min_value is None or range_value is None:
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


def xla_cbrt(x: Tensor) -> Tensor:
    """`jnp.cbrt` of float32 `x` as XLA computes it on the CPU:
    copysign(pow(|x|, f32(1/3)), x). The power is taken in float64 and
    rounded once; XLA's own float32 `pow` differs from that by one ulp on
    0.07% of the integers 1 .. 2^21 (and of random floats), so this is
    within one ulp of the reference, not bit for bit."""
    third = f32(1.0 / 3.0)
    return torch.copysign(torch.pow(torch.abs(x).double(), third).float(), x)


def corto_quantization_step(x: Tensor, nvert: int, level: int = 0) -> Tensor:
    """Corto's bbox/vertex-count quantization-step heuristic: the bounding
    box's diagonal / sqrt(2) / cbrt(nvert) * 2^level / 20, per frame of
    x [..., N, 3] → [...]. Each operation is rounded as the reference's
    eager calls round it (the norm as `jnp.linalg.norm`, the divisions
    IEEE, the cube root as `xla_cbrt`, within one ulp), so the step is
    within two ulps of the reference's."""
    mn = x.amin(dim=-2)
    mx = x.amax(dim=-2)
    diag = xla_norm3(mx - mn)
    side = true_div(diag, f32(math.sqrt(2.0)))
    root = xla_cbrt(torch.tensor(float(nvert), dtype=x.dtype, device=x.device))
    return true_div(true_div(side, root) * (2.0 ** level), 20.0)


def quantize_step(x: Tensor, step: Tensor) -> Tensor:
    """Fixed-step integer quantization (Corto semantics): round(v / step),
    halves to even, per frame: x [..., N, D], step [...] → int32."""
    return torch.round(true_div(x, step[..., None, None])).to(torch.int32)


def dequantize_step(q: Tensor, step: Tensor) -> Tensor:
    return q.to(torch.float32) * step[..., None, None]


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
