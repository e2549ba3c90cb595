"""Octahedral normal codec and normal estimation (PyTorch), counterpart of
`uvol_tpu/ops/normals.py`.

The encode and decode are elementwise PyTorch on either device, each
operation rounded on its own as the reference's eager calls are: its
divisions by a tensor are IEEE (`_device.true_div`), `2.0 / max_value` is
the float32 constant the reference multiplies by, nothing is contracted
into an FMA, and the decode's norm is `jnp.linalg.norm`'s
(`_device.xla_norm3`). `estimate_normals` is U3 (`ops/mesh_cuda.py`).
"""

from __future__ import annotations

import torch

from uvol_tpu_torch._device import f32, true_div, xla_norm3
from uvol_tpu_torch.ops.mesh_cuda import estimate_normals  # noqa: F401

Tensor = torch.Tensor


def _sign(v: Tensor) -> Tensor:
    return torch.where(v >= 0, 1.0, -1.0).to(v.dtype)


def octahedral_encode(n: Tensor, qbits: int) -> Tensor:
    """Unit (or unnormalized) float32 normals [..., 3] → quantized (s, t)
    int32 [..., 2]: scale by 1 / (|x| + |y| + |z|), fold the lower
    hemisphere, then floor((u + 1) * 0.5 * max_value + 0.5) with
    max_value = 2^qbits - 2."""
    x, y, z = n.unbind(-1)
    abs_sum = torch.abs(x) + torch.abs(y) + torch.abs(z)
    safe = torch.where(abs_sum > 0, abs_sum, torch.ones_like(abs_sum))
    xs, ys, zs = true_div(x, safe), true_div(y, safe), true_div(z, safe)
    u = torch.where(zs >= 0, xs, (1.0 - torch.abs(ys)) * _sign(xs))
    v = torch.where(zs >= 0, ys, (1.0 - torch.abs(xs)) * _sign(ys))
    max_value = (1 << qbits) - 2
    s = torch.floor((u + 1.0) * 0.5 * max_value + 0.5).to(torch.int32)
    t = torch.floor((v + 1.0) * 0.5 * max_value + 0.5).to(torch.int32)
    return torch.stack([s, t], dim=-1)


def octahedral_decode(st: Tensor, qbits: int) -> Tensor:
    """Quantized (s, t) [..., 2] → float32 unit normals [..., 3] (the
    inverse of the fold)."""
    scale = f32(2.0 / ((1 << qbits) - 2))
    u = st[..., 0].to(torch.float32) * scale - 1.0
    v = st[..., 1].to(torch.float32) * scale - 1.0
    z = 1.0 - torch.abs(u) - torch.abs(v)
    below = z < 0
    x = torch.where(below, (1.0 - torch.abs(v)) * _sign(u), u)
    y = torch.where(below, (1.0 - torch.abs(u)) * _sign(v), v)
    n = torch.stack([x, y, z], dim=-1)
    norm = xla_norm3(n)[..., None]
    return true_div(n, torch.where(norm > 0, norm, torch.ones_like(norm)))
