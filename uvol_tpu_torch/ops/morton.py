"""Morton (Z-order) codes (PyTorch), counterpart of `uvol_tpu/ops/morton.py`.

Quantized (x, y, z) are bit-interleaved and sorted so nearby points become
neighbours in the stream (Corto's ZPoint sort).

The reference shifts in uint32; every word here is below 2^30, so the
same bits are computed in int32 (the spread keeps a 10-bit value under
2^27 at every step). The reference compares three words (top, mid, lo)
in a 3-key `lax.sort`; here they are one int64 key, top << 60 | mid << 30
| lo, which orders the same way, and one stable `torch.sort`: XLA's sort
keeps tied keys in index order on the CPU, so duplicates come out in the
reference's order.

On the card the point-cloud codec computes the keys with its quantize in
one kernel (`ops/mesh_cuda.morton_keys`, U4); these functions are its
integer half in plain PyTorch, on either device.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _part1by2_10(x: Tensor) -> Tensor:
    """Spread the low 10 bits of x so there are 2 zeros between each bit."""
    x = x.to(torch.int32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton30(q: Tensor) -> Tensor:
    """[..., 3] int coords (<= 10 bits each) → the 30-bit Morton code
    (int32; the reference's uint32 value)."""
    return (
        _part1by2_10(q[..., 0])
        | (_part1by2_10(q[..., 1]) << 1)
        | (_part1by2_10(q[..., 2]) << 2)
    )


def morton63(q: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """[..., 3] int coords (<= 21 bits each) → (top, mid, lo) int32 Morton
    key words, compared lexicographically: bit 20 of (z, y, x), bits 10-19
    and bits 0-9 interleaved, z in the highest position of every triple."""
    q = q.to(torch.int32)
    lo = morton30(q & 0x3FF)
    mid = morton30((q >> 10) & 0x3FF)
    b20 = (q >> 20) & 1
    top = (b20[..., 2] << 2) | (b20[..., 1] << 1) | b20[..., 0]
    return top, mid, lo


def morton_key(q: Tensor) -> Tensor:
    """[..., 3] int coords (<= 21 bits each) → [...] int64 key top << 60 |
    mid << 30 | lo (non-negative: top has 3 bits)."""
    top, mid, lo = (w.to(torch.int64) for w in morton63(q))
    return (top << 60) | (mid << 30) | lo


def morton_order(q: Tensor) -> Tensor:
    """Permutation sorting points by Morton code (21-bit coords), ties in
    index order. q: [..., N, 3] int → [..., N] int32."""
    return torch.sort(morton_key(q), dim=-1, stable=True).indices.to(torch.int32)


def invert_permutation(perm: Tensor) -> Tensor:
    """inv[perm[i]] = i, batched over leading axes (int32)."""
    n = perm.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=perm.device).expand(perm.shape)
    inv = torch.zeros(perm.shape, dtype=torch.int32, device=perm.device)
    return inv.scatter(-1, perm.to(torch.int64), idx)
