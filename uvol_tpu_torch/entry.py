"""The fused per-batch encode step — counterpart of `__graft_entry__.entry`.

Geometry quantize + delta + zigzag on the interleaved [F, N, C] layout,
and the ETC1 encode of the texture layers (kernel K1 on a card, its
plain twin on the CPU), from the same numpy inputs as the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from uvol_tpu_torch._device import DeviceLike, resolve_device
from uvol_tpu_torch.codecs.basis.etc_cuda import encode_etc1_images
from uvol_tpu_torch.ops.prediction import delta_encode
from uvol_tpu_torch.ops.quantize import quantize, zigzag_encode


def forward(positions, uvs, mask, textures):
    """positions [F, N, 3] f32, uvs [F, N, 2] f32, mask [F, N] bool,
    textures [F, H, W, 3] uint8 → symbols (int32 bit patterns of the
    reference's uint32), per-frame min/range and [F, nb, 2] ETC1 words."""
    qp = quantize(positions, 11, mask=mask)
    qu = quantize(uvs, 10, mask=mask)
    f = textures.shape[0]
    return {
        "pos_syms": zigzag_encode(delta_encode(qp.values)),
        "uv_syms": zigzag_encode(delta_encode(qu.values)),
        "pos_min": qp.min_value,
        "pos_range": qp.range_value,
        "uv_min": qu.min_value,
        "uv_range": qu.range_value,
        "tex_words": encode_etc1_images(textures).reshape(f, -1, 2),
    }


def example_inputs(f: int = 4, n: int = 4096, size: int = 128):
    """The reference's numpy example batch, from `default_rng(0)`."""
    r = np.random.default_rng(0)
    return (
        r.normal(size=(f, n, 3)).astype(np.float32),
        r.uniform(size=(f, n, 2)).astype(np.float32),
        np.ones((f, n), bool),
        r.integers(0, 256, (f, size, size, 3)).astype(np.uint8),
    )


def entry(device: DeviceLike = None):
    """(forward, example_args) with the example batch on `device`."""
    dev = resolve_device(device)
    return forward, tuple(torch.from_numpy(a).to(dev) for a in example_inputs())
