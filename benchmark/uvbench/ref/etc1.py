"""The plain reference of the raw ETC1 `.ktx2` segment, in numpy and plain
PyTorch, written from the wire format: KTX2 with vk_format 147 (ETC2 RGB),
one level, `L` layers, no supercompression; the payload is every layer's
ETC1 blocks in raster order, each block's two words big-endian, from the
frozen plain encoder `ref.codecs.basis.etc`.
"""

from __future__ import annotations

import numpy as np
import torch

from uvbench.ref.codecs.basis import etc as etc_ref
from uvbench.ref.containers.ktx2 import KTX2Header, KTX2Level, read_ktx2, write_ktx2

VK_FORMAT_ETC2_R8G8B8_UNORM_BLOCK = 147


def etc1_words(layers: np.ndarray, device="cpu", mean_dtype=None) -> np.ndarray:
    """[L, H, W, 3] uint8 → [L * nb, 2] uint32 ETC1 words by the frozen plain
    encoder on `device`. `mean_dtype` (the control only) computes the 5-bit
    means in that lower precision instead of float32."""
    img = torch.from_numpy(np.ascontiguousarray(layers)).to(device)
    blocks = etc_ref.image_to_blocks(img).reshape(-1, 4, 4, 3)
    if mean_dtype is None:
        words = etc_ref.encode_etc1_blocks(blocks)
    else:
        saved = etc_ref._mean_quant5
        def low(sub):
            mean = (sub.sum(dim=1).to(mean_dtype) * 0.125)
            q = torch.round(mean * 31.0 / 255.0).float()
            return torch.clamp(q, 0, 31).to(torch.int32)
        etc_ref._mean_quant5 = low
        try:
            words = etc_ref.encode_etc1_blocks(blocks)
        finally:
            etc_ref._mean_quant5 = saved
    return words.cpu().numpy().view(np.uint32)


def etc1_segment(layers: np.ndarray, device="cpu", mean_dtype=None) -> bytes:
    """One raw ETC1 `.ktx2` segment of `L` layers."""
    l, h, w, _ = layers.shape
    payload = etc_ref.pack_etc1_payload(etc1_words(layers, device, mean_dtype))
    header = KTX2Header(vk_format=VK_FORMAT_ETC2_R8G8B8_UNORM_BLOCK, type_size=1,
                        pixel_width=w, pixel_height=h, pixel_depth=0, layer_count=l,
                        face_count=1, level_count=1, supercompression_scheme=0)
    return write_ktx2(header, [KTX2Level(payload, len(payload))])


def etc1_decode_segment(data: bytes, device="cpu") -> np.ndarray:
    """[L, H, W, 3] uint8 layers of a raw ETC1 `.ktx2` segment."""
    f = read_ktx2(data)
    h, w, l = f.header.pixel_height, f.header.pixel_width, max(f.header.layer_count, 1)
    nb = (h // 4) * (w // 4)
    words = etc_ref.unpack_etc1_payload(f.level_payload(0)[: l * nb * 8])
    t = torch.from_numpy(words.view(np.int32).copy()).to(device)
    blocks = etc_ref.decode_etc1_blocks(t).reshape(l, nb, 4, 4, 3)
    return etc_ref.blocks_to_image(blocks, h, w).cpu().numpy()
