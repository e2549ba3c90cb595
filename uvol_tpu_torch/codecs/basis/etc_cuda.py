"""ETC1 image encode/decode on the card — counterpart of `etc_pallas.py`.

`encode_etc1_images` and `decode_etc1_images` are the entry points the
texture codec calls. The device of the tensor decides the route:

  - a CUDA tensor launches the hand-written kernels of `csrc/etc1.cu`
    (K1 encode, K2 decode), built by `_build` at first use; a build or
    launch failure raises, nothing falls back;
  - a CPU tensor goes through the plain twins of `etc.py`.

Each kernel launch adds one to `LAUNCHES[name]`, so a run can show that
its main path went through the kernels.

Word layout is `[L*nb, 2]` int32 (uint32 bit patterns), blocks
frame-major in raster order — the host wire order, so no relayout is
needed on either side. `pack_words2`/`unpack_words2` convert to and from
the `[L, nb, 2]` uint32 host arrays (copies of the reference's helpers,
adapted to this layout).
"""

from __future__ import annotations

import numpy as np
import torch

from uvol_tpu_torch import _build
from uvol_tpu_torch.codecs.basis.etc import (
    blocks_to_image,
    decode_etc1_blocks,
    encode_etc1_blocks,
    image_to_blocks,
)

Tensor = torch.Tensor

#: kernel launches per kernel since the last reset (plain-twin calls
#: are not counted)
LAUNCHES = {"etc1_encode": 0, "etc1_decode": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_dims(h: int, w: int) -> None:
    if h % 4 or w % 4:
        raise ValueError(f"ETC1 needs H and W divisible by 4, got {h}x{w}")


def _launch(name: str, fn: str, src: Tensor, dst: Tensor, l: int, h: int, w: int) -> None:
    _build.launch(fn, src.device, src.data_ptr(), dst.data_ptr(), l, h, w)
    LAUNCHES[name] += 1


def encode_etc1_images_plain(images: Tensor) -> Tensor:
    """Plain twin of K1 on any device: [L, H, W, 3] uint8 → [L*nb, 2]."""
    l, h, w, _ = images.shape
    return encode_etc1_blocks(image_to_blocks(images).reshape(-1, 4, 4, 3))


def decode_etc1_images_plain(words: Tensor, l: int, h: int, w: int) -> Tensor:
    """Plain twin of K2 on any device: [L*nb, 2] → [L, H, W, 3] uint8."""
    blocks = decode_etc1_blocks(words).reshape(l, (h // 4) * (w // 4), 4, 4, 3)
    return blocks_to_image(blocks, h, w)


def encode_etc1_images(images: Tensor) -> Tensor:
    """[L, H, W, 3] uint8 → [L*nb, 2] int32 ETC1 words (nb = H/4 * W/4)."""
    if images.dtype != torch.uint8 or images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(
            f"expected [L, H, W, 3] uint8, got {tuple(images.shape)} {images.dtype}"
        )
    l, h, w, _ = images.shape
    _check_dims(h, w)
    if images.device.type == "cpu":
        return encode_etc1_images_plain(images)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    images = images.contiguous()
    out = torch.empty((l * (h // 4) * (w // 4), 2), dtype=torch.int32,
                      device=images.device)
    _launch("etc1_encode", "uvt_etc1_encode", images, out, l, h, w)
    return out


def decode_etc1_images(words: Tensor, l: int, h: int, w: int) -> Tensor:
    """[L*nb, 2] int32 ETC1 words → [L, H, W, 3] uint8."""
    _check_dims(h, w)
    nb = (h // 4) * (w // 4)
    if words.dtype != torch.int32 or tuple(words.shape) != (l * nb, 2):
        raise ValueError(
            f"expected [{l * nb}, 2] int32 words, got {tuple(words.shape)} "
            f"{words.dtype}"
        )
    if words.device.type == "cpu":
        return decode_etc1_images_plain(words, l, h, w)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    words = words.contiguous()
    if words.data_ptr() % 8:  # the kernel reads a block's word pair as one 8-byte load
        words = words.clone()
    out = torch.empty((l, h, w, 3), dtype=torch.uint8, device=words.device)
    _launch("etc1_decode", "uvt_etc1_decode", words, out, l, h, w)
    return out


def pack_words2(words: Tensor, l: int) -> np.ndarray:
    """Device [L*nb, 2] int32 → host wire [L, nb, 2] uint32 (numpy)."""
    a = words.detach().cpu().numpy().view(np.uint32)
    return np.ascontiguousarray(a.reshape(l, -1, 2))


def unpack_words2(words: np.ndarray) -> np.ndarray:
    """Host wire [L, nb, 2] uint32 → device-layout [L*nb, 2] int32."""
    a = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1, 2)
    return a.view(np.int32)
