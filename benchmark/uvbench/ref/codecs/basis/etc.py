# Frozen copy of the program's `codecs/basis/etc.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""ETC1 block codec, plain PyTorch — twin of `uvol_tpu/codecs/basis/etc.py`.

These are the reference's batched formulas written in torch int32, with
the same float32 op order in the 5-bit mean, the same first-minimum
argmins and the same strict-`<` tie rules, so their words and pixels are
identical to the JAX package's. They are the CPU path of
`etc_cuda.encode_etc1_images`/`decode_etc1_images` and the oracle that
the CUDA kernels in `csrc/etc1.cu` are held against on the card.

Words are `[B, 2]` int32 tensors holding the uint32 bit patterns of
(word1, word2): PyTorch's uint32 supports few operations, so the
unsigned view is taken at the numpy boundary only.

Blocks are processed in chunks of `CHUNK` so a 32 x 1024² batch (2M
blocks) stays within a few hundred MB of temporaries.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from uvbench.ref.device import true_div

Tensor = torch.Tensor

#: modifier magnitudes (small, large) per table index; pixel bits map
#: msb=sign (1 → negative), lsb=magnitude (1 → large). Copy of
#: `uvol_tpu.codecs.basis.etc.MODIFIER_TABLE`.
MODIFIER_TABLE = np.array(
    [
        [2, 8], [5, 17], [9, 29], [13, 42],
        [18, 60], [24, 80], [33, 106], [47, 183],
    ],
    np.int32,
)

# per-pixel modifier values per table: [8 tables, 4 codes] =
# (+small, +large, -small, -large)
_MODS = np.stack(
    [MODIFIER_TABLE[:, 0], MODIFIER_TABLE[:, 1],
     -MODIFIER_TABLE[:, 0], -MODIFIER_TABLE[:, 1]],
    axis=1,
)

#: pass-1 mask sentinel — above any subblock ranking total
_RANK_MASK = 1 << 30

#: blocks per chunk of the plain twins
CHUNK = 65536


def _subblock_positions(flip: int) -> Tuple[np.ndarray, np.ndarray]:
    """Wire bit index j = x*4+y of each subblock pixel, in the order the
    subblocks are flattened ((y, x) row-major inside the half)."""
    if flip:  # two 2-row halves
        pos0 = [x * 4 + y for y in range(2) for x in range(4)]
        pos1 = [x * 4 + y for y in range(2, 4) for x in range(4)]
    else:  # two 2-column halves
        pos0 = [x * 4 + y for y in range(4) for x in range(2)]
        pos1 = [x * 4 + y for y in range(4) for x in range(2, 4)]
    return np.array(pos0), np.array(pos1)


def _extend5(c: Tensor) -> Tensor:
    return (c << 3) | (c >> 2)


def _extend4(c: Tensor) -> Tensor:
    return (c << 4) | c


def _to_i32_bits(v: Tensor) -> Tensor:
    """int64 values in [0, 2^32) → int32 with the same low 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _mean_quant5(sub: Tensor) -> Tensor:
    """[B, 8, 3] int32 → [B, 3] int32 5-bit means, in the reference's
    float32 order: sum*0.125 (= mean, exact), *31, /255 (IEEE, see
    `true_div`), round half to even, clip 0..31."""
    mean = sub.sum(dim=1).to(torch.float32) * 0.125
    q = torch.round(true_div(mean * 31.0, 255.0))
    return torch.clamp(q, 0, 31).to(torch.int32)


def _best_table_and_codes(
    pixels: Tensor, base: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """pixels [B, 8, 3] int32, base [B, 3] extended color → (table [B],
    codes [B, 8], err [B]). Pass 1 ranks the 8 tables by the unclipped
    linear error model; pass 2 evaluates the top two exactly and keeps
    the better (ties keep the pass-1 order)."""
    mods = torch.as_tensor(_MODS, device=pixels.device)  # [8, 4]
    g = pixels.sum(dim=-1)  # [B, 8]
    sb = base.sum(dim=-1)
    sb2 = (base * base).sum(dim=-1)
    m = mods[None]  # [1, 8, 4]
    k_lin = sb2[:, None, None] + 2 * m * sb[:, None, None] + 3 * m * m
    q = k_lin[..., None] - 2 * m[..., None] * g[:, None, None, :]  # [B,8,4,8]
    tot = q.amin(dim=-2).sum(dim=-1)  # [B, 8]
    t_first = tot.argmin(dim=-1)  # first minimum wins ties
    masked = tot.scatter(1, t_first[:, None], _RANK_MASK)
    t_second = masked.argmin(dim=-1)

    def exact(ti: Tensor) -> Tuple[Tensor, Tensor]:
        mods_t = mods[ti]  # [B, 4]
        cand = torch.clamp(base[:, None, :] + mods_t[:, :, None], 0, 255)
        diff = cand[:, :, None, :] - pixels[:, None, :, :]  # [B, 4, 8, 3]
        err = (diff * diff).sum(dim=-1)  # [B, 4code, 8pix]
        return err.argmin(dim=-2), err.amin(dim=-2).sum(dim=-1)

    c1, e1 = exact(t_first)
    c2, e2 = exact(t_second)
    better = e2 < e1  # strict: pass-1 winner keeps ties
    table_idx = torch.where(better, t_second, t_first)
    codes = torch.where(better[:, None], c2, c1)
    return table_idx, codes, torch.where(better, e2, e1)


def _encode_chunk(blocks: Tensor) -> Tensor:
    blocks = blocks.to(torch.int32)  # [B, 4, 4, 3] (y, x, c)
    dev = blocks.device
    results = []
    for flip in (0, 1):
        if flip:
            sub0 = blocks[:, 0:2, :, :].reshape(-1, 8, 3)
            sub1 = blocks[:, 2:4, :, :].reshape(-1, 8, 3)
        else:
            sub0 = blocks[:, :, 0:2, :].reshape(-1, 8, 3)
            sub1 = blocks[:, :, 2:4, :].reshape(-1, 8, 3)
        m0 = _mean_quant5(sub0)
        m1 = _mean_quant5(sub1)
        d = torch.clamp(m1 - m0, -4, 3)  # differential: 3-bit delta
        t0, c0, e0 = _best_table_and_codes(sub0, _extend5(m0))
        t1, c1, e1 = _best_table_and_codes(sub1, _extend5(m0 + d))
        m0l, dul = m0.to(torch.int64), (d & 0x7).to(torch.int64)
        word1 = (
            (m0l[:, 0] << 27) | (dul[:, 0] << 24)
            | (m0l[:, 1] << 19) | (dul[:, 1] << 16)
            | (m0l[:, 2] << 11) | (dul[:, 2] << 8)
            | (t0 << 5) | (t1 << 2) | (1 << 1) | flip
        )
        p0, p1 = (torch.as_tensor(p, device=dev) for p in _subblock_positions(flip))
        word2 = (
            ((c0 & 1) << p0).sum(-1) + ((c1 & 1) << p1).sum(-1)
            + ((c0 >> 1) << (p0 + 16)).sum(-1) + ((c1 >> 1) << (p1 + 16)).sum(-1)
        )
        results.append((word1, word2, e0 + e1))
    (w1a, w2a, ea), (w1b, w2b, eb) = results
    use1 = eb < ea  # strict: flip 0 keeps ties
    word1 = torch.where(use1, w1b, w1a)
    word2 = torch.where(use1, w2b, w2a)
    return _to_i32_bits(torch.stack([word1, word2], dim=1))


def encode_etc1_blocks(blocks: Tensor) -> Tensor:
    """Encode [B, 4, 4, 3] uint8 blocks → [B, 2] int32 (word1, word2 bits).

    Differential mode with flip search: subblocks are the two 2x4 column
    halves (flip=0) or 4x2 row halves (flip=1); base colors are the 5-bit
    means; modifier tables by the two-pass search."""
    if blocks.ndim != 4 or tuple(blocks.shape[1:]) != (4, 4, 3):
        raise ValueError(f"expected [B, 4, 4, 3] blocks, got {tuple(blocks.shape)}")
    out = [_encode_chunk(blocks[i : i + CHUNK]) for i in range(0, len(blocks), CHUNK)]
    if not out:
        return torch.empty((0, 2), dtype=torch.int32, device=blocks.device)
    return torch.cat(out)


def _select8(table: Tensor, vals: np.ndarray) -> Tensor:
    return torch.as_tensor(vals, device=table.device)[table]


def _decode_chunk(words: Tensor) -> Tensor:
    w1 = words[:, 0].to(torch.int64) & 0xFFFFFFFF
    w2 = words[:, 1].to(torch.int64) & 0xFFFFFFFF
    diff = (w1 >> 1) & 1
    flip = w1 & 1
    t0 = (w1 >> 5) & 7
    t1 = (w1 >> 2) & 7

    def channels(shifts, mask):
        return torch.stack([(w1 >> s) & mask for s in shifts], dim=-1)

    m0 = channels((27, 19, 11), 31)  # differential base colors
    draw = channels((24, 16, 8), 7)
    d = torch.where(draw >= 4, draw - 8, draw)
    base0_d = _extend5(m0)
    base1_d = _extend5(torch.clamp(m0 + d, 0, 31))
    i0 = channels((28, 20, 12), 15)  # individual base colors
    i1 = channels((24, 16, 8), 15)
    is_diff = diff[:, None] == 1
    base0 = torch.where(is_diff, base0_d, _extend4(i0))
    base1 = torch.where(is_diff, base1_d, _extend4(i1))

    j = torch.arange(16, device=words.device)
    lsb = (w2[:, None] >> j) & 1
    msb = (w2[:, None] >> (j + 16)) & 1  # [B, 16], j = x*4+y
    x, y = j // 4, j % 4
    in_sub1 = torch.where(flip[:, None] == 1, y[None, :] >= 2, x[None, :] >= 2)
    table = torch.where(in_sub1, t1[:, None], t0[:, None])
    mag = torch.where(
        lsb == 1,
        _select8(table, MODIFIER_TABLE[:, 1]),
        _select8(table, MODIFIER_TABLE[:, 0]),
    )
    mod = torch.where(msb == 1, -mag, mag)  # code msb = sign
    base = torch.where(in_sub1[..., None], base1[:, None, :], base0[:, None, :])
    rgb = torch.clamp(base + mod[..., None], 0, 255).to(torch.uint8)
    # j = x*4+y → [B, x, y, 3] → [B, y, x, 3]
    return rgb.reshape(-1, 4, 4, 3).transpose(1, 2).contiguous()


def decode_etc1_blocks(words: Tensor) -> Tensor:
    """Decode [B, 2] int32 (or any integer) words → [B, 4, 4, 3] uint8,
    both differential and individual base colors."""
    if words.ndim != 2 or words.shape[1] != 2:
        raise ValueError(f"expected [B, 2] words, got {tuple(words.shape)}")
    out = [_decode_chunk(words[i : i + CHUNK]) for i in range(0, len(words), CHUNK)]
    if not out:
        return torch.empty((0, 4, 4, 3), dtype=torch.uint8, device=words.device)
    return torch.cat(out)


def image_to_blocks(img: Tensor) -> Tensor:
    """[..., H, W, 3] → [..., H//4 * W//4, 4, 4, 3] in raster block order."""
    *lead, h, w, c = img.shape
    img = img.reshape(*lead, h // 4, 4, w // 4, 4, c).transpose(-4, -3)
    return img.reshape(*lead, (h // 4) * (w // 4), 4, 4, c)


def blocks_to_image(blocks: Tensor, h: int, w: int) -> Tensor:
    *lead, _n, _, _, c = blocks.shape
    img = blocks.reshape(*lead, h // 4, w // 4, 4, 4, c).transpose(-4, -3)
    return img.reshape(*lead, h, w, c)


def pack_etc1_payload(words: np.ndarray) -> bytes:
    """[B, 2] uint32 (or int32 bits) → big-endian byte stream (ETC1/ETC2
    file order). Copy of the reference's, taking the unsigned view."""
    words = np.asarray(words)
    if words.dtype == np.int32:
        words = words.view(np.uint32)
    return np.asarray(words, dtype=">u4").tobytes()


def unpack_etc1_payload(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=">u4").astype(np.uint32).reshape(-1, 2)
