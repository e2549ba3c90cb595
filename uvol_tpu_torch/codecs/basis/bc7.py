"""BC7 (BPTC) block codec: modes 5 and 6 — the UASTC→BC7 device target.

The reference's KTX2Loader transcodes UASTC to BC7 on desktop GPUs
(FORMAT_OPTIONS priority 2, src/lib/KTX2Loader.js:591-697).
This module implements the two BC7 modes that cover the transcode:

  mode 6 — one subset, RGBA 7.7.7.7 + per-endpoint P bit, 4-bit indices:
           the high-quality single-plane carrier.
  mode 5 — one subset, RGB 7.7.7 + alpha 8.8 with SEPARATE 2-bit alpha
           indices (+ channel rotation): the dual-plane/alpha carrier.

`transcode_uastc_to_bc7` maps UASTC-profile blocks (codecs/basis/uastc.py)
onto these: single-subset modes requantize endpoints/weights directly;
multi-subset and dual-plane blocks are refit from their decoded pixels
(the same decode-and-refit fallback basisu's transcoder uses for configs
BC7 cannot carry structurally). Output is real BPTC wire — validated
bit-exactly against Mesa llvmpipe's GL_ARB_texture_compression_bptc
decoder (native/astc_oracle.decode_blocks_gl) in tests/test_bc7.py.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

#: BC7 interpolation weight tables (per index precision)
AWEIGHT2 = np.array([0, 21, 43, 64])
AWEIGHT3 = np.array([0, 9, 18, 27, 37, 46, 55, 64])
# oracle-verified (llvmpipe BPTC): note 51/55, not the often-misquoted 52/56
AWEIGHT4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                     60, 64])


class _Bits:
    def __init__(self, value: int = 0):
        self.v = value
        self.pos = 0

    def put(self, value: int, width: int) -> None:
        self.v |= (int(value) & ((1 << width) - 1)) << self.pos
        self.pos += width

    def get(self, width: int) -> int:
        out = (self.v >> self.pos) & ((1 << width) - 1)
        self.pos += width
        return out

    def bytes16(self) -> bytes:
        return self.v.to_bytes(16, "little")


def _interp(e0: np.ndarray, e1: np.ndarray, w: int) -> np.ndarray:
    return (e0.astype(np.int64) * (64 - w) + e1.astype(np.int64) * w + 32) >> 6


# ---------------------------------------------------------------------------
# Pack
# ---------------------------------------------------------------------------


def pack_bc7_mode6(
    e0: Sequence[int], e1: Sequence[int], weights: Sequence[int]
) -> bytes:
    """e0/e1: RGBA8 endpoints; weights: 16 indices 0..15 (AWEIGHT4).

    Handles the anchor constraint (index 0 MSB must be 0) by swapping
    endpoints + inverting indices when needed; P bits from the endpoint
    LSBs (per-endpoint, shared across channels — chosen by majority)."""
    e0 = np.asarray(e0, np.int64)
    e1 = np.asarray(e1, np.int64)
    weights = list(weights)
    if weights[0] >= 8:
        e0, e1 = e1, e0
        weights = [15 - w for w in weights]
    b = _Bits()
    b.put(1 << 6, 7)  # mode 6
    p0 = int(round(float(np.mean(e0 & 1))))
    p1 = int(round(float(np.mean(e1 & 1))))

    def q7(v, p):
        return int(np.clip((int(v) - p) >> 1, 0, 127))

    for c in range(4):
        b.put(q7(e0[c], p0), 7)
        b.put(q7(e1[c], p1), 7)
    b.put(p0, 1)
    b.put(p1, 1)
    b.put(weights[0], 3)  # anchor: MSB implied 0
    for w in weights[1:]:
        b.put(w, 4)
    assert b.pos == 128
    return b.bytes16()


def pack_bc7_mode5(
    rot: int,
    e0_rgb: Sequence[int], e1_rgb: Sequence[int],
    a0: int, a1: int,
    color_idx: Sequence[int], alpha_idx: Sequence[int],
) -> bytes:
    """rot: channel rotation (0 none; 1/2/3 swap A with R/G/B).
    Color endpoints RGB8 (quantized to 7 bits), alpha endpoints 8-bit
    exact, 2-bit index planes with their anchor constraints."""
    e0 = np.asarray(e0_rgb, np.int64)
    e1 = np.asarray(e1_rgb, np.int64)
    color_idx = list(color_idx)
    alpha_idx = list(alpha_idx)
    if color_idx[0] >= 2:
        e0, e1 = e1, e0
        color_idx = [3 - w for w in color_idx]
    if alpha_idx[0] >= 2:
        a0, a1 = a1, a0
        alpha_idx = [3 - w for w in alpha_idx]
    b = _Bits()
    b.put(1 << 5, 6)  # mode 5
    b.put(rot, 2)
    for c in range(3):
        b.put(int(e0[c]) >> 1, 7)
        b.put(int(e1[c]) >> 1, 7)
    b.put(int(a0), 8)
    b.put(int(a1), 8)
    b.put(color_idx[0], 1)
    for w in color_idx[1:]:
        b.put(w, 2)
    b.put(alpha_idx[0], 1)
    for w in alpha_idx[1:]:
        b.put(w, 2)
    assert b.pos == 128
    return b.bytes16()


# ---------------------------------------------------------------------------
# Mode 1 (2 subsets) — partition/anchor tables extracted empirically from
# the Mesa BPTC decoder (native/astc_oracle.py probe blocks), matching the
# canonical BC7 tables
# ---------------------------------------------------------------------------

#: [64][16] texel -> subset for 2-subset partitions
BC7_PARTITIONS2 = np.array([
    [0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1],
    [0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1],
    [0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1],
    [0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1],
    [0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1],
    [0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1],
    [0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1],
    [0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1],
    [0,0,0,0,1,0,0,0,1,1,1,0,1,1,1,1],
    [0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0],
    [0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0],
    [0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0],
    [0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0],
    [0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1],
    [0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0],
    [0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0],
    [0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0],
    [0,0,1,1,0,1,1,0,0,1,1,0,1,1,0,0],
    [0,0,0,1,0,1,1,1,1,1,1,0,1,0,0,0],
    [0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0],
    [0,1,1,1,0,0,0,1,1,0,0,0,1,1,1,0],
    [0,0,1,1,1,0,0,1,1,0,0,1,1,1,0,0],
    [0,1,0,1,0,1,0,1,0,1,0,1,0,1,0,1],
    [0,0,0,0,1,1,1,1,0,0,0,0,1,1,1,1],
    [0,1,0,1,1,0,1,0,0,1,0,1,1,0,1,0],
    [0,0,1,1,0,0,1,1,1,1,0,0,1,1,0,0],
    [0,0,1,1,1,1,0,0,0,0,1,1,1,1,0,0],
    [0,1,0,1,0,1,0,1,1,0,1,0,1,0,1,0],
    [0,1,1,0,1,0,0,1,0,1,1,0,1,0,0,1],
    [0,1,0,1,1,0,1,0,1,0,1,0,0,1,0,1],
    [0,1,1,1,0,0,1,1,1,1,0,0,1,1,1,0],
    [0,0,0,1,0,0,1,1,1,1,0,0,1,0,0,0],
    [0,0,1,1,0,0,1,0,0,1,0,0,1,1,0,0],
    [0,0,1,1,1,0,1,1,1,1,0,1,1,1,0,0],
    [0,1,1,0,1,0,0,1,1,0,0,1,0,1,1,0],
    [0,0,1,1,1,1,0,0,1,1,0,0,0,0,1,1],
    [0,1,1,0,0,1,1,0,1,0,0,1,1,0,0,1],
    [0,0,0,0,0,1,1,0,0,1,1,0,0,0,0,0],
    [0,1,0,0,1,1,1,0,0,1,0,0,0,0,0,0],
    [0,0,1,0,0,1,1,1,0,0,1,0,0,0,0,0],
    [0,0,0,0,0,0,1,0,0,1,1,1,0,0,1,0],
    [0,0,0,0,0,1,0,0,1,1,1,0,0,1,0,0],
    [0,1,1,0,1,1,0,0,1,0,0,1,0,0,1,1],
    [0,0,1,1,0,1,1,0,1,1,0,0,1,0,0,1],
    [0,1,1,0,0,0,1,1,1,0,0,1,1,1,0,0],
    [0,0,1,1,1,0,0,1,1,1,0,0,0,1,1,0],
    [0,1,1,0,1,1,0,0,1,1,0,0,1,0,0,1],
    [0,1,1,0,0,0,1,1,0,0,1,1,1,0,0,1],
    [0,1,1,1,1,1,1,0,1,0,0,0,0,0,0,1],
    [0,0,0,1,1,0,0,0,1,1,1,0,0,1,1,1],
    [0,0,0,0,1,1,1,1,0,0,1,1,0,0,1,1],
    [0,0,1,1,0,0,1,1,1,1,1,1,0,0,0,0],
    [0,0,1,0,0,0,1,0,1,1,1,0,1,1,1,0],
    [0,1,0,0,0,1,0,0,0,1,1,1,0,1,1,1]
], np.int64)

#: [64] subset-1 anchor texel per partition (subset 0 anchors at texel 0)
BC7_ANCHORS2 = np.array([15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15], np.int64)


def _e8_mode1(q6: int, p: int) -> int:
    full7 = (q6 << 1) | p
    return (full7 << 1) | (full7 >> 6)


def pack_bc7_mode1(
    part: int,
    e0s0: Sequence[int], e1s0: Sequence[int],
    e0s1: Sequence[int], e1s1: Sequence[int],
    indices: Sequence[int],
) -> bytes:
    """RGB8 endpoint pairs per subset + 16 3-bit indices (AWEIGHT3).

    Quantizes endpoints to 6 bits + one shared P bit per subset and
    enforces both anchor constraints (index MSB 0 at texel 0 and at
    BC7_ANCHORS2[part]) by per-subset endpoint swap + index inversion."""
    sub = BC7_PARTITIONS2[part]
    idx = list(int(i) for i in indices)
    eps = [
        [np.asarray(e0s0, np.int64), np.asarray(e1s0, np.int64)],
        [np.asarray(e0s1, np.int64), np.asarray(e1s1, np.int64)],
    ]
    for s, anchor in ((0, 0), (1, int(BC7_ANCHORS2[part]))):
        if idx[anchor] >= 4:
            eps[s] = [eps[s][1], eps[s][0]]
            for t in range(16):
                if sub[t] == s:
                    idx[t] = 7 - idx[t]
    b = _Bits()
    b.put(0b10, 2)
    b.put(part, 6)
    ps = []
    for s in range(2):
        ps.append(int(round(float(np.mean(
            np.concatenate([eps[s][0], eps[s][1]]) >> 1 & 1)))))
    qs = [[np.clip(((e.astype(np.int64)) - (p << 1)) >> 2, 0, 63)
           for e in eps[s]] for s, p in zip(range(2), ps)]
    for c in range(3):
        b.put(int(qs[0][0][c]), 6)
        b.put(int(qs[0][1][c]), 6)
        b.put(int(qs[1][0][c]), 6)
        b.put(int(qs[1][1][c]), 6)
    b.put(ps[0], 1)
    b.put(ps[1], 1)
    anchor1 = int(BC7_ANCHORS2[part])
    for t in range(16):
        b.put(idx[t], 2 if t in (0, anchor1) else 3)
    assert b.pos == 128
    return b.bytes16()


#: [64][16] texel -> subset for 3-subset partitions (GL-extracted)
BC7_PARTITIONS3 = np.array([
    [0,0,1,1,0,0,1,1,0,2,2,1,2,2,2,2],
    [0,0,0,1,0,0,1,1,2,2,1,1,2,2,2,1],
    [0,0,0,0,2,0,0,1,2,2,1,1,2,2,1,1],
    [0,2,2,2,0,0,2,2,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,0,1,1,2,2,1,1,2,2],
    [0,0,1,1,0,0,1,1,0,0,2,2,0,0,2,2],
    [0,0,2,2,0,0,2,2,1,1,1,1,1,1,1,1],
    [0,0,1,1,0,0,1,1,2,2,1,1,2,2,1,1],
    [0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2],
    [0,0,0,0,1,1,1,1,1,1,1,1,2,2,2,2],
    [0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2],
    [0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2],
    [0,1,1,2,0,1,1,2,0,1,1,2,0,1,1,2],
    [0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2],
    [0,0,1,1,0,1,1,2,1,1,2,2,1,2,2,2],
    [0,0,1,1,2,0,0,1,2,2,0,0,2,2,2,0],
    [0,0,0,1,0,0,1,1,0,1,1,2,1,1,2,2],
    [0,1,1,1,0,0,1,1,2,0,0,1,2,2,0,0],
    [0,0,0,0,1,1,2,2,1,1,2,2,1,1,2,2],
    [0,0,2,2,0,0,2,2,0,0,2,2,1,1,1,1],
    [0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2],
    [0,0,0,1,0,0,0,1,2,2,2,1,2,2,2,1],
    [0,0,0,0,0,0,1,1,0,1,2,2,0,1,2,2],
    [0,0,0,0,1,1,0,0,2,2,1,0,2,2,1,0],
    [0,1,2,2,0,1,2,2,0,0,1,1,0,0,0,0],
    [0,0,1,2,0,0,1,2,1,1,2,2,2,2,2,2],
    [0,1,1,0,1,2,2,1,1,2,2,1,0,1,1,0],
    [0,0,0,0,0,1,1,0,1,2,2,1,1,2,2,1],
    [0,0,2,2,1,1,0,2,1,1,0,2,0,0,2,2],
    [0,1,1,0,0,1,1,0,2,0,0,2,2,2,2,2],
    [0,0,1,1,0,1,2,2,0,1,2,2,0,0,1,1],
    [0,0,0,0,2,0,0,0,2,2,1,1,2,2,2,1],
    [0,0,0,0,0,0,0,2,1,1,2,2,1,2,2,2],
    [0,2,2,2,0,0,2,2,0,0,1,2,0,0,1,1],
    [0,0,1,1,0,0,1,2,0,0,2,2,0,2,2,2],
    [0,1,2,0,0,1,2,0,0,1,2,0,0,1,2,0],
    [0,0,0,0,1,1,1,1,2,2,2,2,0,0,0,0],
    [0,1,2,0,1,2,0,1,2,0,1,2,0,1,2,0],
    [0,1,2,0,2,0,1,2,1,2,0,1,0,1,2,0],
    [0,0,1,1,2,2,0,0,1,1,2,2,0,0,1,1],
    [0,0,1,1,1,1,2,2,2,2,0,0,0,0,1,1],
    [0,1,0,1,0,1,0,1,2,2,2,2,2,2,2,2],
    [0,0,0,0,0,0,0,0,2,1,2,1,2,1,2,1],
    [0,0,2,2,1,1,2,2,0,0,2,2,1,1,2,2],
    [0,0,2,2,0,0,1,1,0,0,2,2,0,0,1,1],
    [0,2,2,0,1,2,2,1,0,2,2,0,1,2,2,1],
    [0,1,0,1,2,2,2,2,2,2,2,2,0,1,0,1],
    [0,0,0,0,2,1,2,1,2,1,2,1,2,1,2,1],
    [0,1,0,1,0,1,0,1,0,1,0,1,2,2,2,2],
    [0,2,2,2,0,1,1,1,0,2,2,2,0,1,1,1],
    [0,0,0,2,1,1,1,2,0,0,0,2,1,1,1,2],
    [0,0,0,0,2,1,1,2,2,1,1,2,2,1,1,2],
    [0,2,2,2,0,1,1,1,0,1,1,1,0,2,2,2],
    [0,0,0,2,1,1,1,2,1,1,1,2,0,0,0,2],
    [0,1,1,0,0,1,1,0,0,1,1,0,2,2,2,2],
    [0,0,0,0,0,0,0,0,2,1,1,2,2,1,1,2],
    [0,1,1,0,0,1,1,0,2,2,2,2,2,2,2,2],
    [0,0,2,2,0,0,1,1,0,0,1,1,0,0,2,2],
    [0,0,2,2,1,1,2,2,1,1,2,2,0,0,2,2],
    [0,0,0,0,0,0,0,0,0,0,0,0,2,1,1,2],
    [0,0,0,2,0,0,0,1,0,0,0,2,0,0,0,1],
    [0,2,2,2,1,2,2,2,0,2,2,2,1,2,2,2],
    [0,1,0,1,2,2,2,2,2,2,2,2,2,2,2,2],
    [0,1,1,1,2,0,1,1,2,2,0,1,2,2,2,0]
], np.int64)

#: [64] anchor texels for subsets 1 and 2 (subset 0 anchors at texel 0);
#: partitions 59/60 disambiguated by brute-force against the oracle
#: (tiny subsets make the minority-value extraction ambiguous)
BC7_ANCHORS3_A = np.array([3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3], np.int64)
BC7_ANCHORS3_B = np.array([15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8], np.int64)


def _e8_mode2(q5: int) -> int:
    return (q5 << 3) | (q5 >> 2)


def pack_bc7_mode2(
    part: int,
    eps: Sequence[Sequence[Sequence[int]]],  # [3 subsets][2][RGB8]
    indices: Sequence[int],
) -> bytes:
    """RGB8 endpoint pairs for three subsets + 16 2-bit indices
    (AWEIGHT2). Endpoints quantize to 5 bits (bit-replicated back);
    all three anchor constraints enforced by per-subset swap+invert."""
    sub = BC7_PARTITIONS3[part]
    idx = [int(i) for i in indices]
    eps = [
        [np.asarray(eps[s][0], np.int64), np.asarray(eps[s][1], np.int64)]
        for s in range(3)
    ]
    anchor_of = (0, int(BC7_ANCHORS3_A[part]), int(BC7_ANCHORS3_B[part]))
    for s in range(3):
        if idx[anchor_of[s]] >= 2:
            eps[s] = [eps[s][1], eps[s][0]]
            for t in range(16):
                if sub[t] == s:
                    idx[t] = 3 - idx[t]
    b = _Bits()
    b.put(0b100, 3)
    b.put(part, 6)
    for c in range(3):
        for s in range(3):
            b.put(int(eps[s][0][c]) >> 3, 5)
            b.put(int(eps[s][1][c]) >> 3, 5)
    anchors = set(anchor_of)
    for t in range(16):
        b.put(idx[t], 1 if t in anchors else 2)
    assert b.pos == 128
    return b.bytes16()


def _e8_mode7(q5: int, p: int) -> int:
    full6 = (q5 << 1) | p
    return (full6 << 2) | (full6 >> 4)


def pack_bc7_mode7(
    part: int,
    eps: Sequence[Sequence[Sequence[int]]],  # [2 subsets][2][RGBA8]
    indices: Sequence[int],
) -> bytes:
    """RGBA8 endpoint pairs for two subsets + 16 2-bit indices
    (AWEIGHT2). 5-bit channels + per-endpoint P bit; same partition and
    anchor tables as mode 1."""
    sub = BC7_PARTITIONS2[part]
    idx = [int(i) for i in indices]
    eps = [
        [np.asarray(eps[s][0], np.int64), np.asarray(eps[s][1], np.int64)]
        for s in range(2)
    ]
    for s, anchor in ((0, 0), (1, int(BC7_ANCHORS2[part]))):
        if idx[anchor] >= 2:
            eps[s] = [eps[s][1], eps[s][0]]
            for t in range(16):
                if sub[t] == s:
                    idx[t] = 3 - idx[t]
    b = _Bits()
    b.put(1 << 7, 8)  # mode 7
    b.put(part, 6)
    pbits = []
    qs = []
    for s in range(2):
        row = []
        for e in range(2):
            p = int(round(float(np.mean((eps[s][e] >> 2) & 1))))
            pbits.append(p)
            row.append(np.clip((eps[s][e] - (p << 2)) >> 3, 0, 31))
        qs.append(row)
    for c in range(4):
        for s in range(2):
            b.put(int(qs[s][0][c]), 5)
            b.put(int(qs[s][1][c]), 5)
    for p in pbits:
        b.put(p, 1)
    anchor1 = int(BC7_ANCHORS2[part])
    for t in range(16):
        b.put(idx[t], 1 if t in (0, anchor1) else 2)
    assert b.pos == 128
    return b.bytes16()


# ---------------------------------------------------------------------------
# Decode (modes 5/6 — what this packer emits)
# ---------------------------------------------------------------------------


def decode_bc7_block(block: bytes) -> np.ndarray:
    """16-byte BC7 block → [4,4,4] RGBA8 (modes 5/6; other modes raise —
    this decoder covers what transcode_uastc_to_bc7 emits; the GL oracle
    provides full-format coverage in tests)."""
    v = int.from_bytes(block, "little")
    mode = 0
    while mode < 8 and not (v >> mode) & 1:
        mode += 1
    b = _Bits(v)
    out = np.zeros((4, 4, 4), np.uint8)
    if mode == 6:
        b.get(7)
        q = [[0, 0] for _ in range(4)]
        for c in range(4):
            q[c][0] = b.get(7)
            q[c][1] = b.get(7)
        p0 = b.get(1)
        p1 = b.get(1)
        e0 = np.array([(q[c][0] << 1 | p0) for c in range(4)], np.int64)
        e1 = np.array([(q[c][1] << 1 | p1) for c in range(4)], np.int64)
        idx = [b.get(3)]
        for _ in range(15):
            idx.append(b.get(4))
        for t in range(16):
            out[t // 4, t % 4] = _interp(e0, e1, int(AWEIGHT4[idx[t]]))
        return out
    if mode == 5:
        b.get(6)
        rot = b.get(2)
        e = [[0, 0] for _ in range(3)]
        for c in range(3):
            q0 = b.get(7)
            q1 = b.get(7)
            # no P bit in mode 5 color: expand 7→8 by bit replication
            e[c][0] = (q0 << 1) | (q0 >> 6)
            e[c][1] = (q1 << 1) | (q1 >> 6)
        a0 = b.get(8)
        a1 = b.get(8)
        cidx = [b.get(1)]
        for _ in range(15):
            cidx.append(b.get(2))
        aidx = [b.get(1)]
        for _ in range(15):
            aidx.append(b.get(2))
        e0 = np.array([e[0][0], e[1][0], e[2][0]], np.int64)
        e1 = np.array([e[0][1], e[1][1], e[2][1]], np.int64)
        for t in range(16):
            rgb = _interp(e0, e1, int(AWEIGHT2[cidx[t]]))
            a = _interp(np.array([a0]), np.array([a1]),
                        int(AWEIGHT2[aidx[t]]))[0]
            px = np.array([rgb[0], rgb[1], rgb[2], a], np.int64)
            if rot:  # undo channel rotation: A was swapped with rot-1
                px[rot - 1], px[3] = px[3], px[rot - 1]
            out[t // 4, t % 4] = px
        return out
    if mode == 1:
        b.get(2)
        part = b.get(6)
        q = [[[0, 0], [0, 0]] for _ in range(3)]  # [chan][subset][ep]
        for c in range(3):
            q[c][0][0] = b.get(6)
            q[c][0][1] = b.get(6)
            q[c][1][0] = b.get(6)
            q[c][1][1] = b.get(6)
        p0 = b.get(1)
        p1 = b.get(1)
        anchor1 = int(BC7_ANCHORS2[part])
        idx = []
        for t in range(16):
            idx.append(b.get(2 if t in (0, anchor1) else 3))
        sub = BC7_PARTITIONS2[part]
        for t in range(16):
            s = int(sub[t])
            p = p0 if s == 0 else p1
            e0 = np.array([_e8_mode1(q[c][s][0], p) for c in range(3)]
                          + [255], np.int64)
            e1 = np.array([_e8_mode1(q[c][s][1], p) for c in range(3)]
                          + [255], np.int64)
            out[t // 4, t % 4] = _interp(e0, e1, int(AWEIGHT3[idx[t]]))
        return out
    if mode == 2:
        b.get(3)
        part = b.get(6)
        q = [[[0, 0] for _ in range(3)] for _ in range(3)]  # [chan][sub][ep]
        for c in range(3):
            for s in range(3):
                q[c][s][0] = b.get(5)
                q[c][s][1] = b.get(5)
        anchors = {0, int(BC7_ANCHORS3_A[part]), int(BC7_ANCHORS3_B[part])}
        idx = []
        for t in range(16):
            idx.append(b.get(1 if t in anchors else 2))
        sub = BC7_PARTITIONS3[part]
        for t in range(16):
            s = int(sub[t])
            e0 = np.array([_e8_mode2(q[c][s][0]) for c in range(3)] + [255],
                          np.int64)
            e1 = np.array([_e8_mode2(q[c][s][1]) for c in range(3)] + [255],
                          np.int64)
            out[t // 4, t % 4] = _interp(e0, e1, int(AWEIGHT2[idx[t]]))
        return out
    if mode == 7:
        b.get(8)
        part = b.get(6)
        q = [[[0, 0] for _ in range(2)] for _ in range(4)]  # [chan][sub][ep]
        for c in range(4):
            for s in range(2):
                q[c][s][0] = b.get(5)
                q[c][s][1] = b.get(5)
        pb = [b.get(1) for _ in range(4)]  # s0e0, s0e1, s1e0, s1e1
        anchor1 = int(BC7_ANCHORS2[part])
        idx = []
        for t in range(16):
            idx.append(b.get(1 if t in (0, anchor1) else 2))
        sub = BC7_PARTITIONS2[part]
        for t in range(16):
            s = int(sub[t])
            e0 = np.array(
                [_e8_mode7(q[c][s][0], pb[2 * s]) for c in range(4)],
                np.int64,
            )
            e1 = np.array(
                [_e8_mode7(q[c][s][1], pb[2 * s + 1]) for c in range(4)],
                np.int64,
            )
            out[t // 4, t % 4] = _interp(e0, e1, int(AWEIGHT2[idx[t]]))
        return out
    raise NotImplementedError(
        f"bc7 mode {mode} (transcode emits 1/2/5/6/7)"
    )


def decode_bc7_blocks(blocks: np.ndarray) -> np.ndarray:
    blocks = np.asarray(blocks, np.uint8).reshape(-1, 16)
    return np.stack([decode_bc7_block(b.tobytes()) for b in blocks])


# ---------------------------------------------------------------------------
# UASTC -> BC7 transcode
# ---------------------------------------------------------------------------


def _fit_mode6(px: np.ndarray) -> bytes:
    """Refit a decoded 4x4 RGBA block as one BC7 mode-6 block (min/max
    diagonal fit + nearest AWEIGHT4 index — the decode-and-refit fallback
    for configs mode 6 cannot carry structurally)."""
    px = px.reshape(16, 4).astype(np.float64)
    e0 = px.min(axis=0)
    e1 = px.max(axis=0)
    d = e1 - e0
    denom = float((d * d).sum())
    if denom <= 0:
        t = np.zeros(16)
    else:
        t = np.clip(((px - e0) @ d) / denom, 0.0, 1.0)
    w64 = t * 64.0
    idx = np.abs(w64[:, None] - AWEIGHT4[None, :]).argmin(axis=1)
    return pack_bc7_mode6(
        e0.round().astype(np.int64), e1.round().astype(np.int64), idx
    )


def fit_mode6_blocks(px: np.ndarray) -> np.ndarray:
    """Vectorized `_fit_mode6` over B blocks: [B,4,4,4] (or [B,16,4])
    RGBA -> [B,16] uint8 BC7 mode-6 words, byte-identical to the
    per-block path. This is the playback-relevant spec-wire transcode
    (one numpy pass instead of O(B) interpreter calls — r4 advisor)."""
    px = np.asarray(px).reshape(-1, 16, 4).astype(np.float64)
    B = len(px)
    e0 = px.min(axis=1)  # [B,4]
    e1 = px.max(axis=1)
    d = e1 - e0
    denom = (d * d).sum(axis=1)  # [B]
    t = np.einsum("bkc,bc->bk", px - e0[:, None, :], d)
    t = np.clip(t / np.where(denom > 0, denom, 1.0)[:, None], 0.0, 1.0)
    t = np.where((denom > 0)[:, None], t, 0.0)
    idx = np.abs(t[..., None] * 64.0 - AWEIGHT4[None, None, :]).argmin(
        axis=-1
    )  # [B,16]
    e0i = np.round(e0).astype(np.int64)
    e1i = np.round(e1).astype(np.int64)
    # anchor constraint: index 0 MSB must be 0 — swap + invert
    sw = idx[:, 0] >= 8
    e0s = np.where(sw[:, None], e1i, e0i)
    e1s = np.where(sw[:, None], e0i, e1i)
    idx = np.where(sw[:, None], 15 - idx, idx)
    # P bits: majority of the endpoint LSBs (mean of 4 zero/one values
    # rounds half-to-even exactly like the scalar path's round())
    p0 = np.round((e0s & 1).mean(axis=1)).astype(np.int64)
    p1 = np.round((e1s & 1).mean(axis=1)).astype(np.int64)
    q0 = np.clip((e0s - p0[:, None]) >> 1, 0, 127)
    q1 = np.clip((e1s - p1[:, None]) >> 1, 0, 127)
    bits = np.zeros((B, 128), np.uint8)

    def put(pos, vals, width):
        for i in range(width):
            bits[:, pos + i] = (vals >> i) & 1

    bits[:, 6] = 1  # mode 6 marker (1 << 6 in the 7-bit mode field)
    for c in range(4):
        put(7 + 14 * c, q0[:, c], 7)
        put(14 + 14 * c, q1[:, c], 7)
    put(63, p0, 1)
    put(64, p1, 1)
    put(65, idx[:, 0], 3)  # anchor: MSB implied 0
    for k in range(1, 16):
        put(68 + 4 * (k - 1), idx[:, k], 4)
    # LSB-first within each byte (the scalar path's little-endian int)
    return np.packbits(
        bits.reshape(B, 16, 8)[:, :, ::-1], axis=-1
    ).reshape(B, 16)


_PART2_CACHE: dict = {}


def _best_partition2(seed: int) -> Tuple[int, bool]:
    """Best-agreement BC7 2-subset partition for an ASTC hash52 seed's
    pattern (cached); returns (partition, swap) where swap means the
    ASTC subsets map to BC7 subsets reversed."""
    hit = _PART2_CACHE.get(seed)
    if hit is not None:
        return hit
    from uvol_tpu_torch.codecs.basis.uastc import astc_partition_4x4

    pat = np.asarray(astc_partition_4x4(seed, 2), np.int64)  # [16]
    agree = (BC7_PARTITIONS2 == pat[None, :]).sum(axis=1)    # [64]
    agree_sw = (BC7_PARTITIONS2 == (1 - pat)[None, :]).sum(axis=1)
    if int(agree.max()) >= int(agree_sw.max()):
        res = (int(agree.argmax()), False)
    else:
        res = (int(agree_sw.argmax()), True)
    _PART2_CACHE[seed] = res
    return res


_PART3_CACHE: dict = {}


def _best_partition3(seed: int) -> Tuple[int, Tuple[int, int, int]]:
    """Best-agreement BC7 3-subset partition for an ASTC hash52 seed's
    3-subset pattern; returns (partition, perm) where perm maps ASTC
    subset id -> BC7 subset id."""
    hit = _PART3_CACHE.get(seed)
    if hit is not None:
        return hit
    import itertools

    from uvol_tpu_torch.codecs.basis.uastc import astc_partition_4x4

    pat = np.asarray(astc_partition_4x4(seed, 3), np.int64)
    best = (-1, 0, (0, 1, 2))
    for perm in itertools.permutations(range(3)):
        mapped = np.asarray(perm, np.int64)[pat]
        agree = (BC7_PARTITIONS3 == mapped[None, :]).sum(axis=1)
        k = int(agree.argmax())
        if int(agree[k]) > best[0]:
            best = (int(agree[k]), k, perm)
    res = (best[1], best[2])
    _PART3_CACHE[seed] = res
    return res


def transcode_uastc_to_bc7(blocks: np.ndarray) -> np.ndarray:
    """[B,16] UASTC-profile blocks → [B,16] BC7 blocks.

    Single-subset single-plane modes carry endpoints/weights through with
    requantization (8-bit → 7.7.7.7+P, weight level → nearest AWEIGHT4);
    alpha dual-plane blocks map onto mode 5 (separate alpha indices)
    and RGB channel dual-plane onto mode 5 with channel rotation;
    RGB 2-subset modes map onto mode 1, RGB 3-subset onto mode 2, and
    RGBA/LA 2-subset onto mode 7 — the multi-subset carriers via the
    best-matching BC7 partition with a mode-6 whole-block refit as the
    hybrid fallback — matching the structural limits basisu's own BC7
    transcoder works within."""
    from uvol_tpu_torch.codecs.basis.uastc import (
        MODE_SOLID,
        MODES,
        WEIGHT_TABLES,
        _bits_of,
        _expand_endpoint,
        _get_bise,
        _get_field,
        _ncomp,
        decode_uastc_blocks,
    )

    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, 16)
    bits = _bits_of(blocks)
    modes = _get_field(bits, 0, 5)
    decoded = decode_uastc_blocks(blocks)  # [B,4,4,4] (refit fallback)
    out = np.zeros_like(blocks)
    for i in range(len(blocks)):
        mode_id = int(modes[i])
        if mode_id == MODE_SOLID:
            rgba = [int(_get_field(bits[i : i + 1], 5 + 8 * c, 8)[0])
                    for c in range(4)]
            out[i] = np.frombuffer(
                pack_bc7_mode6(rgba, rgba, [0] * 16), np.uint8
            )
            continue
        m = MODES.get(mode_id)
        if m is None:
            raise ValueError(f"uastc mode {mode_id} unknown")
        row = bits[i : i + 1]
        if m.subsets == 2 and m.cem == 8:
            # RGB 2-subset → BC7 mode 1: best-matching BC7 partition,
            # requantized subset endpoints, per-texel nearest interpolant
            # of the INTENDED color (handles pattern-mismatch texels too)
            seed = int(_get_field(row, 5, 10)[0])
            part, swap = _best_partition2(seed)
            pos2 = 5 + 10
            nc2 = 3
            qq = np.zeros((2, 2, nc2), np.int64)
            for s in range(2):
                for c in range(nc2):
                    qq[s, 0, c] = _get_field(row, pos2, m.ep_bits)[0]
                    pos2 += m.ep_bits
                    qq[s, 1, c] = _get_field(row, pos2, m.ep_bits)[0]
                    pos2 += m.ep_bits
            eps8 = _expand_endpoint(qq, m.ep_bits)  # [2,2,3]
            if swap:
                eps8 = eps8[::-1]
            want = decoded[i].reshape(16, 4)[:, :3].astype(np.int64)
            sub = BC7_PARTITIONS2[part]
            # decoder-visible endpoints after mode-1 requantization
            ps = []
            qs6 = np.zeros((2, 2, 3), np.int64)
            for s in range(2):
                p = int(round(float(np.mean((eps8[s] >> 1) & 1))))
                ps.append(p)
                qs6[s] = np.clip((eps8[s] - (p << 1)) >> 2, 0, 63)
            interp = np.zeros((2, 8, 3), np.int64)
            for s in range(2):
                e0 = np.array(
                    [_e8_mode1(int(qs6[s, 0, c]), ps[s]) for c in range(3)],
                    np.int64,
                )
                e1 = np.array(
                    [_e8_mode1(int(qs6[s, 1, c]), ps[s]) for c in range(3)],
                    np.int64,
                )
                for k in range(8):
                    interp[s, k] = _interp(e0, e1, int(AWEIGHT3[k]))
            idx = np.zeros(16, np.int64)
            err1 = 0
            for t in range(16):
                s = int(sub[t])
                d = interp[s] - want[t][None, :]
                e = (d * d).sum(axis=1)
                idx[t] = int(e.argmin())
                err1 += int(e[idx[t]])
            cand1 = pack_bc7_mode1(
                part, eps8[0, 0], eps8[0, 1], eps8[1, 0], eps8[1, 1], idx
            )
            # hybrid: when the ASTC pattern has no close BC7 partition
            # (mismatched texels land in the wrong subset), a whole-block
            # mode-6 refit can reconstruct better — pick the lower error
            cand6 = _fit_mode6(decoded[i])
            got6 = decode_bc7_block(cand6).reshape(16, 4)[:, :3].astype(
                np.int64
            )
            err6 = int(((got6 - want) ** 2).sum())
            out[i] = np.frombuffer(
                cand1 if err1 <= err6 else cand6, np.uint8
            )
            continue
        if m.subsets == 3 and m.cem == 8:
            # RGB 3-subset → BC7 mode 2 (hybrid with the mode-6 refit)
            seed = int(_get_field(row, 5, 10)[0])
            part, perm = _best_partition3(seed)
            pos3 = 5 + 10
            qq = np.zeros((3, 2, 3), np.int64)
            for s in range(3):
                for c in range(3):
                    qq[s, 0, c] = _get_field(row, pos3, m.ep_bits)[0]
                    pos3 += m.ep_bits
                    qq[s, 1, c] = _get_field(row, pos3, m.ep_bits)[0]
                    pos3 += m.ep_bits
            eps8 = _expand_endpoint(qq, m.ep_bits)  # [3,2,3] (ASTC order)
            bc_eps = np.zeros_like(eps8)
            for s in range(3):
                bc_eps[perm[s]] = eps8[s]
            want = decoded[i].reshape(16, 4)[:, :3].astype(np.int64)
            sub = BC7_PARTITIONS3[part]
            interp = np.zeros((3, 4, 3), np.int64)
            for s in range(3):
                e0 = np.array(
                    [_e8_mode2(int(bc_eps[s, 0, c]) >> 3) for c in range(3)],
                    np.int64,
                )
                e1 = np.array(
                    [_e8_mode2(int(bc_eps[s, 1, c]) >> 3) for c in range(3)],
                    np.int64,
                )
                for k in range(4):
                    interp[s, k] = _interp(e0, e1, int(AWEIGHT2[k]))
            idx = np.zeros(16, np.int64)
            err2 = 0
            for t in range(16):
                s = int(sub[t])
                d = interp[s] - want[t][None, :]
                e = (d * d).sum(axis=1)
                idx[t] = int(e.argmin())
                err2 += int(e[idx[t]])
            cand2 = pack_bc7_mode2(
                part, [(bc_eps[s, 0], bc_eps[s, 1]) for s in range(3)], idx
            )
            cand6 = _fit_mode6(decoded[i])
            got6 = decode_bc7_block(cand6).reshape(16, 4)[:, :3].astype(
                np.int64
            )
            err6 = int(((got6 - want) ** 2).sum())
            out[i] = np.frombuffer(
                cand2 if err2 <= err6 else cand6, np.uint8
            )
            continue
        if m.subsets == 2 and m.cem in (4, 12):
            # RGBA/LA 2-subset → BC7 mode 7 (the only 2-subset BC7 mode
            # with alpha endpoints); hybrid with the mode-6 refit like
            # the mode-1 path
            seed = int(_get_field(row, 5, 10)[0])
            part, swap = _best_partition2(seed)
            pos2 = 5 + 10
            nc2 = _ncomp(m)
            qq = np.zeros((2, 2, nc2), np.int64)
            for s in range(2):
                for c in range(nc2):
                    qq[s, 0, c] = _get_field(row, pos2, m.ep_bits)[0]
                    pos2 += m.ep_bits
                    qq[s, 1, c] = _get_field(row, pos2, m.ep_bits)[0]
                    pos2 += m.ep_bits
            e = _expand_endpoint(qq, m.ep_bits)  # [2,2,nc2]
            if m.cem == 4:  # LA → RGBA
                eps8 = np.concatenate(
                    [np.repeat(e[:, :, :1], 3, axis=2), e[:, :, 1:2]], 2
                )
            else:
                eps8 = e
            if swap:
                eps8 = eps8[::-1]
            want = decoded[i].reshape(16, 4).astype(np.int64)
            sub = BC7_PARTITIONS2[part]
            # decoder-visible endpoints after mode-7 requantization
            interp = np.zeros((2, 4, 4), np.int64)
            for s in range(2):
                dv = np.zeros((2, 4), np.int64)
                for ei in range(2):
                    p = int(round(float(np.mean((eps8[s, ei] >> 2) & 1))))
                    q5 = np.clip((eps8[s, ei] - (p << 2)) >> 3, 0, 31)
                    dv[ei] = [_e8_mode7(int(q5[c]), p) for c in range(4)]
                for k in range(4):
                    interp[s, k] = _interp(dv[0], dv[1], int(AWEIGHT2[k]))
            idx = np.zeros(16, np.int64)
            err7 = 0
            for t in range(16):
                s = int(sub[t])
                d = interp[s] - want[t][None, :]
                er = (d * d).sum(axis=1)
                idx[t] = int(er.argmin())
                err7 += int(er[idx[t]])
            cand7 = pack_bc7_mode7(
                part, [(eps8[s, 0], eps8[s, 1]) for s in range(2)], idx
            )
            cand6 = _fit_mode6(decoded[i])
            got6 = decode_bc7_block(cand6).reshape(16, 4).astype(np.int64)
            err6 = int(((got6 - want) ** 2).sum())
            out[i] = np.frombuffer(
                cand7 if err7 <= err6 else cand6, np.uint8
            )
            continue
        if m.subsets > 1:
            out[i] = np.frombuffer(_fit_mode6(decoded[i]), np.uint8)
            continue
        nc = _ncomp(m)
        pos = 5
        comp = 3
        if m.dual_plane:
            comp = int(_get_field(row, pos, 2)[0])
            pos += 2
        q0 = np.zeros(nc, np.int64)
        q1 = np.zeros(nc, np.int64)
        for c in range(nc):
            q0[c] = _get_field(row, pos, m.ep_bits)[0]
            pos += m.ep_bits
            q1[c] = _get_field(row, pos, m.ep_bits)[0]
            pos += m.ep_bits
        wq, pos = _get_bise(row, pos, 16, m.weight_levels)
        wq = wq[0]
        wq2 = None
        if m.dual_plane:
            wq2, pos = _get_bise(row, pos, 16, m.weight_levels)
            wq2 = wq2[0]
        e0 = _expand_endpoint(q0, m.ep_bits)
        e1 = _expand_endpoint(q1, m.ep_bits)
        w64 = WEIGHT_TABLES[m.weight_levels][wq]  # [16] 0..64
        if m.dual_plane:
            w64a = WEIGHT_TABLES[m.weight_levels][wq2]
            cidx = np.abs(w64[:, None] - AWEIGHT2[None, :]).argmin(1)
            aidx = np.abs(w64a[:, None] - AWEIGHT2[None, :]).argmin(1)
            if comp == 3:
                # alpha dual-plane → mode 5 (2-bit planes; requantize
                # both index planes)
                out[i] = np.frombuffer(
                    pack_bc7_mode5(
                        0, e0[:3], e1[:3], int(e0[3]), int(e1[3]),
                        cidx, aidx,
                    ),
                    np.uint8,
                )
                continue
            if m.cem == 8:
                # RGB channel dual-plane (shared endpoints, ASTC rule)
                # → mode 5 with rotation comp+1: post-interpolation the
                # rotation swaps A with that channel, so the separate
                # "alpha" plane drives it and the rotated-out color
                # slot pins the final alpha to 255 (7-bit 127 expands
                # back to exactly 255)
                c0 = e0[:3].copy()
                c1 = e1[:3].copy()
                c0[comp] = 255
                c1[comp] = 255
                out[i] = np.frombuffer(
                    pack_bc7_mode5(
                        comp + 1, c0, c1, int(e0[comp]), int(e1[comp]),
                        cidx, aidx,
                    ),
                    np.uint8,
                )
                continue
            out[i] = np.frombuffer(_fit_mode6(decoded[i]), np.uint8)
            continue
        # single-plane → mode 6
        if m.cem == 4:  # LA: replicate L, alpha from 2nd pair
            f0 = np.array([e0[0], e0[0], e0[0], e0[1]], np.int64)
            f1 = np.array([e1[0], e1[0], e1[0], e1[1]], np.int64)
        elif nc == 3:
            f0 = np.array([*e0, 255], np.int64)
            f1 = np.array([*e1, 255], np.int64)
        else:
            f0, f1 = e0, e1
        idx = np.abs(w64[:, None] - AWEIGHT4[None, :]).argmin(1)
        out[i] = np.frombuffer(pack_bc7_mode6(f0, f1, idx), np.uint8)
    return out
