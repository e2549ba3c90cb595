"""H.264 intra coding: I_4x4 / I_16x16 prediction, 4x4 integer transform,
quantization and CAVLC entropy — the real compression layer behind the V1
texture track (the reference's V1 texture is a genuinely compressed
H.264 MP4: its example/texture_encoder.py + deprecated/README.md:63).

Scope: baseline-profile I slices.
  decode — I_PCM + I_4x4 (all 9 luma modes) + I_16x16 (all 4 modes,
  luma DC Hadamard) + all 4 chroma modes: everything libx264 emits for
  all-intra CAVLC baseline streams, which is the conformance oracle
  (tests decode x264 streams and pin the reconstruction against
  libavcodec's own — native/h264ref.py).
  encode — I_4x4 mode decision (SAD + mode-bit cost) with per-MB I_PCM
  escape (the V1 frame-counter strip stays lossless), chroma DC/H/V.

Normative pieces (transform scaling, prediction formulas, CAVLC tables)
follow the H.264 spec clause numbers noted inline; everything is integer
arithmetic with C semantics.

The port's copy of `uvol_tpu/codecs/h264_intra.py`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from uvol_tpu_torch.codecs.h264 import BitReader, BitWriter

# ---------------------------------------------------------------------------
# Scans and tables
# ---------------------------------------------------------------------------

ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
# 4x4 luma block order within a macroblock (raster coords per blkIdx)
BLK_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
BLK_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])

# quant multipliers MF (col by coefficient position class) and dequant V
_QUANT_MF = np.array(
    [
        [13107, 5243, 8066],
        [11916, 4660, 7490],
        [10082, 4194, 6554],
        [9362, 3647, 5825],
        [8192, 3355, 5243],
        [7282, 2893, 4559],
    ]
)
_DEQUANT_V = np.array(
    [
        [10, 16, 13],
        [11, 18, 14],
        [13, 20, 16],
        [14, 23, 18],
        [16, 25, 20],
        [18, 29, 23],
    ]
)
# position class per raster coefficient position: 0 for (0,0),(0,2),(2,0),
# (2,2); 1 for (1,1),(1,3),(3,1),(3,3); 2 otherwise
_POS_CLASS = np.array(
    [0, 2, 0, 2, 2, 1, 2, 1, 0, 2, 0, 2, 2, 1, 2, 1]
).reshape(4, 4)

# chroma qP mapping (Table 8-15), index by clipped qPi 0..51
_CHROMA_QP = list(range(30)) + [
    29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
    38, 39, 39, 39, 39,
]


def chroma_qp(qp: int) -> int:
    return _CHROMA_QP[min(max(qp, 0), 51)]


# ---- CAVLC VLC tables (Table 9-5, 9-7, 9-8, 9-10) --------------------------
# coeff_token: [table][total_coeff*4 + trailing_ones] -> (len, bits);
# len 0 marks impossible combinations. Table 3 is the 6-bit FLC.
_COEFF_TOKEN_LEN = [
    [1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16],
    [2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14],
    [4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10],
    [6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6],
]
_COEFF_TOKEN_BITS = [
    [1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8],
    [3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4],
    [15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2],
    [3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63],
]
# chroma DC (4:2:0) coeff_token
_CDC_TOKEN_LEN = [2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7]
_CDC_TOKEN_BITS = [1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0]

# total_zeros for 4x4 blocks: [total_coeff-1][total_zeros] -> (len, bits)
_TOTAL_ZEROS_LEN = [
    [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9],
    [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
    [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6],
    [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
    [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5],
    [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
    [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
    [6, 4, 5, 3, 2, 2, 3, 3, 6],
    [6, 6, 4, 2, 2, 3, 2, 5],
    [5, 5, 3, 2, 2, 2, 4],
    [4, 4, 3, 3, 1, 3],
    [4, 4, 2, 1, 3],
    [3, 3, 1, 2],
    [2, 2, 1],
    [1, 1],
]
_TOTAL_ZEROS_BITS = [
    [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1],
    [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0],
    [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
    [1, 1, 1, 3, 3, 2, 2, 1, 0],
    [1, 0, 1, 3, 2, 1, 1, 1],
    [1, 0, 1, 3, 2, 1, 1],
    [0, 1, 1, 2, 1, 3],
    [0, 1, 1, 1, 1],
    [0, 1, 1, 1],
    [0, 1, 1],
    [0, 1],
]
# chroma DC total_zeros (maxNumCoeff 4)
_CDC_TZ_LEN = [[1, 2, 3, 3], [1, 2, 2], [1, 1]]
_CDC_TZ_BITS = [[1, 1, 1, 0], [1, 1, 0], [1, 0]]

# run_before: [min(zeros_left,7)-1][run] -> (len, bits)
_RUN_LEN = [
    [1, 1],
    [1, 2, 2],
    [2, 2, 2, 2],
    [2, 2, 2, 3, 3],
    [2, 2, 3, 3, 3, 3],
    [2, 3, 3, 3, 3, 3, 3],
    [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11],
]
_RUN_BITS = [
    [1, 0],
    [1, 1, 0],
    [3, 2, 1, 0],
    [3, 2, 1, 1, 0],
    [3, 2, 3, 2, 1, 0],
    [3, 0, 1, 3, 2, 5, 4],
    [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1],
]


def _check_tables() -> None:
    """Import-time self-check: every VLC family must be prefix-free with
    Kraft sum ≤ 1 and near-complete (the spec tables leave a few codes
    unused, so exact completeness is NOT expected). Catches
    transcription slips in the table data."""
    def check(pairs, name):
        entries = [(l, b) for l, b in pairs if l]
        kraft = sum(2.0 ** -l for l, _ in entries)
        assert 0.95 <= kraft <= 1.0 + 1e-9, (name, kraft)
        for i, (l1, b1) in enumerate(entries):
            for l2, b2 in entries[i + 1 :]:
                la, ba, lb, bb = (
                    (l1, b1, l2, b2) if l1 <= l2 else (l2, b2, l1, b1)
                )
                assert not (bb >> (lb - la)) == ba or (la, ba) == (lb, bb), (
                    name, (l1, b1), (l2, b2),
                )

    for t in range(3):
        check(zip(_COEFF_TOKEN_LEN[t], _COEFF_TOKEN_BITS[t]),
              f"coeff_token[{t}]")
    check(zip(_CDC_TOKEN_LEN, _CDC_TOKEN_BITS), "cdc_token")
    for i, (ls, bs) in enumerate(zip(_TOTAL_ZEROS_LEN, _TOTAL_ZEROS_BITS)):
        check(zip(ls, bs), f"total_zeros[{i}]")
    for i, (ls, bs) in enumerate(zip(_CDC_TZ_LEN, _CDC_TZ_BITS)):
        check(zip(ls, bs), f"cdc_tz[{i}]")
    for i in range(7):
        check(zip(_RUN_LEN[i], _RUN_BITS[i]), f"run_before[{i}]")


_check_tables()


def _vlc_decoder(lens, bits):
    """(len,bits) table -> dict[(len, code)] = index for linear-probe read."""
    table = {}
    for idx, (l, b) in enumerate(zip(lens, bits)):
        if l:
            key = (l, b)
            assert key not in table, key
            table[key] = idx
    return table


_COEFF_TOKEN_DEC = [
    _vlc_decoder(_COEFF_TOKEN_LEN[t], _COEFF_TOKEN_BITS[t]) for t in range(3)
]
_CDC_TOKEN_DEC = _vlc_decoder(_CDC_TOKEN_LEN, _CDC_TOKEN_BITS)
_TOTAL_ZEROS_DEC = [
    _vlc_decoder(ls, bs)
    for ls, bs in zip(_TOTAL_ZEROS_LEN, _TOTAL_ZEROS_BITS)
]
_CDC_TZ_DEC = [
    _vlc_decoder(ls, bs) for ls, bs in zip(_CDC_TZ_LEN, _CDC_TZ_BITS)
]
_RUN_DEC = [_vlc_decoder(ls, bs) for ls, bs in zip(_RUN_LEN, _RUN_BITS)]


def _read_vlc(r: BitReader, table: dict, max_len: int = 24) -> int:
    code = 0
    for length in range(1, max_len + 1):
        code = (code << 1) | r.u(1)
        idx = table.get((length, code))
        if idx is not None:
            return idx
    raise ValueError("h264: invalid VLC code")


# coded_block_pattern me-mapping for Intra_4x4 (Table 9-4, intra column)
_CBP_INTRA_FROM_CODE = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41,
]
_CBP_INTRA_TO_CODE = {v: i for i, v in enumerate(_CBP_INTRA_FROM_CODE)}


# ---------------------------------------------------------------------------
# Transforms and quantization (8.5)
# ---------------------------------------------------------------------------


def forward_4x4(block: np.ndarray) -> np.ndarray:
    """Core forward transform W = Cf X Cf^T (encoder side)."""
    c = np.array(
        [[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]],
        np.int64,
    )
    return c @ block.astype(np.int64) @ c.T


def inverse_4x4(d: np.ndarray) -> np.ndarray:
    """Normative inverse transform (8.5.12.2), result includes (x+32)>>6."""
    d = d.astype(np.int64)
    # horizontal
    e0 = d[:, 0] + d[:, 2]
    e1 = d[:, 0] - d[:, 2]
    e2 = (d[:, 1] >> 1) - d[:, 3]
    e3 = d[:, 1] + (d[:, 3] >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=1)
    # vertical
    g0 = f[0] + f[2]
    g1 = f[0] - f[2]
    g2 = (f[1] >> 1) - f[3]
    g3 = f[1] + (f[3] >> 1)
    h = np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=0)
    return (h + 32) >> 6


def quant_4x4(w: np.ndarray, qp: int, skip_dc: bool = False) -> np.ndarray:
    """Encoder quantization (intra deadzone f = 2^qbits/3)."""
    mf = _QUANT_MF[qp % 6][_POS_CLASS]
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    lv = (np.abs(w) * mf + f) >> qbits
    out = np.sign(w) * lv
    if skip_dc:
        out[0, 0] = 0
    return out


def dequant_4x4(c: np.ndarray, qp: int) -> np.ndarray:
    """Normative 4x4 AC scaling: d = c * V(qp%6,pos) << (qp/6)."""
    v = _DEQUANT_V[qp % 6][_POS_CLASS]
    return (c.astype(np.int64) * v) << (qp // 6)


def _clip8(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Intra prediction (8.3)
# ---------------------------------------------------------------------------


def predict_4x4(
    mode: int,
    left: Optional[np.ndarray],   # p[-1, 0..3] top-down, None if unavailable
    top: Optional[np.ndarray],    # p[0..3, -1]
    top_right: Optional[np.ndarray],  # p[4..7, -1] (pre-substituted)
    top_left: Optional[int],      # p[-1,-1]
) -> np.ndarray:
    """One 4x4 luma prediction (modes 0..8, 8.3.1.2). The caller applies
    the above-right substitution rule (replicate p[3,-1]) before calling."""
    if mode == 0:  # Vertical
        if top is None:
            raise ValueError("h264: vertical pred without top")
        return np.tile(top, (4, 1)).astype(np.uint8)
    if mode == 1:  # Horizontal
        if left is None:
            raise ValueError("h264: horizontal pred without left")
        return np.tile(left[:, None], (1, 4)).astype(np.uint8)
    if mode == 2:  # DC
        if top is not None and left is not None:
            dc = (int(top.sum()) + int(left.sum()) + 4) >> 3
        elif top is not None:
            dc = (int(top.sum()) + 2) >> 2
        elif left is not None:
            dc = (int(left.sum()) + 2) >> 2
        else:
            dc = 128
        return np.full((4, 4), dc, np.uint8)
    # directional modes: constructed lines with T(i)=p[i,-1] (i -1..7),
    # L(i)=p[-1,i] (i -1..3) per 8.3.1.2; T(-1)=L(-1)=p[-1,-1]
    t = np.zeros(8, np.int64)
    if top is not None:
        t[:4] = top
        t[4:] = top_right if top_right is not None else top[3]
    lf = left.astype(np.int64) if left is not None else None
    tl = int(top_left) if top_left is not None else 0

    def T(i: int) -> int:
        return tl if i < 0 else int(t[i])

    def L(i: int) -> int:
        return tl if i < 0 else int(lf[i])

    p = np.zeros((4, 4), np.int64)
    if mode == 3:  # Diagonal-Down-Left
        if top is None:
            raise ValueError("h264: DDL pred without top")
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (T(6) + 3 * T(7) + 2) >> 2
                else:
                    i = x + y
                    p[y, x] = (T(i) + 2 * T(i + 1) + T(i + 2) + 2) >> 2
    elif mode == 4:  # Diagonal-Down-Right
        if top is None or lf is None:
            raise ValueError("h264: DDR pred needs top+left")
        for y in range(4):
            for x in range(4):
                if x > y:
                    p[y, x] = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2
                elif x < y:
                    p[y, x] = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2
                else:
                    p[y, x] = (T(0) + 2 * tl + L(0) + 2) >> 2
    elif mode == 5:  # Vertical-Right
        if top is None or lf is None:
            raise ValueError("h264: VR pred needs top+left")
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                i = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (T(i - 1) + T(i) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (T(i - 2) + 2 * T(i - 1) + T(i) + 2) >> 2
                elif z == -1:
                    p[y, x] = (L(0) + 2 * tl + T(0) + 2) >> 2
                else:
                    p[y, x] = (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2
    elif mode == 6:  # Horizontal-Down
        if top is None or lf is None:
            raise ValueError("h264: HD pred needs top+left")
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                i = y - (x >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (L(i - 1) + L(i) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2
                elif z == -1:
                    p[y, x] = (L(0) + 2 * tl + T(0) + 2) >> 2
                else:
                    p[y, x] = (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2
    elif mode == 7:  # Vertical-Left
        if top is None:
            raise ValueError("h264: VL pred without top")
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (T(i) + T(i + 1) + 1) >> 1
                else:
                    p[y, x] = (T(i) + 2 * T(i + 1) + T(i + 2) + 2) >> 2
    elif mode == 8:  # Horizontal-Up
        if lf is None:
            raise ValueError("h264: HU pred without left")
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                i = y + (x >> 1)
                if z % 2 == 0 and z < 6:
                    p[y, x] = (L(i) + L(i + 1) + 1) >> 1
                elif z % 2 == 1 and z < 5:
                    p[y, x] = (L(i) + 2 * L(i + 1) + L(i + 2) + 2) >> 2
                elif z == 5:
                    p[y, x] = (L(2) + 3 * L(3) + 2) >> 2
                else:
                    p[y, x] = L(3)
    else:
        raise ValueError(f"h264: intra4x4 mode {mode}")
    return _clip8(p)


def predict_chroma(
    mode: int,
    plane: np.ndarray,   # recon chroma plane
    cx: int, cy: int,    # top-left of the 8x8 block in chroma coords
    left_avail: bool, top_avail: bool,
) -> np.ndarray:
    """8x8 chroma prediction (8.3.4), modes 0 DC / 1 H / 2 V / 3 Plane."""
    left = plane[cy : cy + 8, cx - 1].astype(np.int64) if left_avail else None
    top = plane[cy - 1, cx : cx + 8].astype(np.int64) if top_avail else None
    if mode == 0:  # DC with per-quadrant rules
        out = np.zeros((8, 8), np.uint8)
        for qy in (0, 4):
            for qx in (0, 4):
                ts = top[qx : qx + 4] if top is not None else None
                ls = left[qy : qy + 4] if left is not None else None
                if qx == qy:  # corner quadrants use both when available
                    if ts is not None and ls is not None:
                        dc = (int(ts.sum()) + int(ls.sum()) + 4) >> 3
                    elif ts is not None:
                        dc = (int(ts.sum()) + 2) >> 2
                    elif ls is not None:
                        dc = (int(ls.sum()) + 2) >> 2
                    else:
                        dc = 128
                elif qx == 4:  # top-right: prefer top
                    if ts is not None:
                        dc = (int(ts.sum()) + 2) >> 2
                    elif ls is not None:
                        dc = (int(ls.sum()) + 2) >> 2
                    else:
                        dc = 128
                else:  # bottom-left: prefer left
                    if ls is not None:
                        dc = (int(ls.sum()) + 2) >> 2
                    elif ts is not None:
                        dc = (int(ts.sum()) + 2) >> 2
                    else:
                        dc = 128
                out[qy : qy + 4, qx : qx + 4] = dc
        return out
    if mode == 1:  # Horizontal
        if left is None:
            raise ValueError("h264: chroma H pred without left")
        return np.tile(left[:, None], (1, 8)).astype(np.uint8)
    if mode == 2:  # Vertical
        if top is None:
            raise ValueError("h264: chroma V pred without top")
        return np.tile(top, (8, 1)).astype(np.uint8)
    if mode == 3:  # Plane
        if top is None or left is None:
            raise ValueError("h264: chroma plane pred needs top+left")
        tl = int(plane[cy - 1, cx - 1])
        hh = sum((x + 1) * (int(top[4 + x]) - (int(top[2 - x]) if 2 - x >= 0 else tl)) for x in range(4))
        vv = sum((y + 1) * (int(left[4 + y]) - (int(left[2 - y]) if 2 - y >= 0 else tl)) for y in range(4))
        a = 16 * (int(left[7]) + int(top[7]))
        b = (17 * hh + 16) >> 5
        c = (17 * vv + 16) >> 5
        xs = np.arange(8) - 3
        ys = (np.arange(8) - 3)[:, None]
        return _clip8((a + b * xs + c * ys + 16) >> 5)
    raise ValueError(f"h264: chroma pred mode {mode}")


def predict_16x16(
    mode: int, plane: np.ndarray, x0: int, y0: int,
    left_avail: bool, top_avail: bool,
) -> np.ndarray:
    """16x16 luma prediction (8.3.3), modes 0 V / 1 H / 2 DC / 3 Plane."""
    left = plane[y0 : y0 + 16, x0 - 1].astype(np.int64) if left_avail else None
    top = plane[y0 - 1, x0 : x0 + 16].astype(np.int64) if top_avail else None
    if mode == 0:
        if top is None:
            raise ValueError("h264: I16 V pred without top")
        return np.tile(top, (16, 1)).astype(np.uint8)
    if mode == 1:
        if left is None:
            raise ValueError("h264: I16 H pred without left")
        return np.tile(left[:, None], (1, 16)).astype(np.uint8)
    if mode == 2:
        if top is not None and left is not None:
            dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
        elif top is not None:
            dc = (int(top.sum()) + 8) >> 4
        elif left is not None:
            dc = (int(left.sum()) + 8) >> 4
        else:
            dc = 128
        return np.full((16, 16), dc, np.uint8)
    if mode == 3:
        if top is None or left is None:
            raise ValueError("h264: I16 plane pred needs top+left")
        tl = int(plane[y0 - 1, x0 - 1])
        hh = sum((x + 1) * (int(top[8 + x]) - (int(top[6 - x]) if 6 - x >= 0 else tl)) for x in range(8))
        vv = sum((y + 1) * (int(left[8 + y]) - (int(left[6 - y]) if 6 - y >= 0 else tl)) for y in range(8))
        a = 16 * (int(left[15]) + int(top[15]))
        b = (5 * hh + 32) >> 6
        c = (5 * vv + 32) >> 6
        xs = np.arange(16) - 7
        ys = (np.arange(16) - 7)[:, None]
        return _clip8((a + b * xs + c * ys + 16) >> 5)
    raise ValueError(f"h264: I16 pred mode {mode}")


# ---------------------------------------------------------------------------
# CAVLC residual block read/write (9.2)
# ---------------------------------------------------------------------------


def read_residual_block(
    r: BitReader, nc: int, max_coeff: int
) -> Tuple[np.ndarray, int]:
    """Parse one CAVLC residual block.

    nc: neighbor context (−1 for chroma DC). Returns (coeff levels in
    scan order [max_coeff], total_coeff)."""
    if nc == -1:
        idx = _read_vlc(r, _CDC_TOKEN_DEC)
    elif nc < 2:
        idx = _read_vlc(r, _COEFF_TOKEN_DEC[0])
    elif nc < 4:
        idx = _read_vlc(r, _COEFF_TOKEN_DEC[1])
    elif nc < 8:
        idx = _read_vlc(r, _COEFF_TOKEN_DEC[2])
    else:
        code = r.u(6)
        if code == 3:  # 000011 -> (0,0)
            idx = 0
        else:
            idx = 4 * (code // 4 + 1) + code % 4
    total_coeff, t1s = idx // 4, idx % 4
    out = np.zeros(max_coeff, np.int64)
    if total_coeff == 0:
        return out, 0
    if total_coeff > max_coeff:
        raise ValueError("h264: total_coeff exceeds block size")
    levels: List[int] = []
    for _ in range(t1s):
        levels.append(-1 if r.u(1) else 1)
    suffix_length = 1 if total_coeff > 10 and t1s < 3 else 0
    for i in range(total_coeff - t1s):
        prefix = 0
        while r.u(1) == 0:
            prefix += 1
            if prefix > 32:
                raise ValueError("h264: level_prefix overflow")
        if prefix == 14 and suffix_length == 0:
            size = 4
        elif prefix >= 15:
            size = prefix - 3
        else:
            size = suffix_length
        suffix = r.u(size) if size else 0
        level_code = (min(15, prefix) << suffix_length) + suffix
        if prefix >= 15 and suffix_length == 0:
            level_code += 15
        if prefix >= 16:
            level_code += (1 << (prefix - 3)) - 4096
        if i == 0 and t1s < 3:
            level_code += 2
        level = (level_code + 2) >> 1
        if level_code % 2:
            level = -level
        levels.append(level)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1
    if total_coeff < max_coeff:
        if nc == -1:
            tz = _read_vlc(r, _CDC_TZ_DEC[total_coeff - 1])
        else:
            tz = _read_vlc(r, _TOTAL_ZEROS_DEC[total_coeff - 1])
    else:
        tz = 0
    if total_coeff + tz > max_coeff:
        raise ValueError("h264: total_zeros exceeds block size")
    pos = total_coeff + tz - 1
    zeros_left = tz
    for i, level in enumerate(levels):
        out[pos] = level
        if i < total_coeff - 1:
            if zeros_left > 0:
                run = _read_vlc(r, _RUN_DEC[min(zeros_left, 7) - 1])
            else:
                run = 0
            if run > zeros_left:
                raise ValueError("h264: run_before exceeds zeros left")
            zeros_left -= run
            pos -= run + 1
            if pos < 0:
                raise ValueError("h264: coefficient position underflow")
    return out, total_coeff


def _write_level_code(w: BitWriter, level_code: int, s: int) -> None:
    """Inverse of 9.2.2.1's levelCode derivation: emit level_prefix
    (unary: prefix zeros + 1) and level_suffix for suffixLength s."""
    if s == 0:
        if level_code < 14:
            w.u(1, level_code + 1)
            return
        if level_code < 30:
            w.u(1, 15)  # prefix 14, 4-bit suffix
            w.u(level_code - 14, 4)
            return
        level_code -= 15  # decoder adds 15 back for prefix>=15 at s==0
        s_base = 15
    else:
        s_base = 15 << s
        if level_code < s_base:
            w.u(1, (level_code >> s) + 1)
            w.u(level_code & ((1 << s) - 1), s)
            return
    # escape: prefix p >= 15, suffix size p-3,
    # levelCode = s_base + suffix + (for p>=16) 2^(p-3) - 4096
    if level_code < s_base + 4096:
        w.u(1, 16)  # prefix 15
        w.u(level_code - s_base, 12)
        return
    p = 16
    while level_code - s_base - ((1 << (p - 3)) - 4096) >= (1 << (p - 3)):
        p += 1
        if p > 32:
            raise ValueError("h264: level too large for CAVLC")
    w.u(1, p + 1)
    w.u(level_code - s_base - ((1 << (p - 3)) - 4096), p - 3)


def _write_vlc(w: BitWriter, lens, bits, idx: int) -> None:
    l = lens[idx]
    assert l, f"impossible VLC entry {idx}"
    w.u(bits[idx], l)


def write_residual_block(
    w: BitWriter, coeffs: np.ndarray, nc: int
) -> int:
    """CAVLC-encode one residual block (coeffs in scan order).

    Returns total_coeff (for the caller's nC bookkeeping)."""
    max_coeff = len(coeffs)
    nz = np.nonzero(coeffs)[0]
    total_coeff = len(nz)
    # trailing ones: up to 3 consecutive |1| at the high-frequency end
    t1s = 0
    for i in range(total_coeff - 1, -1, -1):
        if abs(int(coeffs[nz[i]])) == 1 and t1s < 3:
            t1s += 1
        else:
            break
    idx = total_coeff * 4 + t1s
    if nc == -1:
        _write_vlc(w, _CDC_TOKEN_LEN, _CDC_TOKEN_BITS, idx)
    elif nc < 2:
        _write_vlc(w, _COEFF_TOKEN_LEN[0], _COEFF_TOKEN_BITS[0], idx)
    elif nc < 4:
        _write_vlc(w, _COEFF_TOKEN_LEN[1], _COEFF_TOKEN_BITS[1], idx)
    elif nc < 8:
        _write_vlc(w, _COEFF_TOKEN_LEN[2], _COEFF_TOKEN_BITS[2], idx)
    else:
        w.u(_COEFF_TOKEN_BITS[3][idx], 6)
    if total_coeff == 0:
        return 0
    # trailing-one signs, high frequency first
    for i in range(t1s):
        w.u(1 if coeffs[nz[total_coeff - 1 - i]] < 0 else 0, 1)
    suffix_length = 1 if total_coeff > 10 and t1s < 3 else 0
    for i in range(total_coeff - t1s):
        level = int(coeffs[nz[total_coeff - 1 - t1s - i]])
        level_code = 2 * abs(level) - 2 + (1 if level < 0 else 0)
        if i == 0 and t1s < 3:
            level_code -= 2
        _write_level_code(w, level_code, suffix_length)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1
    tz = int(nz[-1]) + 1 - total_coeff
    if total_coeff < max_coeff:
        if nc == -1:
            _write_vlc(w, _CDC_TZ_LEN[total_coeff - 1],
                       _CDC_TZ_BITS[total_coeff - 1], tz)
        else:
            _write_vlc(w, _TOTAL_ZEROS_LEN[total_coeff - 1],
                       _TOTAL_ZEROS_BITS[total_coeff - 1], tz)
    zeros_left = tz
    for i in range(total_coeff - 1):
        hi = int(nz[total_coeff - 1 - i])
        lo = int(nz[total_coeff - 2 - i])
        run = hi - lo - 1
        if zeros_left > 0:
            _write_vlc(w, _RUN_LEN[min(zeros_left, 7) - 1],
                       _RUN_BITS[min(zeros_left, 7) - 1], run)
        zeros_left -= run
    return total_coeff


# ---------------------------------------------------------------------------
# Slice-level coder: macroblock decode/encode with shared neighbor context
# ---------------------------------------------------------------------------

# above-right availability within a macroblock: the neighbor block decodes
# later for these blkIdx (plus picture-edge rules handled at runtime)
_NO_TOP_RIGHT = {3, 7, 11, 13, 15}

_HADAMARD4 = np.array(
    [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64
)


class SliceCoder:
    """One I slice over a coded (MB-aligned) picture; both directions
    share this context (recon planes, total-coeff planes for nC, intra
    mode plane, running QP)."""

    def __init__(self, cw: int, ch: int, qp: int):
        self.cw, self.ch = cw, ch
        self.qp = qp
        self.y = np.zeros((ch, cw), np.uint8)
        self.cb = np.zeros((ch // 2, cw // 2), np.uint8)
        self.cr = np.zeros((ch // 2, cw // 2), np.uint8)
        self.tc_y = np.zeros((ch // 4, cw // 4), np.int32)
        self.tc_cb = np.zeros((ch // 8, cw // 8), np.int32)
        self.tc_cr = np.zeros((ch // 8, cw // 8), np.int32)
        self.modes = np.full((ch // 4, cw // 4), -1, np.int32)
        self.cqp_offset = 0  # PPS chroma_qp_index_offset
        # P-slice motion state (per 4x4 block): quarter-pel MVs, the
        # reference index (-1 = intra / not yet decoded), and a decoded
        # mask for spec neighbor availability (8.4.1.3)
        self.mv = np.zeros((ch // 4, cw // 4, 2), np.int32)
        self.mvref = np.full((ch // 4, cw // 4), -1, np.int32)
        self.decoded4 = np.zeros((ch // 4, cw // 4), bool)

    # -- neighbor context ---------------------------------------------------
    def _nc(self, plane: np.ndarray, bx: int, by: int) -> int:
        na = int(plane[by, bx - 1]) if bx > 0 else -1
        nb = int(plane[by - 1, bx]) if by > 0 else -1
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        if na >= 0:
            return na
        if nb >= 0:
            return nb
        return 0

    def nc_luma(self, bx: int, by: int) -> int:
        return self._nc(self.tc_y, bx, by)

    def pred_mode4(self, bx: int, by: int) -> int:
        a = int(self.modes[by, bx - 1]) if bx > 0 else -1
        b = int(self.modes[by - 1, bx]) if by > 0 else -1
        if a < 0 or b < 0:
            return 2
        return min(a, b)

    def luma_neighbors(self, x0: int, y0: int, blk: int):
        """(left, top, top_right, top_left) sample lines for a 4x4 at
        (x0, y0) with in-MB blkIdx `blk` (availability per 8.3.1)."""
        left = self.y[y0 : y0 + 4, x0 - 1] if x0 > 0 else None
        top = self.y[y0 - 1, x0 : x0 + 4] if y0 > 0 else None
        tr = None
        if y0 > 0 and x0 + 8 <= self.cw and blk not in _NO_TOP_RIGHT:
            tr = self.y[y0 - 1, x0 + 4 : x0 + 8]
        tl = self.y[y0 - 1, x0 - 1] if (x0 > 0 and y0 > 0) else None
        return left, top, tr, tl

    # -- shared transform helpers -------------------------------------------
    def dequant_luma_block(self, coeffs_scan: np.ndarray, qp: int):
        c = np.zeros(16, np.int64)
        c[ZIGZAG_4x4] = coeffs_scan
        return dequant_4x4(c.reshape(4, 4), qp)

    def add_residual(self, plane, x0, y0, pred, d):
        plane[y0 : y0 + 4, x0 : x0 + 4] = _clip8(
            pred.astype(np.int64) + inverse_4x4(d)
        )

    # -- decode -------------------------------------------------------------
    def decode_mb(self, r: BitReader, mbx: int, mby: int) -> None:
        mb_type = r.ue()
        if mb_type == 25:
            self._decode_pcm(r, mbx, mby)
        elif mb_type == 0:
            self._decode_i4x4(r, mbx, mby)
        elif 1 <= mb_type <= 24:
            self._decode_i16(r, mbx, mby, mb_type)
        else:
            raise ValueError(f"h264: mb_type {mb_type} in I slice")

    def _decode_pcm(self, r: BitReader, mbx: int, mby: int) -> None:
        r.align()
        x0, y0 = 16 * mbx, 16 * mby
        self.y[y0 : y0 + 16, x0 : x0 + 16] = np.frombuffer(
            r.bytes_at(256), np.uint8
        ).reshape(16, 16)
        cx, cy = 8 * mbx, 8 * mby
        self.cb[cy : cy + 8, cx : cx + 8] = np.frombuffer(
            r.bytes_at(64), np.uint8
        ).reshape(8, 8)
        self.cr[cy : cy + 8, cx : cx + 8] = np.frombuffer(
            r.bytes_at(64), np.uint8
        ).reshape(8, 8)
        self._mark_pcm(mbx, mby)

    def _mark_pcm(self, mbx: int, mby: int) -> None:
        self.tc_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 16
        self.tc_cb[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 16
        self.tc_cr[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 16
        self.modes[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 2

    def _decode_i4x4(self, r: BitReader, mbx: int, mby: int) -> None:
        modes = []
        for blk in range(16):
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            pred = self.pred_mode4(bx, by)
            if r.u(1):
                mode = pred
            else:
                rem = r.u(3)
                mode = rem + (1 if rem >= pred else 0)
            self.modes[by, bx] = mode
            modes.append(mode)
        chroma_mode = r.ue()
        if chroma_mode > 3:
            raise ValueError("h264: intra_chroma_pred_mode > 3")
        code = r.ue()
        if code >= 48:
            raise ValueError("h264: coded_block_pattern code out of range")
        cbp = _CBP_INTRA_FROM_CODE[code]
        if cbp:
            self.qp = (self.qp + r.se() + 52) % 52
        luma, cdc, cac = self._parse_residual(r, mbx, mby, cbp, i16=False)
        # luma reconstruction, block order
        for blk in range(16):
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            x0, y0 = 4 * bx, 4 * by
            left, top, tr, tl = self.luma_neighbors(x0, y0, blk)
            pred = predict_4x4(modes[blk], left, top, tr, tl)
            d = self.dequant_luma_block(luma[blk], self.qp)
            self.add_residual(self.y, x0, y0, pred, d)
        self._recon_chroma(mbx, mby, chroma_mode, cdc, cac)

    def _decode_i16(self, r, mbx: int, mby: int, mb_type: int) -> None:
        pred_mode = (mb_type - 1) % 4
        cbp_chroma = ((mb_type - 1) // 4) % 3
        cbp_luma = 15 if mb_type - 1 >= 12 else 0
        chroma_mode = r.ue()
        if chroma_mode > 3:
            raise ValueError("h264: intra_chroma_pred_mode > 3")
        self.qp = (self.qp + r.se() + 52) % 52
        # DC block (nC from blk0 neighbors)
        bx0, by0 = 4 * mbx, 4 * mby
        dc_scan, _ = read_residual_block(r, self.nc_luma(bx0, by0), 16)
        cbp = cbp_luma | (cbp_chroma << 4)
        luma, cdc, cac = self._parse_residual(
            r, mbx, mby, cbp, i16=True
        )
        # luma DC: zig-zag -> 4x4, inverse Hadamard, scale (8.5.10)
        c = np.zeros(16, np.int64)
        c[ZIGZAG_4x4] = dc_scan
        f = _HADAMARD4 @ c.reshape(4, 4) @ _HADAMARD4
        qp = self.qp
        ls = 16 * int(_DEQUANT_V[qp % 6][0])  # x16 weight (see chroma note)
        if qp >= 36:
            dc = (f * ls) << (qp // 6 - 6)
        else:
            dc = (f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)
        x0, y0 = 16 * mbx, 16 * mby
        left_avail, top_avail = mbx > 0, mby > 0
        pred = predict_16x16(pred_mode, self.y, x0, y0, left_avail, top_avail)
        for blk in range(16):
            bxx, byy = int(BLK_X[blk]), int(BLK_Y[blk])
            d = self.dequant_luma_block(luma[blk], qp)
            d[0, 0] = dc[byy, bxx]
            px, py = x0 + 4 * bxx, y0 + 4 * byy
            self.add_residual(
                self.y, px, py, pred[4 * byy : 4 * byy + 4, 4 * bxx : 4 * bxx + 4], d
            )
        self.modes[by0 : by0 + 4, bx0 : bx0 + 4] = 2
        self._recon_chroma(mbx, mby, chroma_mode, cdc, cac)

    def _parse_residual(self, r, mbx, mby, cbp, i16: bool):
        """Parse luma (AC if i16) + chroma residual blocks; updates the
        total-coeff planes. Returns (luma[16], chroma_dc[2], chroma_ac[2][4])
        as scan-order coefficient arrays."""
        max_l = 15 if i16 else 16
        luma = [np.zeros(16, np.int64)] * 16
        for i8 in range(4):
            for i4 in range(4):
                blk = 4 * i8 + i4
                bx = 4 * mbx + int(BLK_X[blk])
                by = 4 * mby + int(BLK_Y[blk])
                if cbp & (1 << i8):
                    coeffs, tc = read_residual_block(
                        r, self.nc_luma(bx, by), max_l
                    )
                    full = np.zeros(16, np.int64)
                    full[16 - max_l :] = coeffs
                    luma[blk] = full
                    self.tc_y[by, bx] = tc
                else:
                    self.tc_y[by, bx] = 0
        cdc = [np.zeros(4, np.int64), np.zeros(4, np.int64)]
        cac = [[np.zeros(16, np.int64)] * 4 for _ in range(2)]
        if cbp >> 4:
            for c in range(2):
                cdc[c], _ = read_residual_block(r, -1, 4)
        for c, tc_plane in enumerate((self.tc_cb, self.tc_cr)):
            for blk in range(4):
                bx = 2 * mbx + blk % 2
                by = 2 * mby + blk // 2
                if (cbp >> 4) == 2:
                    coeffs, tc = read_residual_block(
                        r, self._nc(tc_plane, bx, by), 15
                    )
                    full = np.zeros(16, np.int64)
                    full[1:] = coeffs
                    cac[c][blk] = full
                    tc_plane[by, bx] = tc
                else:
                    tc_plane[by, bx] = 0
        return luma, cdc, cac

    def _recon_chroma(self, mbx, mby, chroma_mode, cdc, cac) -> None:
        qpc = chroma_qp(self.qp + self.cqp_offset)
        cx, cy = 8 * mbx, 8 * mby
        for c, plane in enumerate((self.cb, self.cr)):
            pred = predict_chroma(
                chroma_mode, plane, cx, cy, mbx > 0, mby > 0
            )
            # chroma DC: inverse 2x2 Hadamard, then scale with >>5 (8.5.11)
            dc2 = cdc[c].reshape(2, 2)
            h2 = np.array([[1, 1], [1, -1]], np.int64)
            f = h2 @ dc2 @ h2
            # LevelScale includes the flat weight matrix (x16): the AC
            # path folds the x16 against the formula's >>4, the DC paths
            # must carry it explicitly (8.5.11/8.5.12 with Flat_4x4_16)
            ls = 16 * int(_DEQUANT_V[qpc % 6][0])
            dc = ((f * ls) << (qpc // 6)) >> 5
            for blk in range(4):
                bxx, byy = blk % 2, blk // 2
                d = self.dequant_luma_block(cac[c][blk], qpc)
                d[0, 0] = dc[byy, bxx]
                px, py = cx + 4 * bxx, cy + 4 * byy
                self.add_residual(
                    plane, px, py,
                    pred[4 * byy : 4 * byy + 4, 4 * bxx : 4 * bxx + 4], d,
                )

    # -- encode -------------------------------------------------------------
    def encode_mb_pcm(self, w: BitWriter, mbx, mby, sy, scb, scr,
                      mb_type_offset: int = 0) -> None:
        """I_PCM macroblock: lossless (the V1 counter-strip guarantee).
        `mb_type_offset=5` emits the P-slice intra numbering."""
        x0, y0 = 16 * mbx, 16 * mby
        cx, cy = 8 * mbx, 8 * mby
        w.ue(25 + mb_type_offset)
        w.align()
        ly = sy[y0 : y0 + 16, x0 : x0 + 16]
        lcb = scb[cy : cy + 8, cx : cx + 8]
        lcr = scr[cy : cy + 8, cx : cx + 8]
        w.raw_bytes(
            ly.tobytes() + lcb.tobytes() + lcr.tobytes()
        )
        self.y[y0 : y0 + 16, x0 : x0 + 16] = ly
        self.cb[cy : cy + 8, cx : cx + 8] = lcb
        self.cr[cy : cy + 8, cx : cx + 8] = lcr
        self._mark_pcm(mbx, mby)

    def encode_mb_i4x4(self, w: BitWriter, mbx, mby, sy, scb, scr,
                       mb_type_offset: int = 0) -> None:
        qp = self.qp
        lam = max(1, int(0.85 * 2.0 ** ((qp - 12) / 3.0)))
        modes, luma_coeffs = [], []
        for blk in range(16):
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            x0, y0 = 4 * bx, 4 * by
            left, top, tr, tl = self.luma_neighbors(x0, y0, blk)
            src = sy[y0 : y0 + 4, x0 : x0 + 4].astype(np.int64)
            pmode = self.pred_mode4(bx, by)
            best = None
            for mode in range(9):
                if mode == 0 and top is None:
                    continue
                if mode == 1 and left is None:
                    continue
                if mode == 3 and top is None:
                    continue
                if mode in (4, 5, 6) and (top is None or left is None):
                    continue
                if mode == 7 and top is None:
                    continue
                if mode == 8 and left is None:
                    continue
                pred = predict_4x4(mode, left, top, tr, tl)
                cost = int(np.abs(src - pred).sum())
                cost += lam * (1 if mode == pmode else 4)
                if best is None or cost < best[0]:
                    best = (cost, mode, pred)
            _, mode, pred = best
            modes.append(mode)
            self.modes[by, bx] = mode
            res = src - pred
            wt = forward_4x4(res)
            q = quant_4x4(wt, qp)
            scan = q.reshape(-1)[ZIGZAG_4x4]
            luma_coeffs.append(scan)
            d = self.dequant_luma_block(scan, qp)
            self.add_residual(self.y, x0, y0, pred, d)
        # chroma: best of DC/H/V by SAD over both components
        cx, cy = 8 * mbx, 8 * mby
        best_c = None
        for cmode in (0, 1, 2):
            if cmode == 1 and mbx == 0:
                continue
            if cmode == 2 and mby == 0:
                continue
            sad = 0
            preds = []
            for plane, srcp in ((self.cb, scb), (self.cr, scr)):
                pred = predict_chroma(cmode, plane, cx, cy, mbx > 0, mby > 0)
                sad += int(
                    np.abs(
                        srcp[cy : cy + 8, cx : cx + 8].astype(np.int64) - pred
                    ).sum()
                )
                preds.append(pred)
            if best_c is None or sad < best_c[0]:
                best_c = (sad, cmode, preds)
        _, chroma_mode, cpreds = best_c
        qpc = chroma_qp(qp + self.cqp_offset)
        cdc_q, cac_q = [], []
        for c, (plane, srcp, pred) in enumerate(
            ((self.cb, scb, cpreds[0]), (self.cr, scr, cpreds[1]))
        ):
            res = srcp[cy : cy + 8, cx : cx + 8].astype(np.int64) - pred
            ws = [
                forward_4x4(res[4 * (b // 2) : 4 * (b // 2) + 4,
                                4 * (b % 2) : 4 * (b % 2) + 4])
                for b in range(4)
            ]
            # 2x2 Hadamard of DCs, DC-specific quant (doubled deadzone)
            h2 = np.array([[1, 1], [1, -1]], np.int64)
            dcs = np.array(
                [[ws[0][0, 0], ws[1][0, 0]], [ws[2][0, 0], ws[3][0, 0]]],
                np.int64,
            )
            fdc = h2 @ dcs @ h2
            mf = int(_QUANT_MF[qpc % 6][0])
            qbits = 15 + qpc // 6
            fdz = 2 * ((1 << qbits) // 3)
            qdc = np.sign(fdc) * ((np.abs(fdc) * mf + fdz) >> (qbits + 1))
            cdc_q.append(qdc.reshape(-1))
            acs = []
            for b in range(4):
                q = quant_4x4(ws[b], qpc, skip_dc=True)
                acs.append(q.reshape(-1)[ZIGZAG_4x4])
            cac_q.append(acs)
            # reconstruct
            ls = 16 * int(_DEQUANT_V[qpc % 6][0])  # x16 weight (see decode)
            dc = ((h2 @ qdc.reshape(2, 2) @ h2) * ls << (qpc // 6)) >> 5
            for b in range(4):
                d = self.dequant_luma_block(acs[b], qpc)
                d[0, 0] = dc[b // 2, b % 2]
                px, py = cx + 4 * (b % 2), cy + 4 * (b // 2)
                self.add_residual(
                    plane, px, py,
                    pred[4 * (b // 2) : 4 * (b // 2) + 4,
                         4 * (b % 2) : 4 * (b % 2) + 4], d,
                )
        # coded block pattern from actual coefficients
        cbp = 0
        for i8 in range(4):
            if any(luma_coeffs[4 * i8 + i4].any() for i4 in range(4)):
                cbp |= 1 << i8
        any_ac = any(a.any() for acs in cac_q for a in acs)
        any_dc = any(d.any() for d in cdc_q)
        if any_ac:
            cbp |= 2 << 4
        elif any_dc:
            cbp |= 1 << 4
        # ---- write syntax ----
        w.ue(0 + mb_type_offset)  # mb_type I_4x4 (P slices: +5)
        for blk in range(16):
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            # NOTE: pred_mode4 here sees this block's own mode already
            # written into the plane — recompute from left/above only,
            # which never include later blocks, so the value matches the
            # decoder's view.
            pmode = self.pred_mode4(bx, by)
            mode = modes[blk]
            if mode == pmode:
                w.u(1, 1)
            else:
                w.u(0, 1)
                w.u(mode - (1 if mode > pmode else 0), 3)
        w.ue(chroma_mode)
        w.ue(_CBP_INTRA_TO_CODE[cbp])
        if cbp:
            w.se(0)  # mb_qp_delta
        for i8 in range(4):
            for i4 in range(4):
                blk = 4 * i8 + i4
                bx = 4 * mbx + int(BLK_X[blk])
                by = 4 * mby + int(BLK_Y[blk])
                if cbp & (1 << i8):
                    self.tc_y[by, bx] = write_residual_block(
                        w, luma_coeffs[blk], self.nc_luma(bx, by)
                    )
                else:
                    self.tc_y[by, bx] = 0
        if cbp >> 4:
            for c in range(2):
                write_residual_block(w, cdc_q[c], -1)
        for c, tc_plane in enumerate((self.tc_cb, self.tc_cr)):
            for blk in range(4):
                bx = 2 * mbx + blk % 2
                by = 2 * mby + blk // 2
                if (cbp >> 4) == 2:
                    tc_plane[by, bx] = write_residual_block(
                        w, cac_q[c][blk][1:], self._nc(tc_plane, bx, by)
                    )
                else:
                    tc_plane[by, bx] = 0


# ---------------------------------------------------------------------------
# P-slice support (P_Skip, motion-compensated inter, intra macroblocks)
# ---------------------------------------------------------------------------
# The reference's V1 texture MP4 is inter-coded video
# (example/texture_encoder.py output). Round 3 shipped the zero-motion
# profile (P_Skip + intra refresh only); round 4 adds REAL motion
# compensation: P_L0_16x16 / 16x8 / 8x16 macroblocks with spec MV
# prediction (8.4.1.3), quarter-pel luma (6-tap, 8.4.2.2.1) and
# eighth-pel bilinear chroma interpolation (8.4.2.2.2), P_Skip with the
# derived skip motion vector (8.4.1.1), and the inter coded_block_
# pattern mapping. P_8x8 sub-partitions are refused with a clear error
# (our encoder never emits them; constrain foreign encoders with
# partitions=none).

#: Table 9-4, inter column: codeNum -> coded_block_pattern
#: (cross-validated against libavcodec reconstruction in
#: tests/test_h264_inter.py).
_CBP_INTER_FROM_CODE = np.array(
    [
        0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
        14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
        17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41,
    ],
    np.int64,
)
_CBP_INTER_TO_CODE = np.zeros(48, np.int64)
_CBP_INTER_TO_CODE[_CBP_INTER_FROM_CODE] = np.arange(48)


def _mc_luma(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
             mvx: int, mvy: int) -> np.ndarray:
    """Quarter-pel luma motion compensation (8.4.2.2.1) for a w*h block
    at (x0, y0) with quarter-pel MV (mvx, mvy). Reference samples
    outside the picture are edge-clamped (the normative extension)."""
    ih, iw = ref.shape
    fx, fy = mvx & 3, mvy & 3
    ix, iy = x0 + (mvx >> 2), y0 + (mvy >> 2)
    # padded integer window: 2 left/top, 3 right/bottom (6-tap support),
    # +1 for the quarter-pel neighbor average
    pad_l, pad_r = 2, 3 + 1
    xs = np.clip(np.arange(ix - pad_l, ix + w + pad_r), 0, iw - 1)
    ys = np.clip(np.arange(iy - pad_l, iy + h + pad_r), 0, ih - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int64)  # [h+6+, w+6+]

    def tap6(a, axis):
        s = [a.take(range(k, k + (a.shape[axis] - 5)), axis=axis)
             for k in range(6)]
        return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]

    if fx == 0 and fy == 0:
        return win[pad_l : pad_l + h, pad_l : pad_l + w].astype(np.uint8)
    # full-pel grid G, half-pel b (horizontal), h (vertical), j (center)
    G = win[pad_l : pad_l + h + 1, pad_l : pad_l + w + 1]
    b_raw = tap6(win, 1)  # [h+6+, w+1+]
    b = np.clip((b_raw[pad_l : pad_l + h + 1, : w + 1] + 16) >> 5, 0, 255)
    h_raw = tap6(win, 0)  # [h+1+, w+6+]
    h_half = np.clip(
        (h_raw[: h + 1, pad_l : pad_l + w + 1] + 16) >> 5, 0, 255
    )
    j = None
    if fx and fy:
        # j: 6-tap vertically over the raw b intermediates, >> 10
        j_raw = tap6(b_raw, 0)  # [h+1+, w+1+]
        j = np.clip((j_raw[: h + 1, : w + 1] + 512) >> 10, 0, 255)

    def at(a, dx, dy):
        return a[dy : dy + h, dx : dx + w]

    if fy == 0:  # a, b, c
        if fx == 1:
            out = (at(G, 0, 0) + at(b, 0, 0) + 1) >> 1
        elif fx == 2:
            out = at(b, 0, 0)
        else:
            out = (at(G, 1, 0) + at(b, 0, 0) + 1) >> 1
    elif fx == 0:  # d, h, n
        if fy == 1:
            out = (at(G, 0, 0) + at(h_half, 0, 0) + 1) >> 1
        elif fy == 2:
            out = at(h_half, 0, 0)
        else:
            out = (at(G, 0, 1) + at(h_half, 0, 0) + 1) >> 1
    elif fx == 2:  # f, j, q: vertical neighbors of j use b row pairs
        if fy == 1:
            out = (at(b, 0, 0) + at(j, 0, 0) + 1) >> 1
        elif fy == 2:
            out = at(j, 0, 0)
        else:
            out = (at(b, 0, 1) + at(j, 0, 0) + 1) >> 1
    elif fy == 2:  # i, j, k: horizontal neighbors of j use h columns
        if fx == 1:
            out = (at(h_half, 0, 0) + at(j, 0, 0) + 1) >> 1
        else:
            out = (at(h_half, 1, 0) + at(j, 0, 0) + 1) >> 1
    else:  # e, g, p, r: diagonal average of the nearest b and h
        bdy = 0 if fy == 1 else 1
        hdx = 0 if fx == 1 else 1
        out = (at(b, 0, bdy) + at(h_half, hdx, 0) + 1) >> 1
    return out.astype(np.uint8)


def _mc_chroma(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
               mvx: int, mvy: int) -> np.ndarray:
    """Eighth-pel bilinear chroma MC (8.4.2.2.2): the luma quarter-pel
    vector addresses eighth-pel chroma positions."""
    ih, iw = ref.shape
    fx, fy = mvx & 7, mvy & 7
    ix, iy = x0 + (mvx >> 3), y0 + (mvy >> 3)
    xs = np.clip(np.arange(ix, ix + w + 1), 0, iw - 1)
    ys = np.clip(np.arange(iy, iy + h + 1), 0, ih - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int64)
    a = win[:h, :w]
    b = win[:h, 1 : w + 1]
    c = win[1 : h + 1, :w]
    d = win[1 : h + 1, 1 : w + 1]
    out = (
        (8 - fx) * (8 - fy) * a
        + fx * (8 - fy) * b
        + (8 - fx) * fy * c
        + fx * fy * d
        + 32
    ) >> 6
    return out.astype(np.uint8)


def _slicecoder_mv_neighbors(self, bx: int, by: int, wb: int):
    """(A, B, C) neighbor MVs + availability for a partition whose
    top-left 4x4 block is (bx, by) and width wb 4x4 units. Returns
    [(avail, refok, mv)] per 8.4.1.3 (C falls back to D above-left)."""
    def probe(px, py):
        if px < 0 or py < 0 or px >= self.mv.shape[1] or py >= self.mv.shape[0]:
            return (False, False, (0, 0))
        if not self.decoded4[py, px]:
            return (False, False, (0, 0))
        ok = int(self.mvref[py, px]) == 0
        # intra neighbors are available with mvLXN = 0, refIdxLXN = -1
        mv = (
            (int(self.mv[py, px, 0]), int(self.mv[py, px, 1]))
            if ok
            else (0, 0)
        )
        return (True, ok, mv)

    a = probe(bx - 1, by)
    b = probe(bx, by - 1)
    c = probe(bx + wb, by - 1)
    if not c[0]:
        c = probe(bx - 1, by - 1)  # D
    return a, b, c


def _slicecoder_predict_mv(self, bx: int, by: int, wb: int, hb: int,
                           part: int = 0) -> Tuple[int, int]:
    """Median MV prediction (8.4.1.3) for the partition at 4x4 block
    (bx, by), size (wb, hb) in 4x4 units. `part`: 0 = whole/first,
    1 = second partition of a 16x8/8x16 macroblock."""
    a, b, c = self._mv_neighbors(bx, by, wb)
    # directional rules for the two-partition shapes
    if wb == 4 and hb == 2:  # 16x8: top -> B, bottom -> A (when ref ok)
        if part == 0 and b[1]:
            return b[2]
        if part == 1 and a[1]:
            return a[2]
    elif wb == 2 and hb == 4:  # 8x16: left -> A, right -> C
        if part == 0 and a[1]:
            return a[2]
        if part == 1 and c[1]:
            return c[2]
    refok = [n[1] for n in (a, b, c)]
    if sum(refok) == 1:
        return (a, b, c)[refok.index(True)][2]
    if not b[0] and not c[0] and a[0]:
        return a[2]
    mvs = [n[2] for n in (a, b, c)]
    return (
        int(np.median([m[0] for m in mvs])),
        int(np.median([m[1] for m in mvs])),
    )


def _slicecoder_skip_mv(self, mbx: int, mby: int) -> Tuple[int, int]:
    """P_Skip motion vector (8.4.1.1): the 16x16 prediction, forced to
    zero when the left/top neighbor is unavailable or is a zero-MV
    ref-0 block."""
    bx, by = 4 * mbx, 4 * mby
    a, b, _ = self._mv_neighbors(bx, by, 4)
    if not a[0] or not b[0]:
        return (0, 0)
    if a[1] and a[2] == (0, 0):
        return (0, 0)
    if b[1] and b[2] == (0, 0):
        return (0, 0)
    return self._predict_mv(bx, by, 4, 4)


def _slicecoder_mc_into(self, mbx, mby, x0, y0, w, h, mv, prev):
    """Motion-compensate a luma-coords region (x0,y0,w,h) from `prev`
    into the recon planes; records the MV grid. Returns the luma pred
    (for residual addition by the caller when coding, or direct store
    for skip)."""
    prev_y, prev_cb, prev_cr = prev
    mvx, mvy = mv
    pred_y = _mc_luma(prev_y, x0, y0, w, h, mvx, mvy)
    pred_cb = _mc_chroma(prev_cb, x0 // 2, y0 // 2, w // 2, h // 2, mvx, mvy)
    pred_cr = _mc_chroma(prev_cr, x0 // 2, y0 // 2, w // 2, h // 2, mvx, mvy)
    bx, by = x0 // 4, y0 // 4
    self.mv[by : by + h // 4, bx : bx + w // 4] = (mvx, mvy)
    self.mvref[by : by + h // 4, bx : bx + w // 4] = 0
    self.decoded4[by : by + h // 4, bx : bx + w // 4] = True
    return pred_y, pred_cb, pred_cr


def _slicecoder_copy_skip_mb(self, mbx, mby, prev_y, prev_cb, prev_cr):
    """P_Skip: motion-compensate with the derived skip MV (zero-motion
    streams reduce to the plain co-located copy); skipped MBs count
    TotalCoeff 0 for nC and 'not I4x4' (DC) for mode prediction."""
    x0, y0 = 16 * mbx, 16 * mby
    cx, cy = 8 * mbx, 8 * mby
    mv = self._skip_mv(mbx, mby)
    py, pcb, pcr = self._mc_into(
        mbx, mby, x0, y0, 16, 16, mv, (prev_y, prev_cb, prev_cr)
    )
    self.y[y0 : y0 + 16, x0 : x0 + 16] = py
    self.cb[cy : cy + 8, cx : cx + 8] = pcb
    self.cr[cy : cy + 8, cx : cx + 8] = pcr
    self.tc_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
    self.tc_cb[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
    self.tc_cr[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
    self.modes[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 2


def _slicecoder_decode_mb_p(self, r, mbx, mby, prev=None):
    """One CODED macroblock of a P slice."""
    mb_type = r.ue()
    if mb_type < 5:
        if prev is None:
            raise ValueError("h264: inter macroblock without a reference")
        if mb_type in (3, 4):
            raise NotImplementedError(
                "h264: P_8x8 sub-macroblock partitions (encode with "
                "partitions=none)"
            )
        self._decode_inter(r, mbx, mby, mb_type, prev)
        return
    mb_type -= 5
    if mb_type == 25:
        self._decode_pcm(r, mbx, mby)
    elif mb_type == 0:
        self._decode_i4x4(r, mbx, mby)
    elif 1 <= mb_type <= 24:
        self._decode_i16(r, mbx, mby, mb_type)
    else:
        raise ValueError(f"h264: mb_type {mb_type + 5} in P slice")
    self.mark_intra_mv(mbx, mby)


def _slicecoder_decode_inter(self, r, mbx, mby, mb_type, prev):
    """P_L0_16x16 (0) / P_L0_L0_16x8 (1) / P_L0_L0_8x16 (2)."""
    x0, y0 = 16 * mbx, 16 * mby
    bx, by = 4 * mbx, 4 * mby
    if mb_type == 0:
        parts = [(bx, by, 4, 4)]
    elif mb_type == 1:
        parts = [(bx, by, 4, 2), (bx, by + 2, 4, 2)]
    else:
        parts = [(bx, by, 2, 4), (bx + 2, by, 2, 4)]
    preds = []
    for pi, (pbx, pby, wb, hb) in enumerate(parts):
        mvdx, mvdy = r.se(), r.se()
        px, py = self._predict_mv(pbx, pby, wb, hb, part=pi)
        mv = (px + mvdx, py + mvdy)
        preds.append(
            (pbx, pby, wb, hb,
             self._mc_into(mbx, mby, 4 * pbx, 4 * pby, 4 * wb, 4 * hb,
                           mv, prev))
        )
    # assemble the full-MB prediction planes
    pred_y = np.zeros((16, 16), np.uint8)
    pred_cb = np.zeros((8, 8), np.uint8)
    pred_cr = np.zeros((8, 8), np.uint8)
    for pbx, pby, wb, hb, (py_, pcb, pcr) in preds:
        ly, lx = 4 * (pby - by), 4 * (pbx - bx)
        pred_y[ly : ly + 4 * hb, lx : lx + 4 * wb] = py_
        pred_cb[ly // 2 : ly // 2 + 2 * hb, lx // 2 : lx // 2 + 2 * wb] = pcb
        pred_cr[ly // 2 : ly // 2 + 2 * hb, lx // 2 : lx // 2 + 2 * wb] = pcr
    code = r.ue()
    if code >= 48:
        raise ValueError("h264: coded_block_pattern code out of range")
    cbp = int(_CBP_INTER_FROM_CODE[code])
    if cbp:
        self.qp = (self.qp + r.se() + 52) % 52
    luma, cdc, cac = self._parse_residual(r, mbx, mby, cbp, i16=False)
    for blk in range(16):
        bxx = int(BLK_X[blk])
        byy = int(BLK_Y[blk])
        d = self.dequant_luma_block(luma[blk], self.qp)
        self.add_residual(
            self.y, x0 + 4 * bxx, y0 + 4 * byy,
            pred_y[4 * byy : 4 * byy + 4, 4 * bxx : 4 * bxx + 4], d,
        )
    self._recon_chroma_inter(mbx, mby, pred_cb, pred_cr, cdc, cac)
    self.modes[by : by + 4, bx : bx + 4] = 2


def _slicecoder_recon_chroma_inter(self, mbx, mby, pred_cb, pred_cr,
                                   cdc, cac) -> None:
    """Chroma reconstruction from an INTER prediction (same residual
    math as _recon_chroma, prediction supplied instead of intra)."""
    qpc = chroma_qp(self.qp + self.cqp_offset)
    cx, cy = 8 * mbx, 8 * mby
    for c, (plane, pred) in enumerate(
        ((self.cb, pred_cb), (self.cr, pred_cr))
    ):
        dc2 = cdc[c].reshape(2, 2)
        h2 = np.array([[1, 1], [1, -1]], np.int64)
        f = h2 @ dc2 @ h2
        ls = 16 * int(_DEQUANT_V[qpc % 6][0])
        dc = ((f * ls) << (qpc // 6)) >> 5
        for blk in range(4):
            bxx, byy = blk % 2, blk // 2
            d = self.dequant_luma_block(cac[c][blk], qpc)
            d[0, 0] = dc[byy, bxx]
            px, py = cx + 4 * bxx, cy + 4 * byy
            self.add_residual(
                plane, px, py,
                pred[4 * byy : 4 * byy + 4, 4 * bxx : 4 * bxx + 4], d,
            )


def _slicecoder_encode_mb_i16(self, w, mbx, mby, sy, scb, scr,
                              mb_type_offset: int = 0) -> None:
    """I_16x16 macroblock: single whole-MB prediction (V/H/DC/plane by
    SAD), luma DC through the forward 4x4 Hadamard, AC blocks with the
    DC slot skipped — the cheap intra form for smooth content (x264
    codes ~75% of this corpus's intra MBs as I16; round 3 only ever
    emitted I_4x4). Reconstruction mirrors _decode_i16 bit-for-bit."""
    qp = self.qp
    x0, y0 = 16 * mbx, 16 * mby
    bx0, by0 = 4 * mbx, 4 * mby
    src = sy[y0 : y0 + 16, x0 : x0 + 16].astype(np.int64)
    left_avail, top_avail = mbx > 0, mby > 0
    best = None
    for pm in range(4):
        if pm == 0 and not top_avail:
            continue
        if pm == 1 and not left_avail:
            continue
        if pm == 3 and not (top_avail and left_avail):
            continue
        pred = predict_16x16(pm, self.y, x0, y0, left_avail, top_avail)
        sad = int(np.abs(src - pred).sum())
        if best is None or sad < best[0]:
            best = (sad, pm, pred)
    _, pred_mode, pred = best
    res = src - pred.astype(np.int64)
    ws = [
        forward_4x4(
            res[4 * int(BLK_Y[b]) : 4 * int(BLK_Y[b]) + 4,
                4 * int(BLK_X[b]) : 4 * int(BLK_X[b]) + 4]
        )
        for b in range(16)
    ]
    # luma DC: forward Hadamard over the 16 block DCs (raster layout),
    # quantized at qbits+1 with the doubled intra deadzone (the chroma-DC
    # pattern); AC blocks quantize with the DC slot skipped
    dcs = np.zeros((4, 4), np.int64)
    for b in range(16):
        dcs[int(BLK_Y[b]), int(BLK_X[b])] = ws[b][0, 0]
    # forward Hadamard halved (JM's DC chain): numerically minimizes the
    # roundtrip error against the decoder's 8.5.10 scaling (measured:
    # //2 -> 2.3 mean sq err vs 19.5 at //4 and 62 at //1, qp 28)
    fdc = (_HADAMARD4 @ dcs @ _HADAMARD4) // 2
    mf = int(_QUANT_MF[qp % 6][0])
    qbits = 15 + qp // 6
    fdz = 2 * ((1 << qbits) // 3)
    qdc = np.sign(fdc) * ((np.abs(fdc) * mf + fdz) >> (qbits + 1))
    dc_scan = qdc.reshape(-1)[ZIGZAG_4x4]
    acs = [
        quant_4x4(ws[b], qp, skip_dc=True).reshape(-1)[ZIGZAG_4x4]
        for b in range(16)
    ]
    cbp_luma = 15 if any(a[1:].any() for a in acs) else 0

    # chroma: identical machinery to encode_mb_i4x4's chroma section
    cx, cy = 8 * mbx, 8 * mby
    best_c = None
    for cmode in (0, 1, 2):
        if cmode == 1 and mbx == 0:
            continue
        if cmode == 2 and mby == 0:
            continue
        sad = 0
        preds = []
        for plane, srcp in ((self.cb, scb), (self.cr, scr)):
            cpred = predict_chroma(cmode, plane, cx, cy, mbx > 0, mby > 0)
            sad += int(
                np.abs(
                    srcp[cy : cy + 8, cx : cx + 8].astype(np.int64) - cpred
                ).sum()
            )
            preds.append(cpred)
        if best_c is None or sad < best_c[0]:
            best_c = (sad, cmode, preds)
    _, chroma_mode, cpreds = best_c
    qpc = chroma_qp(qp + self.cqp_offset)
    cdc_q, cac_q = [], []
    for c, (plane, srcp, cpred) in enumerate(
        ((self.cb, scb, cpreds[0]), (self.cr, scr, cpreds[1]))
    ):
        cres = srcp[cy : cy + 8, cx : cx + 8].astype(np.int64) - cpred
        cws = [
            forward_4x4(cres[4 * (b // 2) : 4 * (b // 2) + 4,
                             4 * (b % 2) : 4 * (b % 2) + 4])
            for b in range(4)
        ]
        h2 = np.array([[1, 1], [1, -1]], np.int64)
        cdcs = np.array(
            [[cws[0][0, 0], cws[1][0, 0]], [cws[2][0, 0], cws[3][0, 0]]],
            np.int64,
        )
        cfdc = h2 @ cdcs @ h2
        cmf = int(_QUANT_MF[qpc % 6][0])
        cqbits = 15 + qpc // 6
        cfdz = 2 * ((1 << cqbits) // 3)
        cqdc = np.sign(cfdc) * ((np.abs(cfdc) * cmf + cfdz) >> (cqbits + 1))
        cdc_q.append(cqdc.reshape(-1))
        cac_q.append(
            [quant_4x4(cws[b], qpc, skip_dc=True).reshape(-1)[ZIGZAG_4x4]
             for b in range(4)]
        )
    any_ac = any(a.any() for a2 in cac_q for a in a2)
    any_dc = any(d.any() for d in cdc_q)
    cbp_chroma = 2 if any_ac else (1 if any_dc else 0)

    # ---- write syntax ----
    mb_type = 1 + pred_mode + 4 * cbp_chroma + (12 if cbp_luma else 0)
    w.ue(mb_type + mb_type_offset)
    w.ue(chroma_mode)
    w.se(0)  # mb_qp_delta (always present for I16)
    # DC block first (nC from blk0 neighbors)
    write_residual_block(w, dc_scan, self.nc_luma(bx0, by0))
    cbp = cbp_luma | (cbp_chroma << 4)
    for i8 in range(4):
        for i4 in range(4):
            blk = 4 * i8 + i4
            bxx = bx0 + int(BLK_X[blk])
            byy = by0 + int(BLK_Y[blk])
            if cbp & (1 << i8):
                self.tc_y[byy, bxx] = write_residual_block(
                    w, acs[blk][1:], self.nc_luma(bxx, byy)
                )
            else:
                self.tc_y[byy, bxx] = 0
    if cbp >> 4:
        for c in range(2):
            write_residual_block(w, cdc_q[c], -1)
    for c, tc_plane in enumerate((self.tc_cb, self.tc_cr)):
        for blk in range(4):
            cbx = 2 * mbx + blk % 2
            cby = 2 * mby + blk // 2
            if (cbp >> 4) == 2:
                tc_plane[cby, cbx] = write_residual_block(
                    w, cac_q[c][blk][1:], self._nc(tc_plane, cbx, cby)
                )
            else:
                tc_plane[cby, cbx] = 0

    # ---- reconstruct (mirror _decode_i16 exactly) ----
    c16 = np.zeros(16, np.int64)
    c16[ZIGZAG_4x4] = dc_scan
    fr = _HADAMARD4 @ c16.reshape(4, 4) @ _HADAMARD4
    ls = 16 * int(_DEQUANT_V[qp % 6][0])
    if qp >= 36:
        dc = (fr * ls) << (qp // 6 - 6)
    else:
        dc = (fr * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)
    for blk in range(16):
        bxx, byy = int(BLK_X[blk]), int(BLK_Y[blk])
        scan_full = acs[blk].copy()
        scan_full[0] = 0
        d = self.dequant_luma_block(
            scan_full if cbp_luma else np.zeros(16, np.int64), qp
        )
        d[0, 0] = dc[byy, bxx]
        px, py = x0 + 4 * bxx, y0 + 4 * byy
        self.add_residual(
            self.y, px, py,
            pred[4 * byy : 4 * byy + 4, 4 * bxx : 4 * bxx + 4], d,
        )
    self.modes[by0 : by0 + 4, bx0 : bx0 + 4] = 2
    self._recon_chroma(
        mbx, mby, chroma_mode, cdc_q,
        cac_q if cbp_chroma == 2 else [[np.zeros(16, np.int64)] * 4] * 2,
    )


def se_bits(v: int) -> int:
    """Exp-Golomb se(v) code length in bits."""
    code_num = 2 * v - 1 if v > 0 else -2 * v
    return 2 * (code_num + 1).bit_length() - 1


def _slicecoder_encode_mb_inter16(self, w, mbx, mby, sy, scb, scr,
                                  mv, prev) -> None:
    """P_L0_16x16 with quarter-pel MV `mv`: mvd against the spec MV
    prediction, motion-compensated prediction, coded residual (inter
    CBP mapping), reconstruction + full state update."""
    qp = self.qp
    x0, y0 = 16 * mbx, 16 * mby
    cx, cy = 8 * mbx, 8 * mby
    bx, by = 4 * mbx, 4 * mby
    prev_y, prev_cb, prev_cr = prev
    pmx, pmy = self._predict_mv(bx, by, 4, 4)
    mvx, mvy = mv
    pred_y = _mc_luma(prev_y, x0, y0, 16, 16, mvx, mvy)
    pred_cb = _mc_chroma(prev_cb, cx, cy, 8, 8, mvx, mvy)
    pred_cr = _mc_chroma(prev_cr, cx, cy, 8, 8, mvx, mvy)

    luma_coeffs = []
    for blk in range(16):
        lx, ly = 4 * int(BLK_X[blk]), 4 * int(BLK_Y[blk])
        src = sy[y0 + ly : y0 + ly + 4, x0 + lx : x0 + lx + 4].astype(
            np.int64
        )
        res = src - pred_y[ly : ly + 4, lx : lx + 4]
        q = quant_4x4(forward_4x4(res), qp)
        luma_coeffs.append(q.reshape(-1)[ZIGZAG_4x4])
    qpc = chroma_qp(qp + self.cqp_offset)
    cdc_q, cac_q = [], []
    for srcp, pred in ((scb, pred_cb), (scr, pred_cr)):
        res = srcp[cy : cy + 8, cx : cx + 8].astype(np.int64) - pred
        ws = [
            forward_4x4(res[4 * (b // 2) : 4 * (b // 2) + 4,
                            4 * (b % 2) : 4 * (b % 2) + 4])
            for b in range(4)
        ]
        h2 = np.array([[1, 1], [1, -1]], np.int64)
        dcs = np.array(
            [[ws[0][0, 0], ws[1][0, 0]], [ws[2][0, 0], ws[3][0, 0]]],
            np.int64,
        )
        fdc = h2 @ dcs @ h2
        mf = int(_QUANT_MF[qpc % 6][0])
        qbits = 15 + qpc // 6
        fdz = 2 * ((1 << qbits) // 3)
        qdc = np.sign(fdc) * ((np.abs(fdc) * mf + fdz) >> (qbits + 1))
        cdc_q.append(qdc.reshape(-1))
        cac_q.append(
            [quant_4x4(ws[b], qpc, skip_dc=True).reshape(-1)[ZIGZAG_4x4]
             for b in range(4)]
        )
    cbp = 0
    for i8 in range(4):
        if any(luma_coeffs[4 * i8 + i4].any() for i4 in range(4)):
            cbp |= 1 << i8
    any_ac = any(a.any() for acs in cac_q for a in acs)
    any_dc = any(d.any() for d in cdc_q)
    if any_ac:
        cbp |= 2 << 4
    elif any_dc:
        cbp |= 1 << 4

    # ---- write syntax ----
    w.ue(0)  # mb_type P_L0_16x16
    w.se(mvx - pmx)
    w.se(mvy - pmy)
    w.ue(int(_CBP_INTER_TO_CODE[cbp]))
    if cbp:
        w.se(0)  # mb_qp_delta
    for i8 in range(4):
        for i4 in range(4):
            blk = 4 * i8 + i4
            bxx = bx + int(BLK_X[blk])
            byy = by + int(BLK_Y[blk])
            if cbp & (1 << i8):
                self.tc_y[byy, bxx] = write_residual_block(
                    w, luma_coeffs[blk], self.nc_luma(bxx, byy)
                )
            else:
                self.tc_y[byy, bxx] = 0
    if cbp >> 4:
        for c in range(2):
            write_residual_block(w, cdc_q[c], -1)
    for c, tc_plane in enumerate((self.tc_cb, self.tc_cr)):
        for blk in range(4):
            cbx = 2 * mbx + blk % 2
            cby = 2 * mby + blk // 2
            if (cbp >> 4) == 2:
                tc_plane[cby, cbx] = write_residual_block(
                    w, cac_q[c][blk][1:], self._nc(tc_plane, cbx, cby)
                )
            else:
                tc_plane[cby, cbx] = 0

    # ---- reconstruct (must match _decode_inter bit-for-bit) ----
    for blk in range(16):
        lx, ly = 4 * int(BLK_X[blk]), 4 * int(BLK_Y[blk])
        d = self.dequant_luma_block(luma_coeffs[blk], qp)
        self.add_residual(
            self.y, x0 + lx, y0 + ly,
            pred_y[ly : ly + 4, lx : lx + 4], d,
        )
    # encoder chroma-AC scans are 16-long with a zero DC slot — exactly
    # the layout _recon_chroma_inter consumes
    self._recon_chroma_inter(mbx, mby, pred_cb, pred_cr, cdc_q, cac_q)
    self.mv[by : by + 4, bx : bx + 4] = (mvx, mvy)
    self.mvref[by : by + 4, bx : bx + 4] = 0
    self.decoded4[by : by + 4, bx : bx + 4] = True
    self.modes[by : by + 4, bx : bx + 4] = 2


def _slicecoder_mark_intra_mv(self, mbx: int, mby: int) -> None:
    """Record a P-slice intra macroblock in the motion state: decoded,
    refIdx -1 (its MVs read as zero for neighbor prediction)."""
    by, bx = 4 * mby, 4 * mbx
    self.mvref[by : by + 4, bx : bx + 4] = -1
    self.decoded4[by : by + 4, bx : bx + 4] = True


SliceCoder.copy_skip_mb = _slicecoder_copy_skip_mb
SliceCoder.decode_mb_p = _slicecoder_decode_mb_p
SliceCoder._decode_inter = _slicecoder_decode_inter
SliceCoder._recon_chroma_inter = _slicecoder_recon_chroma_inter
SliceCoder._mv_neighbors = _slicecoder_mv_neighbors
SliceCoder._predict_mv = _slicecoder_predict_mv
SliceCoder._skip_mv = _slicecoder_skip_mv
SliceCoder._mc_into = _slicecoder_mc_into
SliceCoder.mark_intra_mv = _slicecoder_mark_intra_mv
SliceCoder.encode_mb_inter16 = _slicecoder_encode_mb_inter16
SliceCoder.encode_mb_i16 = _slicecoder_encode_mb_i16


def p_skip_threshold(qp: int) -> float:
    """Default macroblock skip budget (luma+chroma SSD): the expected
    intra-coding distortion at this QP (qstep²/12 per sample), so a skip
    never costs materially more distortion than coding would."""
    qstep = 0.625 * 2.0 ** (qp / 6.0)
    return 384.0 * qstep * qstep / 12.0
