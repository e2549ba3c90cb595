"""ASTC-LDR 4x4 block codec: spec decoder + block packer.

Two roles (VERDICT r2 item 4):
  1. Independent ASTC-LDR decoder — validated bit-exactly against Mesa
     llvmpipe's GL_KHR_texture_compression_astc_ldr decoder
     (native/astc_oracle.py), the only independent ASTC implementation
     in this offline image.
  2. Real-wire transcode target: `transcode_uastc_to_astc` repacks the
     UASTC-profile blocks of codecs/basis/uastc.py into genuine ASTC-LDR
     blocks any ASTC-capable GPU consumes — the `astc-4x4` transcode
     target of the reference's KTX2Loader FORMAT_OPTIONS
     (src/lib/KTX2Loader.js:591-697).

Spec pieces implemented (Khronos Data Format spec §C.2, LDR profile,
4x4 footprint): block mode table, void-extent, BISE integer sequences
with mixed trit/quint+bits layouts, color/weight unquantization (the
A/B/C/D method), CEMs 0/4/6/8/12 incl. blue-contract, multi-partition
(hash52 pattern generator shared with uastc.py), dual-plane, weight-grid
bilinear infill. All integer arithmetic.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from uvol_tpu_torch.codecs.basis.uastc import (
    _decode_quint_block,
    _decode_trit_block,
    astc_partition_4x4,
)

# ---------------------------------------------------------------------------
# Quantization ranges
# ---------------------------------------------------------------------------

# (trits, quints, bits) per weight range selector (H, R); R = r2r1r0
_WEIGHT_RANGES = {
    (0, 2): (0, 0, 1), (0, 3): (1, 0, 0), (0, 4): (0, 0, 2),
    (0, 5): (0, 1, 0), (0, 6): (1, 0, 1), (0, 7): (0, 0, 3),
    (1, 2): (0, 1, 1), (1, 3): (1, 0, 2), (1, 4): (0, 0, 4),
    (1, 5): (0, 1, 2), (1, 6): (1, 0, 3), (1, 7): (0, 0, 5),
}

#: color ranges, descending by level count (the decoder picks the first
#: that fits the available endpoint bits)
_COLOR_RANGES: List[Tuple[int, int, int]] = [
    (0, 0, 8), (1, 0, 6), (0, 1, 5), (0, 0, 7), (1, 0, 5), (0, 1, 4),
    (0, 0, 6), (1, 0, 4), (0, 1, 3), (0, 0, 5), (1, 0, 3), (0, 1, 2),
    (0, 0, 4), (1, 0, 2), (0, 1, 1), (0, 0, 3), (1, 0, 1), (0, 0, 2),
]


def _levels(tq: Tuple[int, int, int]) -> int:
    trits, quints, bits = tq
    return (3 if trits else 5 if quints else 1) << bits


def ise_bits(n: int, tq: Tuple[int, int, int]) -> int:
    """Total ISE bits for n values of a (trits, quints, bits) range."""
    trits, quints, bits = tq
    if trits:
        return n * bits + (8 * n + 4) // 5
    if quints:
        return n * bits + (7 * n + 2) // 3
    return n * bits


# trit/quint encode LUTs (inverse of the Khronos block decodes)
def _build_luts():
    trit_enc = np.full(3**5, -1, np.int64)
    for t in range(256):
        vals = _decode_trit_block(t)
        idx = 0
        for k in range(4, -1, -1):
            idx = idx * 3 + vals[k]
        if trit_enc[idx] < 0:
            trit_enc[idx] = t
    quint_enc = np.full(5**3, -1, np.int64)
    for q in range(128):
        vals = _decode_quint_block(q)
        idx = 0
        for k in range(2, -1, -1):
            idx = idx * 5 + vals[k]
        if quint_enc[idx] < 0:
            quint_enc[idx] = q
    return trit_enc, quint_enc


_TRIT_ENC, _QUINT_ENC = _build_luts()

# T/Q-block bit chunks interleaved with value bits (spec C.2.12):
# trits: m0, T[1:0], m1, T[3:2], m2, T[4], m3, T[6:5], m4, T[7]
_TRIT_CHUNKS = [2, 2, 1, 2, 1]
# quints: m0, Q[2:0], m1, Q[4:3], m2, Q[6:5]
_QUINT_CHUNKS = [3, 2, 2]


class _BitVec:
    """128-bit little-endian bit vector."""

    def __init__(self, value: int = 0):
        self.v = value

    def get(self, pos: int, width: int) -> int:
        return (self.v >> pos) & ((1 << width) - 1)

    def put(self, pos: int, width: int, value: int) -> None:
        mask = ((1 << width) - 1) << pos
        self.v = (self.v & ~mask) | ((value & ((1 << width) - 1)) << pos)

    def bytes16(self) -> bytes:
        return self.v.to_bytes(16, "little")


def ise_read(bv: _BitVec, pos: int, n: int, tq) -> Tuple[List[int], int]:
    """Read n ISE values (each trit/quint * 2^bits + bits) from pos."""
    trits, quints, bits = tq
    out: List[int] = []
    if not trits and not quints:
        for _ in range(n):
            out.append(bv.get(pos, bits) if bits else 0)
            pos += bits
        return out, pos
    group = 5 if trits else 3
    chunks = _TRIT_CHUNKS if trits else _QUINT_CHUNKS
    decode = _decode_trit_block if trits else _decode_quint_block
    for g0 in range(0, n, group):
        k = min(group, n - g0)
        ms = []
        tbits = 0
        tpos = 0
        for i in range(k):
            ms.append(bv.get(pos, bits) if bits else 0)
            pos += bits
            tbits |= bv.get(pos, chunks[i]) << tpos
            tpos += chunks[i]
            pos += chunks[i]
        ds = decode(tbits)
        for i in range(k):
            out.append(ds[i] * (1 << bits) + ms[i])
    return out, pos


def ise_write(bv: _BitVec, pos: int, values: Sequence[int], tq) -> int:
    """Write ISE values (trit/quint*2^bits + bits form); returns end."""
    trits, quints, bits = tq
    if not trits and not quints:
        for v in values:
            if bits:
                bv.put(pos, bits, v)
            pos += bits
        return pos
    group = 5 if trits else 3
    chunks = _TRIT_CHUNKS if trits else _QUINT_CHUNKS
    base = 3 if trits else 5
    enc = _TRIT_ENC if trits else _QUINT_ENC
    n = len(values)
    for g0 in range(0, n, group):
        k = min(group, n - g0)
        ds = [values[g0 + i] >> bits for i in range(k)] + [0] * (group - k)
        ms = [values[g0 + i] & ((1 << bits) - 1) for i in range(k)]
        idx = 0
        for i in range(group - 1, -1, -1):
            idx = idx * base + ds[i]
        code = int(enc[idx])
        assert code >= 0
        tpos = 0
        for i in range(k):
            if bits:
                bv.put(pos, bits, ms[i])
            pos += bits
            bv.put(pos, chunks[i], (code >> tpos) & ((1 << chunks[i]) - 1))
            tpos += chunks[i]
            pos += chunks[i]
    return pos


# ---------------------------------------------------------------------------
# Unquantization (spec C.2.13 / C.2.16)
# ---------------------------------------------------------------------------


def _bit_replicate(v: int, n: int, out_bits: int) -> int:
    if n == 0:
        return 0
    s = v
    width = n
    while width < out_bits:
        s = (s << n) | v
        width += n
    return s >> (width - out_bits)


# trit/quint color B patterns (9-bit, variables b..f = value bits 1..5)
_COLOR_B_TRIT = {2: "b000b0bb0", 3: "cb000cbcb", 4: "dcb000dcb",
                 5: "edcb000ed", 6: "fedcb000f"}
_COLOR_B_QUINT = {2: "b0000bb00", 3: "cb0000cbc", 4: "dcb0000dc",
                  5: "edcb0000e"}
_COLOR_C_TRIT = {1: 204, 2: 93, 3: 44, 4: 22, 5: 11, 6: 5}
_COLOR_C_QUINT = {1: 113, 2: 54, 3: 26, 4: 13, 5: 6}
# weight variants (7-bit)
_WEIGHT_B_TRIT = {2: "b000b0b", 3: "cb000cb"}
_WEIGHT_B_QUINT = {2: "b0000b0"}
_WEIGHT_C_TRIT = {1: 50, 2: 23, 3: 11}
_WEIGHT_C_QUINT = {1: 28, 2: 13}


def _pattern_value(pattern: str, bits_val: int) -> int:
    """Evaluate a B bit-pattern string (MSB first; letters b..f name
    value bits 1..5, '0' zero)."""
    out = 0
    for ch in pattern:
        out <<= 1
        if ch != "0":
            out |= (bits_val >> (ord(ch) - ord("a"))) & 1
    return out


def unquantize_color(v: int, tq: Tuple[int, int, int]) -> int:
    trits, quints, bits = tq
    if not trits and not quints:
        return _bit_replicate(v, bits, 8)
    d, b = v >> bits, v & ((1 << bits) - 1)
    a = 0x1FF if (b & 1) else 0
    if trits:
        c = _COLOR_C_TRIT[bits]
        bp = _COLOR_B_TRIT.get(bits)
    else:
        c = _COLOR_C_QUINT[bits]
        bp = _COLOR_B_QUINT.get(bits)
    bval = _pattern_value(bp, b) if bp else 0
    t = d * c + bval
    t ^= a
    return (a & 0x80) | (t >> 2)


def unquantize_weight(v: int, tq: Tuple[int, int, int]) -> int:
    trits, quints, bits = tq
    if not trits and not quints:
        if bits == 0:
            return 0
        w = _bit_replicate(v, bits, 6)
        return w + 1 if w > 32 else w
    d, b = v >> bits, v & ((1 << bits) - 1)
    if bits == 0:
        # direct tables for pure trit/quint weights (oracle-verified)
        return (0, 32, 64)[d] if trits else (0, 16, 32, 48, 64)[d]
    a = 0x7F if (b & 1) else 0
    if trits:
        c = _WEIGHT_C_TRIT[bits]
        bp = _WEIGHT_B_TRIT.get(bits)
    else:
        c = _WEIGHT_C_QUINT[bits]
        bp = _WEIGHT_B_QUINT.get(bits)
    bval = _pattern_value(bp, b) if bp else 0
    t = d * c + bval
    t ^= a
    t = (a & 0x20) | (t >> 2)
    return t + 1 if t > 32 else t


# ---------------------------------------------------------------------------
# Block mode
# ---------------------------------------------------------------------------


def decode_block_mode(m: int):
    """11-bit block mode → (gw, gh, (trits,quints,bits), dual) or None."""
    if m & 0x3 != 0:
        r = ((m >> 1 & 1) << 2) | ((m & 1) << 1) | ((m >> 4) & 1)
        h = (m >> 9) & 1
        d = (m >> 10) & 1
        a = (m >> 5) & 0x3
        b = (m >> 7) & 0x3
        sel = (m >> 2) & 0x3
        if sel == 0:
            gw, gh = b + 4, a + 2
        elif sel == 1:
            gw, gh = b + 8, a + 2
        elif sel == 2:
            gw, gh = a + 2, b + 8
        else:
            if (m >> 8) & 1:
                gw, gh = (b & 1) + 2, a + 2
            else:
                gw, gh = a + 2, (b & 1) + 6
    else:
        if (m >> 2) & 0x3 == 0 and (m >> 4) & 0xF == 0:
            return None  # reserved
        r = ((m >> 3 & 1) << 2) | ((m >> 2 & 1) << 1) | ((m >> 4) & 1)
        h = (m >> 9) & 1
        d = (m >> 10) & 1
        a = (m >> 5) & 0x3
        sel = (m >> 7) & 0x3
        if sel == 0:
            gw, gh = 12, a + 2
        elif sel == 1:
            gw, gh = a + 2, 12
        elif sel == 3 and (m >> 5) & 0xF == 0:
            gw, gh = 6, 10
        elif sel == 3 and (m >> 5) & 0xF == 4:
            gw, gh = 10, 6
        elif sel == 2:
            b = (m >> 9) & 0x3
            gw, gh = a + 6, b + 6
            d = 0
            h = 0
        else:
            return None
    if r < 2:
        return None
    return gw, gh, _WEIGHT_RANGES[(h, r)], bool(d)


_WEIGHT_RANGES_INV = {v: k for k, v in _WEIGHT_RANGES.items()}


def encode_block_mode(gw: int, gh: int, tq, dual: bool) -> int:
    """Inverse of decode_block_mode for the grids this packer emits
    (gw ∈ 2..4, gh ∈ 2..8 subsets)."""
    h, r = _WEIGHT_RANGES_INV[tuple(tq)]
    r0, r1, r2 = r & 1, (r >> 1) & 1, (r >> 2) & 1
    d = 1 if dual else 0
    if 4 <= gw <= 7 and 2 <= gh <= 5:
        a, b = gh - 2, gw - 4
        sel = 0
    elif 2 <= gw <= 3 and 2 <= gh <= 5:
        # row: D H 1 B A A R0 1 1 R2 R1 → W = B+2, H = A+2
        m = (r1 << 0) | (r2 << 1) | (1 << 2) | (1 << 3) | (r0 << 4)
        m |= (gh - 2) << 5 | (gw - 2) << 7 | (1 << 8) | (h << 9) | (d << 10)
        return m
    else:
        raise ValueError(f"unsupported grid {gw}x{gh}")
    m = (r1 << 0) | (r2 << 1) | (sel << 2) | (r0 << 4)
    m |= a << 5 | b << 7 | (h << 9) | (d << 10)
    return m


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

_ERROR_COLOR = np.array([255, 0, 255, 255], np.uint8)


def _cem_values(cem: int) -> int:
    return (((cem >> 2) & 0x3) + 1) * 2


def _decode_endpoints(cem: int, v: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """LDR endpoint decode for CEMs 0/4/6/8/12 (spec C.2.14)."""
    def bc(r, g, b, a):
        return np.array([(r + b) >> 1, (g + b) >> 1, b, a], np.int64)

    if cem == 0:
        return (np.array([v[0], v[0], v[0], 255], np.int64),
                np.array([v[1], v[1], v[1], 255], np.int64))
    if cem == 4:
        return (np.array([v[0], v[0], v[0], v[2]], np.int64),
                np.array([v[1], v[1], v[1], v[3]], np.int64))
    if cem == 6:
        e1 = np.array([v[0], v[1], v[2], 255], np.int64)
        e0 = np.array(
            [(v[0] * v[3]) >> 8, (v[1] * v[3]) >> 8, (v[2] * v[3]) >> 8, 255],
            np.int64,
        )
        return e0, e1
    if cem == 8:
        if v[1] + v[3] + v[5] >= v[0] + v[2] + v[4]:
            return (np.array([v[0], v[2], v[4], 255], np.int64),
                    np.array([v[1], v[3], v[5], 255], np.int64))
        return bc(v[1], v[3], v[5], 255), bc(v[0], v[2], v[4], 255)
    if cem == 12:
        if v[1] + v[3] + v[5] >= v[0] + v[2] + v[4]:
            return (np.array([v[0], v[2], v[4], v[6]], np.int64),
                    np.array([v[1], v[3], v[5], v[7]], np.int64))
        return bc(v[1], v[3], v[5], v[7]), bc(v[0], v[2], v[4], v[6])
    raise ValueError(f"astc: unsupported LDR CEM {cem}")


def _infill_weights(grid: np.ndarray, gw: int, gh: int) -> np.ndarray:
    """Weight-grid bilinear infill to the 4x4 footprint (spec C.2.18)."""
    if (gw, gh) == (4, 4):
        return grid.reshape(4, 4)
    out = np.zeros((4, 4), np.int64)
    ds = (1024 + 2) // 3  # block dim 4: floor((1024 + 4/2) / (4-1))
    g = grid.reshape(gh, gw)
    for t in range(4):
        for s in range(4):
            cs = ds * s
            ct = ds * t
            gs = (cs * (gw - 1) + 32) >> 6
            gt = (ct * (gh - 1) + 32) >> 6
            js, fs = gs >> 4, gs & 0xF
            jt, ft = gt >> 4, gt & 0xF
            p00 = int(g[jt, js])
            p01 = int(g[jt, min(js + 1, gw - 1)])
            p10 = int(g[min(jt + 1, gh - 1), js])
            p11 = int(g[min(jt + 1, gh - 1), min(js + 1, gw - 1)])
            w11 = (fs * ft + 8) >> 4
            w10 = ft - w11
            w01 = fs - w11
            w00 = 16 - fs - ft + w11
            out[t, s] = (
                p00 * w00 + p01 * w01 + p10 * w10 + p11 * w11 + 8
            ) >> 4
    return out


def decode_astc_block(block: bytes) -> np.ndarray:
    """One 16-byte ASTC block → [4,4,4] RGBA8 (LDR; error color on
    invalid encodings, like a conformant decoder)."""
    bv = _BitVec(int.from_bytes(block, "little"))
    mode = bv.get(0, 11)
    if (mode & 0x1FF) == 0x1FC:  # void extent
        if mode & 0x200:  # HDR
            return np.tile(_ERROR_COLOR, (4, 4, 1))
        cols = [((bv.get(64 + 16 * i, 16)) >> 8) for i in range(4)]
        return np.tile(np.array(cols, np.uint8), (4, 4, 1))
    bm = decode_block_mode(mode)
    if bm is None:
        return np.tile(_ERROR_COLOR, (4, 4, 1))
    gw, gh, wtq, dual = bm
    if gw > 4 or gh > 4:
        return np.tile(_ERROR_COLOR, (4, 4, 1))
    parts = bv.get(11, 2) + 1
    nweights = gw * gh * (2 if dual else 1)
    wbits = ise_bits(nweights, wtq)
    if nweights > 64 or wbits > 96 or wbits < 24:
        return np.tile(_ERROR_COLOR, (4, 4, 1))
    if dual and parts == 4:
        return np.tile(_ERROR_COLOR, (4, 4, 1))
    extra_cem = 0
    if parts == 1:
        cems = [bv.get(13, 4)]
        color_start = 17
        part_index = 0
    else:
        part_index = bv.get(13, 10)
        cem_field = bv.get(23, 6)
        color_start = 29
        if cem_field & 0x3 == 0:
            cems = [cem_field >> 2] * parts
        else:
            # multi-CEM: base class + per-partition (C_i, M_i); the low
            # bits live in the field, the remainder just below the weights
            extra_cem = 3 * parts - 4
            full = (
                bv.get(128 - wbits - extra_cem, extra_cem) << 4
            ) | (cem_field >> 2)
            base_class = (cem_field & 0x3) - 1
            cs = [(full >> i) & 1 for i in range(parts)]
            rest = full >> parts
            cems = []
            for i in range(parts):
                m = (rest >> (2 * i)) & 0x3
                cems.append(((base_class + cs[i]) << 2) | m)
    ccs_bits = 2 if dual else 0
    ccs = (
        bv.get(128 - wbits - extra_cem - ccs_bits, 2) if dual else 0
    )
    config_end = 128 - wbits - extra_cem - ccs_bits
    ncolor = sum(_cem_values(c) for c in cems)
    if ncolor > 18:
        return np.tile(_ERROR_COLOR, (4, 4, 1))
    avail = config_end - color_start
    ctq = None
    for tq in _COLOR_RANGES:
        if ise_bits(ncolor, tq) <= avail:
            ctq = tq
            break
    if ctq is None or _levels(ctq) < 6:
        return np.tile(_ERROR_COLOR, (4, 4, 1))
    cvals_q, _ = ise_read(bv, color_start, ncolor, ctq)
    cvals = [unquantize_color(v, ctq) for v in cvals_q]
    # endpoints per partition
    eps = []
    off = 0
    for c in cems:
        n = _cem_values(c)
        try:
            eps.append(_decode_endpoints(c, cvals[off : off + n]))
        except ValueError:
            return np.tile(_ERROR_COLOR, (4, 4, 1))
        off += n
    # weights: bit-reversed stream from the top of the block
    rv = 0
    v = bv.v
    for _ in range(128):
        rv = (rv << 1) | (v & 1)
        v >>= 1
    wq, _ = ise_read(_BitVec(rv), 0, nweights, wtq)
    wu = [unquantize_weight(x, wtq) for x in wq]
    if dual:
        plane0 = np.array(wu[0::2], np.int64)
        plane1 = np.array(wu[1::2], np.int64)
    else:
        plane0 = np.array(wu, np.int64)
        plane1 = None
    w0 = _infill_weights(plane0, gw, gh)
    w1 = _infill_weights(plane1, gw, gh) if dual else None
    pmap = (
        astc_partition_4x4(part_index, parts)
        if parts > 1
        else np.zeros(16, np.int64)
    ).reshape(4, 4)
    out = np.zeros((4, 4, 4), np.uint8)
    for t in range(4):
        for s in range(4):
            e0, e1 = eps[int(pmap[t, s])]
            c0 = (e0 << 8) | e0
            c1 = (e1 << 8) | e1
            w = np.full(4, int(w0[t, s]), np.int64)
            if dual:
                w[ccs] = int(w1[t, s])
            px = (c0 * (64 - w) + c1 * w + 32) >> 6
            out[t, s] = (px >> 8).astype(np.uint8)
    return out


def decode_astc_blocks(blocks: np.ndarray) -> np.ndarray:
    """[N,16] uint8 → [N,4,4,4] RGBA8."""
    blocks = np.asarray(blocks, np.uint8).reshape(-1, 16)
    return np.stack([decode_astc_block(b.tobytes()) for b in blocks])


# ---------------------------------------------------------------------------
# Pack (for tests + the UASTC transcode)
# ---------------------------------------------------------------------------


def pack_void_extent(rgba8: Sequence[int]) -> bytes:
    bv = _BitVec()
    bv.put(0, 9, 0x1FC)
    bv.put(10, 2, 0x3)
    bv.put(12, 52, (1 << 52) - 1)
    for i, c in enumerate(rgba8):
        bv.put(64 + 16 * i, 16, (int(c) << 8) | int(c))
    return bv.bytes16()


def pack_astc_block(
    *,
    gw: int = 4,
    gh: int = 4,
    weight_tq: Tuple[int, int, int],
    color_tq: Tuple[int, int, int],
    cems: Sequence[int],
    color_values: Sequence[int],
    weights: Sequence[int],
    part_index: int = 0,
    dual: bool = False,
    ccs: int = 0,
) -> bytes:
    """Assemble a conformant ASTC-LDR block from quantized fields.

    `color_tq` must be the range the decoder will infer (asserted);
    shared-CEM multi-partition form only (what the transcode emits)."""
    parts = len(cems)
    bv = _BitVec()
    mode = encode_block_mode(gw, gh, weight_tq, dual)
    bv.put(0, 11, mode)
    bv.put(11, 2, parts - 1)
    if parts == 1:
        bv.put(13, 4, cems[0])
        color_start = 17
    else:
        assert all(c == cems[0] for c in cems), "shared CEM only"
        bv.put(13, 10, part_index)
        bv.put(23, 6, cems[0] << 2)
        color_start = 29
    nweights = gw * gh * (2 if dual else 1)
    wbits = ise_bits(nweights, weight_tq)
    ccs_bits = 2 if dual else 0
    if dual:
        bv.put(128 - wbits - 2, 2, ccs)
    avail = 128 - wbits - ccs_bits - color_start
    ncolor = sum(_cem_values(c) for c in cems)
    inferred = None
    for tq in _COLOR_RANGES:
        if ise_bits(ncolor, tq) <= avail:
            inferred = tq
            break
    assert inferred == tuple(color_tq), (inferred, color_tq)
    ise_write(bv, color_start, list(color_values), color_tq)
    # weights: write into a reversed bit vector, then reverse back in
    wv = _BitVec()
    ise_write(wv, 0, list(weights), weight_tq)
    rv = 0
    v = wv.v
    for _ in range(128):
        rv = (rv << 1) | (v & 1)
        v >>= 1
    bv.v |= rv
    return bv.bytes16()


# ---------------------------------------------------------------------------
# UASTC-profile -> ASTC transcode
# ---------------------------------------------------------------------------

#: UASTC weight level count -> ASTC weight range
_LEVELS_TO_WTQ = {2: (0, 0, 1), 3: (1, 0, 0), 4: (0, 0, 2),
                  5: (0, 1, 0), 8: (0, 0, 3), 16: (0, 0, 4)}


from functools import lru_cache


@lru_cache(maxsize=None)
def _color_unquant_lut(tq) -> np.ndarray:
    return np.array(
        [unquantize_color(v, tq) for v in range(_levels(tq))], np.int64
    )


@lru_cache(maxsize=None)
def _weight_unquant_lut(tq) -> np.ndarray:
    return np.array(
        [unquantize_weight(v, tq) for v in range(_levels(tq))], np.int64
    )


def transcode_uastc_to_astc(blocks: np.ndarray) -> np.ndarray:
    """[B,16] UASTC-profile blocks (codecs/basis/uastc.py) → [B,16] real
    ASTC-LDR blocks.

    Value-exact for the modes whose configuration lands on an ASTC color
    range that reproduces the profile's bit-replicated endpoints
    (modes 1,2,4,5,7,12,13,14,15,16,18 + solid); nearest-value endpoint
    (and, for mode 0, weight) requantization otherwise — the same
    requantize-on-transcode contract as the ETC1S→BC1 path. The emitted
    wire is always conformant ASTC (oracle-validated); the decoded image
    of EXACT modes matches `decode_uastc_blocks` bit-for-bit.
    """
    from uvol_tpu_torch.codecs.basis.uastc import (
        MODE_SOLID,
        MODES,
        WEIGHT_TABLES,
        _bits_of,
        _expand_endpoint,
        _get_bise,
        _get_field,
        _ncomp,
    )

    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, 16)
    bits = _bits_of(blocks)
    modes = _get_field(bits, 0, 5)
    out = np.zeros_like(blocks)
    for i in range(len(blocks)):
        mode_id = int(modes[i])
        row = bits[i : i + 1]
        if mode_id == MODE_SOLID:
            rgba = [int(_get_field(row, 5 + 8 * c, 8)[0]) for c in range(4)]
            out[i] = np.frombuffer(pack_void_extent(rgba), np.uint8)
            continue
        m = MODES.get(mode_id)
        if m is None:
            raise ValueError(f"uastc mode {mode_id} unknown")
        nc = _ncomp(m)
        pos = 5
        comp = 3
        if m.dual_plane:
            comp = int(_get_field(row, pos, 2)[0])
            pos += 2
        seed = 0
        subsets = m.subsets
        if subsets > 1:
            seed = int(_get_field(row, pos, 10)[0])
            pos += 10
        q0 = np.zeros((subsets, nc), np.int64)
        q1 = np.zeros((subsets, nc), np.int64)
        for p in range(subsets):
            for c in range(nc):
                q0[p, c] = _get_field(row, pos, m.ep_bits)[0]
                pos += m.ep_bits
                q1[p, c] = _get_field(row, pos, m.ep_bits)[0]
                pos += m.ep_bits
        wq, pos = _get_bise(row, pos, 16, m.weight_levels)
        wq = wq[0]
        wq2 = None
        if m.dual_plane:
            wq2, pos = _get_bise(row, pos, 16, m.weight_levels)
            wq2 = wq2[0]

        # ---- target ASTC config -------------------------------------------
        levels = m.weight_levels
        wtq = _LEVELS_TO_WTQ[levels]
        nweights = 16 * (2 if m.dual_plane else 1)
        promote2 = levels == 2 and ise_bits(nweights, wtq) < 24
        if promote2:
            wtq = (0, 0, 2)  # 1-bit grid under the 24-bit floor: 0→0, 1→3
        wl = _levels(wtq)
        wlut = _weight_unquant_lut(tuple(wtq))
        cem = m.cem
        ncolor = 2 * nc * subsets
        wbits = ise_bits(nweights, wtq)
        start = 17 if subsets == 1 else 29
        avail = 128 - wbits - (2 if m.dual_plane else 0) - start
        ctq = next(
            (tq for tq in _COLOR_RANGES if ise_bits(ncolor, tq) <= avail),
            None,
        )
        if ctq is None or _levels(ctq) < 6:
            raise ValueError(f"uastc mode {mode_id}: no ASTC color range fits")
        clut = _color_unquant_lut(tuple(ctq))

        def cquant(target8: int) -> int:
            return int(np.abs(clut - target8).argmin())

        # per-subset endpoint values with CEM 8/12 ordering (avoid the
        # decoder's blue-contract branch by keeping s1 >= s0)
        flip = [False] * subsets
        cvals: List[int] = []
        for p in range(subsets):
            e0 = _expand_endpoint(q0[p], m.ep_bits)
            e1 = _expand_endpoint(q1[p], m.ep_bits)
            v0 = [cquant(int(x)) for x in e0]
            v1 = [cquant(int(x)) for x in e1]
            u0 = [int(clut[v]) for v in v0]
            u1 = [int(clut[v]) for v in v1]
            if cem in (8, 12) and sum(u1[:3]) < sum(u0[:3]):
                v0, v1 = v1, v0
                flip[p] = True
            if cem == 4:
                # ASTC CEM4 LA order: v0,v1 = L0,L1; v2,v3 = A0,A1
                cvals += [v0[0], v1[0], v0[1], v1[1]]
            else:
                for c in range(nc):
                    cvals += [v0[c], v1[c]]

        # weights in ASTC order (texel-major; dual-plane interleaved)
        uastc_w64 = WEIGHT_TABLES[levels]

        def wmap(q: int) -> int:
            if promote2:
                return 3 * int(q)
            target = int(uastc_w64[int(q)])
            return int(np.abs(wlut - target).argmin())

        if subsets > 1:
            pmap = astc_partition_4x4(seed, subsets)
        else:
            pmap = np.zeros(16, np.int64)
        weights: List[int] = []
        for t in range(16):
            inv = flip[int(pmap[t])]
            wv = wmap(int(wq[t]))
            if inv:
                wv = wl - 1 - wv
            if m.dual_plane:
                w2 = wmap(int(wq2[t]))
                if inv:
                    w2 = wl - 1 - w2
                weights += [wv, w2]
            else:
                weights.append(wv)
        out[i] = np.frombuffer(
            pack_astc_block(
                weight_tq=wtq,
                color_tq=ctq,
                cems=[cem] * subsets,
                color_values=cvals,
                weights=weights,
                part_index=seed,
                dual=m.dual_plane,
                ccs=comp,
            ),
            np.uint8,
        )
    return out


#: modes whose transcode reproduces decode_uastc_blocks bit-for-bit
ASTC_EXACT_MODES = frozenset({1, 2, 4, 5, 7, 8, 12, 13, 14, 15, 16, 18})
