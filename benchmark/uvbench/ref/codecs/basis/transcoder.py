# Frozen copy of the program's `codecs/basis/transcoder.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""BasisLZ / ETC1S transcoder (decode path for real KTX2 textures).

Decodes the supercompressed ETC1S payloads produced by `basisu -ktx2`
(the reference texture pipeline, scripts/Encoder.py:286-298) into RGB
pixels: canonical-Huffman codebooks for the global endpoint/selector
palettes and per-slice block streams with endpoint prediction and
selector history (conditional replenishment for video).

The port's copy of the reference's `codecs/basis/transcoder.py`, cut to
the full RGBA decode (`transcode_ktx2_etc1s(target="rgba")`) and the
constants the ETC1S encoder shares with it, and the player's compressed
passthrough targets: ETC1 words, ETC2+EAC, BC1/BC3 and PVRTC1
(`etc1_word_tables`, `eac_entry_tables`, `blocks_to_bc1_words`,
`alpha_blocks_to_bc4_words`, `pvrtc.py`, `FORMAT_OPTIONS`,
`select_transcode_target`). The native loops run in the port's own
library (`uvbench.ref.native`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# code-length-code transmission order (deflate-style, basis variant)
CODELENGTH_ORDER = [17, 18, 19, 20, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15, 16]
TOTAL_CODELENGTH_CODES = 21
SMALL_ZERO_RUN = 17  # 3..10 zeros, 3 extra bits
BIG_ZERO_RUN = 18  # 11..138 zeros, 7 extra bits
SMALL_REPEAT = 19  # 3..6 repeats of previous, 2 extra bits
BIG_REPEAT = 20  # 7..134 repeats, 7 extra bits
MAX_SYMS_LOG2 = 14


class BitReader:
    """LSB-first bit reader over bytes (basisu bitwise_decoder)."""

    def __init__(self, data: bytes):
        self.data = data
        self.bit_pos = 0

    def get_bits(self, n: int) -> int:
        v = 0
        for i in range(n):
            byte = self.data[self.bit_pos >> 3] if (self.bit_pos >> 3) < len(self.data) else 0
            v |= ((byte >> (self.bit_pos & 7)) & 1) << i
            self.bit_pos += 1
        return v

    def remaining_bits(self) -> int:
        return len(self.data) * 8 - self.bit_pos


class HuffmanTable:
    """Canonical Huffman decode (codes emitted LSB-first, i.e. reversed).

    The (length, reversed-code) -> symbol dict is built lazily: production
    decode goes through `flat_lut()` + the native loops, so the dict only
    materializes on the Python fallback paths.
    """

    def __init__(self, code_sizes):
        self.code_sizes = (
            code_sizes if isinstance(code_sizes, list) else list(code_sizes)
        )
        self._lookup: Optional[Dict[Tuple[int, int], int]] = None
        self._flat = None

    def _canonical(self):
        """(symbols, lengths, reversed_codes) in canonical (length, symbol)
        order — vectorized; exact for lengths <= 16."""
        sizes = np.asarray(self.code_sizes, np.int64)
        nz = np.nonzero(sizes)[0]
        if len(nz) == 0:
            return nz, nz, nz
        order = nz[np.lexsort((nz, sizes[nz]))]
        lens = sizes[order]
        # canonical code c_i = (sum_{j<i} 2^(L-l_j)) >> (L-l_i), L = max len
        L = int(lens.max())
        contrib = np.int64(1) << (L - lens)
        prefix = np.concatenate([[0], np.cumsum(contrib)[:-1]])
        codes = (prefix >> (L - lens)).astype(np.uint32)
        # bit-reverse within each code's length for the LSB-first reader
        v = codes
        v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
        v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
        v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
        v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)
        rev = v >> (16 - lens).astype(np.uint32)
        return order, lens, rev

    @property
    def lookup(self) -> Dict[Tuple[int, int], int]:
        if self._lookup is None:
            max_len = max(self.code_sizes) if self.code_sizes else 0
            if max_len > 16:
                # rare long-code path: the original sequential construction
                lk: Dict[Tuple[int, int], int] = {}
                code = 0
                for length in range(1, max_len + 1):
                    for sym, sz in enumerate(self.code_sizes):
                        if sz == length:
                            rev = 0
                            c = code
                            for _ in range(length):
                                rev = (rev << 1) | (c & 1)
                                c >>= 1
                            lk[(length, rev)] = sym
                            code += 1
                    code <<= 1
                self._lookup = lk
            else:
                syms, lens, revs = self._canonical()
                self._lookup = {
                    (int(l), int(r)): int(s)
                    for s, l, r in zip(syms, lens, revs)
                }
        return self._lookup

    def decode(self, br: BitReader) -> int:
        code = 0
        lookup = self.lookup
        for length in range(1, 33):
            code |= br.get_bits(1) << (length - 1)
            sym = lookup.get((length, code))
            if sym is not None:
                return sym
        raise ValueError("invalid Huffman code")

    def flat_lut(self) -> "np.ndarray":
        """16-bit flat decode table for the native slice decoder:
        lut[next16] = (sym << 5) | code_len (0 = invalid)."""
        if self._flat is None:
            if self.code_sizes and max(self.code_sizes) > 16:
                self._flat = False  # cannot flat-decode; use Python
            else:
                syms, lens, revs = self._canonical()
                # fill a 2^maxlen table, then tile: every code repeats
                # with period 2^len <= 2^maxlen, so the tile is exact —
                # and the strided stores touch KBs instead of 256 KB
                m = int(lens.max()) if len(lens) else 0
                small = np.zeros(1 << m, np.uint32)
                for s, l, r in zip(
                    syms.tolist(), lens.tolist(), revs.tolist()
                ):
                    small[r :: 1 << l] = (s << 5) | l
                self._flat = np.tile(small, 1 << (16 - m))
        return None if self._flat is False else self._flat


def read_huffman_table(br: BitReader) -> Optional[HuffmanTable]:
    from uvbench.ref import native as uvt_native

    res = uvt_native.huffman_read_table_native(br.data, br.bit_pos)
    if res is not None:
        sizes, br.bit_pos = res
        return None if sizes is None else HuffmanTable(sizes.tolist())
    return _read_huffman_table_py(br)


def _read_huffman_table_py(br: BitReader) -> Optional[HuffmanTable]:
    total_used_syms = br.get_bits(MAX_SYMS_LOG2)
    if total_used_syms == 0:
        return None
    num_cl_codes = br.get_bits(5)
    cl_sizes = [0] * TOTAL_CODELENGTH_CODES
    for i in range(num_cl_codes):
        cl_sizes[CODELENGTH_ORDER[i]] = br.get_bits(3)
    cl_table = HuffmanTable(cl_sizes)
    code_sizes = [0] * total_used_syms
    cur = 0
    prev_nonzero = 0
    while cur < total_used_syms:
        c = cl_table.decode(br)
        if c <= 16:
            code_sizes[cur] = c
            if c:
                prev_nonzero = c
            cur += 1
        elif c == SMALL_ZERO_RUN:
            cur += br.get_bits(3) + 3
        elif c == BIG_ZERO_RUN:
            cur += br.get_bits(7) + 11
        elif c == SMALL_REPEAT:
            rep = br.get_bits(2) + 3
            for _ in range(rep):
                code_sizes[cur] = prev_nonzero
                cur += 1
        elif c == BIG_REPEAT:
            rep = br.get_bits(7) + 7
            for _ in range(rep):
                code_sizes[cur] = prev_nonzero
                cur += 1
        else:
            raise ValueError(f"bad code-length code {c}")
    return HuffmanTable(code_sizes)


# ---------------------------------------------------------------------------
# Global palettes
# ---------------------------------------------------------------------------

# color5 delta model selection thresholds; deltas are raw huffman symbols
# added modulo 32 ((prev+delta)&31) — pinned empirically against the liam
# global data (decode consumes the buffer to within a byte)
COLOR5_PAL0_PREV_HI = 9
COLOR5_PAL1_PREV_HI = 21


@dataclasses.dataclass
class Endpoint:
    inten5: int
    color5: Tuple[int, int, int]


class EndpointList:
    """Sequence of Endpoint with the palette exposed as arrays
    (`color5_arr` [E,3] uint8, `inten_arr` [E] uint8) so per-layer
    transcode table builds stay vectorized. Endpoint objects are
    materialized lazily — the hot transcode paths only touch the
    arrays, and eagerly building ~1.5k dataclass objects per segment
    measured ~0.5 ms/frame in the playback profile."""

    def __init__(self, color5_arr: np.ndarray, inten_arr: np.ndarray):
        self.color5_arr = color5_arr
        self.inten_arr = inten_arr

    def __len__(self) -> int:
        return len(self.inten_arr)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self)))]
        c = self.color5_arr[i]
        return Endpoint(
            int(self.inten_arr[i]), (int(c[0]), int(c[1]), int(c[2]))
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _endpoint_arrays(endpoints) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(endpoints, EndpointList):
        return endpoints.color5_arr, endpoints.inten_arr
    return (
        np.array([list(e.color5) for e in endpoints], np.uint8),
        np.array([e.inten5 for e in endpoints], np.uint8),
    )


def decode_endpoints(data: bytes, num_endpoints: int) -> List[Endpoint]:
    br = BitReader(data)
    color5_model0 = read_huffman_table(br)
    color5_model1 = read_huffman_table(br)
    color5_model2 = read_huffman_table(br)
    inten_model = read_huffman_table(br)
    grayscale = br.get_bits(1)

    from uvbench.ref import native as uvt_native

    luts = (
        None if color5_model0 is None else color5_model0.flat_lut(),
        None if color5_model1 is None else color5_model1.flat_lut(),
        None if color5_model2 is None else color5_model2.flat_lut(),
        None if inten_model is None else inten_model.flat_lut(),
    )
    if all(l is not None for l in luts) and uvt_native.get_lib():
        res = uvt_native.etc1s_palette_endpoints_native(
            data, br.bit_pos, num_endpoints, grayscale, luts
        )
        if res is not None:
            color5, inten, _pos = res
            return EndpointList(color5, inten)

    endpoints = []
    prev_color5 = [16, 16, 16]
    prev_inten = 0
    for _ in range(num_endpoints):
        inten_delta = inten_model.decode(br)
        inten = (inten_delta + prev_inten) & 7
        prev_inten = inten
        color = [0, 0, 0]
        for c in range(1 if grayscale else 3):
            prev = prev_color5[c]
            if prev <= COLOR5_PAL0_PREV_HI:
                delta = color5_model0.decode(br)
            elif prev <= COLOR5_PAL1_PREV_HI:
                delta = color5_model1.decode(br)
            else:
                delta = color5_model2.decode(br)
            v = (prev + delta) & 31
            color[c] = v
            prev_color5[c] = v
        if grayscale:
            color = [color[0]] * 3
            prev_color5 = [color[0]] * 3
        endpoints.append(Endpoint(inten, tuple(color)))
    return EndpointList(
        np.array([list(e.color5) for e in endpoints], np.uint8),
        np.array([e.inten5 for e in endpoints], np.uint8),
    )


def decode_selectors(data: bytes, num_selectors: int) -> np.ndarray:
    """Returns [num_selectors, 4, 4] 2-bit selector values."""
    br = BitReader(data)
    used_global_cb = br.get_bits(1)
    if used_global_cb:
        raise NotImplementedError("global selector codebook")
    used_hybrid_cb = br.get_bits(1)
    if used_hybrid_cb:
        raise NotImplementedError("hybrid selector codebook")
    used_raw = br.get_bits(1)
    out = np.zeros((num_selectors, 4, 4), np.uint8)
    if used_raw:
        for i in range(num_selectors):
            for y in range(4):
                byte = br.get_bits(8)
                for x in range(4):
                    out[i, y, x] = (byte >> (2 * x)) & 3
        return out
    delta_model = read_huffman_table(br)

    from uvbench.ref import native as uvt_native

    lut = None if delta_model is None else delta_model.flat_lut()
    if lut is not None and uvt_native.get_lib():
        res = uvt_native.etc1s_palette_selectors_native(
            data, br.bit_pos, num_selectors, lut
        )
        if res is not None:
            codes, _pos = res
            return codes.reshape(num_selectors, 4, 4)

    prev_bytes = [0, 0, 0, 0]
    for i in range(num_selectors):
        for y in range(4):
            byte = delta_model.decode(br) ^ prev_bytes[y]
            prev_bytes[y] = byte
            for x in range(4):
                out[i, y, x] = (byte >> (2 * x)) & 3
    return out


# ---------------------------------------------------------------------------
# ETC1S slice decode (per-image block streams)
# ---------------------------------------------------------------------------

ENDPOINT_PRED_REPEAT_LAST = 256  # alphabet 257: 8-bit quad preds + repeat
PRED_LEFT = 0
PRED_ABOVE = 1
PRED_CR = 2  # copy the co-located block of the previous frame (zeros on I)
PRED_EXPLICIT = 3


def decode_vlc(br: BitReader, chunk_bits: int) -> int:
    v = 0
    ofs = 0
    mask = (1 << chunk_bits) - 1
    while True:
        s = br.get_bits(chunk_bits + 1)
        v |= (s & mask) << ofs
        ofs += chunk_bits
        if not (s >> chunk_bits):
            return v


class ApproxMoveToFront:
    """basisu's approximate-MTF selector history buffer."""

    def __init__(self, size: int):
        self.values = [0] * size
        self.size = size

    def add(self, value: int) -> None:
        half = self.size // 2
        self.values[half + 1 :] = self.values[half : self.size - 1]
        self.values[half] = value

    def use(self, index: int) -> None:
        if index:
            self.values[index - 1], self.values[index] = (
                self.values[index], self.values[index - 1],
            )

    def __getitem__(self, i: int) -> int:
        return self.values[i]


@dataclasses.dataclass
class SliceModels:
    endpoint_pred: HuffmanTable
    delta_endpoint: HuffmanTable
    selector: HuffmanTable
    selector_rle: HuffmanTable
    history_size: int


def decode_slice_models(tables_data: bytes) -> SliceModels:
    br = BitReader(tables_data)
    return SliceModels(
        endpoint_pred=read_huffman_table(br),
        delta_endpoint=read_huffman_table(br),
        selector=read_huffman_table(br),
        selector_rle=read_huffman_table(br),
        history_size=br.get_bits(13),
    )


def decode_etc1s_slice(
    data: bytes,
    num_blocks_x: int,
    num_blocks_y: int,
    models: SliceModels,
    num_endpoints: int,
    num_selectors: int,
    prev_frame: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Decode one ETC1S slice → [num_blocks_y, num_blocks_x, 2] int32
    (endpoint index, selector index).

    Semantics pinned against the liam corpus (full-slice consumption):
    endpoint-pred symbols cover 2×2 block quads (8 bits, [this, right,
    below, below-right] 2-bit fields) with a repeat escape (vlc(4)+2
    further quads); CR blocks copy the co-located previous-frame entry
    (zeros for I-frames) but still decode their selector symbol; selector
    stream = direct indices | MTF history hits | an RLE escape repeating
    history[0] (count = rle_sym + 1, 63 extends via vlc(7)).
    """
    from uvbench.ref import native as uvt_native

    if uvt_native.get_lib() is not None:
        luts = (
            models.endpoint_pred.flat_lut(),
            models.delta_endpoint.flat_lut(),
            models.selector.flat_lut(),
            models.selector_rle.flat_lut(),
        )
        if all(l is not None for l in luts):
            res = uvt_native.etc1s_slice_decode_native(
                data, num_blocks_y, num_blocks_x,
                num_endpoints, num_selectors, models.history_size,
                prev_frame, luts,
            )
            if res is not None:
                return res

    br = BitReader(data)
    hist = ApproxMoveToFront(models.history_size)
    out = np.zeros((num_blocks_y, num_blocks_x, 2), np.int32)
    if prev_frame is None:
        prev_frame = np.zeros_like(out)

    pred_rle = 0
    prev_sym = 0
    cur_bits = 0
    prev_ep = 0
    sel_rle = 0
    stored = np.zeros(num_blocks_x, np.int32)

    def decode_selector() -> int:
        nonlocal sel_rle
        sym = models.selector.decode(br)
        if sym == num_selectors + models.history_size:
            rle = models.selector_rle.decode(br)
            if rle == 63:
                rle += decode_vlc(br, 7)
            sel_rle = rle + 1
            return hist[0]
        if sym >= num_selectors:
            idx = sym - num_selectors
            s = hist[idx]
            hist.use(idx)
            return s
        hist.add(sym)
        return sym

    for by in range(num_blocks_y):
        for bx in range(num_blocks_x):
            if (by & 1) == 0 and (bx & 1) == 0:
                if pred_rle:
                    pred_rle -= 1
                    cur_bits = prev_sym
                else:
                    cur_bits = models.endpoint_pred.decode(br)
                    if cur_bits == ENDPOINT_PRED_REPEAT_LAST:
                        pred_rle = decode_vlc(br, 4) + 2
                        cur_bits = prev_sym
                    else:
                        prev_sym = cur_bits
                stored[bx] = (cur_bits >> 4) & 3
                if bx + 1 < num_blocks_x:
                    stored[bx + 1] = (cur_bits >> 6) & 3
                pred = cur_bits & 3
            elif (by & 1) == 0:
                pred = (cur_bits >> 2) & 3
            else:
                pred = int(stored[bx])

            if pred == PRED_CR:
                out[by, bx] = prev_frame[by, bx]
                if sel_rle:
                    sel_rle -= 1
                else:
                    decode_selector()
                continue

            if pred == PRED_LEFT:
                ep = int(out[by, bx - 1, 0])
            elif pred == PRED_ABOVE:
                ep = int(out[by - 1, bx, 0])
            else:
                delta = models.delta_endpoint.decode(br)
                ep = prev_ep + delta
                if ep >= num_endpoints:
                    ep -= num_endpoints
            prev_ep = ep

            if sel_rle:
                sel_rle -= 1
                sel = hist[0]
            else:
                sel = decode_selector()
            out[by, bx] = (ep, sel)

    return out


#: ETC1 modifier tables indexed by inten5 (ascending selector order)
INTEN_TABLES = np.array(
    [
        [-8, -2, 2, 8], [-17, -5, 5, 17], [-29, -9, 9, 29],
        [-42, -13, 13, 42], [-60, -18, 18, 60], [-80, -24, 24, 80],
        [-106, -33, 33, 106], [-183, -47, 47, 183],
    ],
    np.int32,
)


def blocks_to_rgb(
    blocks: np.ndarray, endpoints: List[Endpoint], selectors: np.ndarray
) -> np.ndarray:
    """(endpoint, selector) block indices → [H, W, 3] uint8 pixels."""
    nby, nbx, _ = blocks.shape
    color5, inten = _endpoint_arrays(endpoints)
    c5 = color5.astype(np.int64)
    base = (c5 << 3) | (c5 >> 2)
    ep_idx = blocks[..., 0]
    sel_idx = blocks[..., 1]
    mods = INTEN_TABLES[inten[ep_idx]]  # [nby, nbx, 4]
    sel_grid = selectors[sel_idx]  # [nby, nbx, 4, 4]
    pix_mod = np.take_along_axis(
        mods[:, :, None, None, :], sel_grid[..., None].astype(np.int64), axis=-1
    )[..., 0]
    rgb = np.clip(
        base[ep_idx][:, :, None, None, :] + pix_mod[..., None], 0, 255
    ).astype(np.uint8)
    return rgb.transpose(0, 2, 1, 3, 4).reshape(nby * 4, nbx * 4, 3)


def blocks_to_etc1_words(
    blocks: np.ndarray, endpoints: List[Endpoint], selectors: np.ndarray
) -> np.ndarray:
    """(endpoint, selector) indices → ETC1 block words [nby*nbx, 2] uint32.

    The "fast transcode" target: every ETC1S block is a valid ETC1
    differential block with both subblocks sharing the base color and
    intensity table (what the native basis transcoder emits for
    ETC1/ETC2-capable devices, src/lib/KTX2Loader.js:591-697 table).
    """
    # word1 depends only on the endpoint and word2 only on the selector,
    # so build per-palette-entry tables once and gather (the per-block
    # work is two index lookups instead of per-pixel bit packing)
    word1_of, word2_of = etc1_word_tables(endpoints, selectors)
    ep = blocks[..., 0].reshape(-1)
    sel = blocks[..., 1].reshape(-1)
    return np.stack([word1_of[ep], word2_of[sel]], axis=1)


def etc1_word_tables(
    endpoints, selectors: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-palette-entry ETC1 word tables (word1_of [E], word2_of [S]).

    Palettes are per-segment globals, so sequence transcoders build
    these once and reuse them for every layer (the rebuild measured
    ~0.6 ms/frame in the playback profile)."""
    color5, inten5 = _endpoint_arrays(endpoints)
    base5 = color5.astype(np.uint32)  # [E,3]
    inten = inten5.astype(np.uint32)
    word1_of = (
        (base5[:, 0] << 27) | (base5[:, 1] << 19) | (base5[:, 2] << 11)
        | (inten << 5) | (inten << 2) | (1 << 1)  # diff=1, flip=0
    ).astype(np.uint32)  # [E]
    # ETC1S selector s (ascending modifier [-L,-s,+s,+L]) → ETC1 pixel code
    # (msb=sign, lsb=magnitude): 0→(1,1) 1→(1,0) 2→(0,0) 3→(0,1)
    msb_of = np.array([1, 1, 0, 0], np.uint32)
    lsb_of = np.array([1, 0, 0, 1], np.uint32)
    j = np.arange(16)
    y, x = j % 4, j // 4
    codes = selectors[:, y, x]  # [S, 16] in ETC1 column-major order j=x*4+y
    word2_of = (
        (lsb_of[codes] << j[None, :]).sum(1)
        + (msb_of[codes] << (j[None, :] + 16)).sum(1)
    ).astype(np.uint32)  # [S]
    return word1_of, word2_of


def blocks_to_bc1_words(
    blocks: np.ndarray, endpoints, selectors: np.ndarray
) -> np.ndarray:
    """(endpoint, selector) indices → BC1/DXT1 block words [nby*nbx, 2]
    uint32 (word0 = color0 | color1<<16 in RGB565, word1 = 2-bit codes).

    The "dxt" fast-transcode target of the reference's format table
    (src/lib/KTX2Loader.js:591-697): each ETC1S block spans the segment
    [base+mod0 .. base+mod3]; its ends quantize to the BC1 endpoints and
    the two middle modifiers map to the 1/3-2/3 interpolants. Like the
    ETC1 target, per-palette-entry tables make the per-block work two
    gathers."""
    color5, inten5 = _endpoint_arrays(endpoints)
    c5 = color5.astype(np.int64)
    base8 = (c5 << 3) | (c5 >> 2)  # [E,3]
    mods = INTEN_TABLES[inten5.astype(np.int64)]  # [E,4]
    lo8 = np.clip(base8 + mods[:, 0:1], 0, 255)  # [E,3]
    hi8 = np.clip(base8 + mods[:, 3:4], 0, 255)

    def to565(rgb8):
        r = (rgb8[:, 0] * 31 + 127) // 255
        g = (rgb8[:, 1] * 63 + 127) // 255
        b = (rgb8[:, 2] * 31 + 127) // 255
        return (r << 11) | (g << 5) | b

    q_lo = to565(lo8)
    q_hi = to565(hi8)  # channel-wise >= q_lo, so u16 >= q_lo
    equal = q_hi == q_lo
    # 4-color mode needs color0 > color1: color0 = high end, color1 = low
    word1_of = np.where(
        equal, q_lo | (q_lo << 16), q_hi | (q_lo << 16)
    ).astype(np.uint32)
    # ETC1S selector s (ascending [-L,-s,+s,+L]) → BC1 code with color0 =
    # high: 3 (nearest low+1/3), 2 (nearest high-1/3), endpoints 1 / 0
    code_of = np.array([1, 3, 2, 0], np.uint32)
    j = np.arange(16)
    y, x = j // 4, j % 4  # BC1 texel order: i = y*4 + x, 2 bits LSB-first
    codes = code_of[selectors[:, y, x].astype(np.int64)]  # [S,16]
    word2_4c = (codes << (2 * j[None, :])).sum(1).astype(np.uint32)
    ep = blocks[..., 0].reshape(-1)
    sel = blocks[..., 1].reshape(-1)
    word2 = np.where(equal[ep], np.uint32(0), word2_4c[sel])
    return np.stack([word1_of[ep], word2.astype(np.uint32)], axis=1)


def alpha_blocks_to_bc4_words(
    blocks: np.ndarray, endpoints, selectors: np.ndarray
) -> np.ndarray:
    """ETC1S gray *alpha* slice blocks → BC4 alpha words [N, 2] uint32
    (the alpha half of a BC3 block: a0, a1, then 16 3-bit codes).

    a0 = the block's highest alpha level, a1 = the lowest (a0 > a1
    selects BC4's 8-step mode); each ETC1S selector maps to the 3-bit
    code whose interpolant is nearest its level. The code map depends on
    the endpoint entry, so it is a per-palette-entry [E, 4] table
    gathered per texel."""
    color5, inten5 = _endpoint_arrays(endpoints)
    g5 = color5[:, 1].astype(np.int64)  # alpha rides the green channel
    base8 = (g5 << 3) | (g5 >> 2)  # [E]
    mods = INTEN_TABLES[inten5.astype(np.int64)]  # [E,4] ascending
    levels = np.clip(base8[:, None] + mods, 0, 255)  # [E,4]
    a1 = levels[:, 0]
    a0 = levels[:, 3]
    equal = a0 <= a1  # uniform block: all codes 0, a0==a1
    a0 = np.where(equal, a1, a0)
    # BC4 8-step palette for a0 > a1: p0=a0, p1=a1, pk=( (8-k)*a0+(k-1)*a1 )/7
    k = np.arange(8)
    pal = np.empty((len(a0), 8), np.int64)
    pal[:, 0] = a0
    pal[:, 1] = a1
    for j in range(2, 8):
        pal[:, j] = ((8 - j) * a0 + (j - 1) * a1) // 7
    # per-entry map: ETC1S selector s (level index) -> nearest BC4 code
    code_map = np.abs(levels[:, :, None] - pal[:, None, :]).argmin(-1)  # [E,4]
    code_map[equal] = 0
    ep = blocks[..., 0].reshape(-1)
    sel = blocks[..., 1].reshape(-1)
    # texel order i = y*4 + x, 3 bits LSB-first over the 48-bit field
    j16 = np.arange(16)
    y, x = j16 // 4, j16 % 4
    sel_codes = selectors[:, y, x]  # [S,16] level indices 0..3
    codes = code_map[ep[:, None], sel_codes[sel]]  # [N,16] 3-bit codes
    field = (codes.astype(np.uint64) << (3 * j16[None, :]).astype(np.uint64)).sum(1)
    w0 = (
        a0[ep].astype(np.uint64)
        | (a1[ep].astype(np.uint64) << 8)
        | ((field & 0xFFFF) << 16)
    )
    w1 = field >> 16
    return np.stack([w0.astype(np.uint32), w1.astype(np.uint32)], axis=1)


#: ETC2 EAC alpha modifier tables (Khronos spec; extracted + verified
#: against Mesa llvmpipe's GL_COMPRESSED_RGBA8_ETC2_EAC decoder)
EAC_MODIFIERS = np.array([
    (-3, -6, -9, -15, 2, 5, 8, 14),
    (-3, -7, -10, -13, 2, 6, 9, 12),
    (-2, -5, -8, -13, 1, 4, 7, 12),
    (-2, -4, -6, -13, 1, 3, 5, 12),
    (-3, -6, -8, -12, 2, 5, 7, 11),
    (-3, -7, -9, -11, 2, 6, 8, 10),
    (-4, -7, -8, -11, 3, 6, 7, 10),
    (-3, -5, -8, -11, 2, 4, 7, 10),
    (-2, -6, -8, -10, 1, 5, 7, 9),
    (-2, -5, -8, -10, 1, 4, 7, 9),
    (-2, -4, -8, -10, 1, 3, 7, 9),
    (-2, -5, -7, -10, 1, 4, 6, 9),
    (-3, -4, -7, -10, 2, 3, 6, 9),
    (-1, -2, -3, -10, 0, 1, 2, 9),
    (-4, -6, -8, -9, 3, 5, 7, 8),
    (-3, -5, -7, -9, 2, 4, 6, 8),
], np.int64)  # [16 tables, 8 indices]


def eac_entry_tables(endpoints):
    """Per-endpoint-entry EAC alpha parameters for the ETC1S gray alpha
    slice: (byte0 [E] base, byte1 [E] mult<<4|table, code_map [E,4]).

    An ETC1S alpha block holds at most the entry's 4 intensity levels
    (alpha rides the green channel), so the best (base, multiplier,
    table) fit depends only on the endpoint entry — searched over all
    16 tables with a small multiplier/base neighborhood, scored by the
    squared distance of each level to its nearest decodable value
    (clamped like the hardware decoder)."""
    color5, inten5 = _endpoint_arrays(endpoints)
    g5 = color5[:, 1].astype(np.int64)
    base8 = (g5 << 3) | (g5 >> 2)  # [E]
    levels = np.clip(
        base8[:, None] + INTEN_TABLES[inten5.astype(np.int64)], 0, 255
    )  # [E,4] ascending
    E = len(levels)
    lmin, lmax = levels[:, 0], levels[:, 3]
    mod_min = EAC_MODIFIERS.min(axis=1)  # [16]
    mod_max = EAC_MODIFIERS.max(axis=1)
    span = (mod_max - mod_min).astype(np.float64)  # [16]
    mult0 = np.clip(
        np.round((lmax - lmin)[:, None] / span[None, :]), 1, 15
    )  # [E,16]
    # candidate grid: per table, multiplier in {m0-1,m0,m0+1} x base in
    # {b0-1,b0,b0+1}
    mults = np.clip(
        mult0[:, :, None] + np.array([-1.0, 0.0, 1.0]), 1, 15
    )  # [E,16,3]
    center = (lmin + lmax)[:, None, None] / 2.0
    b0 = np.round(
        center - mults * (mod_min + mod_max)[None, :, None] / 2.0
    )
    bases = np.clip(
        b0[..., None] + np.array([-1.0, 0.0, 1.0]), 0, 255
    )  # [E,16,3,3]
    # decodable values: [E,16,3mult,3base,8idx]
    vals = np.clip(
        bases[..., None]
        + mults[..., None, None] * EAC_MODIFIERS[None, :, None, None, :],
        0,
        255,
    )
    # error of each level against its nearest decodable value
    d = np.abs(
        vals[:, :, :, :, None, :] - levels[:, None, None, None, :, None]
    )  # [E,16,3,3,4lev,8idx]
    best_idx = d.argmin(axis=-1)  # [E,16,3,3,4]
    err = (d.min(axis=-1) ** 2).sum(axis=-1)  # [E,16,3,3]
    flat = err.reshape(E, -1).argmin(axis=1)
    ti, mi, bi = np.unravel_index(flat, (16, 3, 3))
    e_idx = np.arange(E)
    byte0 = bases[e_idx, ti, mi, bi].astype(np.uint8)  # base codeword
    mult = mults[e_idx, ti, mi].astype(np.uint8)
    byte1 = ((mult << 4) | ti.astype(np.uint8)).astype(np.uint8)
    code_map = best_idx[e_idx, ti, mi, bi]  # [E,4] level -> 3-bit index
    return byte0, byte1, code_map.astype(np.int64)


def alpha_blocks_to_eac_words(
    blocks: np.ndarray, endpoints, selectors: np.ndarray
) -> np.ndarray:
    """ETC1S gray *alpha* slice blocks → EAC alpha words [N, 2] uint32
    (big-endian halves, pack with `pack_etc1_payload` semantics: the
    alpha half of a GL_COMPRESSED_RGBA8_ETC2_EAC block).

    Wire: byte0 = base codeword, byte1 = multiplier<<4 | table, then a
    48-bit index field, 3 bits per texel MSB-first in ETC column-major
    order (texel k = x*4 + y)."""
    byte0, byte1, code_map = eac_entry_tables(endpoints)
    ep = blocks[..., 0].reshape(-1)
    sel = blocks[..., 1].reshape(-1)
    j16 = np.arange(16)
    y, x = j16 % 4, j16 // 4  # k = x*4+y column-major
    sel_codes = selectors[:, y, x]  # [S,16] level indices
    codes = code_map[ep[:, None], sel_codes[sel]].astype(np.uint64)  # [N,16]
    field = (codes << (3 * (15 - j16))[None, :].astype(np.uint64)).sum(1)
    w0 = (
        (byte0[ep].astype(np.uint64) << 24)
        | (byte1[ep].astype(np.uint64) << 16)
        | (field >> 32)
    )
    w1 = field & 0xFFFFFFFF
    return np.stack([w0.astype(np.uint32), w1.astype(np.uint32)], axis=1)


#: transcode-target selection table — priorities and constraints per device
#: capability, mirroring the reference's FORMAT_OPTIONS
#: (src/lib/KTX2Loader.js:591-697): lower priority number wins among
#: supported formats; PVRTC-class targets require power-of-two textures.
FORMAT_OPTIONS = [
    # ETC1S cannot be transcoded to ASTC blocks (reference marks this
    # priorityETC1S: Infinity, src/lib/KTX2Loader.js): etc1s priority None
    {"cap": "astc", "target": "astc-4x4", "priority_etc1s": None,
     "priority_uastc": 1, "needs_pow2": False},
    {"cap": "bptc", "target": "bc7", "priority_etc1s": 3,
     "priority_uastc": 2, "needs_pow2": False},
    {"cap": "dxt", "target": "bc1-bc3", "priority_etc1s": 4,
     "priority_uastc": 5, "needs_pow2": False},
    {"cap": "etc2", "target": "etc1", "priority_etc1s": 1,
     "priority_uastc": 3, "needs_pow2": False},
    {"cap": "etc1", "target": "etc1", "priority_etc1s": 2,
     "priority_uastc": 4, "needs_pow2": False},
    {"cap": "pvrtc", "target": "pvrtc1", "priority_etc1s": 5,
     "priority_uastc": 6, "needs_pow2": True},
]


def select_transcode_target(
    capabilities, *, is_uastc: bool = False, width: int = 0, height: int = 0
) -> str:
    """Pick the best device target; falls back to 'rgba' (full decode)."""

    def pow2(n):
        return n > 0 and (n & (n - 1)) == 0

    key = "priority_uastc" if is_uastc else "priority_etc1s"
    best = None
    for opt in FORMAT_OPTIONS:
        if opt[key] is None:  # source format cannot reach this target
            continue
        if opt["cap"] not in capabilities:
            continue
        if opt["needs_pow2"] and not (pow2(width) and pow2(height)):
            continue
        if best is None or opt[key] < best[key]:
            best = opt
    return best["target"] if best else "rgba"


def transcode_ktx2_etc1s(ktx2_file, target: str = "rgba") -> np.ndarray:
    """Full BasisLZ KTX2 → frames.

    target="rgba": [layers, H, W, 3] uint8 pixels (full decode; 4 channels
    when the file carries alpha slices).
    target="etc1": [layers, nblocks, 2] uint32 ETC1 words (fast passthrough
    for ETC-capable devices — no pixel math, palette lookups only).
    target="etc2-eac": [layers, nblocks, 4] uint32 — EAC alpha block words
    followed by the ETC1 color words (GL_COMPRESSED_RGBA8_ETC2_EAC
    layout); carries alpha files on ETC2-capable devices.
    target="bc1-bc3": [layers, nblocks, 2] uint32 BC1 words, or [layers,
    nblocks, 4] BC4 alpha words then BC1 color words (BC3) for alpha files.
    target="pvrtc1": [layers, nblocks, 2] uint32 PVRTC1 4bpp block words
    (modulation, color) in Morton order — power-of-two textures only
    (the format-selection table enforces this).
    """
    g = ktx2_file.basis_lz
    if g is None:
        raise ValueError("not a BasisLZ ktx2 file")
    h = ktx2_file.header.pixel_height
    w = ktx2_file.header.pixel_width
    # slices carry ceil(dim/4) blocks (basisu pads the last row/column);
    # floor would desync every row of a non-multiple-of-4 texture
    nbx, nby = (w + 3) // 4, (h + 3) // 4
    endpoints = decode_endpoints(g.endpoints_data, g.endpoint_count)
    selectors = decode_selectors(g.selectors_data, g.selector_count)
    models = decode_slice_models(g.tables_data)
    level = ktx2_file.levels[0].data
    has_alpha = any(d.alpha_slice_byte_length for d in g.image_descs)
    if has_alpha and target not in ("rgba", "bc1-bc3", "etc2-eac"):
        # callers fall back to the full decode like the reference on
        # devices with no matching alpha format (bc1-bc3 upgrades to
        # BC3 = BC1 color + BC4 alpha; etc2-eac pairs an EAC alpha
        # block with the ETC1 color block)
        raise NotImplementedError(f"alpha slices: no {target!r} target")
    frames = []
    prev_blocks = None
    prev_alpha_blocks = None
    etc1_tabs = (
        etc1_word_tables(endpoints, selectors)
        if target in ("etc1", "etc2-eac")
        else None
    )
    for d in g.image_descs:
        sl = level[
            d.rgb_slice_byte_offset : d.rgb_slice_byte_offset + d.rgb_slice_byte_length
        ]
        blocks = decode_etc1s_slice(
            sl, nbx, nby, models, g.endpoint_count, g.selector_count,
            prev_frame=prev_blocks,
        )
        prev_blocks = blocks

        def _alpha_blocks():
            nonlocal prev_alpha_blocks
            asl = level[
                d.alpha_slice_byte_offset :
                d.alpha_slice_byte_offset + d.alpha_slice_byte_length
            ]
            ab = decode_etc1s_slice(
                asl, nbx, nby, models, g.endpoint_count,
                g.selector_count, prev_frame=prev_alpha_blocks,
            )
            prev_alpha_blocks = ab
            return ab

        if target in ("etc1", "etc2-eac"):
            word1_of, word2_of = etc1_tabs
            from uvbench.ref import native

            color = native.etc1s_words_native(blocks, word1_of, word2_of)
            if color is None:
                color = np.stack(
                    [
                        word1_of[blocks[..., 0].reshape(-1)],
                        word2_of[blocks[..., 1].reshape(-1)],
                    ],
                    axis=1,
                )
            if target == "etc2-eac":
                # GL_COMPRESSED_RGBA8_ETC2_EAC: 8-byte EAC alpha block
                # then the 8-byte color block
                if has_alpha:
                    alpha = alpha_blocks_to_eac_words(
                        _alpha_blocks(), endpoints, selectors
                    )
                else:
                    # constant opaque alpha: base 255, multiplier 1,
                    # table 13 whose index 4 modifier is 0 -> exact 255
                    alpha = np.empty_like(color)
                    alpha[:, 0] = np.uint32(
                        (255 << 24) | (0x1D << 16) | 0x9249
                    )
                    alpha[:, 1] = np.uint32(0x24924924)
                frames.append(np.concatenate([alpha, color], axis=1))
            else:
                frames.append(color)
        elif target == "bc1-bc3":
            color = blocks_to_bc1_words(blocks, endpoints, selectors)
            if has_alpha:
                # BC3 block = 8 bytes BC4 alpha then 8 bytes BC1 color
                alpha = alpha_blocks_to_bc4_words(
                    _alpha_blocks(), endpoints, selectors
                )
                frames.append(np.concatenate([alpha, color], axis=1))
            else:
                frames.append(color)
        elif target == "pvrtc1":
            from uvbench.ref.codecs.basis.pvrtc import (
                transcode_blocks_to_pvrtc1,
            )

            frames.append(
                transcode_blocks_to_pvrtc1(blocks, endpoints, selectors, w, h)
            )
        else:
            rgb = blocks_to_rgb(blocks, endpoints, selectors)[:h, :w]
            if has_alpha:
                # alpha rides the decoded green channel (gray ETC1S slice)
                alpha = blocks_to_rgb(
                    _alpha_blocks(), endpoints, selectors
                )[:h, :w, 1:2]
                rgb = np.concatenate([rgb, alpha], axis=-1)
            frames.append(rgb)
    return np.stack(frames)
