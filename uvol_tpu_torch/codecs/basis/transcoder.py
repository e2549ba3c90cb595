"""BasisLZ / ETC1S transcoder (decode path for real KTX2 textures).

Decodes the supercompressed ETC1S payloads produced by `basisu -ktx2`
(the reference texture pipeline, scripts/Encoder.py:286-298) into RGB
pixels: canonical-Huffman codebooks for the global endpoint/selector
palettes and per-slice block streams with endpoint prediction and
selector history (conditional replenishment for video).

The port's copy of the reference's `codecs/basis/transcoder.py`, cut to
the full RGBA decode (`transcode_ktx2_etc1s(target="rgba")`) and the
constants the ETC1S encoder shares with it. The native loops run in the
port's own library (`uvol_tpu_torch.native`). The compressed targets
(ETC1 words, BC1/BC3, ETC2+EAC, PVRTC1) are not copied yet.
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
    from uvol_tpu_torch import native as uvt_native

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

    from uvol_tpu_torch import native as uvt_native

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

    from uvol_tpu_torch import native as uvt_native

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
    from uvol_tpu_torch import native as uvt_native

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


def transcode_ktx2_etc1s(ktx2_file, target: str = "rgba") -> np.ndarray:
    """Full BasisLZ KTX2 → [layers, H, W, 3] uint8 pixels (4 channels
    when the file carries alpha slices). Only `target="rgba"` is copied."""
    if target != "rgba":
        raise NotImplementedError(f"transcode target {target!r} is not ported")
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
    frames = []
    prev_blocks = None
    prev_alpha_blocks = None
    for d in g.image_descs:
        sl = level[
            d.rgb_slice_byte_offset : d.rgb_slice_byte_offset + d.rgb_slice_byte_length
        ]
        blocks = decode_etc1s_slice(
            sl, nbx, nby, models, g.endpoint_count, g.selector_count,
            prev_frame=prev_blocks,
        )
        prev_blocks = blocks
        rgb = blocks_to_rgb(blocks, endpoints, selectors)[:h, :w]
        if has_alpha:
            asl = level[
                d.alpha_slice_byte_offset :
                d.alpha_slice_byte_offset + d.alpha_slice_byte_length
            ]
            ab = decode_etc1s_slice(
                asl, nbx, nby, models, g.endpoint_count,
                g.selector_count, prev_frame=prev_alpha_blocks,
            )
            prev_alpha_blocks = ab
            # alpha rides the decoded green channel (gray ETC1S slice)
            alpha = blocks_to_rgb(ab, endpoints, selectors)[:h, :w, 1:2]
            rgb = np.concatenate([rgb, alpha], axis=-1)
        frames.append(rgb)
    return np.stack(frames)
