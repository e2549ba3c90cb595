"""H.264/AVC baseline codec: containers, parameter sets, and the frame
entry points over the real intra/inter coding layer.

The reference's UVOL 1.0 texture track is an H.264 MP4
(deprecated/README.md:63; played via src/V1/player.ts:120-132). This
module provides a REAL H.264 implementation for it:
  - qp=None: every macroblock I_PCM (mb_type 25) — lossless raw-rate
    wire, the conservative profile;
  - qp set: I_4x4 intra compression (codecs/h264_intra.py /
    native/h264_native.cpp — prediction + 4x4 integer transform + CAVLC),
    with `pcm_rows` keeping the V1 counter strip lossless;
  - gop=N: zero-motion P slices between IDRs (P_Skip + intra refresh).
Conformance is cross-verified both directions against the system
libavcodec/libx264 (native/h264ref.py): our streams reconstruct
bit-exactly in a real decoder, and foreign all-intra CAVLC baseline
streams (incl. I_16x16 + plane modes) reconstruct bit-exactly here.

Layout notes:
  - baseline profile (66), pic_order_cnt_type=2, frame_mbs_only,
  - 4:2:0 full-range JFIF color (the same matrix io/video.py's JPEG path
    uses), chroma = 2x2 box mean,
  - emulation-prevention (0x03) applied over every NAL payload.

The port's copy of `uvol_tpu/codecs/h264.py`; its native fast path is
the port's `native/h264c.py`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Bit I/O (MSB-first) + Exp-Golomb
# ---------------------------------------------------------------------------


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0
        self._n = 0

    def u(self, value: int, bits: int) -> None:
        for i in range(bits - 1, -1, -1):
            self._acc = (self._acc << 1) | ((value >> i) & 1)
            self._n += 1
            if self._n == 8:
                self._bytes.append(self._acc)
                self._acc = 0
                self._n = 0

    def ue(self, v: int) -> None:
        """Unsigned Exp-Golomb."""
        v += 1
        nbits = v.bit_length()
        self.u(0, nbits - 1)
        self.u(v, nbits)

    def se(self, v: int) -> None:
        """Signed Exp-Golomb (0, 1, -1, 2, -2, ...)."""
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align(self) -> None:
        while self._n:
            self.u(0, 1)

    @property
    def bit_position(self) -> int:
        return 8 * len(self._bytes) + self._n

    def raw_bytes(self, data: bytes) -> None:
        assert self._n == 0, "raw bytes must be byte-aligned"
        self._bytes += data

    def rbsp_trailing(self) -> None:
        self.u(1, 1)
        self.align()

    def getvalue(self) -> bytes:
        assert self._n == 0
        return bytes(self._bytes)


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def u(self, bits: int) -> int:
        if self.pos + bits > 8 * len(self.data):
            raise ValueError("h264: truncated bitstream")
        v = 0
        for _ in range(bits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("h264: bad exp-golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def bytes_at(self, n: int) -> bytes:
        assert self.pos % 8 == 0
        start = self.pos >> 3
        out = self.data[start : start + n]
        if len(out) != n:
            raise ValueError("h264: truncated PCM samples")
        self.pos += 8 * n
        return out


# ---------------------------------------------------------------------------
# NAL framing
# ---------------------------------------------------------------------------


def _escape(rbsp: bytes) -> bytes:
    """Insert emulation-prevention 0x03 after 00 00 before {00,01,02,03}."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _unescape(ebsp: bytes) -> bytes:
    """Strip emulation-prevention 0x03 bytes (vectorized; the byte-loop
    ran ~40 ms/frame at 1024² — 2/3 of the whole decode glue).

    Equivalence with the sequential zero-counter form: a removed byte is
    always 0x03 (never 0x00), so it can never be part of a later
    candidate's 00 00 prefix, and the counter reset after a removal is
    exactly 'the two zeros must be literal input bytes' — which the
    d[i-2]==0 & d[i-1]==0 test already requires."""
    d = np.frombuffer(ebsp, np.uint8)
    if len(d) < 4:
        return ebsp
    cand = (
        np.flatnonzero(
            (d[2:-1] == 3) & (d[1:-2] == 0) & (d[:-3] == 0) & (d[3:] <= 3)
        )
        + 2
    )
    if cand.size == 0:
        return ebsp
    return np.delete(d, cand).tobytes()


def _unescape_slow(ebsp: bytes) -> bytes:
    """Sequential reference form of _unescape (parity oracle in tests)."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def nal(nal_type: int, rbsp: bytes, ref_idc: int = 3) -> bytes:
    return b"\x00\x00\x00\x01" + bytes([(ref_idc << 5) | nal_type]) + _escape(rbsp)


def split_nals(stream: bytes) -> List[bytes]:
    """Annex-B stream → list of NAL units (header byte + EBSP payload)."""
    out = []
    i = 0
    n = len(stream)
    starts = []
    while i + 3 <= n:
        if stream[i : i + 3] == b"\x00\x00\x01":
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        while e > s and stream[e - 1] == 0:  # trailing zero padding
            e -= 1
        out.append(stream[s:e])
    return out


# ---------------------------------------------------------------------------
# Parameter sets
# ---------------------------------------------------------------------------


def make_sps(width: int, height: int, max_ref_frames: int = 1,
             profile: int = 66) -> bytes:
    """`max_ref_frames=1` admits P slices (one-frame DPB, sliding
    window) while remaining valid for all-IDR streams. `profile`:
    66 = baseline (CAVLC), 77 = Main (required for CABAC streams)."""
    if width % 16 or height % 16:
        raise ValueError("h264 I_PCM writer requires multiple-of-16 dims")
    w = BitWriter()
    w.u(profile, 8)  # profile_idc
    w.u(0, 8)  # constraint flags + reserved
    # level 5.2 — I_PCM payloads are raw YUV420 rate (~9 bits/pixel), far
    # above lower levels' MaxBR; 5.2 is the highest standard level and the
    # honest declaration for 1k 30 fps PCM streams
    w.u(52, 8)
    w.ue(0)  # seq_parameter_set_id
    w.ue(0)  # log2_max_frame_num_minus4 → 4-bit frame_num
    w.ue(2)  # pic_order_cnt_type 2 (output order == decode order)
    w.ue(max_ref_frames)  # max_num_ref_frames
    w.u(0, 1)  # gaps_in_frame_num_value_allowed
    w.ue(width // 16 - 1)
    w.ue(height // 16 - 1)
    w.u(1, 1)  # frame_mbs_only
    w.u(0, 1)  # direct_8x8_inference
    w.u(0, 1)  # frame_cropping
    w.u(0, 1)  # vui_parameters_present
    w.rbsp_trailing()
    return w.getvalue()


def make_pps(cabac: bool = False) -> bytes:
    w = BitWriter()
    w.ue(0)  # pic_parameter_set_id
    w.ue(0)  # seq_parameter_set_id
    w.u(1 if cabac else 0, 1)  # entropy_coding_mode
    w.u(0, 1)  # bottom_field_pic_order_in_frame_present
    w.ue(0)  # num_slice_groups_minus1
    w.ue(0)  # num_ref_idx_l0_default_active_minus1
    w.ue(0)  # num_ref_idx_l1_default_active_minus1
    w.u(0, 1)  # weighted_pred
    w.u(0, 2)  # weighted_bipred_idc
    w.se(0)  # pic_init_qp_minus26
    w.se(0)  # pic_init_qs_minus26
    w.se(0)  # chroma_qp_index_offset
    w.u(1, 1)  # deblocking_filter_control_present (slices disable it)
    w.u(0, 1)  # constrained_intra_pred
    w.u(0, 1)  # redundant_pic_cnt_present
    w.rbsp_trailing()
    return w.getvalue()


@dataclasses.dataclass
class Sps:
    width: int   # display (cropped) dimensions
    height: int
    log2_max_frame_num: int
    coded_width: int = 0   # MB-aligned coded dimensions (crop applied after)
    coded_height: int = 0
    poc_type: int = 2
    log2_max_poc_lsb: int = 0


@dataclasses.dataclass
class Pps:
    pic_init_qp: int = 26
    deblocking_control_present: bool = True
    bottom_field_poc_present: bool = False
    redundant_pic_cnt_present: bool = False
    chroma_qp_offset: int = 0
    cabac: bool = False
    weighted_pred: bool = False


def parse_pps(rbsp: bytes) -> Pps:
    r = BitReader(rbsp)
    r.ue()  # pps id
    r.ue()  # sps id
    cabac = bool(r.u(1))
    bottom = bool(r.u(1))
    if r.ue() != 0:
        raise NotImplementedError("h264: slice groups")
    r.ue()
    r.ue()
    weighted = bool(r.u(1))
    r.u(2)  # weighted_bipred_idc (B slices only)
    qp = 26 + r.se()
    r.se()  # qs
    cqp_offset = r.se()
    deblock = bool(r.u(1))
    r.u(1)  # constrained_intra_pred
    redundant = bool(r.u(1))
    return Pps(qp, deblock, bottom, redundant, cqp_offset, cabac, weighted)


def parse_pred_weight_table(r: "BitReader", num_ref_l0: int = 1) -> None:
    """pred_weight_table (7.3.3.2), P-slice form. Explicit weights equal
    to the defaults (weight = 1 << denom, offset = 0) are a no-op for
    motion compensation and accepted; anything else needs weighted MC,
    which this profile refuses rather than decoding wrong (x264 writes
    this table whenever weightp is enabled, its default)."""
    luma_denom = r.ue()
    chroma_denom = r.ue()
    for _ in range(num_ref_l0):
        if r.u(1):  # luma_weight_l0_flag
            wgt, off = r.se(), r.se()
            if wgt != (1 << luma_denom) or off != 0:
                raise NotImplementedError(
                    "h264: weighted prediction with non-default weights "
                    "(encode with weightp=0)"
                )
        if r.u(1):  # chroma_weight_l0_flag
            for _ in range(2):
                wgt, off = r.se(), r.se()
                if wgt != (1 << chroma_denom) or off != 0:
                    raise NotImplementedError(
                        "h264: weighted prediction with non-default "
                        "weights (encode with weightp=0)"
                    )


def parse_sps(rbsp: bytes) -> Sps:
    r = BitReader(rbsp)
    profile = r.u(8)
    r.u(8)
    r.u(8)
    r.ue()  # sps id
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        chroma = r.ue()
        if chroma == 3:
            r.u(1)
        r.ue()
        r.ue()
        r.u(1)
        if r.u(1):
            raise NotImplementedError("h264: scaling matrices")
    log2_mfn = r.ue() + 4
    poc_type = r.ue()
    log2_max_poc = 0
    if poc_type == 0:
        log2_max_poc = r.ue() + 4
    elif poc_type == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()  # max_num_ref_frames
    r.u(1)
    w_mbs = r.ue() + 1
    h_mbs = r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        raise NotImplementedError("h264: interlaced streams")
    r.u(1)  # direct_8x8
    coded_w, coded_h = 16 * w_mbs, 16 * h_mbs
    width, height = coded_w, coded_h
    if r.u(1):  # cropping
        left, right, top, bottom = r.ue(), r.ue(), r.ue(), r.ue()
        width -= 2 * (left + right)
        height -= 2 * (top + bottom)
    return Sps(width, height, log2_mfn, coded_w, coded_h,
               poc_type, log2_max_poc)


# ---------------------------------------------------------------------------
# Color conversion (full-range JFIF BT.601, matching io/video.py's JPEG)
# ---------------------------------------------------------------------------


def rgb_to_yuv420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    f = rgb.astype(np.float32)
    r_, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r_ + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r_ - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r_ - 0.418688 * g - 0.081312 * b
    sub = lambda p: p.reshape(p.shape[0] // 2, 2, p.shape[1] // 2, 2).mean((1, 3))
    to8 = lambda p: np.clip(np.round(p), 0, 255).astype(np.uint8)
    return to8(y), to8(sub(cb)), to8(sub(cr))


def yuv420_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    from uvol_tpu_torch.native.h264c import yuv420_to_rgb_native

    out = yuv420_to_rgb_native(y, cb, cr)
    if out is not None:
        return out
    return _yuv420_to_rgb_numpy(y, cb, cr)


def _yuv420_to_rgb_numpy(y, cb, cr) -> np.ndarray:
    """Reference form of yuv420_to_rgb (parity oracle for the native
    mirror in tests/test_h264.py)."""
    up = lambda p: np.repeat(np.repeat(p, 2, 0), 2, 1)
    yf = y.astype(np.float32)
    cbf = up(cb).astype(np.float32) - 128.0
    crf = up(cr).astype(np.float32) - 128.0
    r_ = yf + 1.402 * crf
    g = yf - 0.344136 * cbf - 0.714136 * crf
    b = yf + 1.772 * cbf
    return np.clip(np.round(np.stack([r_, g, b], -1)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _mb_pcm_payload(y, cb, cr, mby, mbx) -> bytes:
    """256 luma + 64 Cb + 64 Cr raster bytes for one 16x16 macroblock."""
    ly = y[16 * mby : 16 * mby + 16, 16 * mbx : 16 * mbx + 16]
    lcb = cb[8 * mby : 8 * mby + 8, 8 * mbx : 8 * mbx + 8]
    lcr = cr[8 * mby : 8 * mby + 8, 8 * mbx : 8 * mbx + 8]
    return ly.tobytes() + lcb.tobytes() + lcr.tobytes()


def encode_idr_planes(
    y: np.ndarray,
    cb: np.ndarray,
    cr: np.ndarray,
    idr_pic_id: int = 0,
    qp: Optional[int] = None,
    pcm_rows: int = 0,
) -> bytes:
    """One YUV420 frame → IDR slice NAL.

    qp=None: every macroblock I_PCM (lossless raw-rate wire, the round-2
    form). qp set (0..51): real intra compression — I_4x4 mode decision +
    transforms + CAVLC (codecs/h264_intra.py) — with the bottom
    `pcm_rows` PIXEL rows forced to I_PCM macroblocks so the V1
    frame-counter strip stays bit-exact."""
    h, w_ = y.shape
    bw = BitWriter()
    bw.ue(0)  # first_mb_in_slice
    bw.ue(7)  # slice_type: I (all slices in picture)
    bw.ue(0)  # pic_parameter_set_id
    bw.u(0, 4)  # frame_num (log2_max_frame_num = 4; IDR → 0)
    bw.ue(idr_pic_id & 0xFFFF)
    # poc_type 2 → no POC fields
    bw.u(0, 1)  # no_output_of_prior_pics
    bw.u(0, 1)  # long_term_reference
    bw.se(0 if qp is None else qp - 26)  # slice_qp_delta
    bw.ue(1)  # disable_deblocking_filter_idc = 1 (recon is normative-exact)
    if qp is None:
        for mby in range(h // 16):
            for mbx in range(w_ // 16):
                bw.ue(25)  # mb_type I_PCM
                bw.align()  # pcm_alignment_zero_bit(s)
                bw.raw_bytes(_mb_pcm_payload(y, cb, cr, mby, mbx))
    else:
        pcm_from_mby = (h - max(0, pcm_rows)) // 16 if pcm_rows else -1
        # native whole-slice fast path (bit-identical; Python SliceCoder
        # is the oracle/fallback — tests/test_h264_intra.py pins parity)
        from uvol_tpu_torch.native.h264c import encode_slice_native

        rbsp = encode_slice_native(y, cb, cr, qp, pcm_from_mby, idr_pic_id)
        if rbsp is not None:
            return nal(5, rbsp)
        from uvol_tpu_torch.codecs.h264_intra import SliceCoder

        sc = SliceCoder(w_, h, qp)
        for mby in range(h // 16):
            for mbx in range(w_ // 16):
                if pcm_rows and mby >= pcm_from_mby:
                    sc.encode_mb_pcm(bw, mbx, mby, y, cb, cr)
                else:
                    sc.encode_mb_i4x4(bw, mbx, mby, y, cb, cr)
    bw.rbsp_trailing()
    return nal(5, bw.getvalue())


def encode_idr_frame(
    rgb: np.ndarray,
    idr_pic_id: int = 0,
    qp: Optional[int] = None,
    pcm_rows: int = 0,
) -> bytes:
    """One RGB frame → IDR slice NAL (see encode_idr_planes)."""
    y, cb, cr = rgb_to_yuv420(rgb)
    return encode_idr_planes(y, cb, cr, idr_pic_id, qp, pcm_rows)


def _intra_costs(sc, mbx, mby, y):
    """(sad16, sad4_proxy) — deterministic intra cost estimates.

    sad16: best whole-MB prediction SAD (V/H/DC/plane over decoded
    neighbors). sad4_proxy: per-4x4 best of {DC, V, H} built from
    SOURCE neighbor lines (the cheap stand-in for the full 9-mode
    search; shared verbatim by the future native mirror)."""
    from uvol_tpu_torch.codecs.h264_intra import predict_16x16

    x0, y0 = 16 * mbx, 16 * mby
    src = y[y0 : y0 + 16, x0 : x0 + 16].astype(np.int64)
    left_avail, top_avail = mbx > 0, mby > 0
    sad16 = None
    for pm in range(4):
        if pm == 0 and not top_avail:
            continue
        if pm == 1 and not left_avail:
            continue
        if pm == 3 and not (top_avail and left_avail):
            continue
        pred = predict_16x16(pm, sc.y, x0, y0, left_avail, top_avail)
        s = int(np.abs(src - pred.astype(np.int64)).sum())
        sad16 = s if sad16 is None else min(sad16, s)
    sad4 = 0
    for by_ in range(4):
        for bx_ in range(4):
            blk = src[4 * by_ : 4 * by_ + 4, 4 * bx_ : 4 * bx_ + 4]
            cands = [np.full((4, 4), int(round(blk.mean())), np.int64)]
            if by_ > 0 or top_avail:
                top = (
                    src[4 * by_ - 1, 4 * bx_ : 4 * bx_ + 4]
                    if by_ > 0
                    else sc.y[y0 - 1, x0 + 4 * bx_ : x0 + 4 * bx_ + 4]
                ).astype(np.int64)
                cands.append(np.broadcast_to(top, (4, 4)))
            if bx_ > 0 or left_avail:
                left = (
                    src[4 * by_ : 4 * by_ + 4, 4 * bx_ - 1]
                    if bx_ > 0
                    else sc.y[y0 + 4 * by_ : y0 + 4 * by_ + 4, x0 - 1]
                ).astype(np.int64)
                cands.append(np.broadcast_to(left[:, None], (4, 4)))
            sad4 += min(int(np.abs(blk - c).sum()) for c in cands)
    return sad16, sad4


def _encode_intra_mb(sc, bw, mbx, mby, y, cb, cr, lam,
                     mb_type_offset=0):
    """Intra macroblock with I_16x16-vs-I_4x4 mode decision (I_4x4's
    richer modes+signalling cost ~24 bits extra, folded in via lambda).
    x264 codes ~75% of this corpus's intra MBs as I16 — round 3 only
    ever emitted I_4x4, the single biggest bpp gap vs x264 at matched
    PSNR (0.93 vs 0.65 bpp measured)."""
    sad16, sad4 = _intra_costs(sc, mbx, mby, y)
    if sad16 is not None and sad16 <= sad4 + lam * 24:
        sc.encode_mb_i16(bw, mbx, mby, y, cb, cr,
                         mb_type_offset=mb_type_offset)
    else:
        sc.encode_mb_i4x4(bw, mbx, mby, y, cb, cr,
                          mb_type_offset=mb_type_offset)


def _mb_state_snapshot(sc, mbx, mby):
    """Copies of every per-MB state slice a trial encode can touch."""
    x0, y0 = 16 * mbx, 16 * mby
    cx, cy = 8 * mbx, 8 * mby
    bx, by = 4 * mbx, 4 * mby
    return (
        sc.y[y0 : y0 + 16, x0 : x0 + 16].copy(),
        sc.cb[cy : cy + 8, cx : cx + 8].copy(),
        sc.cr[cy : cy + 8, cx : cx + 8].copy(),
        sc.tc_y[by : by + 4, bx : bx + 4].copy(),
        sc.tc_cb[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2].copy(),
        sc.tc_cr[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2].copy(),
        sc.modes[by : by + 4, bx : bx + 4].copy(),
        sc.mv[by : by + 4, bx : bx + 4].copy(),
        sc.mvref[by : by + 4, bx : bx + 4].copy(),
        sc.decoded4[by : by + 4, bx : bx + 4].copy(),
    )


def _mb_state_restore(sc, mbx, mby, snap):
    x0, y0 = 16 * mbx, 16 * mby
    cx, cy = 8 * mbx, 8 * mby
    bx, by = 4 * mbx, 4 * mby
    (sc.y[y0 : y0 + 16, x0 : x0 + 16], sc.cb[cy : cy + 8, cx : cx + 8],
     sc.cr[cy : cy + 8, cx : cx + 8], sc.tc_y[by : by + 4, bx : bx + 4],
     sc.tc_cb[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2],
     sc.tc_cr[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2],
     sc.modes[by : by + 4, bx : bx + 4], sc.mv[by : by + 4, bx : bx + 4],
     sc.mvref[by : by + 4, bx : bx + 4],
     sc.decoded4[by : by + 4, bx : bx + 4]) = snap


def _mb_ssd(sc, mbx, mby, y, cb, cr) -> int:
    x0, y0 = 16 * mbx, 16 * mby
    cx, cy = 8 * mbx, 8 * mby
    d = sc.y[y0 : y0 + 16, x0 : x0 + 16].astype(np.int64) - y[
        y0 : y0 + 16, x0 : x0 + 16
    ]
    ssd = int((d * d).sum())
    for plane, srcp in ((sc.cb, cb), (sc.cr, cr)):
        dc = plane[cy : cy + 8, cx : cx + 8].astype(np.int64) - srcp[
            cy : cy + 8, cx : cx + 8
        ]
        ssd += int((dc * dc).sum())
    return ssd


def _encode_best_mb_rd(sc, bw, mbx, mby, y, cb, cr, mv, prev, lam,
                       skip_ssd=None, flush=None):
    """Trial-encode P_Skip / inter16 / I16 / I4x4 for this macroblock,
    pick the exact-cost winner (SSD + lambda * CAVLC bits), re-encode
    it into the real bitstream. State is restored between trials so
    every candidate sees identical CAVLC nC/mode contexts.

    `skip_ssd`: precomputed SSD of the P_Skip reconstruction (None
    disables the skip candidate). Returns True when skip won — the
    caller extends its skip run instead of flushing it."""
    cands = [
        ("inter", lambda w: sc.encode_mb_inter16(
            w, mbx, mby, y, cb, cr, mv, prev)),
        ("i16", lambda w: (
            sc.encode_mb_i16(w, mbx, mby, y, cb, cr, mb_type_offset=5),
            sc.mark_intra_mv(mbx, mby),
        )),
        ("i4", lambda w: (
            sc.encode_mb_i4x4(w, mbx, mby, y, cb, cr, mb_type_offset=5),
            sc.mark_intra_mv(mbx, mby),
        )),
    ]
    snap = _mb_state_snapshot(sc, mbx, mby)
    # skip: ~2 amortized bits (run length ue), no residual
    best = (
        (skip_ssd + lam * 2.0, "skip", None)
        if skip_ssd is not None
        else None
    )
    for name, enc in cands:
        trial = BitWriter()
        enc(trial)
        bits = trial.bit_position
        cost = _mb_ssd(sc, mbx, mby, y, cb, cr) + lam * bits
        if best is None or cost < best[0]:
            best = (cost, name, enc)
        _mb_state_restore(sc, mbx, mby, snap)
    if best[1] == "skip":
        sc.copy_skip_mb(mbx, mby, *prev)
        return True
    if flush is not None:
        flush()
    best[2](bw)
    return False


def _coarse_sad_maps(y: np.ndarray, prev_y: np.ndarray, offsets):
    """SAD of every macroblock against `prev_y` shifted by each integer
    offset (edge-clamped), vectorized over the whole picture.
    Returns [len(offsets), MBy, MBx] int64."""
    h, w_ = y.shape
    pad = 16 + 3
    ref = np.pad(prev_y.astype(np.int64), pad, mode="edge")
    src = y.astype(np.int64)
    maps = np.empty((len(offsets), h // 16, w_ // 16), np.int64)
    for k, (dx, dy) in enumerate(offsets):
        win = ref[pad + dy : pad + dy + h, pad + dx : pad + dx + w_]
        ad = np.abs(src - win)
        maps[k] = (
            ad.reshape(h // 16, 16, w_ // 16, 16).sum(axis=(1, 3))
        )
    return maps


def _motion_search_mb(y, ref_pad, pad, x0, y0, base_mv, lam, bits_of):
    """Deterministic +-3 full-pel refinement around `base_mv` (integer
    pel) for the 16x16 at (x0, y0): returns (mv_qpel, sad)."""
    src = y[y0 : y0 + 16, x0 : x0 + 16].astype(np.int64)
    # the padded reference covers +-16 (+3 refine): clamp the base so
    # every probed window stays inside (MV predictions can point beyond)
    base_mv = (
        max(-16, min(16, base_mv[0])),
        max(-16, min(16, base_mv[1])),
    )
    best = None
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            mx, my = base_mv[0] + dx, base_mv[1] + dy
            win = ref_pad[
                pad + y0 + my : pad + y0 + my + 16,
                pad + x0 + mx : pad + x0 + mx + 16,
            ]
            sad = int(np.abs(src - win).sum())
            cost = sad + lam * bits_of(mx, my)
            if best is None or cost < best[0]:
                best = (cost, (4 * mx, 4 * my), sad)
    return best[1], best[2]


def encode_p_planes(
    y: np.ndarray,
    cb: np.ndarray,
    cr: np.ndarray,
    prev: Tuple[np.ndarray, np.ndarray, np.ndarray],
    *,
    qp: int,
    pcm_rows: int = 0,
    frame_num: int = 1,
    skip_bias: float = 1.0,
    motion: bool = True,
):
    """One P slice NAL. With `motion` (default): real motion-compensated
    inter coding — integer-pel search (coarse +-16 grid, +-3 refine),
    P_L0_16x16 macroblocks with spec MV prediction and CAVLC mvd,
    P_Skip with the derived skip vector, intra fallback on uncovered
    content, counter-strip I_PCM kept lossless. With `motion=False`:
    round 3's zero-motion profile (P_Skip + intra refresh; native fast
    path). Returns (nal_bytes, recon_planes)."""
    from uvol_tpu_torch.codecs.h264_intra import (
        SliceCoder,
        _mc_chroma,
        _mc_luma,
        p_skip_threshold,
        se_bits,
    )

    h, w_ = y.shape
    prev_y, prev_cb, prev_cr = prev
    bw = BitWriter()
    bw.ue(0)  # first_mb_in_slice
    bw.ue(5)  # slice_type: P (all slices)
    bw.ue(0)  # pic_parameter_set_id
    bw.u(frame_num & 0xF, 4)
    # poc_type 2 → no POC fields
    bw.u(0, 1)  # num_ref_idx_active_override
    bw.u(0, 1)  # ref_pic_list_modification_flag_l0
    bw.u(0, 1)  # adaptive_ref_pic_marking (sliding window)
    bw.se(qp - 26)
    bw.ue(1)  # deblocking off
    thresh = p_skip_threshold(qp) * skip_bias
    pcm_from = (h - max(0, pcm_rows)) // 16 if pcm_rows else -1
    if not motion:
        # native whole-slice fast path (bit-identical; parity-tested)
        from uvol_tpu_torch.native.h264c import encode_p_slice_native

        res = encode_p_slice_native(
            y, cb, cr, (prev_y, prev_cb, prev_cr), qp, pcm_from,
            frame_num & 0xF, thresh,
        )
        if res is not None:
            return nal(1, res[0]), res[1]
    sc = SliceCoder(w_, h, qp)
    skip_run = 0
    lam = max(1, int(0.85 * 2.0 ** ((qp - 12) / 3.0)))
    coarse_best = None
    ref_pad = None
    pad = 16 + 3
    if motion:
        # native whole-slice motion path (bit-identical; parity-tested)
        from uvol_tpu_torch.native.h264c import encode_p_slice_motion_native

        res = encode_p_slice_motion_native(
            y, cb, cr, (prev_y, prev_cb, prev_cr), qp, pcm_from,
            frame_num & 0xF, thresh,
        )
        if res is not None:
            return nal(1, res[0]), res[1]
        offsets = [
            (dx, dy)
            for dy in range(-16, 17, 4)
            for dx in range(-16, 17, 4)
        ]
        maps = _coarse_sad_maps(y, prev_y, offsets)
        coarse_best = np.argmin(maps, axis=0)  # [MBy, MBx]
        ref_pad = np.pad(prev_y.astype(np.int64), pad, mode="edge")
    for mby in range(h // 16):
        for mbx in range(w_ // 16):
            is_pcm = pcm_rows and mby >= pcm_from
            x0, y0 = 16 * mbx, 16 * mby
            cx, cy = 8 * mbx, 8 * mby
            src_y = y[y0 : y0 + 16, x0 : x0 + 16].astype(np.int64)
            if motion and not is_pcm:
                skip_mv = sc._skip_mv(mbx, mby)
                sp_y = _mc_luma(prev_y, x0, y0, 16, 16, *skip_mv)
                ssd = int(((src_y - sp_y) ** 2).sum())
                sp_cb = _mc_chroma(prev_cb, cx, cy, 8, 8, *skip_mv)
                sp_cr = _mc_chroma(prev_cr, cx, cy, 8, 8, *skip_mv)
                for spp, srcp in ((sp_cb, cb), (sp_cr, cr)):
                    dch = (
                        srcp[cy : cy + 8, cx : cx + 8].astype(np.int64)
                        - spp
                    )
                    ssd += int((dch * dch).sum())
                if ssd <= thresh:
                    sc.copy_skip_mb(mbx, mby, prev_y, prev_cb, prev_cr)
                    skip_run += 1
                    continue
                pmx, pmy = sc._predict_mv(4 * mbx, 4 * mby, 4, 4)

                def mvd_bits(mx, my, _px=pmx, _py=pmy):
                    return se_bits(4 * mx - _px) + se_bits(4 * my - _py)

                base = offsets[int(coarse_best[mby, mbx])]
                # refine around the coarse winner AND the MV prediction
                mv1, sad1 = _motion_search_mb(
                    y, ref_pad, pad, x0, y0, base, lam, mvd_bits
                )
                mv2, sad2 = _motion_search_mb(
                    y, ref_pad, pad, x0, y0,
                    (int(round(pmx / 4.0)), int(round(pmy / 4.0))),
                    lam, mvd_bits,
                )
                mv, sad = (
                    (mv1, sad1)
                    if sad1 + lam * mvd_bits(mv1[0] // 4, mv1[1] // 4)
                    <= sad2 + lam * mvd_bits(mv2[0] // 4, mv2[1] // 4)
                    else (mv2, sad2)
                )
                # true rate-distortion mode decision: TRIAL-ENCODE each
                # candidate (exact CAVLC bits incl. nC context + exact
                # reconstruction SSD), restore state, re-encode the
                # winner. SAD proxies measured uselessly here: predicted
                # bits and actual CAVLC bits diverge ~3x on this
                # re-shaded (non-translational) corpus.
                run_now = skip_run

                def _flush(_run=run_now):
                    bw.ue(_run)

                won_skip = _encode_best_mb_rd(
                    sc, bw, mbx, mby, y, cb, cr, mv,
                    (prev_y, prev_cb, prev_cr), lam,
                    skip_ssd=ssd, flush=_flush,
                )
                skip_run = skip_run + 1 if won_skip else 0
                continue
            # zero-motion profile (and the PCM counter strip)
            d = src_y - prev_y[y0 : y0 + 16, x0 : x0 + 16]
            ssd = int((d * d).sum())
            for sp, pp in ((cb, prev_cb), (cr, prev_cr)):
                dc = sp[cy : cy + 8, cx : cx + 8].astype(np.int64) - pp[
                    cy : cy + 8, cx : cx + 8
                ]
                ssd += int((dc * dc).sum())
            # counter-strip MBs may ONLY skip when bit-exact (ssd 0 ⇒
            # the copy IS the source); others use the distortion budget.
            # A PCM-strip skip must also carry a ZERO skip vector — with
            # motion on, neighbors can push the derived vector nonzero,
            # so require it zero before skipping.
            can_skip = ssd <= (0 if is_pcm else thresh)
            if motion and can_skip and sc._skip_mv(mbx, mby) != (0, 0):
                can_skip = False
            if can_skip:
                sc.copy_skip_mb(mbx, mby, prev_y, prev_cb, prev_cr)
                skip_run += 1
                continue
            bw.ue(skip_run)
            skip_run = 0
            if is_pcm:
                sc.encode_mb_pcm(bw, mbx, mby, y, cb, cr, mb_type_offset=5)
            else:
                sc.encode_mb_i4x4(bw, mbx, mby, y, cb, cr, mb_type_offset=5)
            sc.mark_intra_mv(mbx, mby)
    if skip_run:
        bw.ue(skip_run)  # trailing skip run
    bw.rbsp_trailing()
    return nal(1, bw.getvalue()), (sc.y, sc.cb, sc.cr)


def encode_annexb(
    frames: np.ndarray,
    qp: Optional[int] = None,
    pcm_rows: int = 0,
    gop: Optional[int] = None,
    skip_bias: float = 1.0,
    motion: Optional[bool] = None,
    entropy: str = "cavlc",
) -> bytes:
    """[F, H, W, 3] uint8 RGB → Annex-B H.264 stream.

    gop=None (default): every frame an IDR (random access everywhere).
    gop=N with qp set: IDR every N frames, P slices between.

    motion: True = motion-compensated inter coding (integer-pel search,
    P_L0_16x16, RD mode decision — ~20% fewer bits on the liam track);
    False = round 3's zero-motion profile (P_Skip + intra refresh).
    None (default) picks motion only when the native fast path exists —
    the Python reference coder is ~40 s/frame at 1024^2.

    entropy: "cavlc" (baseline profile) or "cabac" (Main profile) — the
    CABAC form is a lossless per-slice re-entropy-coding of the CAVLC
    encode (identical reconstruction, ~20-25% fewer bits on this
    corpus; codecs/h264_cabac.py)."""
    if entropy not in ("cavlc", "cabac"):
        raise ValueError("h264: entropy must be 'cavlc' or 'cabac'")
    if entropy == "cabac":
        from uvol_tpu_torch.codecs.h264_cabac import transcode_annexb

        stream = encode_annexb(frames, qp, pcm_rows, gop, skip_bias,
                               motion, entropy="cavlc")
        return transcode_annexb(stream, to_cabac=True)
    f, h, w_ = frames.shape[:3]
    if gop is not None and gop < 1:
        raise ValueError("gop must be >= 1")
    if gop is not None and qp is None:
        raise ValueError(
            "gop requires qp (the all-I_PCM lossless form has no P slices)"
        )
    out = [nal(7, make_sps(w_, h)), nal(8, make_pps())]
    if gop is None or qp is None:
        for i in range(f):
            out.append(
                encode_idr_frame(frames[i], idr_pic_id=i % 2, qp=qp,
                                 pcm_rows=pcm_rows)
            )
        return b"".join(out)
    sps = parse_sps(make_sps(w_, h))
    pps = parse_pps(make_pps())
    if motion is None:
        from uvol_tpu_torch.native.h264c import native_motion_available

        use_motion = native_motion_available()
    else:
        use_motion = motion
    recon = None
    for i in range(f):
        y, cb, cr = rgb_to_yuv420(frames[i])
        in_gop = i % gop
        if in_gop == 0:
            # native path hands back its own recon (the P reference);
            # otherwise decode the emitted slice once
            from uvol_tpu_torch.native.h264c import encode_slice_native

            pcm_from = (h - max(0, pcm_rows)) // 16 if pcm_rows else -1
            res = encode_slice_native(
                y, cb, cr, qp, pcm_from, (i // gop) % 2, want_recon=True
            )
            if res is not None:
                rbsp, recon = res
                unit = nal(5, rbsp)
            else:
                unit = encode_idr_planes(y, cb, cr,
                                         idr_pic_id=(i // gop) % 2,
                                         qp=qp, pcm_rows=pcm_rows)
                recon = _decode_slice_planes(
                    _unescape(split_nals(unit)[0][1:]), sps, pps, idr=True
                )
        else:
            unit, recon = encode_p_planes(
                y, cb, cr, recon, qp=qp, pcm_rows=pcm_rows,
                frame_num=in_gop & 0xF, skip_bias=skip_bias,
                motion=use_motion,
            )
        out.append(unit)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Decode (I_PCM-only parser)
# ---------------------------------------------------------------------------


def decode_annexb(stream: bytes) -> np.ndarray:
    """Annex-B H.264 baseline intra (I_PCM / I_4x4 / I_16x16, CAVLC) →
    [F, H, W, 3] RGB. Handles foreign all-intra streams (e.g. x264's) —
    SEI/AUD skipped, SPS poc-type and PPS shapes parsed for real."""
    y, cb, cr, sps = decode_annexb_planes(stream)
    return np.stack(
        [
            yuv420_to_rgb(y[i], cb[i], cr[i])[: sps.height, : sps.width]
            for i in range(len(y))
        ]
    )


def decode_annexb_planes(stream: bytes):
    """Annex-B → (Y [F,ch,cw], Cb, Cr, sps) reconstruction planes at
    CODED dimensions — the exact normative output, comparable
    bit-for-bit against an independent decoder (native/h264ref.py)."""
    sps = None
    pps = Pps()
    ys, cbs, crs = [], [], []
    ref_planes = None  # last REFERENCE picture (the P prediction source)
    for unit in split_nals(stream):
        ntype = unit[0] & 0x1F
        if ntype in (6, 9, 10, 11, 12):  # SEI/AUD/end/filler
            continue
        rbsp = _unescape(unit[1:])
        if ntype == 7:
            sps = parse_sps(rbsp)
        elif ntype == 8:
            pps = parse_pps(rbsp)
        elif ntype in (1, 5):
            if sps is None:
                raise ValueError("h264: slice before SPS")
            ref_idc = (unit[0] >> 5) & 3
            y, cb, cr = _decode_slice_planes(
                rbsp, sps, pps, idr=(ntype == 5), prev=ref_planes,
                nal_ref_idc=ref_idc,
            )
            ys.append(y)
            cbs.append(cb)
            crs.append(cr)
            if ref_idc:  # non-reference pictures never enter the DPB
                ref_planes = (y, cb, cr)
    if not ys:
        raise ValueError("h264: no slices")
    return np.stack(ys), np.stack(cbs), np.stack(crs), sps


def _decode_slice_planes(
    rbsp: bytes, sps: Sps, pps: Pps, idr: bool, prev=None, nal_ref_idc: int = 3
):
    """One I or P slice → (y, cb, cr) planes at coded dimensions.

    P slices (zero-motion profile: P_Skip + intra MBs) need `prev`, the
    previous decoded frame's planes."""
    if pps.cabac:
        # CABAC slices are losslessly re-entropy-coded to CAVLC and fall
        # through to the conformance-locked (native) decoder below
        from uvol_tpu_torch.codecs.h264_cabac import cabac_slice_to_cavlc

        rbsp = cabac_slice_to_cavlc(rbsp, sps, pps, idr,
                                    nal_ref_idc=nal_ref_idc)
        # the re-emitted header is canonical: no poc/redundant extras
        pps = dataclasses.replace(pps, cabac=False,
                                  bottom_field_poc_present=False,
                                  redundant_pic_cnt_present=False,
                                  weighted_pred=False)
    if not pps.weighted_pred:
        # the native header parser does not know pred_weight_table;
        # weighted-pred streams stay on the Python path (which validates
        # the weights are the no-op defaults)
        from uvol_tpu_torch.native.h264c import decode_slice_native

        res = decode_slice_native(rbsp, sps, pps, idr, prev=prev,
                                  nal_ref_idc=nal_ref_idc)
        if res is not None:
            return res
    from uvol_tpu_torch.codecs.h264_intra import SliceCoder

    r = BitReader(rbsp)
    if r.ue() != 0:
        raise NotImplementedError("h264: multi-slice pictures")
    slice_type = r.ue()
    is_p = slice_type % 5 == 0
    if not is_p and slice_type % 5 != 2:
        raise NotImplementedError("h264: only I and P slices")
    if is_p and idr:
        raise ValueError("h264: P slice in an IDR NAL")
    if is_p and prev is None:
        raise ValueError("h264: P slice without a reference frame")
    r.ue()  # pps id
    r.u(sps.log2_max_frame_num)  # frame_num
    if idr:
        r.ue()  # idr_pic_id
    if sps.poc_type == 0:
        r.u(sps.log2_max_poc_lsb)
        if pps.bottom_field_poc_present:
            r.se()
    if pps.redundant_pic_cnt_present:
        r.ue()
    if is_p:
        if r.u(1):  # num_ref_idx_active_override
            if r.ue() != 0:
                raise NotImplementedError("h264: multiple reference frames")
        if r.u(1):  # ref_pic_list_modification_flag_l0
            raise NotImplementedError("h264: reference list modification")
        if pps.weighted_pred:
            parse_pred_weight_table(r)
    if idr:
        r.u(1)
        r.u(1)  # dec_ref_pic_marking (IDR form)
    elif nal_ref_idc:
        if r.u(1):  # adaptive_ref_pic_marking_mode_flag
            raise NotImplementedError("h264: adaptive reference marking")
    qp = pps.pic_init_qp + r.se()
    if not 0 <= qp <= 51:
        raise ValueError(f"h264: slice QP {qp} out of range")
    if pps.deblocking_control_present:
        idc = r.ue()  # disable_deblocking_filter_idc
        if idc != 1:  # idc 0/2 carry alpha/beta offsets
            r.se()
            r.se()
        # the in-loop filter is a decoded-picture post-pass this intra
        # profile does not implement; conformant decode requires it off
        if idc != 1:
            raise NotImplementedError(
                "h264: deblocking enabled (encode with the filter off)"
            )
    else:
        # no control flag ⇒ the filter is implicitly ON: refusing beats
        # silently returning unfiltered (wrong) reconstruction
        raise NotImplementedError(
            "h264: PPS without deblocking control (filter implicitly on; "
            "encode with the filter explicitly off)"
        )
    cw = sps.coded_width or sps.width
    ch = sps.coded_height or sps.height
    sc = SliceCoder(cw, ch, qp)
    sc.cqp_offset = pps.chroma_qp_offset
    w_mb = cw // 16
    total = (ch // 16) * w_mb
    if is_p:
        prev_y, prev_cb, prev_cr = prev
        mb = 0
        while mb < total:
            skip_run = r.ue()
            if skip_run > total - mb:
                raise ValueError("h264: mb_skip_run past end of slice")
            for _ in range(skip_run):
                sc.copy_skip_mb(mb % w_mb, mb // w_mb, prev_y, prev_cb,
                                prev_cr)
                mb += 1
            if mb >= total:
                break
            sc.decode_mb_p(r, mb % w_mb, mb // w_mb, prev=prev)
            mb += 1
    else:
        for mb in range(total):
            sc.decode_mb(r, mb % w_mb, mb // w_mb)
    return sc.y, sc.cb, sc.cr


def _decode_slice(rbsp: bytes, sps: Sps, pps: Optional[Pps] = None) -> np.ndarray:
    """One IDR slice → RGB frame (cropped)."""
    y, cb, cr = _decode_slice_planes(rbsp, sps, pps or Pps(), idr=True)
    return yuv420_to_rgb(y, cb, cr)[: sps.height, : sps.width]


# ---------------------------------------------------------------------------
# MP4 (avc1) sample packaging helpers
# ---------------------------------------------------------------------------


def make_avcc(width: int, height: int, cabac: bool = False) -> bytes:
    """AVCDecoderConfigurationRecord for the streams this module writes."""
    sps = make_sps(width, height, profile=77 if cabac else 66)
    pps = make_pps(cabac=cabac)
    sps_nal = bytes([0x67]) + _escape(sps)
    pps_nal = bytes([0x68]) + _escape(pps)
    return (
        bytes([1, sps_nal[1], sps_nal[2], sps_nal[3], 0xFF, 0xE1])
        + len(sps_nal).to_bytes(2, "big")
        + sps_nal
        + bytes([1])
        + len(pps_nal).to_bytes(2, "big")
        + pps_nal
    )


def encode_avc_samples(
    frames: np.ndarray,
    qp: Optional[int] = None,
    pcm_rows: int = 0,
    gop: Optional[int] = None,
    skip_bias: float = 1.0,
    motion: Optional[bool] = None,
    entropy: str = "cavlc",
) -> List[bytes]:
    """Per-frame MP4 samples: 4-byte-length-prefixed slice NAL (no
    SPS/PPS in-band — they live in the avcC box; entropy="cabac" needs
    the matching make_avcc(cabac=True)). qp/pcm_rows/gop as in
    encode_annexb (gop=None ⇒ every sample an IDR sync sample)."""
    f, h, w_ = frames.shape[:3]
    if entropy == "cabac":
        stream = encode_annexb(
            frames, qp=qp, pcm_rows=pcm_rows,
            gop=gop if (gop is not None and qp is not None) else None,
            skip_bias=skip_bias, motion=motion, entropy="cabac",
        )
        units = [u for u in split_nals(stream) if (u[0] & 0x1F) in (1, 5)]
        if len(units) != f:
            raise ValueError(
                f"h264: {len(units)} slice NALs for {f} frames — sample "
                "alignment would be corrupt"
            )
        return [len(u).to_bytes(4, "big") + u for u in units]
    if gop is None or qp is None:
        out = []
        for i in range(f):
            unit = encode_idr_frame(
                frames[i], idr_pic_id=i % 2, qp=qp, pcm_rows=pcm_rows
            )[4:]  # strip the start code
            out.append(len(unit).to_bytes(4, "big") + unit)
        return out
    stream = encode_annexb(frames, qp=qp, pcm_rows=pcm_rows, gop=gop,
                           skip_bias=skip_bias, motion=motion)
    units = [u for u in split_nals(stream) if (u[0] & 0x1F) in (1, 5)]
    if len(units) != f:
        raise ValueError(
            f"h264: {len(units)} slice NALs for {f} frames — sample "
            "alignment would be corrupt"
        )
    return [len(u).to_bytes(4, "big") + u for u in units]


def sample_is_sync(sample: bytes) -> bool:
    """True when the MP4 sample's slice NAL is an IDR (random access)."""
    pos = 0
    while pos + 4 <= len(sample):
        n = int.from_bytes(sample[pos : pos + 4], "big")
        unit = sample[pos + 4 : pos + 4 + n]
        pos += 4 + n
        if unit and (unit[0] & 0x1F) in (1, 5):
            return (unit[0] & 0x1F) == 5
    return False


def decode_avc_sample_planes(sample: bytes, sps: Sps, prev=None,
                             pps: Optional[Pps] = None):
    """One length-prefixed MP4 sample → (y, cb, cr) planes. P samples
    need `prev` (the previous decoded frame's planes). `pps` carries the
    avcC PPS (entropy mode etc.); defaults to this module's CAVLC form."""
    pos = 0
    planes = None
    while pos + 4 <= len(sample):
        n = int.from_bytes(sample[pos : pos + 4], "big")
        unit = sample[pos + 4 : pos + 4 + n]
        pos += 4 + n
        if unit and (unit[0] & 0x1F) in (1, 5):
            planes = _decode_slice_planes(
                _unescape(unit[1:]), sps, pps or Pps(),
                idr=(unit[0] & 0x1F) == 5,
                prev=prev, nal_ref_idc=(unit[0] >> 5) & 3,
            )
    if planes is None:
        raise ValueError("h264: sample holds no slice NAL")
    return planes


def decode_avc_sample(sample: bytes, sps: Sps, prev=None,
                      pps: Optional[Pps] = None) -> np.ndarray:
    """One length-prefixed MP4 sample → RGB frame (see
    decode_avc_sample_planes for the P-sample `prev` contract)."""
    y, cb, cr = decode_avc_sample_planes(sample, sps, prev=prev, pps=pps)
    return yuv420_to_rgb(y, cb, cr)[: sps.height, : sps.width]


def parse_avcc(avcc: bytes) -> Sps:
    if not avcc or avcc[0] != 1:
        raise ValueError("h264: bad avcC record")
    n_sps = avcc[5] & 0x1F
    if n_sps < 1:
        raise ValueError("h264: avcC without SPS")
    ln = int.from_bytes(avcc[6:8], "big")
    sps_nal = avcc[8 : 8 + ln]
    return parse_sps(_unescape(sps_nal[1:]))


def parse_avcc_pps(avcc: bytes) -> Pps:
    """The first PPS of an avcC record (entropy mode for sample decode);
    falls back to this module's CAVLC defaults when no PPS is present."""
    if not avcc or avcc[0] != 1:
        raise ValueError("h264: bad avcC record")
    pos = 6
    for _ in range(avcc[5] & 0x1F):  # skip SPS entries
        ln = int.from_bytes(avcc[pos : pos + 2], "big")
        pos += 2 + ln
    if pos >= len(avcc) or avcc[pos] < 1:
        return Pps()
    pos += 1
    ln = int.from_bytes(avcc[pos : pos + 2], "big")
    pps_nal = avcc[pos + 2 : pos + 2 + ln]
    return parse_pps(_unescape(pps_nal[1:]))
