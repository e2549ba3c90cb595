"""H.264 CABAC entropy coding (spec clause 9.3) + lossless CAVLC↔CABAC
slice transcoding.

Why a transcoder: the framework's H.264 analysis (mode decision, motion
search, trial-encode RD) lives in the CAVLC encoder with a native fast
path. Entropy coding is a pure re-serialization of the slice syntax, so
CABAC is implemented as a neutral per-slice *syntax record* plus four
converters:

    cavlc_parse  : rbsp → (header, records)     (reuses read_residual_block)
    cavlc_emit   : (header, records) → rbsp     (reuses write_residual_block)
    cabac_parse  : rbsp → (header, records)     (arithmetic decoder, 9.3.3)
    cabac_emit   : (header, records) → rbsp     (arithmetic encoder, 9.3.4)

Encode path: existing CAVLC encoder → cavlc_parse → cabac_emit — the
reconstruction (and therefore PSNR) is bit-identical to the CAVLC stream
at the same QP; only the entropy layer changes. Decode path:
cabac_parse → cavlc_emit → the existing conformance-locked (native)
CAVLC decoder.

Constant tables (rangeTabLPS, transIdxLPS, context init) are extracted
from the in-image codec binaries (native/gen_cabac_tables.py — zero
egress, no spec text); every context assignment below is additionally
pinned behaviorally by tests/test_h264_cabac.py: libavcodec must decode
our CABAC streams bit-exactly, and our decoder must match libavcodec on
x264-encoded Main-profile streams. A wrong context index desynchronizes
the arithmetic decoder within a few macroblocks, so conformance is a
strong oracle for every table entry and ctxIdx rule.

Reference capability being matched: the V1 texture track's encoder class
(x264 — the reference's example/texture_encoder.py:53-66), which uses
Main-profile CABAC by default; measured on the liam track CABAC buys
x264 ~29% bits (docs/h264_calibration.jsonl).

The port's copy of `uvol_tpu/codecs/h264_cabac.py`, unchanged but
for its imports.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from uvol_tpu_torch.codecs.h264_intra import (
    _CBP_INTER_TO_CODE,
    _CBP_INTRA_TO_CODE,
    read_residual_block,
    write_residual_block,
)
from uvol_tpu_torch.native.h264_cabac_tables import (
    CTX_INIT_I,
    CTX_INIT_PB,
    RANGE_LPS,
    TRANS_LPS,
)

_RANGE_LPS = RANGE_LPS.tolist()
_TRANS_LPS = TRANS_LPS.tolist()
_TRANS_MPS = [min(p + 1, 62) if p != 63 else 63 for p in range(64)]

# significance-map / last-significant ctx offsets per ctxBlockCat 0..4
_SIG_CAT_OFF = (0, 15, 29, 44, 47)
# coeff_abs_level_minus1 ctx offsets per ctxBlockCat 0..4
_LVL_CAT_OFF = (0, 10, 20, 30, 39)
# residual maxNumCoeff per ctxBlockCat
_CAT_NMAX = (16, 15, 16, 4, 15)

_TERM_CTX = 276


def init_contexts(slice_qp: int, is_i: bool, init_idc: int = 0):
    """Context initialisation (9.3.1.1): (pStateIdx[1024], valMPS[1024])."""
    tab = CTX_INIT_I if is_i else CTX_INIT_PB[init_idc]
    m = tab[:, 0].astype(np.int32)
    n = tab[:, 1].astype(np.int32)
    pre = np.clip(((m * min(max(slice_qp, 0), 51)) >> 4) + n, 1, 126)
    state = np.where(pre <= 63, 63 - pre, pre - 64).astype(np.int32)
    mps = (pre > 63).astype(np.int32)
    return state.tolist(), mps.tolist()


# ---------------------------------------------------------------------------
# Arithmetic decoding engine (9.3.3.2)
# ---------------------------------------------------------------------------


class CabacReader:
    """Bit-level CABAC decoder over an RBSP byte string.

    `pos` counts bits consumed; at any terminate()==1 it equals the
    number of bits the encoder emitted (the flush construction makes the
    two countings meet there), which is what lets I_PCM payloads and the
    slice end re-synchronize to the byte stream."""

    def __init__(self, data: bytes, bitpos: int, state, mps):
        self.data = data
        self.pos = bitpos
        self.state = state
        self.mps = mps
        self.range = 510
        self.offset = self._bits(9)
        if self.offset in (510, 511):
            raise ValueError("h264: forbidden CABAC initial offset")

    def _bits(self, n: int) -> int:
        if self.pos + n > 8 * len(self.data):
            raise ValueError("h264: truncated CABAC stream")
        v = 0
        data, pos = self.data, self.pos
        for _ in range(n):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def reinit(self) -> None:
        """Engine re-initialisation after I_PCM samples (9.3.1.2)."""
        self.range = 510
        self.offset = self._bits(9)
        if self.offset in (510, 511):
            raise ValueError("h264: forbidden CABAC initial offset")

    def decision(self, ctx: int) -> int:
        s = self.state[ctx]
        lps = _RANGE_LPS[s][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            bin_ = 1 - self.mps[ctx]
            self.offset -= self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = _TRANS_LPS[s]
        else:
            bin_ = self.mps[ctx]
            self.state[ctx] = _TRANS_MPS[s]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bits(1)
        return bin_

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bits(1)
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bits(1)
        return 0

    # -- composite reads -----------------------------------------------------
    def unary(self, ctx_of, cmax: int = 1 << 30) -> int:
        v = 0
        while v < cmax and self.decision(ctx_of(v)):
            v += 1
        return v

    def eg_bypass(self, k: int) -> int:
        """Exp-Golomb order-k suffix in bypass bins (9.3.2.3 UEGk)."""
        v = 0
        while self.bypass():
            v += 1 << k
            k += 1
            if k > 30:
                raise ValueError("h264: CABAC EGk overflow")
        while k:
            k -= 1
            v += self.bypass() << k
        return v


# ---------------------------------------------------------------------------
# Arithmetic encoding engine (9.3.4)
# ---------------------------------------------------------------------------


class CabacWriter:
    def __init__(self, bw, state, mps):
        self.bw = bw
        self.state = state
        self.mps = mps
        self.low = 0
        self.range = 510
        self.first = True
        self.outstanding = 0

    def _put(self, b: int) -> None:
        if self.first:
            self.first = False
        else:
            self.bw.u(b, 1)
        while self.outstanding:
            self.bw.u(1 - b, 1)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, bin_: int) -> None:
        s = self.state[ctx]
        lps = _RANGE_LPS[s][(self.range >> 6) & 3]
        self.range -= lps
        if bin_ != self.mps[ctx]:
            self.low += self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = _TRANS_LPS[s]
        else:
            self.state[ctx] = _TRANS_MPS[s]
        self._renorm()

    def bypass(self, bin_: int) -> None:
        self.low <<= 1
        if bin_:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, bin_: int) -> None:
        self.range -= 2
        if bin_:
            self.low += self.range
            self.range = 2
            self.flush()
        else:
            self._renorm()

    def flush(self) -> None:
        """EncodeFlush (9.3.4.6) — called by terminate(1); leaves the
        BitWriter positioned right after the final '1' stop pattern."""
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.bw.u(((self.low >> 7) & 3) | 1, 2)

    def reinit(self) -> None:
        """Engine re-initialisation after I_PCM samples (9.3.4.1)."""
        self.low = 0
        self.range = 510
        self.first = True
        self.outstanding = 0

    # -- composite writes ----------------------------------------------------
    def unary(self, ctx_of, v: int, cmax: int = 1 << 30) -> None:
        for i in range(v):
            self.decision(ctx_of(i), 1)
        if v < cmax:
            self.decision(ctx_of(v), 0)

    def eg_bypass(self, k: int, v: int) -> None:
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)


# ---------------------------------------------------------------------------
# Neutral slice syntax records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MbRec:
    """One macroblock's syntax, entropy-coder-neutral.

    kind: 'skip' | 'pcm' | 'i4' | 'i16' | 'p16' | 'p16x8' | 'p8x16'
    i4_modes: 16 × (prev_flag, rem|None)      (i4 only)
    i16: (pred_mode, cbp_chroma, cbp_luma15)  (i16 only)
    chroma_mode: intra chroma prediction mode (intra kinds only)
    cbp: luma | chroma << 4 (i4/inter; i16's is implied by `i16`)
    qp_delta: 0 when the syntax element is absent
    mvd: per-partition (mvdx, mvdy)           (inter kinds only)
    pcm: 384 raw bytes                        (pcm only)
    ydc / y / cdc / cac: residual coefficient levels in scan order —
    ydc[16] (i16), y[16][16 or 15], cdc[2][4], cac[2][4][15]."""

    kind: str
    i4_modes: Optional[List[Tuple[int, Optional[int]]]] = None
    i16: Optional[Tuple[int, int, int]] = None
    chroma_mode: int = 0
    cbp: int = 0
    qp_delta: int = 0
    mvd: Optional[List[Tuple[int, int]]] = None
    pcm: Optional[bytes] = None
    ydc: Optional[np.ndarray] = None
    y: Optional[List[np.ndarray]] = None
    cdc: Optional[List[np.ndarray]] = None
    cac: Optional[List[List[np.ndarray]]] = None

    def full_cbp(self) -> int:
        if self.kind == "pcm":
            return 15 | (2 << 4)
        if self.kind == "i16":
            return self.i16[2] | (self.i16[1] << 4)
        return self.cbp

    def is_intra(self) -> bool:
        return self.kind in ("i4", "i16", "pcm")


@dataclasses.dataclass
class SliceHeader:
    is_p: bool
    idr: bool
    nal_ref_idc: int
    frame_num: int
    idr_pic_id: int
    poc_lsb: Optional[int]
    qp: int
    cabac_init_idc: int = 0
    slice_type_raw: int = 0


# raster-scan order of the 4x4 luma blocks inside a MB, as (x, y) in 4x4
# units — decode order is 8x8-block-major (same tables as h264_intra)
from uvol_tpu_torch.codecs.h264_intra import BLK_X, BLK_Y  # noqa: E402


# ---------------------------------------------------------------------------
# CAVLC slice-data ↔ records
# ---------------------------------------------------------------------------


class _TcCtx:
    """Total-coeff planes for CAVLC nC derivation (mirror of SliceCoder's
    tc_* bookkeeping, record-level)."""

    def __init__(self, mbw: int, mbh: int):
        self.tc_y = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.tc_cb = np.zeros((2 * mbh, 2 * mbw), np.int32)
        self.tc_cr = np.zeros((2 * mbh, 2 * mbw), np.int32)

    def nc(self, plane, bx, by) -> int:
        na = int(plane[by, bx - 1]) if bx > 0 else -1
        nb = int(plane[by - 1, bx]) if by > 0 else -1
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        if na >= 0:
            return na
        if nb >= 0:
            return nb
        return 0

    def mark_pcm(self, mbx, mby) -> None:
        self.tc_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 16
        self.tc_cb[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 16
        self.tc_cr[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 16

    def clear(self, mbx, mby) -> None:
        self.tc_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
        self.tc_cb[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        self.tc_cr[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0


def _cavlc_parse_residual(r, tc, mbx, mby, cbp, i16):
    max_l = 15 if i16 else 16
    y = [np.zeros(max_l, np.int64) for _ in range(16)]
    for i8 in range(4):
        for i4 in range(4):
            blk = 4 * i8 + i4
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            if cbp & (1 << i8):
                coeffs, tcv = read_residual_block(r, tc.nc(tc.tc_y, bx, by),
                                                  max_l)
                y[blk] = coeffs
                tc.tc_y[by, bx] = tcv
            else:
                tc.tc_y[by, bx] = 0
    cdc = [np.zeros(4, np.int64), np.zeros(4, np.int64)]
    cac = [[np.zeros(15, np.int64) for _ in range(4)] for _ in range(2)]
    if cbp >> 4:
        for c in range(2):
            cdc[c], _ = read_residual_block(r, -1, 4)
    for c, plane in enumerate((tc.tc_cb, tc.tc_cr)):
        for blk in range(4):
            bx = 2 * mbx + blk % 2
            by = 2 * mby + blk // 2
            if (cbp >> 4) == 2:
                coeffs, tcv = read_residual_block(r, tc.nc(plane, bx, by), 15)
                cac[c][blk] = coeffs
                plane[by, bx] = tcv
            else:
                plane[by, bx] = 0
    return y, cdc, cac


def _cavlc_emit_residual(w, tc, mbx, mby, rec) -> None:
    cbp = rec.full_cbp()
    for i8 in range(4):
        for i4 in range(4):
            blk = 4 * i8 + i4
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            if cbp & (1 << i8):
                tc.tc_y[by, bx] = write_residual_block(
                    w, rec.y[blk], tc.nc(tc.tc_y, bx, by)
                )
            else:
                tc.tc_y[by, bx] = 0
    if cbp >> 4:
        for c in range(2):
            write_residual_block(w, rec.cdc[c], -1)
    for c, plane in enumerate((tc.tc_cb, tc.tc_cr)):
        for blk in range(4):
            bx = 2 * mbx + blk % 2
            by = 2 * mby + blk // 2
            if (cbp >> 4) == 2:
                plane[by, bx] = write_residual_block(
                    w, rec.cac[c][blk], tc.nc(plane, bx, by)
                )
            else:
                plane[by, bx] = 0


_CBP_INTRA_FROM = None  # built lazily from the TO table


def _cbp_code(cbp: int, intra: bool) -> int:
    if intra:
        return _CBP_INTRA_TO_CODE[cbp]
    return int(_CBP_INTER_TO_CODE[cbp])


def cavlc_parse_slice_data(r, hdr: SliceHeader, mbw: int, mbh: int,
                           slice_qp: int) -> List[MbRec]:
    """CAVLC slice_data → per-MB records (decode order)."""
    from uvol_tpu_torch.codecs.h264_intra import (
        _CBP_INTER_FROM_CODE,
        _CBP_INTRA_FROM_CODE,
    )

    tc = _TcCtx(mbw, mbh)
    total = mbw * mbh
    recs: List[MbRec] = []
    qp = slice_qp

    def parse_intra(mb_type: int, mbx: int, mby: int) -> MbRec:
        nonlocal qp
        if mb_type == 25:
            r.align()
            rec = MbRec("pcm", pcm=r.bytes_at(384))
            tc.mark_pcm(mbx, mby)
            return rec
        if mb_type == 0:
            modes = []
            for _ in range(16):
                if r.u(1):
                    modes.append((1, None))
                else:
                    modes.append((0, r.u(3)))
            cm = r.ue()
            if cm > 3:
                raise ValueError("h264: intra_chroma_pred_mode > 3")
            code = r.ue()
            if code >= 48:
                raise ValueError("h264: coded_block_pattern out of range")
            cbp = _CBP_INTRA_FROM_CODE[code]
            qd = 0
            if cbp:
                qd = r.se()
                qp = (qp + qd + 52) % 52
            y, cdc, cac = _cavlc_parse_residual(r, tc, mbx, mby, cbp, False)
            return MbRec("i4", i4_modes=modes, chroma_mode=cm, cbp=cbp,
                         qp_delta=qd, y=y, cdc=cdc, cac=cac)
        if not 1 <= mb_type <= 24:
            raise ValueError(f"h264: mb_type {mb_type} in I slice")
        pm = (mb_type - 1) % 4
        cbpc = ((mb_type - 1) // 4) % 3
        cbpl = 15 if mb_type - 1 >= 12 else 0
        cm = r.ue()
        if cm > 3:
            raise ValueError("h264: intra_chroma_pred_mode > 3")
        qd = r.se()
        qp = (qp + qd + 52) % 52
        bx0, by0 = 4 * mbx, 4 * mby
        ydc, _ = read_residual_block(r, tc.nc(tc.tc_y, bx0, by0), 16)
        y, cdc, cac = _cavlc_parse_residual(
            r, tc, mbx, mby, cbpl | (cbpc << 4), True
        )
        return MbRec("i16", i16=(pm, cbpc, cbpl), chroma_mode=cm,
                     qp_delta=qd, ydc=ydc, y=y, cdc=cdc, cac=cac)

    def parse_inter(mb_type: int, mbx: int, mby: int) -> MbRec:
        nonlocal qp
        from uvol_tpu_torch.codecs.h264_intra import _CBP_INTER_FROM_CODE

        if mb_type in (3, 4):
            raise NotImplementedError(
                "h264: P_8x8 sub-macroblock partitions (encode with "
                "partitions=none)"
            )
        nparts = 1 if mb_type == 0 else 2
        mvd = [(r.se(), r.se()) for _ in range(nparts)]
        code = r.ue()
        if code >= 48:
            raise ValueError("h264: coded_block_pattern out of range")
        cbp = int(_CBP_INTER_FROM_CODE[code])
        qd = 0
        if cbp:
            qd = r.se()
            qp = (qp + qd + 52) % 52
        y, cdc, cac = _cavlc_parse_residual(r, tc, mbx, mby, cbp, False)
        kind = ("p16", "p16x8", "p8x16")[mb_type]
        return MbRec(kind, cbp=cbp, qp_delta=qd, mvd=mvd, y=y, cdc=cdc,
                     cac=cac)

    if hdr.is_p:
        mb = 0
        while mb < total:
            skip_run = r.ue()
            if skip_run > total - mb:
                raise ValueError("h264: mb_skip_run past end of slice")
            for _ in range(skip_run):
                mbx, mby = mb % mbw, mb // mbw
                tc.clear(mbx, mby)
                recs.append(MbRec("skip"))
                mb += 1
            if mb >= total:
                break
            mbx, mby = mb % mbw, mb // mbw
            mb_type = r.ue()
            if mb_type < 5:
                recs.append(parse_inter(mb_type, mbx, mby))
            else:
                recs.append(parse_intra(mb_type - 5, mbx, mby))
            mb += 1
    else:
        for mb in range(total):
            mbx, mby = mb % mbw, mb // mbw
            recs.append(parse_intra(r.ue(), mbx, mby))
    return recs


_KIND_TO_P_MBTYPE = {"p16": 0, "p16x8": 1, "p8x16": 2}


def cavlc_emit_slice_data(w, hdr: SliceHeader, recs: List[MbRec],
                          mbw: int, mbh: int) -> None:
    tc = _TcCtx(mbw, mbh)

    def emit_mb(rec: MbRec, mbx: int, mby: int, off: int) -> None:
        if rec.kind == "pcm":
            w.ue(25 + off)
            w.align()
            w.raw_bytes(rec.pcm)
            tc.mark_pcm(mbx, mby)
            return
        if rec.kind == "i4":
            w.ue(0 + off)
            for prev, rem in rec.i4_modes:
                w.u(prev, 1)
                if not prev:
                    w.u(rem, 3)
            w.ue(rec.chroma_mode)
            w.ue(_cbp_code(rec.cbp, intra=True))
            if rec.cbp:
                w.se(rec.qp_delta)
            _cavlc_emit_residual(w, tc, mbx, mby, rec)
            return
        if rec.kind == "i16":
            pm, cbpc, cbpl = rec.i16
            w.ue(1 + pm + 4 * cbpc + (12 if cbpl else 0) + off)
            w.ue(rec.chroma_mode)
            w.se(rec.qp_delta)
            bx0, by0 = 4 * mbx, 4 * mby
            tcv = write_residual_block(w, rec.ydc, tc.nc(tc.tc_y, bx0, by0))
            # the DC block's total_coeff does NOT update the nC plane
            # (AC blocks own the per-4x4 counts) — matches SliceCoder
            _cavlc_emit_residual(w, tc, mbx, mby, rec)
            return
        # inter
        w.ue(_KIND_TO_P_MBTYPE[rec.kind])
        for mvdx, mvdy in rec.mvd:
            w.se(mvdx)
            w.se(mvdy)
        w.ue(_cbp_code(rec.cbp, intra=False))
        if rec.cbp:
            w.se(rec.qp_delta)
        _cavlc_emit_residual(w, tc, mbx, mby, rec)

    if hdr.is_p:
        skip_run = 0
        for mb, rec in enumerate(recs):
            mbx, mby = mb % mbw, mb // mbw
            if rec.kind == "skip":
                tc.clear(mbx, mby)
                skip_run += 1
                continue
            w.ue(skip_run)
            skip_run = 0
            emit_mb(rec, mbx, mby, 5 if rec.is_intra() else 0)
        if skip_run:
            w.ue(skip_run)
    else:
        for mb, rec in enumerate(recs):
            emit_mb(rec, mb % mbw, mb // mbw, 0)
    w.rbsp_trailing()


# ---------------------------------------------------------------------------
# CABAC neighbor-context state (shared by parser and emitter, so the two
# directions cannot diverge)
# ---------------------------------------------------------------------------


class _CabacCtxGrid:
    KIND = {"skip": 1, "pcm": 2, "i4": 3, "i16": 4,
            "p16": 5, "p16x8": 5, "p8x16": 5}

    def __init__(self, mbw: int, mbh: int):
        self.mbw, self.mbh = mbw, mbh
        self.kind = np.zeros((mbh, mbw), np.int32)      # 0 = not yet decoded
        self.cbp = np.zeros((mbh, mbw), np.int32)
        self.cpm = np.full((mbh, mbw), -1, np.int32)    # chroma pred mode
        self.cbf_y = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.cbf_ydc = np.zeros((mbh, mbw), np.int32)
        self.cbf_cdc = np.zeros((2, mbh, mbw), np.int32)
        self.cbf_cac = np.zeros((2, 2 * mbh, 2 * mbw), np.int32)
        self.absmvd = np.zeros((4 * mbh, 4 * mbw, 2), np.int32)
        self.prev_qpd_nz = 0

    # -- per-MB commit (after its syntax is known) ---------------------------
    def commit(self, rec: MbRec, mbx: int, mby: int) -> None:
        self.kind[mby, mbx] = self.KIND[rec.kind]
        self.cbp[mby, mbx] = rec.full_cbp()
        self.cpm[mby, mbx] = rec.chroma_mode if rec.is_intra() else -1
        ys, xs = slice(4 * mby, 4 * mby + 4), slice(4 * mbx, 4 * mbx + 4)
        cys = slice(2 * mby, 2 * mby + 2)
        cxs = slice(2 * mbx, 2 * mbx + 2)
        if rec.kind == "pcm":
            self.cbf_y[ys, xs] = 1
            self.cbf_ydc[mby, mbx] = 1
            self.cbf_cdc[:, mby, mbx] = 1
            self.cbf_cac[:, cys, cxs] = 1
        elif rec.kind == "skip":
            self.cbf_y[ys, xs] = -1
            self.cbf_ydc[mby, mbx] = -1
            self.cbf_cdc[:, mby, mbx] = -1
            self.cbf_cac[:, cys, cxs] = -1
        else:
            cbp = rec.full_cbp()
            for blk in range(16):
                bx = 4 * mbx + int(BLK_X[blk])
                by = 4 * mby + int(BLK_Y[blk])
                self.cbf_y[by, bx] = (
                    int(np.any(rec.y[blk]))
                    if cbp & (1 << (blk >> 2))
                    else -1
                )
            self.cbf_ydc[mby, mbx] = (
                int(np.any(rec.ydc)) if rec.kind == "i16" else -1
            )
            for c in range(2):
                self.cbf_cdc[c, mby, mbx] = (
                    int(np.any(rec.cdc[c])) if cbp >> 4 else -1
                )
                for blk in range(4):
                    self.cbf_cac[c, 2 * mby + blk // 2,
                                 2 * mbx + blk % 2] = (
                        int(np.any(rec.cac[c][blk]))
                        if (cbp >> 4) == 2
                        else -1
                    )
        # mvd bookkeeping (skip/intra → zeros)
        self.absmvd[ys, xs] = 0
        if rec.mvd is not None:
            bx, by = 4 * mbx, 4 * mby
            if rec.kind == "p16":
                parts = [(bx, by, 4, 4, rec.mvd[0])]
            elif rec.kind == "p16x8":
                parts = [(bx, by, 4, 2, rec.mvd[0]),
                         (bx, by + 2, 4, 2, rec.mvd[1])]
            else:
                parts = [(bx, by, 2, 4, rec.mvd[0]),
                         (bx + 2, by, 2, 4, rec.mvd[1])]
            for pbx, pby, wb, hb, (mvdx, mvdy) in parts:
                self.absmvd[pby : pby + hb, pbx : pbx + wb, 0] = abs(mvdx)
                self.absmvd[pby : pby + hb, pbx : pbx + wb, 1] = abs(mvdy)
        self.prev_qpd_nz = 1 if rec.qp_delta else 0

    # -- ctxIdxInc derivations ------------------------------------------------
    def _mb(self, mbx: int, mby: int) -> int:
        """kind code of a neighbor MB, 0 when unavailable/undecoded."""
        if mbx < 0 or mby < 0 or mbx >= self.mbw or mby >= self.mbh:
            return 0
        return int(self.kind[mby, mbx])

    def inc_skip(self, mbx: int, mby: int) -> int:
        a = self._mb(mbx - 1, mby)
        b = self._mb(mbx, mby - 1)
        return (1 if a and a != 1 else 0) + (1 if b and b != 1 else 0)

    def inc_mbtype_i(self, mbx: int, mby: int) -> int:
        # condTermFlagN = mbN available and mb_type(mbN) != I_NxN
        a = self._mb(mbx - 1, mby)
        b = self._mb(mbx, mby - 1)
        return (1 if a not in (0, 3) else 0) + (1 if b not in (0, 3) else 0)

    def inc_cpm(self, mbx: int, mby: int) -> int:
        def term(nx, ny):
            k = self._mb(nx, ny)
            if k in (3, 4) and self.cpm[ny, nx] != 0:
                return 1
            return 0

        return term(mbx - 1, mby) + term(mbx, mby - 1)

    def inc_cbp_luma(self, mbx: int, mby: int, b8: int, cur_cbp: int) -> int:
        # neighbor 8x8 blocks in the luma 8x8 grid; the left/above block
        # may live in the current MB (already-decoded cbp bits)
        gx = 2 * mbx + (b8 & 1)
        gy = 2 * mby + (b8 >> 1)

        def term(nx, ny):
            nmbx, nmby = nx >> 1, ny >> 1
            if nx < 0 or ny < 0:
                return 0
            if nmbx == mbx and nmby == mby:
                bit = (cur_cbp >> ((ny & 1) * 2 + (nx & 1))) & 1
                return 0 if bit else 1
            k = self._mb(nmbx, nmby)
            if k == 0 or k == 2:  # unavailable or I_PCM → 0
                return 0
            bit = (int(self.cbp[nmby, nmbx]) >> ((ny & 1) * 2 + (nx & 1))) & 1
            return 0 if bit else 1

        return term(gx - 1, gy) + 2 * term(gx, gy - 1)

    def inc_cbp_chroma(self, mbx: int, mby: int, bin1: bool) -> int:
        def term(nx, ny):
            k = self._mb(nx, ny)
            if k == 0:
                return 0
            cc = int(self.cbp[ny, nx]) >> 4
            if bin1:
                return 1 if cc == 2 else 0
            return 1 if cc != 0 else 0

        return term(mbx - 1, mby) + 2 * term(mbx, mby - 1)

    def inc_qpd(self) -> int:
        return self.prev_qpd_nz

    # cbf planes are tri-state: 1 = coded nonzero, 0 = coded (or inferred)
    # zero, -1 = the block's coefficients are NOT PRESENT in the bitstream
    # (8x8 cbp bit clear, cbpc<2, non-I16 neighbor for the DC block, skip).
    # Whether an ABSENT block behaves like "unavailable" (intra → 1) or
    # like cbf=0 was resolved against x264 Main-profile streams via the
    # parse→re-emit byte-diff oracle (tests/test_h264_cabac.py): absent
    # blocks count 0, only truly out-of-picture neighbors take the
    # intra default.
    ABSENT_INTRA_ONE = False

    def _cbf_term(self, v: int, intra: bool) -> int:
        if v < 0:
            return (1 if intra else 0) if self.ABSENT_INTRA_ONE else 0
        return v

    def inc_cbf(self, cat: int, mbx: int, mby: int, blk: int, comp: int,
                intra: bool) -> int:
        """coded_block_flag ctxIdxInc = condA + 2*condB (9.3.3.1.1.9)."""

        def term_mb(nx, ny, plane) -> int:
            k = self._mb(nx, ny)
            if k == 0:
                return 1 if intra else 0
            if k == 2:
                return 1
            return self._cbf_term(int(plane[ny, nx]), intra)

        if cat == 0:
            # neighbor's luma DC block exists only when it is I_16x16
            def term(nx, ny):
                k = self._mb(nx, ny)
                if k == 0:
                    return 1 if intra else 0
                if k == 2:
                    return 1
                if k != 4:
                    return self._cbf_term(-1, intra)
                return self._cbf_term(int(self.cbf_ydc[ny, nx]), intra)

            return term(mbx - 1, mby) + 2 * term(mbx, mby - 1)
        if cat in (1, 2):
            gx = 4 * mbx + int(BLK_X[blk])
            gy = 4 * mby + int(BLK_Y[blk])

            def term(nx, ny):
                if nx < 0 or ny < 0:
                    return 1 if intra else 0
                k = self._mb(nx >> 2, ny >> 2)
                if k == 0:
                    return 1 if intra else 0
                if k == 2:
                    return 1
                return self._cbf_term(int(self.cbf_y[ny, nx]), intra)

            return term(gx - 1, gy) + 2 * term(gx, gy - 1)
        if cat == 3:
            return (term_mb(mbx - 1, mby, self.cbf_cdc[comp])
                    + 2 * term_mb(mbx, mby - 1, self.cbf_cdc[comp]))
        # cat 4: chroma AC, 2x2 blocks per MB per component
        gx = 2 * mbx + (blk & 1)
        gy = 2 * mby + (blk >> 1)

        def term(nx, ny):
            if nx < 0 or ny < 0:
                return 1 if intra else 0
            k = self._mb(nx >> 1, ny >> 1)
            if k == 0:
                return 1 if intra else 0
            if k == 2:
                return 1
            return self._cbf_term(int(self.cbf_cac[comp, ny, nx]), intra)

        return term(gx - 1, gy) + 2 * term(gx, gy - 1)

    def inc_mvd(self, mbx: int, mby: int, pbx: int, pby: int,
                comp: int) -> int:
        def amvd(nx, ny):
            if nx < 0 or ny < 0 or nx >= 4 * self.mbw or ny >= 4 * self.mbh:
                return 0
            if self._mb(nx >> 2, ny >> 2) == 0:
                return 0
            return int(self.absmvd[ny, nx, comp])

        s = amvd(pbx - 1, pby) + amvd(pbx, pby - 1)
        if s < 3:
            return 0
        return 2 if s > 32 else 1


# inner-MB cbf state updates during parse/emit: the current MB's own
# earlier blocks are neighbors of later ones, so cbf values must be
# visible before commit(); both directions write them eagerly into the
# grid (commit() then re-derives the same values — idempotent).


# ---------------------------------------------------------------------------
# CABAC slice-data ↔ records
# ---------------------------------------------------------------------------


def cabac_parse_slice_data(data: bytes, bitpos: int, hdr: SliceHeader,
                           mbw: int, mbh: int, slice_qp: int) -> List[MbRec]:
    """CABAC slice_data → per-MB records. `bitpos`: first bit after the
    cabac_alignment_one_bit string."""
    state, mps = init_contexts(slice_qp, not hdr.is_p, hdr.cabac_init_idc)
    rd = CabacReader(data, bitpos, state, mps)
    grid = _CabacCtxGrid(mbw, mbh)
    recs: List[MbRec] = []
    total = mbw * mbh

    def read_residual(cat: int, nmax: int, mbx, mby, blk, comp, intra):
        inc = grid.inc_cbf(cat, mbx, mby, blk, comp, intra)
        out = np.zeros(nmax, np.int64)
        if not rd.decision(85 + 4 * cat + inc):
            return out
        sig_base = 105 + _SIG_CAT_OFF[cat]
        last_base = 166 + _SIG_CAT_OFF[cat]
        sig = []
        last = nmax - 1
        for i in range(nmax - 1):
            pos_inc = min(i, 2) if cat == 3 else i
            if rd.decision(sig_base + pos_inc):
                sig.append(i)
                if rd.decision(last_base + pos_inc):
                    last = i
                    break
        else:
            # no last_significant flag terminated the map: the final
            # position is implicitly significant (and last)
            sig.append(nmax - 1)
        num_eq1 = 0
        num_gt1 = 0
        lvl_base = 227 + _LVL_CAT_OFF[cat]
        for i in reversed(sig):
            inc0 = 0 if num_gt1 else min(4, 1 + num_eq1)
            cap = 3 if cat == 3 else 4
            incn = 5 + min(cap, num_gt1)
            v = 0
            if rd.decision(lvl_base + inc0):
                v = 1
                while v < 14 and rd.decision(lvl_base + incn):
                    v += 1
                if v == 14:
                    v += rd.eg_bypass(0)
            level = v + 1
            if level == 1:
                num_eq1 += 1
            else:
                num_gt1 += 1
            if rd.bypass():
                level = -level
            out[i] = level
        return out

    def read_mb_residuals(rec: MbRec, mbx: int, mby: int) -> None:
        intra = rec.is_intra()
        cbp = rec.full_cbp()
        i16 = rec.kind == "i16"
        # the current MB is "available" to its own later blocks' cbf
        # neighbor derivation (kind is otherwise only set at commit)
        grid.kind[mby, mbx] = grid.KIND[rec.kind]
        if i16:
            rec.ydc = read_residual(0, 16, mbx, mby, 0, 0, True)
            grid.cbf_ydc[mby, mbx] = int(np.any(rec.ydc))
        nmax = 15 if i16 else 16
        cat = 1 if i16 else 2
        rec.y = [np.zeros(nmax, np.int64) for _ in range(16)]
        for blk in range(16):
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            if not cbp & (1 << (blk >> 2)):
                grid.cbf_y[by, bx] = -1  # absent, visible to later blocks
        for blk in range(16):
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            if cbp & (1 << (blk >> 2)):
                rec.y[blk] = read_residual(cat, nmax, mbx, mby, blk, 0,
                                           intra)
                grid.cbf_y[by, bx] = int(np.any(rec.y[blk]))
        rec.cdc = [np.zeros(4, np.int64), np.zeros(4, np.int64)]
        rec.cac = [[np.zeros(15, np.int64) for _ in range(4)]
                   for _ in range(2)]
        if cbp >> 4:
            for c in range(2):
                rec.cdc[c] = read_residual(3, 4, mbx, mby, 0, c, intra)
                grid.cbf_cdc[c, mby, mbx] = int(np.any(rec.cdc[c]))
        if (cbp >> 4) == 2:
            for c in range(2):
                for blk in range(4):
                    rec.cac[c][blk] = read_residual(4, 15, mbx, mby, blk,
                                                    c, intra)
                    grid.cbf_cac[c, 2 * mby + blk // 2,
                                 2 * mbx + blk % 2] = int(
                        np.any(rec.cac[c][blk])
                    )

    def read_qpd(rec: MbRec) -> None:
        # mb_qp_delta: U binarization of the se(v)-style mapping
        if not rd.decision(60 + grid.inc_qpd()):
            rec.qp_delta = 0
            return
        k = 1
        if rd.decision(62):
            k = 2
            while k < 88 and rd.decision(63):
                k += 1
            if k >= 88:
                raise ValueError("h264: mb_qp_delta overflow")
        rec.qp_delta = (k + 1) // 2 if k % 2 else -(k // 2)

    def read_i4_modes(rec: MbRec) -> None:
        modes = []
        for _ in range(16):
            if rd.decision(68):
                modes.append((1, None))
            else:
                rem = rd.decision(69)
                rem += rd.decision(69) << 1
                rem += rd.decision(69) << 2
                modes.append((0, rem))
        rec.i4_modes = modes

    def read_cpm(mbx: int, mby: int) -> int:
        if not rd.decision(64 + grid.inc_cpm(mbx, mby)):
            return 0
        if not rd.decision(67):
            return 1
        return 2 + rd.decision(67)

    def read_cbp(mbx: int, mby: int) -> int:
        cbp = 0
        for b8 in range(4):
            inc = grid.inc_cbp_luma(mbx, mby, b8, cbp)
            cbp |= rd.decision(73 + inc) << b8
        if rd.decision(77 + grid.inc_cbp_chroma(mbx, mby, False)):
            cc = 1 + rd.decision(77 + 4 + grid.inc_cbp_chroma(mbx, mby, True))
        else:
            cc = 0
        return cbp | (cc << 4)

    def read_intra_mb(mbx: int, mby: int, suffix: bool) -> MbRec:
        base = 17 if suffix else 3
        if suffix:
            first = rd.decision(base)
        else:
            first = rd.decision(base + grid.inc_mbtype_i(mbx, mby))
        if not first:
            rec = MbRec("i4")
            read_i4_modes(rec)
            rec.chroma_mode = read_cpm(mbx, mby)
            rec.cbp = read_cbp(mbx, mby)
            if rec.cbp:
                read_qpd(rec)
            read_mb_residuals(rec, mbx, mby)
            return rec
        if rd.terminate():
            # I_PCM: byte-align (zero bits), raw samples, engine re-init
            rd.pos = (rd.pos + 7) & ~7
            if rd.pos + 8 * 384 > 8 * len(data):
                raise ValueError("h264: truncated PCM samples")
            pcm = data[rd.pos // 8 : rd.pos // 8 + 384]
            rd.pos += 8 * 384
            rd.reinit()
            return MbRec("pcm", pcm=pcm)
        if suffix:
            cbpl = 15 if rd.decision(base + 1) else 0
            if rd.decision(base + 2):
                cbpc = 1 + rd.decision(base + 2)
            else:
                cbpc = 0
            pm = rd.decision(base + 3) << 1
            pm += rd.decision(base + 3)
        else:
            cbpl = 15 if rd.decision(base + 3) else 0
            if rd.decision(base + 4):
                cbpc = 1 + rd.decision(base + 5)
            else:
                cbpc = 0
            pm = rd.decision(base + 6) << 1
            pm += rd.decision(base + 7)
        rec = MbRec("i16", i16=(pm, cbpc, cbpl))
        rec.chroma_mode = read_cpm(mbx, mby)
        read_qpd(rec)
        read_mb_residuals(rec, mbx, mby)
        return rec

    def read_mvd(mbx, mby, pbx, pby, comp) -> int:
        base = 40 if comp == 0 else 47
        inc = grid.inc_mvd(mbx, mby, pbx, pby, comp)
        if not rd.decision(base + inc):
            return 0
        v = 1
        while v < 9 and rd.decision(base + min(v + 2, 6)):
            v += 1
        if v == 9:
            v += rd.eg_bypass(3)
        return -v if rd.bypass() else v

    def read_p_mb(mbx: int, mby: int) -> MbRec:
        if rd.decision(14):
            return read_intra_mb(mbx, mby, suffix=True)
        if rd.decision(15):
            # '01x': 1 → 16x8, 0 → 8x16
            kind = "p16x8" if rd.decision(17) else "p8x16"
        else:
            if rd.decision(16):
                raise NotImplementedError(
                    "h264: P_8x8 sub-macroblock partitions (encode with "
                    "partitions=none)"
                )
            kind = "p16"
        bx, by = 4 * mbx, 4 * mby
        if kind == "p16":
            parts = [(bx, by, 4, 4)]
        elif kind == "p16x8":
            parts = [(bx, by, 4, 2), (bx, by + 2, 4, 2)]
        else:
            parts = [(bx, by, 2, 4), (bx + 2, by, 2, 4)]
        rec = MbRec(kind, mvd=[])
        for pbx, pby, wb, hb in parts:
            mvdx = read_mvd(mbx, mby, pbx, pby, 0)
            mvdy = read_mvd(mbx, mby, pbx, pby, 1)
            rec.mvd.append((mvdx, mvdy))
            # later partitions of this MB see the earlier ones' |mvd|
            grid.absmvd[pby : pby + hb, pbx : pbx + wb, 0] = abs(mvdx)
            grid.absmvd[pby : pby + hb, pbx : pbx + wb, 1] = abs(mvdy)
            grid.kind[mby, mbx] = grid.KIND[kind]
        rec.cbp = read_cbp(mbx, mby)
        if rec.cbp:
            read_qpd(rec)
        read_mb_residuals(rec, mbx, mby)
        return rec

    for mb in range(total):
        mbx, mby = mb % mbw, mb // mbw
        if hdr.is_p and rd.decision(11 + grid.inc_skip(mbx, mby)):
            rec = MbRec("skip")
        elif hdr.is_p:
            rec = read_p_mb(mbx, mby)
        else:
            rec = read_intra_mb(mbx, mby, suffix=False)
        grid.commit(rec, mbx, mby)
        recs.append(rec)
        eos = rd.terminate()
        if eos != (1 if mb == total - 1 else 0):
            raise ValueError("h264: CABAC end_of_slice_flag mismatch")
    return recs


def cabac_emit_slice_data(bw, hdr: SliceHeader, recs: List[MbRec],
                          mbw: int, mbh: int, slice_qp: int) -> None:
    """Records → CABAC slice_data appended to `bw` (which must hold the
    slice header; this writes cabac_alignment_one_bit first)."""
    while bw.bit_position % 8:
        bw.u(1, 1)
    state, mps = init_contexts(slice_qp, not hdr.is_p, hdr.cabac_init_idc)
    wr = CabacWriter(bw, state, mps)
    grid = _CabacCtxGrid(mbw, mbh)
    total = mbw * mbh

    def write_residual(coeffs, cat, mbx, mby, blk, comp, intra) -> None:
        inc = grid.inc_cbf(cat, mbx, mby, blk, comp, intra)
        nz = np.nonzero(coeffs)[0]
        wr.decision(85 + 4 * cat + inc, 1 if len(nz) else 0)
        if not len(nz):
            return
        nmax = len(coeffs)
        last = int(nz[-1])
        sig_base = 105 + _SIG_CAT_OFF[cat]
        last_base = 166 + _SIG_CAT_OFF[cat]
        nzset = set(int(i) for i in nz)
        for i in range(min(last + 1, nmax - 1)):
            pos_inc = min(i, 2) if cat == 3 else i
            s = 1 if i in nzset else 0
            wr.decision(sig_base + pos_inc, s)
            if s:
                wr.decision(last_base + pos_inc, 1 if i == last else 0)
        num_eq1 = 0
        num_gt1 = 0
        lvl_base = 227 + _LVL_CAT_OFF[cat]
        for i in reversed(nz):
            level = int(coeffs[i])
            mag = abs(level)
            inc0 = 0 if num_gt1 else min(4, 1 + num_eq1)
            cap = 3 if cat == 3 else 4
            incn = 5 + min(cap, num_gt1)
            v = mag - 1
            if v == 0:
                wr.decision(lvl_base + inc0, 0)
            else:
                wr.decision(lvl_base + inc0, 1)
                for _ in range(min(v, 14) - 1):
                    wr.decision(lvl_base + incn, 1)
                if v < 14:
                    wr.decision(lvl_base + incn, 0)
                else:
                    wr.eg_bypass(0, v - 14)
            if mag == 1:
                num_eq1 += 1
            else:
                num_gt1 += 1
            wr.bypass(1 if level < 0 else 0)

    def write_mb_residuals(rec: MbRec, mbx: int, mby: int) -> None:
        intra = rec.is_intra()
        cbp = rec.full_cbp()
        i16 = rec.kind == "i16"
        # mirror of the parse side: the current MB is "available" to its
        # own later blocks' cbf neighbor derivation
        grid.kind[mby, mbx] = grid.KIND[rec.kind]
        if i16:
            write_residual(rec.ydc, 0, mbx, mby, 0, 0, True)
            grid.cbf_ydc[mby, mbx] = int(np.any(rec.ydc))
        cat = 1 if i16 else 2
        for blk in range(16):
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            if not cbp & (1 << (blk >> 2)):
                grid.cbf_y[by, bx] = -1  # absent, visible to later blocks
        for blk in range(16):
            bx = 4 * mbx + int(BLK_X[blk])
            by = 4 * mby + int(BLK_Y[blk])
            if cbp & (1 << (blk >> 2)):
                write_residual(rec.y[blk], cat, mbx, mby, blk, 0, intra)
                grid.cbf_y[by, bx] = int(np.any(rec.y[blk]))
        if cbp >> 4:
            for c in range(2):
                write_residual(rec.cdc[c], 3, mbx, mby, 0, c, intra)
                grid.cbf_cdc[c, mby, mbx] = int(np.any(rec.cdc[c]))
        if (cbp >> 4) == 2:
            for c in range(2):
                for blk in range(4):
                    write_residual(rec.cac[c][blk], 4, mbx, mby, blk, c,
                                   intra)
                    grid.cbf_cac[c, 2 * mby + blk // 2,
                                 2 * mbx + blk % 2] = int(
                        np.any(rec.cac[c][blk])
                    )

    def write_qpd(rec: MbRec) -> None:
        d = rec.qp_delta
        k = 2 * d - 1 if d > 0 else -2 * d
        wr.decision(60 + grid.inc_qpd(), 1 if k else 0)
        if not k:
            return
        wr.decision(62, 1 if k > 1 else 0)
        for _ in range(k - 2):
            wr.decision(63, 1)
        if k > 1:
            wr.decision(63, 0)

    def write_cpm(cm: int, mbx: int, mby: int) -> None:
        wr.decision(64 + grid.inc_cpm(mbx, mby), 1 if cm else 0)
        if cm:
            wr.decision(67, 1 if cm > 1 else 0)
            if cm > 1:
                wr.decision(67, cm - 2)

    def write_cbp(cbp: int, mbx: int, mby: int) -> None:
        part = 0
        for b8 in range(4):
            inc = grid.inc_cbp_luma(mbx, mby, b8, part)
            bit = (cbp >> b8) & 1
            wr.decision(73 + inc, bit)
            part |= bit << b8
        cc = cbp >> 4
        wr.decision(77 + grid.inc_cbp_chroma(mbx, mby, False),
                    1 if cc else 0)
        if cc:
            wr.decision(77 + 4 + grid.inc_cbp_chroma(mbx, mby, True), cc - 1)

    def write_intra_mb(rec: MbRec, mbx: int, mby: int, suffix: bool) -> None:
        base = 17 if suffix else 3
        first_ctx = base if suffix else base + grid.inc_mbtype_i(mbx, mby)
        if rec.kind == "i4":
            wr.decision(first_ctx, 0)
            for prev, rem in rec.i4_modes:
                wr.decision(68, prev)
                if not prev:
                    wr.decision(69, rem & 1)
                    wr.decision(69, (rem >> 1) & 1)
                    wr.decision(69, (rem >> 2) & 1)
            write_cpm(rec.chroma_mode, mbx, mby)
            write_cbp(rec.cbp, mbx, mby)
            if rec.cbp:
                write_qpd(rec)
            write_mb_residuals(rec, mbx, mby)
            return
        wr.decision(first_ctx, 1)
        if rec.kind == "pcm":
            wr.terminate(1)
            while bw.bit_position % 8:
                bw.u(0, 1)
            bw.raw_bytes(rec.pcm)
            wr.reinit()
            return
        wr.terminate(0)
        pm, cbpc, cbpl = rec.i16
        if suffix:
            wr.decision(base + 1, 1 if cbpl else 0)
            wr.decision(base + 2, 1 if cbpc else 0)
            if cbpc:
                wr.decision(base + 2, cbpc - 1)
            wr.decision(base + 3, (pm >> 1) & 1)
            wr.decision(base + 3, pm & 1)
        else:
            wr.decision(base + 3, 1 if cbpl else 0)
            wr.decision(base + 4, 1 if cbpc else 0)
            if cbpc:
                wr.decision(base + 5, cbpc - 1)
            wr.decision(base + 6, (pm >> 1) & 1)
            wr.decision(base + 7, pm & 1)
        write_cpm(rec.chroma_mode, mbx, mby)
        write_qpd(rec)
        write_mb_residuals(rec, mbx, mby)

    def write_mvd(v: int, mbx, mby, pbx, pby, comp) -> None:
        base = 40 if comp == 0 else 47
        inc = grid.inc_mvd(mbx, mby, pbx, pby, comp)
        mag = abs(v)
        wr.decision(base + inc, 1 if mag else 0)
        if not mag:
            return
        for i in range(1, min(mag, 9)):
            wr.decision(base + min(i + 2, 6), 1)
        if mag < 9:
            wr.decision(base + min(mag + 2, 6), 0)
        else:
            wr.eg_bypass(3, mag - 9)
        wr.bypass(1 if v < 0 else 0)

    def write_p_mb(rec: MbRec, mbx: int, mby: int) -> None:
        if rec.is_intra():
            wr.decision(14, 1)
            write_intra_mb(rec, mbx, mby, suffix=True)
            return
        wr.decision(14, 0)
        bx, by = 4 * mbx, 4 * mby
        if rec.kind == "p16":
            wr.decision(15, 0)
            wr.decision(16, 0)
            parts = [(bx, by, 4, 4)]
        elif rec.kind == "p16x8":
            wr.decision(15, 1)
            wr.decision(17, 1)
            parts = [(bx, by, 4, 2), (bx, by + 2, 4, 2)]
        else:
            wr.decision(15, 1)
            wr.decision(17, 0)
            parts = [(bx, by, 2, 4), (bx + 2, by, 2, 4)]
        for (pbx, pby, wb, hb), (mvdx, mvdy) in zip(parts, rec.mvd):
            write_mvd(mvdx, mbx, mby, pbx, pby, 0)
            write_mvd(mvdy, mbx, mby, pbx, pby, 1)
            grid.absmvd[pby : pby + hb, pbx : pbx + wb, 0] = abs(mvdx)
            grid.absmvd[pby : pby + hb, pbx : pbx + wb, 1] = abs(mvdy)
            grid.kind[mby, mbx] = grid.KIND[rec.kind]
        write_cbp(rec.cbp, mbx, mby)
        if rec.cbp:
            write_qpd(rec)
        write_mb_residuals(rec, mbx, mby)

    for mb, rec in enumerate(recs):
        mbx, mby = mb % mbw, mb // mbw
        if hdr.is_p:
            wr.decision(11 + grid.inc_skip(mbx, mby),
                        1 if rec.kind == "skip" else 0)
            if rec.kind != "skip":
                write_p_mb(rec, mbx, mby)
        else:
            write_intra_mb(rec, mbx, mby, suffix=False)
        grid.commit(rec, mbx, mby)
        wr.terminate(1 if mb == total - 1 else 0)
    # flush already ran inside the final terminate(1); pad to a byte
    while bw.bit_position % 8:
        bw.u(0, 1)


# ---------------------------------------------------------------------------
# Slice header parse/emit + whole-slice / whole-stream transcoding
# ---------------------------------------------------------------------------


def parse_slice_header(r, sps, pps, idr: bool, nal_ref_idc: int):
    """Slice header → (SliceHeader, slice QP). Mirrors the field subset
    (and refusals) of h264._decode_slice_planes."""
    if r.ue() != 0:
        raise NotImplementedError("h264: multi-slice pictures")
    slice_type = r.ue()
    is_p = slice_type % 5 == 0
    if not is_p and slice_type % 5 != 2:
        raise NotImplementedError("h264: only I and P slices")
    if is_p and idr:
        raise ValueError("h264: P slice in an IDR NAL")
    r.ue()  # pps id
    frame_num = r.u(sps.log2_max_frame_num)
    idr_pic_id = 0
    if idr:
        idr_pic_id = r.ue()
    poc_lsb = None
    if sps.poc_type == 0:
        poc_lsb = r.u(sps.log2_max_poc_lsb)
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
        if getattr(pps, "weighted_pred", False):
            from uvol_tpu_torch.codecs.h264 import parse_pred_weight_table

            parse_pred_weight_table(r)
    if idr:
        r.u(1)
        r.u(1)  # dec_ref_pic_marking (IDR form)
    elif nal_ref_idc:
        if r.u(1):
            raise NotImplementedError("h264: adaptive reference marking")
    cabac_init_idc = 0
    if getattr(pps, "cabac", False) and is_p:
        cabac_init_idc = r.ue()
        if cabac_init_idc > 2:
            raise ValueError("h264: cabac_init_idc out of range")
    qp = pps.pic_init_qp + r.se()
    if not 0 <= qp <= 51:
        raise ValueError(f"h264: slice QP {qp} out of range")
    if pps.deblocking_control_present:
        idc = r.ue()
        if idc != 1:
            raise NotImplementedError(
                "h264: deblocking enabled (encode with the filter off)"
            )
    else:
        raise NotImplementedError(
            "h264: PPS without deblocking control (filter implicitly on)"
        )
    return (
        SliceHeader(
            is_p=is_p, idr=idr, nal_ref_idc=nal_ref_idc,
            frame_num=frame_num, idr_pic_id=idr_pic_id, poc_lsb=poc_lsb,
            qp=qp, cabac_init_idc=cabac_init_idc,
            slice_type_raw=slice_type,
        ),
        qp,
    )


def emit_slice_header(w, hdr: SliceHeader, sps, pic_init_qp: int,
                      cabac: bool) -> None:
    w.ue(0)  # first_mb_in_slice
    w.ue(hdr.slice_type_raw)
    w.ue(0)  # pps id
    w.u(hdr.frame_num, sps.log2_max_frame_num)
    if hdr.idr:
        w.ue(hdr.idr_pic_id)
    if sps.poc_type == 0:
        w.u(hdr.poc_lsb or 0, sps.log2_max_poc_lsb)
    if hdr.is_p:
        w.u(0, 1)  # num_ref_idx_active_override
        w.u(0, 1)  # ref_pic_list_modification_flag_l0
    if hdr.idr:
        w.u(0, 1)
        w.u(0, 1)
    elif hdr.nal_ref_idc:
        w.u(0, 1)  # adaptive_ref_pic_marking_mode_flag
    if cabac and hdr.is_p:
        w.ue(hdr.cabac_init_idc)
    w.se(hdr.qp - pic_init_qp)
    w.ue(1)  # disable_deblocking_filter_idc


def slice_to_records(rbsp: bytes, sps, pps, idr: bool,
                     nal_ref_idc: int = 3):
    """One slice RBSP (either entropy mode, per pps.cabac) →
    (SliceHeader, records)."""
    from uvol_tpu_torch.codecs.h264 import BitReader

    r = BitReader(rbsp)
    hdr, qp = parse_slice_header(r, sps, pps, idr, nal_ref_idc)
    cw = sps.coded_width or sps.width
    ch = sps.coded_height or sps.height
    mbw, mbh = cw // 16, ch // 16
    if getattr(pps, "cabac", False):
        # cabac_alignment_one_bit: all 1s to the next byte boundary
        while r.pos % 8:
            if r.u(1) != 1:
                raise ValueError("h264: bad cabac_alignment_one_bit")
        recs = cabac_parse_slice_data(rbsp, r.pos, hdr, mbw, mbh, qp)
    else:
        recs = cavlc_parse_slice_data(r, hdr, mbw, mbh, qp)
    return hdr, recs


def records_to_slice(hdr: SliceHeader, recs, sps, pic_init_qp: int,
                     cabac: bool) -> bytes:
    """(header, records) → slice RBSP in the requested entropy mode."""
    from uvol_tpu_torch.codecs.h264 import BitWriter

    w = BitWriter()
    emit_slice_header(w, hdr, sps, pic_init_qp, cabac)
    cw = sps.coded_width or sps.width
    ch = sps.coded_height or sps.height
    mbw, mbh = cw // 16, ch // 16
    if cabac:
        cabac_emit_slice_data(w, hdr, recs, mbw, mbh, hdr.qp)
    else:
        cavlc_emit_slice_data(w, hdr, recs, mbw, mbh)
    return w.getvalue()


def transcode_annexb(stream: bytes, to_cabac: bool) -> bytes:
    """Losslessly re-entropy-code every slice of an Annex-B stream
    (CAVLC → CABAC or back). Reconstruction is bit-identical: only the
    entropy layer of each slice is rewritten; SPS gains the matching
    profile_idc and the PPS entropy_coding_mode_flag flips."""
    from uvol_tpu_torch.codecs.h264 import (
        _unescape,
        make_pps,
        make_sps,
        nal,
        parse_pps,
        parse_sps,
        split_nals,
    )

    out = []
    sps = None
    pps = None
    for unit in split_nals(stream):
        ntype = unit[0] & 0x1F
        ref_idc = (unit[0] >> 5) & 3
        if ntype in (6, 9, 10, 11, 12):
            continue
        rbsp = _unescape(unit[1:])
        if ntype == 7:
            sps = parse_sps(rbsp)
            out.append(nal(7, make_sps(sps.coded_width, sps.coded_height,
                                       profile=77 if to_cabac else 66)))
        elif ntype == 8:
            pps = parse_pps(rbsp)
            out.append(nal(8, make_pps(cabac=to_cabac)))
        elif ntype in (1, 5):
            if sps is None or pps is None:
                raise ValueError("h264: slice before parameter sets")
            if bool(getattr(pps, "cabac", False)) == bool(to_cabac):
                out.append(nal(ntype, rbsp, ref_idc))
                continue
            hdr, recs = slice_to_records(rbsp, sps, pps, idr=(ntype == 5),
                                         nal_ref_idc=ref_idc)
            out.append(
                nal(ntype, records_to_slice(hdr, recs, sps, 26, to_cabac),
                    ref_idc)
            )
        else:
            out.append(nal(ntype, rbsp, ref_idc))
    return b"".join(out)


def cabac_slice_to_cavlc(rbsp: bytes, sps, pps, idr: bool,
                         nal_ref_idc: int = 3) -> bytes:
    """One CABAC slice RBSP → the equivalent CAVLC RBSP (the decode-path
    bridge: the conformance-locked CAVLC decoder reconstructs it)."""
    hdr, recs = slice_to_records(rbsp, sps, pps, idr, nal_ref_idc)
    return records_to_slice(hdr, recs, sps, pps.pic_init_qp, cabac=False)
