"""Spec-structured UASTC LDR 4x4 wire (VERDICT r3 item 4).

Replaces the legacy ``UVTUASTCProfile`` container layout
(codecs/basis/uastc.py) as the wire this encoder EMITS. The reference
consumes real UASTC through the Basis transcoder
(src/lib/KTX2Loader.js:552 transcodeImage); this module
re-creates that wire class from UASTC's defining design property:

    **every UASTC mode is a strict subset of ASTC-LDR 4x4** — the same
    endpoint quantization ranges, the same weight ranges, the same
    partition-pattern seeds — so transcoding UASTC -> ASTC is a verbatim
    field shuffle (no requantization anywhere).

That property pins most of the format mechanically and makes it
verifiable offline:

- Per-mode endpoint ranges are NOT free parameters: for each mode's
  (CEM, planes, subsets, weight bits) configuration, the range equals
  the one an ASTC decoder infers from the equivalent ASTC block's
  leftover color bits (pack_astc_block's inference rule). Every row of
  MODE_CONFIGS reproduces its declared range through that rule
  (tests/test_uastc_spec.py::test_mode_ranges_are_astc_inferred), and
  the GL ASTC oracle validates the verbatim repack end to end.
- Endpoint values are ASTC color-range quantized (trits/quints + bits,
  codecs/basis/astc.py unquantize_color), BISE-packed in ASTC CEM value
  order; decode implements full ASTC CEM 4/8/12 semantics including the
  blue-contract + swap rule, so foreign blocks that exercise it decode
  exactly like ASTC.
- Weights are plain n-bit fields (1..5 bits) in texel raster order,
  plane-interleaved for dual-plane modes, dequantized with the ASTC
  weight unquantization (bit-replication + the >32 adjustment — NOT
  uniform rounding; they differ at 4/5 bits).

RECONSTRUCTION RISK (honesty; zero-egress environment, no UASTC spec
text or basisu fixtures to verify against — see the legacy module's
scope note). Three layout cells cannot be derived from the ASTC-subset
property and are this module's own documented choices, isolated below
so a single table edit fixes interop when fixtures appear:

1. ``_MODE_CODE_LENGTHS`` / the canonical prefix code built from it —
   real UASTC uses a variable-length mode code; the per-mode code
   assignments here are a deterministic canonical code, not verified
   bit values.
2. Transcode-hint fields (real UASTC dedicates leftover bits to ETC1/
   BC1 transcoding hints): modeled as one zero-filled field per block
   whose width makes the layout sum to exactly 128 bits
   (``hint_bits``); positions of ccs/seed/endpoints/weights around it
   are this module's choice (weights at the top end, ASTC-like).
3. The void-extent (solid) block body: mode code + RGBA8888.

Files written with this wire carry NO profile marker; the container
reader routes marker-less UASTC payloads here and legacy-marked files
to the legacy decoder (codecs/basis/uastc.py transcode path).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from uvol_tpu_torch.codecs.basis.astc import (
    _COLOR_RANGES,
    _color_unquant_lut,
    _levels,
    _weight_unquant_lut,
    ise_bits,
)
from uvol_tpu_torch.codecs.basis.uastc import (
    MODE_SOLID,
    _bits_of,
    _fit_endpoints_weights,
    _fit_subsets,
    _get_field,
    _mode_pixels,
    _pack_bits,
    _put_field,
    astc_partition_4x4,
)

# ---------------------------------------------------------------------------
# Mode configuration — (cem, weight_bits, planes, subsets). The color
# range is DERIVED (ASTC inference), not stored.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecMode:
    cem: int            # ASTC CEM: 4 = LA, 8 = RGB, 12 = RGBA (direct)
    weight_bits: int    # plain per-texel weight field width (1..5)
    planes: int = 1     # 2 = dual-plane (adds a 2-bit ccs field)
    subsets: int = 1    # ASTC partitions (adds a 10-bit seed field)

    @property
    def ncomp(self) -> int:
        return {4: 2, 8: 3, 12: 4}[self.cem]

    @property
    def weight_tq(self) -> Tuple[int, int, int]:
        return (0, 0, self.weight_bits)

    @property
    def n_weights(self) -> int:
        return 16 * self.planes


#: (cem, weight_bits, planes, subsets) per mode id. Derivable cells:
#: each row's endpoint range below falls out of ASTC's range inference.
MODE_CONFIGS: Dict[int, SpecMode] = {
    0: SpecMode(cem=8, weight_bits=4),
    1: SpecMode(cem=8, weight_bits=2),
    2: SpecMode(cem=8, weight_bits=3, subsets=2),
    3: SpecMode(cem=8, weight_bits=2, subsets=3),
    4: SpecMode(cem=8, weight_bits=2, subsets=2),
    5: SpecMode(cem=8, weight_bits=3),
    6: SpecMode(cem=8, weight_bits=2, planes=2),
    7: SpecMode(cem=8, weight_bits=2, subsets=2),
    # 8 = void extent (solid)
    9: SpecMode(cem=12, weight_bits=2, subsets=2),
    10: SpecMode(cem=12, weight_bits=4),
    11: SpecMode(cem=12, weight_bits=2, planes=2),
    12: SpecMode(cem=12, weight_bits=3),
    13: SpecMode(cem=12, weight_bits=1, planes=2),
    14: SpecMode(cem=12, weight_bits=2),
    15: SpecMode(cem=4, weight_bits=4),
    16: SpecMode(cem=4, weight_bits=2, subsets=2),
    17: SpecMode(cem=4, weight_bits=2, planes=2),
    18: SpecMode(cem=8, weight_bits=5),
}

#: RECONSTRUCTION CELL 1 — per-mode code lengths for the canonical
#: prefix code (mode 8 = solid included). Edit here for interop fixes.
_MODE_CODE_LENGTHS: Dict[int, int] = {
    0: 4, 1: 6, 2: 5, 3: 5, 4: 5, 5: 5, 6: 5, 7: 5, 8: 5, 9: 5,
    10: 6, 11: 6, 12: 6, 13: 7, 14: 6, 15: 7, 16: 6, 17: 6, 18: 6,
}

_MAX_CODE_LEN = max(_MODE_CODE_LENGTHS.values())


def _reverse_bits(v: int, n: int) -> int:
    out = 0
    for _ in range(n):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


@lru_cache(maxsize=1)
def mode_codes() -> Dict[int, Tuple[int, int]]:
    """mode -> (code, length); canonical prefix code over
    _MODE_CODE_LENGTHS, stored LSB-first (read the low `length` bits)."""
    order = sorted(_MODE_CODE_LENGTHS, key=lambda m: (_MODE_CODE_LENGTHS[m], m))
    codes: Dict[int, Tuple[int, int]] = {}
    code = 0
    prev_len = _MODE_CODE_LENGTHS[order[0]]
    for m in order:
        ln = _MODE_CODE_LENGTHS[m]
        code <<= ln - prev_len
        prev_len = ln
        codes[m] = (_reverse_bits(code, ln), ln)
        code += 1
    return codes


@lru_cache(maxsize=1)
def _mode_lut() -> np.ndarray:
    """low-_MAX_CODE_LEN-bits -> mode id (or -1)."""
    lut = np.full(1 << _MAX_CODE_LEN, -1, np.int64)
    for m, (code, ln) in mode_codes().items():
        step = 1 << ln
        lut[code::step] = m
    return lut


# ---------------------------------------------------------------------------
# Derived layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModeLayout:
    mode_id: int
    cfg: SpecMode
    code: int
    code_len: int
    color_tq: Tuple[int, int, int]  # ASTC-inferred endpoint range
    hint_bits: int                  # RECONSTRUCTION CELL 2 (zero filler)
    ccs_pos: int                    # -1 when single-plane
    seed_pos: int                   # -1 when single-subset
    color_pos: int
    weight_pos: int                 # == 128 - n_weights * weight_bits


def _astc_inferred_range(cfg: SpecMode) -> Tuple[int, int, int]:
    """The range the equivalent ASTC block's decoder infers — UASTC's
    defining subset property makes this THE mode's endpoint range."""
    wbits = ise_bits(cfg.n_weights, cfg.weight_tq)
    color_start = 17 if cfg.subsets == 1 else 29
    avail = 128 - wbits - (2 if cfg.planes == 2 else 0) - color_start
    ncolor = cfg.ncomp * 2 * cfg.subsets
    for tq in _COLOR_RANGES:
        if ise_bits(ncolor, tq) <= avail:
            return tq
    raise AssertionError(f"no ASTC range fits mode config {cfg}")


@lru_cache(maxsize=1)
def mode_layouts() -> Dict[int, ModeLayout]:
    out: Dict[int, ModeLayout] = {}
    for mode_id, cfg in MODE_CONFIGS.items():
        code, code_len = mode_codes()[mode_id]
        ctq = _astc_inferred_range(cfg)
        ncolor = cfg.ncomp * 2 * cfg.subsets
        cbits = ise_bits(ncolor, ctq)
        wfield = cfg.n_weights * cfg.weight_bits
        ccs_bits = 2 if cfg.planes == 2 else 0
        seed_bits = 10 if cfg.subsets > 1 else 0
        hint = 128 - code_len - ccs_bits - seed_bits - cbits - wfield
        assert hint >= 0, (mode_id, hint)
        pos = code_len + hint
        ccs_pos = -1
        if ccs_bits:
            ccs_pos = pos
            pos += 2
        seed_pos = -1
        if seed_bits:
            seed_pos = pos
            pos += 10
        color_pos = pos
        weight_pos = 128 - wfield
        assert color_pos + cbits == weight_pos, mode_id
        out[mode_id] = ModeLayout(
            mode_id, cfg, code, code_len, ctq, hint,
            ccs_pos, seed_pos, color_pos, weight_pos,
        )
    return out


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------


def pack_spec_blocks(
    mode_id: int,
    cq: np.ndarray,        # [B, subsets, 2*ncomp] quantized ASTC color
                           # values in CEM order (v0..v{2nc-1})
    wq: np.ndarray,        # [B, 16] plane-1 weight indices
    wq2: Optional[np.ndarray] = None,   # [B, 16] plane-2 (dual only)
    seed: Optional[np.ndarray] = None,  # [B] partition seeds
    ccs: Optional[np.ndarray] = None,   # [B] dual-plane component
) -> np.ndarray:
    lay = mode_layouts()[mode_id]
    cfg = lay.cfg
    B = len(cq)
    bits = np.zeros((B, 128), np.uint8)
    _put_field(bits, 0, lay.code_len, np.full(B, lay.code))
    if cfg.planes == 2:
        _put_field(bits, lay.ccs_pos, 2, np.asarray(ccs))
    if cfg.subsets > 1:
        _put_field(bits, lay.seed_pos, 10, np.asarray(seed))
    vals = cq.reshape(B, cfg.subsets * 2 * cfg.ncomp)
    _ise_put(bits, lay.color_pos, vals, lay.color_tq)
    pos = lay.weight_pos
    wb = cfg.weight_bits
    if cfg.planes == 2:
        inter = np.empty((B, 32), np.int64)
        inter[:, 0::2] = wq
        inter[:, 1::2] = wq2
        for i in range(32):
            _put_field(bits, pos + i * wb, wb, inter[:, i])
    else:
        for i in range(16):
            _put_field(bits, pos + i * wb, wb, wq[:, i])
    return _pack_bits(bits)


def _ise_put(bits: np.ndarray, pos: int, vals: np.ndarray, tq) -> int:
    """ASTC-ISE pack [B, N] values: value bits interleaved with trit/
    quint block chunks exactly like astc.ise_write, vectorized over B.
    Partial trailing groups use the zero-truncatable block codes."""
    from uvol_tpu_torch.codecs.basis.uastc import (
        _QUINT_ENC,
        _QUINT_ENC_PARTIAL,
        _TRIT_ENC,
        _TRIT_ENC_PARTIAL,
    )

    t, q, b = tq
    B, N = vals.shape
    if not t and not q:
        for i in range(N):
            _put_field(bits, pos + i * b, b, vals[:, i])
        return pos + N * b
    if t:
        group, chunks, base = 5, [2, 2, 1, 2, 1], 3
        enc_full, enc_part = _TRIT_ENC, _TRIT_ENC_PARTIAL
    else:
        group, chunks, base = 3, [3, 2, 2], 5
        enc_full, enc_part = _QUINT_ENC, _QUINT_ENC_PARTIAL
    p = pos
    for g0 in range(0, N, group):
        n = min(group, N - g0)
        hi = vals[:, g0 : g0 + n] >> b
        lo = vals[:, g0 : g0 + n] & ((1 << b) - 1)
        idx = np.zeros(B, np.int64)
        for k in range(n - 1, -1, -1):
            idx = idx * base + hi[:, k]
        code = (enc_full if n == group else enc_part[n - 1])[idx]
        if (code < 0).any():
            raise ValueError("unencodable ISE group")
        cpos = 0
        for k in range(n):
            _put_field(bits, p, b, lo[:, k])
            p += b
            cb = chunks[k]
            _put_field(bits, p, cb, (code >> cpos) & ((1 << cb) - 1))
            cpos += cb
            p += cb
    return p


def _ise_get(bits: np.ndarray, pos: int, n_values: int, tq):
    from uvol_tpu_torch.codecs.basis.uastc import _QUINT_DEC, _TRIT_DEC

    t, q, b = tq
    B = len(bits)
    out = np.zeros((B, n_values), np.int64)
    if not t and not q:
        for i in range(n_values):
            out[:, i] = _get_field(bits, pos + i * b, b)
        return out, pos + n_values * b
    if t:
        group, chunks, dec = 5, [2, 2, 1, 2, 1], _TRIT_DEC
    else:
        group, chunks, dec = 3, [3, 2, 2], _QUINT_DEC
    p = pos
    for g0 in range(0, n_values, group):
        n = min(group, n_values - g0)
        lo = np.zeros((B, n), np.int64)
        code = np.zeros(B, np.int64)
        cpos = 0
        for k in range(n):
            lo[:, k] = _get_field(bits, p, b)
            p += b
            cb = chunks[k]
            code |= _get_field(bits, p, cb) << cpos
            cpos += cb
            p += cb
        hi = dec[code]  # [B, group]
        out[:, g0 : g0 + n] = (hi[:, :n] << b) | lo
    return out, p


# ---------------------------------------------------------------------------
# Decode (full ASTC CEM semantics, vectorized)
# ---------------------------------------------------------------------------


def _blue_contract(rgb: np.ndarray) -> np.ndarray:
    out = rgb.copy()
    out[..., 0] = (rgb[..., 0] + rgb[..., 2]) >> 1
    out[..., 1] = (rgb[..., 1] + rgb[..., 2]) >> 1
    return out


def _endpoints_rgba(cem: int, v8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ASTC CEM 4/8/12 endpoint decode. v8: [..., 2*ncomp] unquantized
    8-bit values in CEM order -> (e0, e1) [..., 4] RGBA."""
    shape = v8.shape[:-1]
    e0 = np.full(shape + (4,), 255, np.int64)
    e1 = np.full(shape + (4,), 255, np.int64)
    if cem == 4:  # L0 L1 A0 A1
        e0[..., :3] = v8[..., 0:1]
        e1[..., :3] = v8[..., 1:2]
        e0[..., 3] = v8[..., 2]
        e1[..., 3] = v8[..., 3]
        return e0, e1
    s0 = v8[..., 0] + v8[..., 2] + v8[..., 4]
    s1 = v8[..., 1] + v8[..., 3] + v8[..., 5]
    r0 = np.stack([v8[..., 0], v8[..., 2], v8[..., 4]], -1)
    r1 = np.stack([v8[..., 1], v8[..., 3], v8[..., 5]], -1)
    bc = (s1 < s0)[..., None]
    rgb0 = np.where(bc, _blue_contract(r1), r0)
    rgb1 = np.where(bc, _blue_contract(r0), r1)
    e0[..., :3] = rgb0
    e1[..., :3] = rgb1
    if cem == 12:
        a0 = np.where(bc[..., 0], v8[..., 7], v8[..., 6])
        a1 = np.where(bc[..., 0], v8[..., 6], v8[..., 7])
        e0[..., 3] = a0
        e1[..., 3] = a1
    return e0, e1


def _interp64(e0: np.ndarray, e1: np.ndarray, w64: np.ndarray) -> np.ndarray:
    c0 = (e0 << 8) | e0
    c1 = (e1 << 8) | e1
    c = (c0 * (64 - w64[..., None]) + c1 * w64[..., None] + 32) >> 6
    return c >> 8


@dataclasses.dataclass
class SpecFields:
    """Parsed spec-wire block fields for one mode's block subset."""

    mode_id: int
    ccs: Optional[np.ndarray]    # [B] or None
    seed: Optional[np.ndarray]   # [B] or None
    cq: np.ndarray               # [B, subsets, 2*ncomp] quantized values
    v8: np.ndarray               # [B, subsets, 2*ncomp] unquantized 8-bit
    wq: np.ndarray               # [B, 16] plane-1 weight indices
    wq2: Optional[np.ndarray]    # [B, 16] plane-2 indices or None
    w64: np.ndarray              # [B, 16] plane-1 weights, 0..64
    w64b: Optional[np.ndarray]   # [B, 16] plane-2 weights or None


def parse_mode_payload(bits: np.ndarray, mode_id: int) -> SpecFields:
    lay = mode_layouts()[mode_id]
    cfg = lay.cfg
    B = len(bits)
    ccs = seed = None
    if cfg.planes == 2:
        ccs = _get_field(bits, lay.ccs_pos, 2)
    if cfg.subsets > 1:
        seed = _get_field(bits, lay.seed_pos, 10)
    ncolor = cfg.ncomp * 2 * cfg.subsets
    vals, _ = _ise_get(bits, lay.color_pos, ncolor, lay.color_tq)
    lvl = _levels(lay.color_tq)
    if (vals >= lvl).any():
        raise ValueError(f"uastc mode {mode_id}: endpoint value out of range")
    cq = vals.reshape(B, cfg.subsets, 2 * cfg.ncomp)
    clut = _color_unquant_lut(tuple(lay.color_tq))
    v8 = clut[cq]
    wb = cfg.weight_bits
    wlut = _weight_unquant_lut((0, 0, wb))
    pos = lay.weight_pos
    if cfg.planes == 2:
        inter = np.zeros((B, 32), np.int64)
        for i in range(32):
            inter[:, i] = _get_field(bits, pos + i * wb, wb)
        wq, wq2 = inter[:, 0::2], inter[:, 1::2]
        return SpecFields(mode_id, ccs, seed, cq, v8, wq, wq2,
                          wlut[wq], wlut[wq2])
    wq = np.zeros((B, 16), np.int64)
    for i in range(16):
        wq[:, i] = _get_field(bits, pos + i * wb, wb)
    return SpecFields(mode_id, ccs, seed, cq, v8, wq, None, wlut[wq], None)


def _decode_fields(f: SpecFields) -> np.ndarray:
    cfg = MODE_CONFIGS[f.mode_id]
    B = len(f.cq)
    e0, e1 = _endpoints_rgba(cfg.cem, f.v8)  # [B, subsets, 4]
    if cfg.subsets > 1:
        part = astc_partition_4x4(f.seed, cfg.subsets)  # [B, 16]
        bidx = np.arange(B)[:, None]
        e0t = e0[bidx, part]  # [B,16,4]
        e1t = e1[bidx, part]
    else:
        e0t = np.repeat(e0, 16, axis=1)
        e1t = np.repeat(e1, 16, axis=1)
    out = _interp64(e0t, e1t, f.w64)  # [B,16,4]
    if cfg.planes == 2:
        second = _interp64(e0t, e1t, f.w64b)
        ccs = np.clip(f.ccs, 0, 3)
        for c in range(4):
            sel = ccs == c
            if sel.any():
                out[sel, :, c] = second[sel, :, c]
    if cfg.cem == 8:
        out[..., 3] = 255
    return out


def decode_spec_blocks(blocks: np.ndarray) -> np.ndarray:
    """[B,16] uint8 spec-wire UASTC blocks -> [B,4,4,4] uint8 RGBA."""
    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, 16)
    bits = _bits_of(blocks)
    prefix = _get_field(bits, 0, _MAX_CODE_LEN)
    modes = _mode_lut()[prefix]
    if (modes < 0).any():
        raise ValueError("invalid UASTC mode code")
    out = np.zeros((len(blocks), 16, 4), np.uint8)
    solid = modes == MODE_SOLID
    if solid.any():
        _code, ln = mode_codes()[MODE_SOLID]
        for c in range(4):
            out[solid, :, c] = _get_field(bits[solid], ln + 8 * c, 8)[:, None]
    for mode_id in MODE_CONFIGS:
        sel = modes == mode_id
        if not sel.any():
            continue
        f = parse_mode_payload(bits[sel], mode_id)
        out[sel] = _decode_fields(f).astype(np.uint8)
    return out.reshape(-1, 4, 4, 4)


def pack_solid_blocks(rgba: np.ndarray) -> np.ndarray:
    """[B, 4] uint8 -> [B, 16] solid (void-extent-class) blocks."""
    B = len(rgba)
    code, ln = mode_codes()[MODE_SOLID]
    bits = np.zeros((B, 128), np.uint8)
    _put_field(bits, 0, ln, np.full(B, code))
    for c in range(4):
        _put_field(bits, ln + 8 * c, 8, rgba[:, c].astype(np.int64))
    return _pack_bits(bits)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _quantize_endpoints(e8: np.ndarray, tq) -> np.ndarray:
    """Nearest ASTC color-range value per 8-bit component."""
    clut = _color_unquant_lut(tuple(tq))  # [L]
    e = np.clip(np.round(e8), 0, 255).astype(np.int64)
    return np.abs(clut[None, :] - e[..., None]).argmin(-1)


def _cem_order(q0: np.ndarray, q1: np.ndarray) -> np.ndarray:
    """[..., C] pairs -> [..., 2C] interleaved CEM value order."""
    out = np.empty(q0.shape[:-1] + (2 * q0.shape[-1],), np.int64)
    out[..., 0::2] = q0
    out[..., 1::2] = q1
    return out


def _normalize_no_blue_contract(
    cem: int, cq: np.ndarray, clut: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Swap endpoint pairs (returning a per-subset invert mask) so the
    ASTC decoder's blue-contract branch never fires on emitted blocks."""
    if cem == 4:
        return cq, np.zeros(cq.shape[:-1], bool)
    v8 = clut[cq]
    s0 = v8[..., 0] + v8[..., 2] + v8[..., 4]
    s1 = v8[..., 1] + v8[..., 3] + v8[..., 5]
    flip = s1 < s0
    out = cq.copy()
    fl = flip[..., None] & np.ones_like(cq, bool)
    ev = cq[..., 0::2]
    od = cq[..., 1::2]
    out[..., 0::2] = np.where(flip[..., None], od, ev)
    out[..., 1::2] = np.where(flip[..., None], ev, od)
    del fl
    return out, flip


def _fit_mode_spec(px16: np.ndarray, mode_id: int):
    """Host fit for one spec mode over [B,16,4] int pixels. Returns
    (cq [B,subsets,2nc], wq [B,16], wq2 or None, seed or None,
    ccs or None)."""
    lay = mode_layouts()[mode_id]
    cfg = lay.cfg
    wlut = _weight_unquant_lut((0, 0, cfg.weight_bits))
    nlevels = len(wlut)
    clut = _color_unquant_lut(tuple(lay.color_tq))

    # legacy fit helpers keyed by level count — steer them with an
    # explicit table matching ASTC weight unquantization
    class _P:
        cem = cfg.cem
        subsets = cfg.subsets
        dual_plane = cfg.planes == 2
        weight_levels = nlevels
        plane2 = 3

    pxf = _mode_pixels(px16.astype(np.float64), _P)
    seed = ccs = wq2 = None
    if cfg.subsets > 1:
        from uvol_tpu_torch.codecs.basis.uastc import _best_partition_seed

        seed = _best_partition_seed(pxf, _P)
        part = astc_partition_4x4(seed, cfg.subsets)
        e0, e1, wq = _fit_subsets(pxf, part, nlevels, cfg.subsets,
                                  table=wlut)
        # [B, subsets, C]
    elif cfg.planes == 2:
        if cfg.cem == 12:
            e0m, e1m, wq = _fit_endpoints_weights(
                pxf[..., :3], nlevels, table=wlut
            )
            e0a, e1a, wq2 = _fit_endpoints_weights(
                pxf[..., 3:4], nlevels, table=wlut
            )
            e0 = np.concatenate([e0m, e0a], -1)[:, None, :]
            e1 = np.concatenate([e1m, e1a], -1)[:, None, :]
            ccs = np.full(len(px16), 3)
        elif cfg.cem == 4:
            e0l, e1l, wq = _fit_endpoints_weights(
                pxf[..., :1], nlevels, table=wlut
            )
            e0a, e1a, wq2 = _fit_endpoints_weights(
                pxf[..., 1:2], nlevels, table=wlut
            )
            e0 = np.concatenate([e0l, e0a], -1)[:, None, :]
            e1 = np.concatenate([e1l, e1a], -1)[:, None, :]
            ccs = np.full(len(px16), 3)
        else:  # cem 8 RGB dual-plane: shared endpoints, pick worst channel
            e0f, e1f, _ = _fit_endpoints_weights(pxf, nlevels, table=wlut)
            spread = (pxf.max(1) - pxf.min(1))  # [B,3]
            sel = spread.argmax(-1)  # channel driven by plane 2
            B = len(px16)
            rest_w = np.zeros((B, 16), np.int64)
            sel_w = np.zeros((B, 16), np.int64)
            for c in range(3):
                m = sel == c
                if not m.any():
                    continue
                rest = [k for k in range(3) if k != c]
                _, _, wm = _fit_endpoints_weights(
                    pxf[m][..., rest], nlevels,
                    endpoints=(e0f[m][:, rest], e1f[m][:, rest]),
                    table=wlut,
                )
                _, _, wa = _fit_endpoints_weights(
                    pxf[m][..., c : c + 1], nlevels,
                    endpoints=(e0f[m][:, c : c + 1], e1f[m][:, c : c + 1]),
                    table=wlut,
                )
                rest_w[m] = wm
                sel_w[m] = wa
            wq, wq2 = rest_w, sel_w
            ccs = sel
            e0, e1 = e0f[:, None, :], e1f[:, None, :]
    else:
        e0, e1, wq = _fit_endpoints_weights(pxf, nlevels, table=wlut)
        e0, e1 = e0[:, None, :], e1[:, None, :]

    q0 = _quantize_endpoints(e0, lay.color_tq)  # [B, subsets, C]
    q1 = _quantize_endpoints(e1, lay.color_tq)
    cq = _cem_order(q0, q1)  # [B, subsets, 2C]
    cq, flip = _normalize_no_blue_contract(cfg.cem, cq, clut)
    # weight inversion for flipped subsets
    if flip.any():
        inv = nlevels - 1
        if cfg.subsets > 1:
            part = astc_partition_4x4(seed, cfg.subsets)  # [B,16]
            bidx = np.arange(len(px16))[:, None]
            tex_flip = flip[bidx, part]
            wq = np.where(tex_flip, inv - wq, wq)
        else:
            wq = np.where(flip[:, 0][:, None], inv - wq, wq)
            if wq2 is not None:
                wq2 = np.where(flip[:, 0][:, None], inv - wq2, wq2)
    return cq, wq, wq2, seed, ccs


#: candidate (rgb, rgba) mode sets per quality level — the legacy
#: encoder's UASTC_QUALITY_MODES policy mapped onto the spec table
#: (mode 17 is LA dual-plane here, so the RGBA ladder uses 13 instead)
SPEC_QUALITY_MODES = {
    0: ([0, 5], [10, 12]),
    1: ([0, 5, 6], [10, 12, 11]),
    2: ([0, 5, 6, 3, 7], [10, 12, 11, 13, 9]),
}


def encode_spec_blocks(
    px: np.ndarray, modes: Optional[List[int]] = None
) -> np.ndarray:
    """px: [B,4,4,4] uint8 RGBA -> [B,16] uint8 spec-wire UASTC blocks."""
    B = len(px)
    px16 = px.reshape(B, 16, 4).astype(np.int64)
    has_alpha = (px16[..., 3] != 255).any()
    if modes is None:
        modes = [10, 12] if has_alpha else [0, 5]
    out = np.zeros((B, 16), np.uint8)
    best = np.full(B, np.inf)
    for mode_id in modes:
        cq, wq, wq2, seed, ccs = _fit_mode_spec(px16, mode_id)
        blocks = pack_spec_blocks(mode_id, cq, wq, wq2, seed, ccs)
        dec = decode_spec_blocks(blocks).reshape(B, 16, 4)
        mse = ((dec.astype(np.float64) - px16) ** 2).mean((1, 2))
        take = mse < best
        out[take] = blocks[take]
        best[take] = mse[take]
    uniform = (px16 == px16[:, :1]).all((1, 2))
    if uniform.any():
        out[uniform] = pack_solid_blocks(
            px16[uniform, 0].astype(np.uint8)
        )
    return out


# ---------------------------------------------------------------------------
# Verbatim UASTC -> ASTC repack (the defining subset property)
# ---------------------------------------------------------------------------


def spec_to_astc(blocks: np.ndarray) -> np.ndarray:
    """[B,16] spec-wire UASTC -> [B,16] conformant ASTC-LDR 4x4 blocks.

    VALUE-EXACT for every mode: endpoint quant values and weight indices
    copy verbatim (same ranges on both sides by construction); only the
    container bits differ. decode_astc_blocks(spec_to_astc(x)) ==
    decode_spec_blocks(x) bit-for-bit (tests/test_uastc_spec.py)."""
    from uvol_tpu_torch.codecs.basis.astc import pack_astc_block, pack_void_extent

    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, 16)
    bits = _bits_of(blocks)
    prefix = _get_field(bits, 0, _MAX_CODE_LEN)
    modes = _mode_lut()[prefix]
    if (modes < 0).any():
        raise ValueError("invalid UASTC mode code")
    out = np.zeros_like(blocks)
    solid = modes == MODE_SOLID
    if solid.any():
        _code, ln = mode_codes()[MODE_SOLID]
        idxs = np.nonzero(solid)[0]
        for i in idxs:
            rgba = [int(_get_field(bits[i : i + 1], ln + 8 * c, 8)[0])
                    for c in range(4)]
            out[i] = np.frombuffer(pack_void_extent(rgba), np.uint8)
    for mode_id, lay in mode_layouts().items():
        sel = modes == mode_id
        if not sel.any():
            continue
        cfg = lay.cfg
        f = parse_mode_payload(bits[sel], mode_id)
        idxs = np.nonzero(sel)[0]
        for j, i in enumerate(idxs):
            weights: List[int] = []
            for t in range(16):
                weights.append(int(f.wq[j, t]))
                if cfg.planes == 2:
                    weights.append(int(f.wq2[j, t]))
            out[i] = np.frombuffer(
                pack_astc_block(
                    weight_tq=cfg.weight_tq,
                    color_tq=lay.color_tq,
                    cems=[cfg.cem] * cfg.subsets,
                    color_values=[int(x) for x in f.cq[j].reshape(-1)],
                    weights=weights,
                    part_index=int(f.seed[j]) if cfg.subsets > 1 else 0,
                    dual=cfg.planes == 2,
                    ccs=int(f.ccs[j]) if cfg.planes == 2 else 0,
                ),
                np.uint8,
            )
    return out
