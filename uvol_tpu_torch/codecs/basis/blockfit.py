"""Generic RGBA block refits: BC1/BC4, EAC alpha, PVRTC1 from pixels.

The UASTC transcode path (codecs/basis/uastc.py) carries ASTC and BC7
structurally, but the remaining rows of the reference's format table
(src/lib/KTX2Loader.js:591-697 UASTC column — ETC, DXT, PVRTC) have no
structural mapping from UASTC block configurations, so basisu's own
transcoder decodes and refits; these helpers are that refit stage.
ETC1 refit already exists as the jitted `etc.encode_etc1_blocks`; this
module adds the numpy-vectorized single-pass fits for the rest:

  - `fit_bc1_blocks`: principal-axis endpoints quantized to RGB565,
    2-bit codes against the decoder's 4-level palette (always the
    c0 > c1 opaque mode). Bit-exact decodable by Mesa's S3TC decoder.
  - `fit_bc4_blocks`: min/max endpoints, 8-step interpolated codes (the
    alpha half of BC3 / DXT5).
  - `fit_eac_blocks`: per-block EAC alpha search over all 16 modifier
    tables with a multiplier/base neighborhood — the same scoring as
    transcoder.eac_entry_tables but against the block's 16 actual
    values instead of a palette entry's 4 levels.
"""

from __future__ import annotations

import numpy as np

from uvol_tpu_torch.codecs.basis.transcoder import EAC_MODIFIERS


def _quant565(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] int RGB8 → packed RGB565."""
    r = np.clip((rgb[..., 0] * 31 + 127) // 255, 0, 31)
    g = np.clip((rgb[..., 1] * 63 + 127) // 255, 0, 63)
    b = np.clip((rgb[..., 2] * 31 + 127) // 255, 0, 31)
    return (r << 11) | (g << 5) | b


def _expand565(c: np.ndarray) -> np.ndarray:
    r = (c >> 11) & 31
    g = (c >> 5) & 63
    b = c & 31
    return np.stack(
        [(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)],
        axis=-1,
    )


def fit_bc1_blocks(px: np.ndarray) -> np.ndarray:
    """[N, 16, 3] uint8 → BC1 words [N, 2] uint32 (w0 = c0 | c1<<16,
    w1 = 2-bit codes LSB-first raster order), opaque 4-color mode."""
    px = px.astype(np.int64)
    N = len(px)
    mean = px.mean(axis=1, keepdims=True)
    d = px - mean
    # principal axis via one power-iteration step from the luma seed
    # (cheap, robust for block-sized statistics)
    v = np.full((N, 3), 1.0)
    cov_d = d.astype(np.float64)
    for _ in range(4):
        v = np.einsum("npc,np->nc", cov_d, np.einsum("npc,nc->np", cov_d, v))
        n = np.linalg.norm(v, axis=1, keepdims=True)
        v = np.where(n > 1e-9, v / np.maximum(n, 1e-9), [[1.0, 0.0, 0.0]])
    proj = np.einsum("npc,nc->np", cov_d, v)  # [N,16]
    ilo = proj.argmin(axis=1)
    ihi = proj.argmax(axis=1)
    e0 = px[np.arange(N), ihi].astype(np.float64)  # color0 = high end
    e1 = px[np.arange(N), ilo].astype(np.float64)

    def finish(e0f, e1f):
        """Quantize endpoints, pick codes, return (words, error)."""
        c0 = _quant565(np.clip(np.rint(e0f), 0, 255).astype(np.int64))
        c1 = _quant565(np.clip(np.rint(e1f), 0, 255).astype(np.int64))
        # force opaque mode (c0 > c1); equal endpoints: all codes 0
        swap = c0 < c1
        c0s = np.where(swap, c1, c0)
        c1s = np.where(swap, c0, c1)
        p0 = _expand565(c0s).astype(np.int64)
        p1 = _expand565(c1s).astype(np.int64)
        pal = np.stack(
            [p0, p1, (2 * p0 + p1 + 1) // 3, (p0 + 2 * p1 + 1) // 3], axis=1
        )  # [N,4,3]
        err = ((px[:, :, None, :] - pal[:, None, :, :]) ** 2).sum(-1)
        codes = err.argmin(-1)  # [N,16]
        codes = np.where((c0s == c1s)[:, None], 0, codes)
        tot = np.take_along_axis(err, codes[:, :, None], axis=2)[..., 0].sum(1)
        w1 = (
            codes.astype(np.uint64)
            << (2 * np.arange(16))[None, :].astype(np.uint64)
        ).sum(1)
        w0 = c0s.astype(np.uint64) | (c1s.astype(np.uint64) << 16)
        words = np.stack(
            [w0.astype(np.uint32), w1.astype(np.uint32)], axis=1
        )
        return words, tot, codes

    words0, err0, codes0 = finish(e0, e1)
    # one least-squares endpoint refinement against the chosen codes
    # (stb_dxt-style): minimize sum |p - (a*w + b*(1-w))|^2 over (a, b)
    # per channel with w in {1, 0, 2/3, 1/3}; keep only if it improves
    wtab = np.array([1.0, 0.0, 2.0 / 3.0, 1.0 / 3.0])
    w = wtab[codes0]  # [N,16] weight of endpoint 0
    sw2 = (w * w).sum(1)
    swu = (w * (1 - w)).sum(1)
    su2 = ((1 - w) ** 2).sum(1)
    det = sw2 * su2 - swu * swu
    rhs0 = np.einsum("np,npc->nc", w, px.astype(np.float64))
    rhs1 = np.einsum("np,npc->nc", 1 - w, px.astype(np.float64))
    ok = np.abs(det) > 1e-9
    detS = np.where(ok, det, 1.0)
    a = (su2[:, None] * rhs0 - swu[:, None] * rhs1) / detS[:, None]
    bq = (sw2[:, None] * rhs1 - swu[:, None] * rhs0) / detS[:, None]
    a = np.where(ok[:, None], a, e0)
    bq = np.where(ok[:, None], bq, e1)
    words1, err1, _ = finish(a, bq)
    take = err1 < err0
    words = np.where(take[:, None], words1, words0)
    return words


def fit_bc4_blocks(a: np.ndarray) -> np.ndarray:
    """[N, 16] uint8 → BC4 words [N, 2] uint32 (a0, a1, 3-bit codes
    LSB-first over the 48-bit field), 8-step a0 > a1 mode."""
    a = a.astype(np.int64)
    a0 = a.max(axis=1)
    a1 = a.min(axis=1)
    eq = a0 <= a1
    a0 = np.where(eq, a1, a0)
    k = np.arange(8)
    pal = np.empty((len(a), 8), np.int64)
    pal[:, 0] = a0
    pal[:, 1] = a1
    for j in range(2, 8):
        pal[:, j] = ((8 - j) * a0 + (j - 1) * a1) // 7
    codes = (
        np.abs(a[:, :, None] - pal[:, None, :]).argmin(-1).astype(np.uint64)
    )
    codes = np.where(eq[:, None], 0, codes)
    field = (codes << (3 * np.arange(16))[None, :].astype(np.uint64)).sum(1)
    w0 = (
        a0.astype(np.uint64)
        | (a1.astype(np.uint64) << 8)
        | ((field & 0xFFFF) << 16)
    )
    w1 = field >> 16
    return np.stack([w0.astype(np.uint32), w1.astype(np.uint32)], axis=1)


def fit_eac_blocks(a: np.ndarray) -> np.ndarray:
    """[N, 16] uint8 alpha → EAC words [N, 2] uint32 (big-endian halves:
    byte0 base, byte1 mult<<4|table, 48-bit indices MSB-first in ETC
    column-major texel order k = x*4 + y). Input texels are in raster
    order (k = y*4 + x); the packer reorders."""
    a = a.astype(np.float64)
    N = len(a)
    amin = a.min(axis=1)
    amax = a.max(axis=1)
    mod_min = EAC_MODIFIERS.min(axis=1)
    mod_max = EAC_MODIFIERS.max(axis=1)
    span = (mod_max - mod_min).astype(np.float64)
    mult0 = np.clip(np.round((amax - amin)[:, None] / span[None, :]), 1, 15)
    mults = np.clip(mult0[:, :, None] + np.array([-1.0, 0.0, 1.0]), 1, 15)
    center = (amin + amax)[:, None, None] / 2.0
    b0 = np.round(center - mults * (mod_min + mod_max)[None, :, None] / 2.0)
    bases = np.clip(b0[..., None] + np.array([-1.0, 0.0, 1.0]), 0, 255)
    # decodable values [N,16tab,3,3,8]
    vals = np.clip(
        bases[..., None]
        + mults[..., None, None] * EAC_MODIFIERS[None, :, None, None, :],
        0,
        255,
    )
    # per-texel best index and its error, summed per candidate
    d = np.abs(
        vals[:, :, :, :, None, :] - a[:, None, None, None, :, None]
    )  # [N,16,3,3,16tex,8]
    best_idx = d.argmin(-1)  # [N,16,3,3,16]
    err = (d.min(-1) ** 2).sum(-1)  # [N,16,3,3]
    flat = err.reshape(N, -1).argmin(1)
    ti, mi, bi = np.unravel_index(flat, (16, 3, 3))
    n_idx = np.arange(N)
    base = bases[n_idx, ti, mi, bi].astype(np.uint64)
    mult = mults[n_idx, ti, mi].astype(np.uint64)
    idx = best_idx[n_idx, ti, mi, bi].astype(np.uint64)  # [N,16] raster
    # reorder raster k=y*4+x → wire order k=x*4+y, MSB-first
    j16 = np.arange(16)
    y, x = j16 % 4, j16 // 4  # wire texel j holds raster texel y*4+x
    wire_codes = idx[:, y * 4 + x]
    field = (
        wire_codes << (3 * (15 - j16))[None, :].astype(np.uint64)
    ).sum(1)
    w0 = (
        (base << np.uint64(24))
        | (((mult << np.uint64(4)) | ti.astype(np.uint64)) << np.uint64(16))
        | (field >> np.uint64(32))
    )
    w1 = field & np.uint64(0xFFFFFFFF)
    return np.stack([w0.astype(np.uint32), w1.astype(np.uint32)], axis=1)


def fit_pvrtc1_from_rgba(img: np.ndarray) -> np.ndarray:
    """[H, W, 3|4] uint8 (power-of-two dims) → PVRTC1 4bpp words [N, 2]
    uint32 (modulation, color) in Morton order: per-block channel-wise
    min/max endpoints, modulation against the interpolated fields (the
    same machinery as the ETC1S pvrtc transcode)."""
    from uvol_tpu_torch.codecs.basis.pvrtc import (
        _MOD_WEIGHTS8,
        _expand_a,
        _expand_b,
        _morton_interleave,
        _quant_a,
        _quant_b,
        _upscale_bilinear_wrap,
    )

    h, w = img.shape[:2]
    by, bx = h // 4, w // 4
    px = (
        img[..., :3]
        .reshape(by, 4, bx, 4, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(by, bx, 16, 3)
        .astype(np.int64)
    )
    lo = px.min(axis=2)  # [by,bx,3]
    hi = px.max(axis=2)
    a_field = _quant_a(lo)
    b_field = _quant_b(hi)
    colw = (
        (b_field.astype(np.uint64) << np.uint64(16))
        | np.uint64(1 << 31)
        | (a_field.astype(np.uint64) << np.uint64(1))
        | np.uint64(1 << 15)
    )
    a_up = _upscale_bilinear_wrap(_expand_a(a_field))
    b_up = _upscale_bilinear_wrap(_expand_b(b_field))
    t = np.arange(16)
    ly, lx = t // 4, t % 4
    yy = (np.repeat(np.arange(by), bx) * 4)[:, None] + ly[None, :]
    xx = (np.tile(np.arange(bx), by) * 4)[:, None] + lx[None, :]
    at = a_up[yy, xx]
    bt = b_up[yy, xx]
    want = px.reshape(-1, 16, 3).astype(np.float64)
    cand = (
        at[:, :, None, :]
        + (bt - at)[:, :, None, :]
        * (_MOD_WEIGHTS8 / 8.0)[None, None, :, None]
    )
    err = ((cand - want[:, :, None, :]) ** 2).sum(-1)
    code = err.argmin(-1).astype(np.uint64)
    modw = (code << (2 * t)[None, :].astype(np.uint64)).sum(1)
    gy, gx = np.mgrid[0:by, 0:bx]
    morton = _morton_interleave(gx.ravel(), gy.ravel(), bx, by)
    out = np.zeros((by * bx, 2), np.uint32)
    out[morton, 0] = modw.astype(np.uint32)
    out[morton, 1] = colw.reshape(-1).astype(np.uint32)
    return out
