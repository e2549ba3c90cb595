"""ETC1S palette-build kernels on the card — counterpart of `etc1s_pallas.py`.

`assign_endpoints` (K4), `inten_errors` (K5) and `kmeans_iter` (K6) are
the three hot stages of the palette build (`etc1s_encode.palette_core`);
`segment_sum` is the fixed-order segment sum that the build takes for
every per-cluster reduction, the port's `_seg_reduce`; `rate_sweep_frame`
(K7) is a whole frame of the delta-aware stage's rate sweep
(`etc1s_encode.rate_sweep_assignments`: error product, column scan and CR
snap), one launch per frame. The
device of the tensor decides the route:

  - a CUDA tensor launches the hand-written kernels of `csrc/etc1s.cu`,
    built by `_build` at first use; a build or launch failure raises,
    nothing falls back;
  - a CPU tensor goes through the plain twin beside each kernel
    (`*_plain`), which computes the same numbers in the same order.

Each wrapper call that launches adds one to `LAUNCHES[name]` (K6 and
`segment_sum` are two kernels each); twin calls are not counted.

The kernels take at most `SEG_MAX_ROWS` rows a launch. Above that,
`segment_sum` and `kmeans_iter` (kernel and twin alike) sum consecutive
chunks of `SEG_MAX_ROWS` rows and add the chunk results in order, first
to last; at or below it nothing is chunked. Within a launch they sum
windows of `SEG_WINDOW` segments (K6: centroids) one after another, and so
does the twin: a segment's sum depends only on its own rows in tile order,
so a window's result is the bits of one pass over every segment. K7 keeps
the palette in registers up to `SWEEP_REG_MAX_E` entries and reads it from a
table in device memory above.

K7 computes its errors in int32 (exact: the reference's float32 product
holds integers below 2^24) and prices with one fused multiply-add per
entry, as XLA compiles the reference's scan on the CPU; its twin rounds
the same FMA once (`_device.fma_f32`), so kernel and twin agree bit for
bit.

K4 and K5 are exact integer arithmetic (the TPU kernels' f32 terms are
all integers below 2^24), so kernel, twin and TPU kernel agree bit for
bit, argmin ties included (first minimum). K6 is f32: its distances keep
the TPU kernel's op order, and its sums take the fixed order of
`segment_sum_plain`, the order the segment-sum kernel keeps too, so
kernel and twin agree bit for bit as well; against the TPU kernel (whose
sums are an MXU product) the sums agree to rounding. `kmeans_iter_plain`
sums through `segment_sum_plain` on every device, so K6's twin on the
card stays independent of the kernel it is held against.

Blocks are `[N, 16, 3]` uint8, pixels row-major within the block — the
upload the palette build makes once per segment.
"""

from __future__ import annotations

import functools
from typing import Iterable, List, Optional, Tuple

import torch

from uvol_tpu_torch import _build
from uvol_tpu_torch._device import f32, fma_f32
from uvol_tpu_torch.codecs.basis.transcoder import INTEN_TABLES as _INTEN_TABLES

Tensor = torch.Tensor

#: kernel launches per kernel since the last reset
LAUNCHES = {
    "etc1s_assign_endpoints": 0,
    "etc1s_inten_errors": 0,
    "etc1s_kmeans_iter": 0,
    "etc1s_segment_sum": 0,
    "etc1s_rate_sweep": 0,
}

#: the ETC1S intensity modifiers [8 tables, 4 codes]; `csrc/etc1s.cu`
#: holds the same rows in constant memory
INTEN_TABLES = tuple(tuple(int(v) for v in row) for row in _INTEN_TABLES)

#: rows per fixed-order partial of `segment_sum` (kSegTile in the kernel)
SEG_TILE = 64
#: tiles per pass-1 chunk of the segment-sum kernel (kChunkTiles)
SEG_CHUNK_TILES = 16
#: segments (K6: centroids) one window of the kernels sums, the width of
#: their shared-memory map; a wider sum takes ceil(k / SEG_WINDOW) windows,
#: two launches each, on both routes in the same order
SEG_WINDOW = 2048
#: most palette entries K7 keeps in a CTA's registers; wider palettes take
#: its wide path (an entry table in device memory, written first)
SWEEP_REG_MAX_E = 2048
#: most rows one launch takes (pass 2 reduces at most 64 x 256 chunk
#: partials); longer inputs are summed in chunks of this many rows
SEG_MAX_ROWS = 1 << 24
#: elements per temporary of the plain twins
_TWIN_ELEMS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def inten_tables(device: torch.device) -> Tensor:
    """`INTEN_TABLES` as an [8, 4] int32 tensor on `device`, uploaded once
    per device (an upload per use would be a blocking copy each); read
    only."""
    return torch.tensor(INTEN_TABLES, dtype=torch.int32, device=device)


def _route(t: Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (twin)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    _build.launch(fn, device, *args)
    LAUNCHES[name] += 1


def _row_chunks(n: int, rows: int) -> List[Tuple[int, int]]:
    """[start, stop) of the consecutive chunks of at most `rows` rows."""
    return [(a, min(a + rows, n)) for a in range(0, n, rows)]


def _add_in_order(parts: Iterable[Tensor]) -> Tensor:
    """((p0 + p1) + p2) + ...: the one order in which chunk results are
    added, on both routes. Each part must be a tensor of its own."""
    acc = None
    for p in parts:
        acc = p if acc is None else acc + p
    return acc


def _aligned(t: Tensor) -> Tensor:
    """t itself when its data is 16-byte aligned (the kernels read float4
    rows), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_blocks(blocks: Tensor) -> None:
    if blocks.dtype != torch.uint8 or blocks.ndim != 3 or tuple(blocks.shape[1:]) != (16, 3):
        raise ValueError(
            f"expected [N, 16, 3] uint8 blocks, got {tuple(blocks.shape)} {blocks.dtype}"
        )


# ---------------------------------------------------------------------------
# Fixed-order segment sum: the order K6 shares, and its kernel
# ---------------------------------------------------------------------------


def segment_sum_plain(idx: Tensor, k: int, x: Tensor,
                      _chunk_rows: Optional[int] = None,
                      _window: Optional[int] = None) -> Tensor:
    """Plain twin of the segment-sum kernel: `out[s] = sum of x[i] over
    idx[i] == s`, x [N, D] f32, idx [N] in [0, k) → [k, D] f32, in one
    order on every device and every run.

    Above `SEG_MAX_ROWS` rows (`_chunk_rows`, for the tests of that order)
    the sum is that of consecutive chunks of so many rows, each summed as
    below, added in order (`_add_in_order`). Above `SEG_WINDOW` segments
    each window of so many is summed apart (`_window`, for the tests), rows
    of other segments dropped: the same bits, in less memory.

    Rows are added in order within consecutive tiles of `SEG_TILE` rows,
    starting from 0.0; the tile partials are then added pairwise, level
    by level (adjacent pairs; an odd last tile is added to 0.0). No float
    atomics: `index_add_` on CUDA would order the adds differently from
    run to run, and the cluster error sums (far above 2^24) would then
    flip argmins between runs."""
    n, d = x.shape
    rows = SEG_MAX_ROWS if _chunk_rows is None else _chunk_rows
    window = SEG_WINDOW if _window is None else _window
    if n > rows:
        return _add_in_order(segment_sum_plain(idx[a:b], k, x[a:b], _window=_window)
                             for a, b in _row_chunks(n, rows))
    if k > window:  # rows of other windows go to the spare segment
        idx = idx.to(torch.int64)
        return torch.cat([
            segment_sum_plain(torch.where((idx >= s0) & (idx < s0 + kw), idx - s0, kw), kw, x,
                              _chunk_rows=rows)
            for s0, kw in ((s0, min(window, k - s0)) for s0 in range(0, k, window))])
    nt = max(1, -(-n // SEG_TILE))
    pad = nt * SEG_TILE - n
    idx = idx.to(torch.int64)
    if pad:  # padding rows land in a spare segment k, dropped below
        idx = torch.cat([idx, idx.new_full((pad,), k)])
        x = torch.cat([x, x.new_zeros((pad, d))])
    it = idx.view(nt, SEG_TILE)
    xt = x.view(nt, SEG_TILE, d)
    part = x.new_zeros((nt, k + 1, d))
    tiles = torch.arange(nt, device=x.device)
    for r in range(SEG_TILE):  # one row of every tile per step: no conflicts
        ix = it[:, r]
        part[tiles, ix] = part[tiles, ix] + xt[:, r]
    part = part[:, :k]
    while part.shape[0] > 1:
        if part.shape[0] % 2:
            part = torch.cat([part, part.new_zeros((1, k, d))])
        part = part[0::2] + part[1::2]
    return part[0]


def segment_sum(idx: Tensor, k: int, x: Tensor) -> Tensor:
    """The fixed-order segment sum of `segment_sum_plain`: idx [N] integer
    in [0, k), x [N, D] f32 → [k, D] f32. A CUDA tensor launches the
    kernel of `csrc/etc1s.cu` (pass 1 over chunks of `SEG_CHUNK_TILES`
    tiles, pass 2 over the chunk partials: two launches per window of
    `SEG_WINDOW` segments up to `SEG_MAX_ROWS` rows, and so per chunk of so
    many rows above), a CPU tensor takes the twin; both give the same
    bits."""
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"expected [N, D] float32 values, got {tuple(x.shape)} {x.dtype}")
    if idx.ndim != 1 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"expected [{x.shape[0]}] indices, got {tuple(idx.shape)}")
    if k <= 0:
        raise ValueError(f"segment_sum takes k >= 1, got {k}")
    if not _route(x):
        return segment_sum_plain(idx, k, x)
    x = x.contiguous()
    idx = idx.to(device=x.device, dtype=torch.int32).contiguous()
    n = x.shape[0]
    return _add_in_order(_segment_sum_launch(idx[a:b], k, x[a:b])
                         for a, b in _row_chunks(max(n, 1), SEG_MAX_ROWS))


def _segment_sum_launch(idx: Tensor, k: int, x: Tensor) -> Tensor:
    """One launch of the segment-sum kernels: idx [N] int32, x [N, D] f32,
    contiguous, N <= SEG_MAX_ROWS."""
    n, d = x.shape
    chunks = max(1, -(-n // (SEG_TILE * SEG_CHUNK_TILES)))
    part = torch.empty((chunks, min(k, SEG_WINDOW), d), dtype=torch.float32, device=x.device)
    out = torch.empty((k, d), dtype=torch.float32, device=x.device)
    _launch("etc1s_segment_sum", "uvt_etc1s_segment_sum", x.device,
            idx.data_ptr(), x.data_ptr(), n, d, k, part.data_ptr(), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K5: intensity-table errors
# ---------------------------------------------------------------------------


def inten_errors_plain(blocks: Tensor, base: Tensor) -> Tensor:
    """Plain twin of K5: blocks [N, 16, 3] uint8, base [N, 3] int32 →
    [N, 8] int32, the block's exact error under each intensity table
    (min over the 4 codes, summed over the 16 pixels)."""
    b = base.to(torch.int32)[:, None, :]  # [N, 1, 3]
    d = blocks.to(torch.int32) - b  # [N, 16, 3]
    cols = []
    for row in INTEN_TABLES:
        best = None
        for m in row:
            me = torch.clamp(b + m, 0, 255) - b  # [N, 1, 3]
            cand = (me * me).sum(-1) - 2 * (d * me).sum(-1)  # [N, 16]
            best = cand if best is None else torch.minimum(best, cand)
        cols.append(best.sum(1))
    return torch.stack(cols, 1).to(torch.int32)


def inten_errors(blocks: Tensor, base: Tensor) -> Tensor:
    """K5: blocks [N, 16, 3] uint8, base [N, 3] int32 (8-bit colors, 0..255:
    the kernel's float32 arithmetic is exact there) → [N, 8] int32."""
    _check_blocks(blocks)
    n = blocks.shape[0]
    if base.dtype != torch.int32 or tuple(base.shape) != (n, 3):
        raise ValueError(f"expected [{n}, 3] int32 base, got {tuple(base.shape)} {base.dtype}")
    if not _route(blocks):
        return inten_errors_plain(blocks, base)
    blocks, base = blocks.contiguous(), base.contiguous()
    out = torch.empty((n, 8), dtype=torch.int32, device=blocks.device)
    _launch("etc1s_inten_errors", "uvt_etc1s_inten_errors", blocks.device,
            blocks.data_ptr(), base.data_ptr(), out.data_ptr(), n)
    return out


# ---------------------------------------------------------------------------
# K4: exact endpoint assignment
# ---------------------------------------------------------------------------


def endpoint_table(base: Tensor, inten: Tensor) -> Tensor:
    """[E, 20] int32 endpoint rows for K4 from base [E, 3] (8-bit colors)
    and inten [E] (table indices): per code j, (-2*me_r, -2*me_g,
    -2*me_b, q_j) with me the clip-aware effective modifier
    clip(base + m_j) - base and q_j = 2*base.me_j + |me_j|^2; then
    (-2*base_r, -2*base_g, -2*base_b, 16*|base|^2). The rows of
    `etc1s_pallas.endpoint_const_rows`, transposed, as integers."""
    b = base.to(torch.int32)
    mods = inten_tables(b.device)[inten.long()]
    me = torch.clamp(b[:, None, :] + mods[:, :, None], 0, 255) - b[:, None, :]  # [E,4,3]
    q = 2 * (b[:, None, :] * me).sum(-1) + (me * me).sum(-1)  # [E, 4]
    codes = torch.cat([-2 * me, q[:, :, None]], 2).reshape(-1, 16)
    tail = torch.cat([-2 * b, 16 * (b * b).sum(1, keepdim=True)], 1)
    return torch.cat([codes, tail], 1).to(torch.int32).contiguous()


def assign_endpoints_plain(blocks: Tensor, table: Tensor) -> Tensor:
    """Plain twin of K4: blocks [N, 16, 3] uint8, table [E, 20] int32 →
    [N] int32, the first endpoint of least exact block error. The
    per-pixel candidates q_j + p . (-2 me_j) come from one float64 product
    per chunk of blocks: every term is an integer far below 2^53, so each
    sum is exact, in any order."""
    e = table.shape[0]
    px = blocks.to(torch.float64)
    psum = px.sum(1)  # [N, 3]
    t = table.to(torch.float64)
    m = t[:, :16].reshape(e, 4, 4)
    w = m[:, :, :3].reshape(e * 4, 3).T.contiguous()  # [3, E * 4]
    q = m[:, :, 3].reshape(e * 4)
    chunk = max(1, _TWIN_ELEMS // (16 * 4 * e))
    out = []
    for s in range(0, px.shape[0], chunk):
        p = px[s : s + chunk]
        cand = torch.addmm(q, p.reshape(-1, 3), w)  # [B * 16, E * 4]
        best = cand.view(p.shape[0], 16, e, 4).amin(3).sum(1)  # [B, E]
        err = best + (t[:, 19] + psum[s : s + chunk] @ t[:, 16:19].T)
        out.append(torch.argmin(err, dim=1))
    return torch.cat(out).to(torch.int32)


def assign_endpoints(blocks: Tensor, table: Tensor) -> Tensor:
    """K4: blocks [N, 16, 3] uint8, table [E, 20] int32 (`endpoint_table`)
    → [N] int32 endpoint indices."""
    _check_blocks(blocks)
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[1] != 20:
        raise ValueError(f"expected [E, 20] int32 table, got {tuple(table.shape)} {table.dtype}")
    if not _route(blocks):
        return assign_endpoints_plain(blocks, table)
    blocks, table = blocks.contiguous(), table.contiguous()
    if table.data_ptr() % 16:  # the kernel reads int4 rows
        table = table.clone()
    n, e = blocks.shape[0], table.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=blocks.device)
    _launch("etc1s_assign_endpoints", "uvt_etc1s_assign_endpoints", blocks.device,
            blocks.data_ptr(), table.data_ptr(), out.data_ptr(), n, e)
    return out


# ---------------------------------------------------------------------------
# K6: fused Lloyd step
# ---------------------------------------------------------------------------


def centroid_rows(cb: Tensor) -> Tensor:
    """[5, K] f32 distance rows for K6: -2*cb[:, j] for j = 0..3, then
    c2 = ((cb0^2 + cb1^2) + cb2^2) + cb3^2 in that order (fixed, so both
    routes see the same c2)."""
    cb = cb.to(torch.float32)
    sq = cb * cb
    c2 = ((sq[:, 0] + sq[:, 1]) + sq[:, 2]) + sq[:, 3]
    return torch.cat([-2.0 * cb.T, c2[None, :]], 0).contiguous()


def kmeans_iter_plain(feats: Tensor, cb: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain twin of K6: feats [N, 4] f32, cb [K, 4] → (sums [K, 4],
    counts [K], assign [N] int32) of the nearest-centroid partition.
    dist = c2 + f0*(-2cb0) + ... + f3*(-2cb3), each step rounded."""
    n, k = feats.shape[0], cb.shape[0]
    rows = centroid_rows(cb)
    chunk = max(1, _TWIN_ELEMS // k)
    assign = []
    for s in range(0, n, chunk):
        f = feats[s : s + chunk]
        dist = rows[4][None, :].expand(f.shape[0], k)
        for j in range(4):
            dist = dist + f[:, j : j + 1] * rows[j][None, :]
        assign.append(torch.argmin(dist, dim=1))
    assign = torch.cat(assign).to(torch.int32)
    s5 = segment_sum_plain(assign, k, torch.cat([feats, feats.new_ones((n, 1))], 1))
    return s5[:, :4], s5[:, 4], assign


def kmeans_iter(feats: Tensor, cb: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K6: feats [N, 4] f32, cb [K, 4] f32 → (sums [K, 4], counts [K],
    assign [N] int32). The kernel assigns every row in its first window's
    launch (the centroids staged 2,048 at a time) and sums each window of
    `SEG_WINDOW` centroids in its own launch.
    Above `SEG_MAX_ROWS` rows: one call per chunk of so many rows, the
    sums and counts added in order as `segment_sum` adds them."""
    if feats.dtype != torch.float32 or feats.ndim != 2 or feats.shape[1] != 4:
        raise ValueError(f"expected [N, 4] float32 feats, got {tuple(feats.shape)} {feats.dtype}")
    if cb.ndim != 2 or cb.shape[1] != 4 or cb.shape[0] == 0:
        raise ValueError(f"expected [K, 4] centroids with K >= 1, got {tuple(cb.shape)}")
    if feats.shape[0] == 0:
        raise ValueError("kmeans_iter needs at least one row")
    if not _route(feats):
        return kmeans_iter_plain(feats, cb)
    n, dev = feats.shape[0], feats.device
    feats = feats.contiguous()
    cb = _aligned(cb.to(device=dev, dtype=torch.float32).contiguous())
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    sums = _add_in_order(_kmeans_launch(feats[a:b], cb, assign[a:b])
                         for a, b in _row_chunks(n, SEG_MAX_ROWS))
    return sums[:, :4], sums[:, 4], assign


def _kmeans_launch(feats: Tensor, cb: Tensor, assign: Tensor) -> Tensor:
    """One launch of K6 on feats [N, 4] (N <= SEG_MAX_ROWS), writing
    `assign` [N]; returns sums [K, 5] (features, then the count)."""
    n, k = feats.shape[0], cb.shape[0]
    feats = _aligned(feats)
    chunks = -(-n // (SEG_TILE * SEG_CHUNK_TILES))
    part = torch.empty((chunks, min(k, SEG_WINDOW), 5), dtype=torch.float32, device=feats.device)
    sums = torch.empty((k, 5), dtype=torch.float32, device=feats.device)
    _launch("etc1s_kmeans_iter", "uvt_etc1s_kmeans_iter", feats.device,
            feats.data_ptr(), cb.data_ptr(), n, k, part.data_ptr(),
            sums.data_ptr(), assign.data_ptr())
    return sums


# ---------------------------------------------------------------------------
# K7: the rate sweep's frame stage (error product, column scan, CR snap)
# ---------------------------------------------------------------------------

#: the sweep's price in bits of an entry equal to the block above's, at most
SWEEP_ABOVE_BITS = f32(1.4)
#: the CR cost of a block whose frame has no previous one
SWEEP_NO_CR = f32(3.0e38)
#: the CR snap's absolute headroom on near-zero errors
SWEEP_SLACK = 64.0


def pair_errors(px: Tensor, base: Tensor, mods: Tensor, sel_cb: Tensor, ep_idx: Tensor,
                sel_idx: Tensor) -> Tensor:
    """Exact error [N] (f32) of coding blocks px [N, 16, 3] (int32 or
    uint8) with endpoints ep_idx and selectors sel_idx [N]: base [E, 3] and
    mods [E, 4] int32, sel_cb [S, 16] integer codes; int32 arithmetic,
    every sum below 2^24."""
    mod = mods[ep_idx].gather(1, sel_cb.long()[sel_idx])  # [N, 16]
    d = px.to(torch.int32) - torch.clamp(base[ep_idx][:, None, :] + mod[:, :, None], 0, 255)
    return (d * d).sum((1, 2)).to(torch.float32)


def sweep_features(blocks: Tensor, base: Tensor, mods: Tensor, sel_cb: Tensor,
                   sel: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The rate sweep's error decomposition, as f32 tensors of integers:
    (p_sq [N], feat [N, 16], mat [E, 16]) with err[b, e] = p_sq[b] +
    feat[b] . mat[e]: grouping block b's pixels by their code c under its
    own selector row, feat = (-2 S_c (12, code-major), n_c (4)) and mat =
    (col(e, c) (12), |col(e, c)|^2 (4)), col the clipped decoded color."""
    px = blocks.to(torch.int32)
    e_n = base.shape[0]
    col = torch.clamp(base[:, None, :] + mods[:, :, None], 0, 255)  # [E, 4, 3]
    mat = torch.cat([col.reshape(e_n, 12), (col * col).sum(2)], 1).float()
    codes = sel_cb.long()[sel.long()]  # [N, 16]
    onehot = [(codes == j).to(torch.int32) for j in range(4)]
    s_c = torch.cat([(px * m[:, :, None]).sum(1) for m in onehot], 1)  # [N, 12], code-major
    feat = torch.cat([-2 * s_c, torch.stack([m.sum(1) for m in onehot], 1)], 1).float()
    return (px * px).sum((1, 2)).float(), feat, mat


def rate_sweep_cols_plain(err: Tensor, bits: Tensor, ep_in: Tensor, prev_ep: Tensor,
                          e_prev: Tensor, has_prev: bool, lam: float,
                          nbx: int) -> Tuple[Tensor, Tensor]:
    """The twin's column scan, the reference's `col_step` as a loop over
    the block columns; the rows go together.

    err [nb, E] f32 (nb = nby * nbx, rows of blocks in raster order),
    bits [E] f32 (`etc1s_encode.sweep_bits_table`), ep_in and prev_ep [nb],
    e_prev [nb] f32, has_prev whether the frame has a previous one, lam the
    bits' weight → (new_ep [nb] int32, use_cr [nb] bool). Block (r, c)
    prices entry e at fma(lam, b, err) with b = bits[(e - left) mod E],
    left the new entry of (r, c - 1) (column 0: its own incoming one), and
    b at most `SWEEP_ABOVE_BITS` for the incoming entry of (r - 1, c) (row
    0: its own); the first minimum wins unless e_prev + lam / 2 (with
    has_prev; else `SWEEP_NO_CR`) is no more: then CR, prev_ep."""
    nb, e = err.shape
    nby = nb // nbx
    lam = f32(lam)
    half = f32(lam * 0.5)  # exact
    ep = ep_in.long().reshape(nby, nbx)
    above = torch.cat([ep[:1], ep[:-1]])
    pe, epv = prev_ep.long().reshape(nby, nbx), e_prev.reshape(nby, nbx)
    cols = err.reshape(nby, nbx, e)
    iota = torch.arange(e, device=err.device)[None, :]
    left = ep[:, 0]
    new_ep, use_cr = [], []
    for c in range(nbx):
        b = bits[(iota - left[:, None]) % e]  # [nby, E]
        b = torch.where(iota == above[:, c:c + 1], torch.clamp(b, max=SWEEP_ABOVE_BITS), b)
        cost = fma_f32(lam, b, cols[:, c])
        ep_rd = torch.argmin(cost, 1)
        cost_cr = epv[:, c] + half if has_prev else torch.full_like(epv[:, c], SWEEP_NO_CR)
        cr = cost_cr <= cost.gather(1, ep_rd[:, None])[:, 0]
        left = torch.where(cr, pe[:, c], ep_rd)
        new_ep.append(left)
        use_cr.append(cr)
    return (torch.stack(new_ep, 1).reshape(nb).to(torch.int32),
            torch.stack(use_cr, 1).reshape(nb))


def rate_sweep_frame_plain(blocks: Tensor, base: Tensor, mods: Tensor, sel_cb: Tensor,
                           bits: Tensor, ep: Tensor, sel: Tensor,
                           prev: Optional[Tuple[Tensor, Tensor]], s0_index: int, lam: float,
                           lam_cr: float, nbx: int) -> Tuple[Tensor, Tensor]:
    """Plain twin of K7: the reference's `_rate_sweep_fn` frame body.

    The error of every palette entry under each block's own selector codes
    (`sweep_features`: one [nb, 16] x [16, E] product, exact: integers
    below 2^24), the column scan (`rate_sweep_cols_plain`), where CR won the
    previous selector, then the CR snap of the patterned blocks (sel !=
    s0_index on entry): the previous pair where e_prev <= fma(lam_cr, e_new,
    64). Arguments as `rate_sweep_frame`; returns (ep, sel) [nb] int32."""
    nb = ep.shape[0]
    p_sq, feat, mat = sweep_features(blocks, base, mods, sel_cb, sel)
    err = p_sq[:, None] + feat @ mat.T  # [nb, E]
    if prev is None:
        prev_ep = prev_sel = torch.zeros_like(ep)
        e_prev = torch.zeros(nb, dtype=torch.float32, device=ep.device)
    else:
        prev_ep, prev_sel = prev
        e_prev = pair_errors(blocks, base, mods, sel_cb, prev_ep.long(), prev_sel.long())
    new_ep, use_cr = rate_sweep_cols_plain(err, bits, ep, prev_ep, e_prev, prev is not None,
                                           lam, nbx)
    new_sel = torch.where(use_cr, prev_sel, sel)
    if prev is not None:  # patterned blocks: the plain CR snap
        e_new = pair_errors(blocks, base, mods, sel_cb, new_ep.long(), new_sel.long())
        cr = (e_prev <= fma_f32(lam_cr, e_new, SWEEP_SLACK)) & (sel != s0_index)
        new_ep, new_sel = torch.where(cr, prev_ep, new_ep), torch.where(cr, prev_sel, new_sel)
    return new_ep.to(torch.int32), new_sel.to(torch.int32)


def rate_sweep_frame(blocks: Tensor, base: Tensor, mods: Tensor, sel_cb: Tensor, bits: Tensor,
                     ep: Tensor, sel: Tensor, prev: Optional[Tuple[Tensor, Tensor]],
                     s0_index: int, lam: float, lam_cr: float,
                     nbx: int) -> Tuple[Tensor, Tensor]:
    """K7: the rate sweep on one frame, the reference's `_rate_sweep_fn`
    frame body in one launch of nby CTAs. blocks [nb, 16, 3] uint8 (rows of
    nbx blocks in raster order), base [E, 3] and mods [E, 4] int32 (8-bit
    colors and intensity modifiers, E >= 1), sel_cb [S, 16]
    int32 codes, bits [E] f32 (`etc1s_encode.sweep_bits_table`), ep and sel
    [nb] int32 (the incoming pairs), prev the previous frame's (ep, sel)
    [nb] int32 or None, s0_index the uniform selector row, lam the bits'
    weight, lam_cr the CR snap's → (ep, sel) [nb] int32, as
    `rate_sweep_frame_plain`. Above `SWEEP_REG_MAX_E` entries the launch
    is preceded by one that writes the palette's entry table (a scratch of
    E x 32 bytes)."""
    _check_blocks(blocks)
    nb = blocks.shape[0]
    if base.ndim != 2 or base.shape[0] == 0:
        raise ValueError(f"expected at least one palette entry, got {tuple(base.shape)}")
    e = base.shape[0]
    if nbx <= 0 or nb % nbx:
        raise ValueError(f"{nb} blocks are not rows of {nbx}")
    pairs = (ep, sel) + (() if prev is None else tuple(prev))
    for name, t, dt, shape in (("base", base, torch.int32, (e, 3)),
                               ("mods", mods, torch.int32, (e, 4)),
                               ("sel_cb", sel_cb, torch.int32, (sel_cb.shape[0], 16)),
                               ("bits", bits, torch.float32, (e,)),
                               *((n, t, torch.int32, (nb,))
                                 for n, t in zip(("ep", "sel", "prev_ep", "prev_sel"), pairs))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected {list(shape)} {dt} {name}, got {tuple(t.shape)} {t.dtype}")
    if not _route(blocks):
        return rate_sweep_frame_plain(blocks, base, mods, sel_cb, bits, ep, sel, prev,
                                      s0_index, lam, lam_cr, nbx)
    args = [t.contiguous() for t in (blocks, base, mods, sel_cb, bits, *pairs)]
    if prev is None:  # not read by the kernel
        args += args[-2:]
    out_ep = torch.empty(nb, dtype=torch.int32, device=blocks.device)
    out_sel = torch.empty(nb, dtype=torch.int32, device=blocks.device)
    table = (torch.empty((e, 8), dtype=torch.int32, device=blocks.device)
             if e > SWEEP_REG_MAX_E else None)
    _launch("etc1s_rate_sweep", "uvt_etc1s_rate_sweep", blocks.device,
            *(t.data_ptr() for t in args), int(prev is not None), int(s0_index), f32(lam),
            f32(lam_cr), nb // nbx, nbx, e, None if table is None else table.data_ptr(),
            out_ep.data_ptr(), out_sel.data_ptr())
    return out_ep, out_sel
