"""ETC1S palette-build kernels on the card — counterpart of `etc1s_pallas.py`.

`assign_endpoints` (K4), `inten_errors` (K5) and `kmeans_iter` (K6) are
the three hot stages of the palette build (`etc1s_encode.palette_core`).
The device of the tensor decides the route:

  - a CUDA tensor launches the hand-written kernels of `csrc/etc1s.cu`,
    built by `_build` at first use; a build or launch failure raises,
    nothing falls back;
  - a CPU tensor goes through the plain twin beside each kernel
    (`*_plain`), which computes the same numbers in the same order.

Each kernel launch adds one to `LAUNCHES[name]`; twin calls are not
counted.

K4 and K5 are exact integer arithmetic (the TPU kernels' f32 terms are
all integers below 2^24), so kernel, twin and TPU kernel agree bit for
bit, argmin ties included (first minimum). K6 is f32: its distances keep
the TPU kernel's op order, and its sums take the fixed order of
`segment_sum`, which the kernel mirrors, so kernel and twin agree bit
for bit as well; against the TPU kernel (whose sums are an MXU product)
the sums agree to rounding.

Blocks are `[N, 16, 3]` uint8, pixels row-major within the block — the
upload the palette build makes once per segment.
"""

from __future__ import annotations

from typing import Tuple

import torch

from uvol_tpu.codecs.basis.transcoder import INTEN_TABLES as _INTEN_TABLES
from uvol_tpu_torch import _build

Tensor = torch.Tensor

#: kernel launches per kernel since the last reset
LAUNCHES = {
    "etc1s_assign_endpoints": 0,
    "etc1s_inten_errors": 0,
    "etc1s_kmeans_iter": 0,
}

#: the ETC1S intensity modifiers [8 tables, 4 codes]; `csrc/etc1s.cu`
#: holds the same rows in constant memory
INTEN_TABLES = tuple(tuple(int(v) for v in row) for row in _INTEN_TABLES)

#: rows per fixed-order partial of `segment_sum` (kSegTile in the kernel)
SEG_TILE = 64
#: most centroids K6 takes (its shared-memory table)
KMEANS_MAX_K = 2048
#: elements per temporary of the plain twins
_TWIN_ELEMS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _route(t: Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (twin)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    lib = _build.get_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = lib.uvt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def _check_blocks(blocks: Tensor) -> None:
    if blocks.dtype != torch.uint8 or blocks.ndim != 3 or tuple(blocks.shape[1:]) != (16, 3):
        raise ValueError(
            f"expected [N, 16, 3] uint8 blocks, got {tuple(blocks.shape)} {blocks.dtype}"
        )


# ---------------------------------------------------------------------------
# Fixed-order segment sum (the order K6's kernel mirrors)
# ---------------------------------------------------------------------------


def segment_sum(idx: Tensor, k: int, x: Tensor) -> Tensor:
    """`out[s] = sum of x[i] over idx[i] == s`: x [N, D] f32, idx [N] in
    [0, k) → [k, D] f32, in one order on every device and every run.

    Rows are added in order within consecutive tiles of `SEG_TILE` rows,
    starting from 0.0; the tile partials are then added pairwise, level
    by level (adjacent pairs; an odd last tile is added to 0.0). No float
    atomics: `index_add_` on CUDA would order the adds differently from
    run to run, and the cluster error sums (far above 2^24) would then
    flip argmins between runs."""
    n, d = x.shape
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
    """K5: blocks [N, 16, 3] uint8, base [N, 3] int32 → [N, 8] int32."""
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
    mods = torch.tensor(INTEN_TABLES, dtype=torch.int32, device=b.device)[inten.long()]
    me = torch.clamp(b[:, None, :] + mods[:, :, None], 0, 255) - b[:, None, :]  # [E,4,3]
    q = 2 * (b[:, None, :] * me).sum(-1) + (me * me).sum(-1)  # [E, 4]
    codes = torch.cat([-2 * me, q[:, :, None]], 2).reshape(-1, 16)
    tail = torch.cat([-2 * b, 16 * (b * b).sum(1, keepdim=True)], 1)
    return torch.cat([codes, tail], 1).to(torch.int32).contiguous()


def assign_endpoints_plain(blocks: Tensor, table: Tensor) -> Tensor:
    """Plain twin of K4: blocks [N, 16, 3] uint8, table [E, 20] int32 →
    [N] int32, the first endpoint of least exact block error."""
    e = table.shape[0]
    px = blocks.to(torch.int32)
    psum = px.sum(1)  # [N, 3]
    t = table.to(torch.int32)
    m = t[:, :16].reshape(e, 4, 4)
    chunk = max(1, _TWIN_ELEMS // (16 * e))
    out = []
    for s in range(0, px.shape[0], chunk):
        p = px[s : s + chunk, :, None, :]  # [B, 16, 1, 3]
        best = None
        for j in range(4):
            cand = (m[:, j, 3] + p[..., 0] * m[:, j, 0] + p[..., 1] * m[:, j, 1]
                    + p[..., 2] * m[:, j, 2])  # [B, 16, E]
            best = cand if best is None else torch.minimum(best, cand)
        ps = psum[s : s + chunk]
        err = best.sum(1) + (t[:, 19] + ps[:, 0:1] * t[:, 16] + ps[:, 1:2] * t[:, 17]
                             + ps[:, 2:3] * t[:, 18])
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
    s5 = segment_sum(assign, k, torch.cat([feats, feats.new_ones((n, 1))], 1))
    return s5[:, :4], s5[:, 4], assign


def kmeans_iter(feats: Tensor, cb: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K6: feats [N, 4] f32, cb [K, 4] f32 (K <= 2048) → (sums [K, 4],
    counts [K], assign [N] int32)."""
    if feats.dtype != torch.float32 or feats.ndim != 2 or feats.shape[1] != 4:
        raise ValueError(f"expected [N, 4] float32 feats, got {tuple(feats.shape)} {feats.dtype}")
    if cb.ndim != 2 or cb.shape[1] != 4 or not 0 < cb.shape[0] <= KMEANS_MAX_K:
        raise ValueError(f"expected [K, 4] centroids with K <= {KMEANS_MAX_K}, "
                         f"got {tuple(cb.shape)}")
    if feats.shape[0] == 0:
        raise ValueError("kmeans_iter needs at least one row")
    if not _route(feats):
        return kmeans_iter_plain(feats, cb)
    feats = feats.contiguous()
    rows = centroid_rows(cb.to(feats.device))
    n, k = feats.shape[0], cb.shape[0]
    nt = -(-n // SEG_TILE)
    part = torch.empty((2, nt, k, 5), dtype=torch.float32, device=feats.device)
    sums = torch.empty((k, 5), dtype=torch.float32, device=feats.device)
    assign = torch.empty(n, dtype=torch.int32, device=feats.device)
    _launch("etc1s_kmeans_iter", "uvt_etc1s_kmeans_iter", feats.device,
            feats.data_ptr(), rows.data_ptr(), n, k, part[0].data_ptr(),
            part[1].data_ptr(), sums.data_ptr(), assign.data_ptr())
    return sums[:, :4], sums[:, 4], assign
