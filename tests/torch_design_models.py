"""numpy/torch models of the segment-sum kernel and of K6 past one window,
shared by the port's design tests and its card tests.

  - the segment sum's pass 1 (`csrc/etc1s.cu`: each tile's keys sorted by a
    warp, a walk per run, the 16 tiles of a chunk added by a binary counter)
    and its sparse path past 2,048 segments (each chunk's roots found by
    presence words and slot bases, pass 2's counter over the present chunks):
    `_chunk_roots` and `_sparse_model_loop` chunk by chunk, `_pass1_roots`
    and `_sparse_model` every chunk at once;
  - K6's assignment past 2,048 centroids (`kmeans_assign_wide_kernel`: an
    FMA filter against the running best plus a margin, the reference's dist
    re-checked where it passes): `_wide_assign_loop` centroid by centroid,
    `_wide_assign_model` a chunk of centroids at once, with the kernel's
    counters (pairs re-checked, warp steps that re-checked).

Each loop model is the reference of its faster form:
tests/test_torch_design_segment_sum.py and tests/test_torch_design_k6.py
hold them equal, bit for bit and counter for counter. Not a test module:
pytest collects only `test_*.py`.
"""

import re
from pathlib import Path

import numpy as np
import torch

from uvol_tpu_torch._device import fma_f32
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern

CHUNK = kern.SEG_TILE * kern.SEG_CHUNK_TILES  # rows per pass-1 chunk


def _values(r: np.random.Generator, n: int, d: int) -> np.ndarray:
    """f32 values over many magnitudes (so every change of order shows),
    with -0.0 and +0.0 among them."""
    x = r.normal(size=(n, d)) * 10.0 ** r.integers(-3, 8, (n, d))
    x = x.astype(np.float32)
    x[r.random((n, d)) < 0.1] = -0.0
    x[r.random((n, d)) < 0.05] = 0.0
    return x


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _chunk_roots(idx: np.ndarray, x: np.ndarray, ch: int) -> tuple:
    """Pass 1 of the segment-sum kernel on chunk `ch` of 1,024 rows, as
    `csrc/etc1s.cu` computes it: the keys segment << 10 | row sorted within
    each tile of 64 (one warp a tile); the (segment, tile) runs (stretches
    of the sorted keys) and the present segments, a slot each in segment
    order; per column group (at most 16 columns), each run's in-order sum
    from 0.0 written over its first row, then per present segment the
    levels 0..3 over the 16 tiles (an absent tile adding 0.0). Returns the
    present segments, ascending, and their roots [segments, D]."""
    n, d = x.shape
    tiles, levels = kern.SEG_CHUNK_TILES, 4
    groups = -(-d // 16)
    dc = -(-d // groups)
    rows = np.arange(ch * CHUNK, min(n, (ch + 1) * CHUNK))
    keys = (idx[rows].astype(np.int64) << 10) | (rows - ch * CHUNK)
    keys = np.concatenate([np.sort(keys[t:t + kern.SEG_TILE])
                           for t in range(0, len(keys), kern.SEG_TILE)] or [keys])
    st = keys >> 6  # (segment, tile)
    starts = np.flatnonzero(np.r_[True, st[1:] != st[:-1]]) if len(keys) else np.zeros(0, int)
    ends = np.r_[starts[1:], len(keys)]
    run_row = keys[starts] & (CHUNK - 1)
    run_seg = keys[starts] >> 10
    segs = np.unique(run_seg)
    roots = np.zeros((len(segs), d), np.float32)
    for g in range(groups):
        c0 = g * dc
        xs = x[ch * CHUNK:ch * CHUNK + len(rows), c0:c0 + dc].copy()  # staged, row order
        acc = np.zeros((len(starts), xs.shape[1]), np.float32)
        for step in range(kern.SEG_TILE):  # every run's walk, one row a step
            live = ends - starts > step
            acc[live] = acc[live] + xs[keys[starts[live] + step] & (CHUNK - 1)]
        xs[run_row] = acc  # each run's sum over its first row
        seg_of_run = np.searchsorted(segs, run_seg)
        tile_sum = np.zeros((tiles, len(segs), xs.shape[1]), np.float32)
        tile_sum[run_row >> 6, seg_of_run] = xs[run_row]
        pend = [None] * levels
        for t in range(tiles):  # levels 0..3: a binary counter, absent tiles 0.0
            node = tile_sum[t]
            for lvl in range(levels):
                if not (t >> lvl) & 1:
                    pend[lvl] = node
                    break
                node = pend[lvl] + node
        roots[:, c0:c0 + dc] = node
    return segs, roots

ROOT_LEVELS = 15  # kRootLevels: chunk indices below 2^14


def _popcount(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.uint64)
    return np.array([bin(int(v)).count("1") for v in a.ravel()], np.int64).reshape(a.shape)


def _sparse_tree(c_of: list, leaves: list, k: int, d: int) -> np.ndarray:
    """Pass 2 of the sparse path, for every segment at once: each segment's
    present chunks in order (c_of[c]: the segments chunk c holds, leaves[c]
    their roots), added in the twin's tree over the chunks as the kernel
    does: a binary counter whose absent leaves are identities. Leaves next
    .. c - 1 absent: the pending nodes below h = the highest bit of c ^
    next fold (right-nested) into one node at h; then leaf c carries to its
    first zero bit; at the end every pending node folds into the root."""
    pend = np.zeros((ROOT_LEVELS, k, d), np.float32)
    valid = np.zeros(k, np.int64)
    nxt = np.zeros(k, np.int64)
    for c, (segs, vals) in enumerate(zip(c_of, leaves)):
        skip = nxt[segs] != c
        if skip.any():
            sk = segs[skip]
            h = np.array([int(v).bit_length() - 1 for v in (c ^ nxt[sk])], np.int64)
            node = np.zeros((len(sk), d), np.float32)
            have = np.zeros(len(sk), bool)
            for lvl in range(ROOT_LEVELS - 1):
                sel = (lvl < h) & (((valid[sk] >> lvl) & 1) == 1)
                node[sel] = np.where(have[sel, None], pend[lvl, sk[sel]] + node[sel],
                                     pend[lvl, sk[sel]])
                have |= sel
            for lvl in range(ROOT_LEVELS):
                sel = (h == lvl) & have
                pend[lvl, sk[sel]] = node[sel]
            valid[sk] = (valid[sk] & ~((1 << h) - 1)) | (have.astype(np.int64) << h)
        node = vals.copy()
        for lvl in range(ROOT_LEVELS):  # the same carry for every segment of chunk c
            if not (c >> lvl) & 1:
                pend[lvl, segs] = node
                valid[segs] |= 1 << lvl
                break
            here = ((valid[segs] >> lvl) & 1) == 1
            node = np.where(here[:, None], pend[lvl, segs] + node, node)
            valid[segs] &= ~(1 << lvl)
        nxt[segs] = c + 1
    out = np.zeros((k, d), np.float32)  # a segment without a row: the twin's 0.0
    have = np.zeros(k, bool)
    for lvl in range(ROOT_LEVELS):
        sel = ((valid >> lvl) & 1) == 1
        out[sel] = np.where(have[sel, None], pend[lvl, sel] + out[sel], pend[lvl, sel])
        have |= sel
    return out


def _sparse_model_loop(idx: np.ndarray, k: int, x: np.ndarray) -> np.ndarray:
    """numpy model of the segment sum past one window (`seg_sum_sparse_chunk_
    kernel` and `seg_sum_roots_kernel`): pass 1 as `_chunk_roots`, every
    row read once, the roots written under their slots with the chunk's
    presence words and the slots before each word; pass 2 finds each
    segment's root in chunk c at slot base[c][w] + popc(bits[c][w] & the
    bits below the segment's) and adds the present chunks in the twin's
    tree (`_sparse_tree`)."""
    n, d = x.shape
    m = max(1, -(-n // CHUNK))
    words = -(-k // 32)
    c_of, leaves = [], []
    for ch in range(m):
        segs, roots = _chunk_roots(idx, x, ch)
        present = np.zeros(words * 32, np.int64)
        present[segs] = 1
        bits = (present.reshape(words, 32) << np.arange(32)).sum(1)
        base = np.r_[0, np.cumsum(present.reshape(words, 32).sum(1))[:-1]]
        w, b = segs >> 5, segs & 31
        slot = base[w] + _popcount(bits[w] & ((1 << b) - 1))
        c_of.append(segs)
        leaves.append(roots[slot])  # the root a thread of pass 2 reads
        assert (slot == np.arange(len(segs))).all()  # slots are ranks in segment order
    return _sparse_tree(c_of, leaves, k, d)

_ETC1S_SRC = (Path(kern.__file__).resolve().parents[2] / "csrc" / "etc1s.cu").read_text()


def _etc1s_const(name: str):
    """A constexpr of `csrc/etc1s.cu`: an int, or a float written as 0x1p-Nf."""
    m = re.search(rf"constexpr (?:int|float) {name} = ([^;]+);", _ETC1S_SRC).group(1)
    return float.fromhex(m[:-1]) if m.startswith("0x") else int(m)


KM_CHUNK = _etc1s_const("kKmWideChunk")
KM_ROWS = _etc1s_const("kKmWideRows")
KM_GROUPS = _etc1s_const("kKmWideGroups")
KM_SCALE = _etc1s_const("kKmMarginScale")
KM_FLOOR = _etc1s_const("kKmMarginFloor")


def _up(r: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The least float32 >= hi + lo (float64 hi, its exact error lo), given
    r = float32(hi) rounded to nearest."""
    r64 = r.double()
    return torch.where((r64 < hi) | ((r64 == hi) & (lo > 0)),
                       torch.nextafter(r, torch.full_like(r, np.inf)), r)


def _add_ru(a, b) -> torch.Tensor:
    """__fadd_ru / __fmaf_ru: a + b rounded up to float32, a and b float64
    (a + b in float64 with its TwoSum error)."""
    s = a + b
    t = s - a
    lo = (a - (s - t)) + (b - t)
    r = s.float()
    inf = torch.isinf(s)
    return torch.where(inf, r, _up(r, s, torch.where(inf, 0.0, lo)))


def _fma_ru(a, b, c) -> torch.Tensor:
    """__fmaf_ru(a, b, c) on float32 tensors: the product is exact in float64."""
    return _add_ru(a.double() * b.double(), c.double())


def _c2(cb: torch.Tensor) -> torch.Tensor:
    """c2 in `centroid_rows`' order, every step rounded."""
    sq = cb * cb
    return ((sq[:, 0] + sq[:, 1]) + sq[:, 2]) + sq[:, 3]


def _filter(fp: torch.Tensor, cb: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """d~ [rows, centroids]: four fused multiply-adds from c2 with fp = -2 f."""
    d = c2[None, :].expand(fp.shape[0], -1)
    for j in range(4):
        d = fma_f32(fp[:, j : j + 1], cb[None, :, j], d)
    return d


def _dist(fp: torch.Tensor, cb: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """The reference's dist of each row of fp (-2 f) with each centroid,
    every step rounded: (-2f) * c is the real f * (-2c)."""
    d = c2[None, :].expand(fp.shape[0], -1)
    for j in range(4):
        d = d + fp[:, j : j + 1] * cb[None, :, j]
    return d


def _warp_layout(n_rows: int, rows: int) -> tuple:
    """For each of the grid's rows, its thread and its warp: a CTA's warp g
    holds the 32 * rows rows row0 + g * 32 * rows + q * 32 + lane."""
    gr = torch.arange(n_rows)
    warp = gr // (32 * rows)
    return warp * 32 + gr % 32, warp


def _thread_margin_terms(f: torch.Tensor, rows: int) -> torch.Tensor:
    """2 sum_j |f_j| (rounded up) of the largest row of each row's thread."""
    a = f.abs().double()
    nf = _add_ru(_add_ru(_add_ru(a[:, 0], a[:, 1]).double(), a[:, 2]).double(), a[:, 3])
    thread, _ = _warp_layout(f.shape[0], rows)
    top = torch.zeros(int(thread.max()) + 1).scatter_reduce(0, thread, nf, "amax")
    return 2.0 * top[thread]


def _margin(nf2: torch.Tensor, c2max: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """The kernel's margin: (c2max + 2 sum_j |f_j| amax) 2^-20 + 2^-120,
    each step rounded up."""
    inner = _fma_ru(nf2, amax.expand_as(nf2), c2max.expand_as(nf2))
    return _fma_ru(inner, torch.full_like(inner, KM_SCALE), torch.full_like(inner, KM_FLOOR))


def _wide_assign_loop(feats: np.ndarray, cb: np.ndarray) -> tuple:
    """numpy/torch model of `kmeans_assign_wide_kernel`: the grid's rows
    (padding rows of zeros past n; CTAs of KM_GROUPS warps of 32 x KM_ROWS
    rows), the centroids in chunks of KM_CHUNK with each chunk's largest c2
    and |c_j|, the filter d~ < best + margin (rounded up), the reference's
    dist only where it passes, taken where dist < best. Returns (assign [n]
    int32, pairs re-checked, warp steps that re-checked): the kernel's
    counters."""
    n, k = len(feats), len(cb)
    rows = KM_ROWS
    per = 32 * rows * KM_GROUPS
    g_rows = -(-n // per) * per
    f = torch.zeros((g_rows, 4), dtype=torch.float32)
    f[:n] = torch.from_numpy(feats)
    fp = -2.0 * f
    nf2 = _thread_margin_terms(f, rows)
    _, warp = _warp_layout(g_rows, rows)
    c = torch.from_numpy(cb)
    best = torch.full((g_rows,), np.inf)
    bi = torch.zeros(g_rows, dtype=torch.int64)
    rechecks = slow = 0
    for c0 in range(0, k, KM_CHUNK):
        ch = c[c0 : c0 + KM_CHUNK]
        c2 = _c2(ch)
        mg = _margin(nf2, c2.max()[None], ch.abs().max()[None])
        thr = _add_ru(best.double(), mg.double())
        dt, ds = _filter(fp, ch, c2), _dist(fp, ch, c2)  # ds read only where dt passes
        for j in range(len(ch)):
            idx = torch.nonzero(dt[:, j] < thr).flatten()
            if not len(idx):
                continue
            rechecks += len(idx)
            slow += int(torch.count_nonzero(torch.bincount(warp[idx])))
            e = ds[idx, j]
            win = e < best[idx]
            r = idx[win]
            best[r], bi[r] = e[win], c0 + j
            thr[r] = _add_ru(e[win].double(), mg[r].double())
    return bi[:n].to(torch.int32).numpy(), rechecks, slow

def _wide_kmeans_case(kind: str, n: int, k: int, seed: int) -> tuple:
    """(feats [n, 4], cb [k, 4]) float32: `random` uniform features and
    centroids drawn from them with duplicates in every chunk and across
    2,048; `gradient` rows of a smooth ramp with a low contrast (B-like);
    `all_equal` one centroid k times; `ulp` centroids in pairs one ulp
    apart and exact repeats; `extremes` features at 0 and 255 (contrast up
    to 255) against centroids past the data, at +-0.0 and up to +-1,000."""
    r = np.random.default_rng(seed)
    if kind == "gradient":
        t = np.arange(n, dtype=np.float64)
        rgb = np.stack([128 + 120 * np.sin(t / 700 + s) for s in (0.0, 2.0, 4.0)], 1)
        f = np.concatenate([rgb + r.normal(0, 0.5, (n, 3)), r.random((n, 1)) * 8], 1)
    elif kind == "extremes":
        f = np.where(r.random((n, 4)) < 0.5, 255.0, 0.0)
        f[::7, 3] = 255.0 * r.random(len(f[::7]))
    else:
        f = r.random((n, 4)) * 255
    f = f.astype(np.float32)
    if kind == "all_equal":
        cb = np.broadcast_to(f[:1] + np.float32(0.25), (k, 4)).copy()
    elif kind == "extremes":
        cb = (r.random((k, 4)) * 2000 - 1000).astype(np.float32)
        cb[:3] = 0.0
        cb[3] = -0.0
        cb[4:8] = np.float32(255.0)
    else:
        cb = (f[r.integers(0, n, k)] + r.normal(0, 2, (k, 4))).astype(np.float32)
    if kind == "ulp":
        cb[1::2] = np.nextafter(cb[0::2][: k // 2], np.float32(np.inf))
        cb[2::5] = cb[0]
    if kind in ("random", "gradient", "ulp"):
        cb[k - 1] = cb[0]  # a duplicate past the first window: ties go to the first
        cb[2048] = cb[5]
        for c0 in range(0, k - 9, KM_CHUNK):  # and one in every chunk
            cb[c0 + 9] = cb[c0 + 2]
    return f, cb


KM_KINDS = ("random", "gradient", "all_equal", "ulp", "extremes")


def _pass1_roots(idx: np.ndarray, x: np.ndarray) -> tuple:
    """Pass 1 of the segment-sum kernel on every chunk at once, as
    `_chunk_roots` computes it chunk by chunk: each tile's keys sorted by
    (segment, row), each (segment, tile) run summed in row order from 0.0
    (all runs a step at a time), each (chunk, segment)'s 16 tile sums (an
    absent tile 0.0) added by levels 0..3 as the binary counter pairs them.
    Returns (chunk, segment) of each root in ascending order, and the roots
    [roots, D]."""
    n, d = x.shape
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros((0, d), np.float32)
    rows = np.arange(n)
    tile = rows // kern.SEG_TILE
    order = np.lexsort((rows, idx, tile))  # within a tile: segment << 10 | row, ascending
    s_tile, s_seg = tile[order], idx[order].astype(np.int64)
    starts = np.flatnonzero(np.r_[True, (s_tile[1:] != s_tile[:-1]) | (s_seg[1:] != s_seg[:-1])])
    ends = np.r_[starts[1:], n]
    acc = np.zeros((len(starts), d), np.float32)
    for step in range(kern.SEG_TILE):  # every run's walk, one row a step
        live = ends - starts > step
        acc[live] = acc[live] + x[order[starts[live] + step]]
    run_tile, run_seg = s_tile[starts], s_seg[starts]
    run_chunk = run_tile // kern.SEG_CHUNK_TILES
    pairs, root_of_run = np.unique(run_chunk * (int(s_seg.max()) + 1) + run_seg,
                                   return_inverse=True)
    tiles = np.zeros((len(pairs), kern.SEG_CHUNK_TILES, d), np.float32)  # absent tiles 0.0
    tiles[root_of_run, run_tile % kern.SEG_CHUNK_TILES] = acc
    while tiles.shape[1] > 1:  # a level: the pending node (left) + the new one (right)
        tiles = tiles[:, 0::2] + tiles[:, 1::2]
    return pairs // (int(s_seg.max()) + 1), pairs % (int(s_seg.max()) + 1), tiles[:, 0]


def _sparse_model(idx: np.ndarray, k: int, x: np.ndarray) -> np.ndarray:
    """`_sparse_model_loop` with pass 1 and the slot lookup taken for every
    chunk at once (`_pass1_roots`; the presence words, the slot bases and
    the popcounts as arrays [chunks, words]); pass 2 is the same chunk walk
    (`_sparse_tree`), each chunk's segments at once."""
    n, d = x.shape
    m = max(1, -(-n // CHUNK))
    words = -(-k // 32)
    chunk, seg, roots = _pass1_roots(idx, x)
    present = np.zeros((m, words, 32), np.int64)
    present[chunk, seg >> 5, seg & 31] = 1
    bits = (present << np.arange(32)).sum(2)  # a presence word per 32 segments a chunk
    count = present.sum(2)
    base = np.cumsum(count, 1) - count  # the slots before each word
    w, b = seg >> 5, seg & 31
    slot = base[chunk, w] + np.bitwise_count(bits[chunk, w] & ((1 << b) - 1))
    first = np.searchsorted(chunk, np.arange(m))  # where each chunk's roots start
    assert (slot == np.arange(len(seg)) - first[chunk]).all()  # slots are ranks in segment order
    read = roots[first[chunk] + slot]  # the root a thread of pass 2 reads
    return _sparse_tree(np.split(seg, first[1:]), np.split(read, first[1:]), k, d)


def _wide_assign_model(feats: np.ndarray, cb: np.ndarray) -> tuple:
    """`_wide_assign_loop` with each chunk's centroids taken at once: a row's
    scan of the chunk goes from one change of its best to the next. From
    the centroid after its last change, the next change is the first
    centroid that passes the filter against the running best plus the
    margin (rounded up) and whose dist, re-checked, is below the best;
    every centroid up to it that passes is a re-check. The rows still
    scanning (their best changed) take the next step together. Returns
    what `_wide_assign_loop` returns: (assign [n] int32, pairs re-checked,
    warp steps that re-checked)."""
    n, k = len(feats), len(cb)
    rows = KM_ROWS
    per = 32 * rows * KM_GROUPS
    g_rows = -(-n // per) * per
    f = torch.zeros((g_rows, 4), dtype=torch.float32)
    f[:n] = torch.from_numpy(feats)
    fp = -2.0 * f
    nf2 = _thread_margin_terms(f, rows)
    c = torch.from_numpy(cb)
    best = torch.full((g_rows,), np.inf)
    bi = torch.zeros(g_rows, dtype=torch.int64)
    rechecks = slow = 0
    for c0 in range(0, k, KM_CHUNK):
        ch = c[c0 : c0 + KM_CHUNK]
        m = len(ch)
        c2 = _c2(ch)
        mg = _margin(nf2, c2.max()[None], ch.abs().max()[None])
        thr = _add_ru(best.double(), mg.double())
        dt, ds = _filter(fp, ch, c2), _dist(fp, ch, c2)
        passed = torch.zeros((g_rows, m), dtype=torch.bool)
        pos = torch.full((g_rows,), -1)  # the centroid of the row's last change
        live = torch.arange(g_rows)
        j = torch.arange(m)
        while len(live):
            ahead = j[None, :] > pos[live, None]
            passes = ahead & (dt[live] < thr[live, None])
            takes = passes & (ds[live] < best[live, None])
            has = takes.any(1)
            nxt = torch.where(has, takes.int().argmax(1), m)  # the first change, else the end
            passed[live] |= passes & (j[None, :] <= nxt[:, None])
            live, at = live[has], nxt[has]
            e = ds[live, at]
            best[live], bi[live], pos[live] = e, c0 + at, at
            thr[live] = _add_ru(e.double(), mg[live].double())
        rechecks += int(passed.sum())
        slow += int(passed.view(-1, 32 * rows, m).any(1).sum())  # warps hold 32 x rows rows
    return bi[:n].to(torch.int32).numpy(), rechecks, slow
