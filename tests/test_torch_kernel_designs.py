"""The arithmetic the redesigned kernels of `uvol_tpu_torch` rely on, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain twins there). What can be
checked here is that the decompositions they compute are the twins'
functions, bit for bit:

  - the segment-sum kernel (`csrc/etc1s.cu`: pass 1 over chunks of 16
    tiles, each tile's keys sorted by a warp, a walk per (run, columns)
    and per (present segment, columns); pass 2 over the chunk partials)
    against `segment_sum_plain`, through a numpy model of the two passes;
  - K1 (`csrc/etc1.cu`): the closed form of pass 1's table ranking, and
    the forms of pass 2's code errors, against the twin's formulas in
    `codecs/basis/etc.py`;
  - K5 (`csrc/etc1s.cu`): the float32 forms of a code's error (one
    multiply-add where the code clips no channel of the base, the
    per-channel form where it does) and the test that tells them apart,
    against `inten_errors_plain`;
  - K2 (`csrc/etc1.cu`): a block's rows formed by byte selects from the
    four values a channel of a subblock can take, packed as three
    little-endian words a row and stored by either path's index
    arithmetic, against `decode_etc1_images_plain`;
  - the geometry stage (`csrc/geometry.cu`): the strided masked
    minimum/maximum with its order of the zeros, and K3's index
    arithmetic (4 vertices a thread on the buffer's 16-byte grid, the
    left neighbour by warp shuffle or recomputed at a warp's seam, row
    heads and tails, both store paths), against
    `geometry_quantize_stage_plain`;
  - K7 (`csrc/etc1s.cu`, the rate sweep's frame stage): the per-row
    prologue (features, e_prev), int32 errors, a thread's first minimum
    over its entries, the warps' minima of (ordered cost, entry) with CR
    winning ties, and the CR snap's gate, against
    `rate_sweep_frame_plain`;
  - K8 (`csrc/drc.cu`, the `.drc` window's device stage): each CTA's first
    frame, offset and one-frame flag, its staged metadata, its bytes staged
    in 16-byte pieces from the boundary at or below its first byte (bytewise
    where a piece leaves the window), runs of whole groups with the
    component, vertex and frame carried, and the padded output offsets,
    against `fused_batch_plain`.

Every comparison here is exact: integers compared as integers, floats
compared bit for bit (`view(int32)`), no tolerance.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from uvol_tpu_torch.codecs.basis import etc as tetc
from uvol_tpu_torch._device import fma_f32
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern
from uvol_tpu_torch.codecs.basis import etc1s_encode as tenc
from uvol_tpu_torch.codecs.basis import etc_cuda
from uvol_tpu_torch.models import drc_device as dd
from uvol_tpu_torch.ops import pallas_kernels as pk

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


def _documented_order(idx: np.ndarray, k: int, x: np.ndarray) -> np.ndarray:
    """`segment_sum_plain`'s documented order, written as loops: rows in
    order within 64-row tiles from 0.0, then tiles pairwise, level by
    level, an odd last tile added to 0.0."""
    n, d = x.shape
    tiles = []
    for t0 in range(0, max(n, 1), kern.SEG_TILE):
        acc = np.zeros((k, d), np.float32)
        for i in range(t0, min(n, t0 + kern.SEG_TILE)):
            acc[idx[i]] = acc[idx[i]] + x[i]
        tiles.append(acc)
    while len(tiles) > 1:
        if len(tiles) % 2:
            tiles.append(np.zeros((k, d), np.float32))
        tiles = [tiles[i] + tiles[i + 1] for i in range(0, len(tiles), 2)]
    return tiles[0]


@pytest.mark.parametrize("n", [1, 64, 65, 1025])
@pytest.mark.parametrize("d", [1, 5, 9, 33, 64])
def test_segment_sum_plain_takes_its_documented_order(d, n):
    """Bit-exact: the twin of the segment-sum kernel against its
    documented order, at the widths the palette build uses, tile and
    chunk edges, -0.0 inputs."""
    r = np.random.default_rng(1000 * d + n)
    k = 7
    idx = r.integers(0, k, n)
    x = _values(r, n, d)
    got = kern.segment_sum_plain(torch.from_numpy(idx), k, torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), _bits(_documented_order(idx, k, x)))


def _kernel_model(idx: np.ndarray, k: int, x: np.ndarray) -> np.ndarray:
    """numpy model of the segment-sum kernel's two passes, as
    `csrc/etc1s.cu` computes them.

    Pass 1, one CTA per chunk of 1,024 rows: the keys segment << 10 | row
    sorted within each tile of 64 (one warp a tile); the (segment, tile)
    runs (stretches of the sorted keys) and the present segments, a slot
    each in segment order; per column group (at most 16 columns), each
    run's in-order sum from 0.0 written over its first row, then per
    present segment the levels 0..3 over the 16 tiles (an absent tile
    adding 0.0), written as the chunk's partial; 0.0 for a segment the
    chunk does not hold. Pass 2: the tree over the chunk partials in
    pieces of 256 leaves, then the piece roots."""
    n, d = x.shape
    tiles, levels = kern.SEG_CHUNK_TILES, 4
    m = max(1, -(-n // CHUNK))
    groups = -(-d // 16)
    dc = -(-d // groups)
    part = np.zeros((m, k, d), np.float32)  # 0.0 for the segments a chunk does not hold
    for ch in range(m):
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
            part[ch, segs, c0:c0 + dc] = node
    p = 1  # pass 2: pieces of up to 256 leaves, then the piece roots
    while p < m:
        p *= 2
    piece = min(p, 256)

    def tree(leaves):
        leaves = list(leaves)
        w = 1
        while w < len(leaves):
            for j in range(0, len(leaves), 2 * w):
                leaves[j] = leaves[j] + leaves[j + w]
            w *= 2
        return leaves[0]

    zero = np.zeros((k, d), np.float32)
    roots = [tree(part[j] if j < m else zero for j in range(pc * piece, (pc + 1) * piece))
             if pc * piece < m else zero for pc in range(p // piece)]
    return tree(roots)


def _window_model(idx: np.ndarray, k: int, x: np.ndarray, window: int) -> np.ndarray:
    """The kernel past one window: `_kernel_model` once per window of
    `window` segments, the rows of other segments keyed to a spare segment
    past the window (they sort after the window's rows in their tile, as
    kNoSegment does) and dropped."""
    outs = []
    for s0 in range(0, k, window):
        kw = min(window, k - s0)
        inw = (idx >= s0) & (idx < s0 + kw)
        outs.append(_kernel_model(np.where(inw, idx - s0, kw), kw + 1, x)[:kw])
    return np.concatenate(outs)


@pytest.mark.parametrize("k,window", [(2049, 2048), (4100, 2048), (300, 64), (130, 7)])
@pytest.mark.parametrize("n", [1025, 3077])
def test_kernel_windows_match_segment_sum_plain(k, window, n):
    """Bit-exact: a sum over k segments taken window by window, each
    window's pass dropping the other rows, equals the twin's one tree, and
    so does the twin taken window by window."""
    r = np.random.default_rng(k + n + window)
    idx = r.integers(0, k, n)
    idx[: n // 3] = np.sort(idx[: n // 3])
    x = _values(r, n, 9)
    want = kern.segment_sum_plain(torch.from_numpy(idx), k, torch.from_numpy(x), _window=1 << 30)
    np.testing.assert_array_equal(_bits(_window_model(idx, k, x, window)), _bits(want))
    got = kern.segment_sum_plain(torch.from_numpy(idx), k, torch.from_numpy(x), _window=window)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _hold_model(idx: np.ndarray, k: int, x: np.ndarray) -> None:
    want = kern.segment_sum_plain(torch.from_numpy(idx), k, torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(_kernel_model(idx, k, x)), _bits(want))


@pytest.mark.parametrize("n", [1, 63, 65, 1023, 1025, 3077])
@pytest.mark.parametrize("d", [1, 4, 8, 9, 33, 64])
@pytest.mark.parametrize("k", [1, 7, 256, 1024, 2048])
def test_kernel_decomposition_matches_segment_sum_plain(k, d, n):
    """Bit-exact: chunk partials, then the outer levels, equal the twin's
    one tree, at every (k, D) of a palette build,
    over tile and chunk edges; -0.0 inputs and long runs of one segment
    included."""
    r = np.random.default_rng(k * 100003 + n * 101 + d)
    idx = r.integers(0, k, n)
    idx[: n // 3] = np.sort(idx[: n // 3])
    _hold_model(idx, k, _values(r, n, d))


@pytest.mark.parametrize("k,d", [(7, 3), (2048, 9)])
@pytest.mark.parametrize("n", [20000, 256 * 1024 + 1])
def test_kernel_decomposition_at_pass_2_piece_edges(k, d, n):
    """Past one piece of 256 chunk partials (pass 2's second round)."""
    r = np.random.default_rng(n + k)
    _hold_model(r.integers(0, k, n), k, _values(r, n, d))


@pytest.mark.parametrize("k,d", [(256, 64), (1024, 9), (2, 33)])
@pytest.mark.parametrize("n", [1025, 5000])
def test_kernel_decomposition_on_skewed_assignments(k, d, n):
    """90% of the rows in one segment: its runs are whole tiles."""
    r = np.random.default_rng(n * 3 + k)
    idx = np.where(r.random(n) < 0.9, k // 2, r.integers(0, k, n))
    _hold_model(idx, k, _values(r, n, d))


@pytest.mark.parametrize("n", [64, 1000, 1024, 3000])
def test_kernel_decomposition_with_negative_zeros_beside_absent_tiles(n):
    """A segment of -0.0 rows in every tile, and one whose only row of a
    tile is -0.0 beside tiles without it: each run's sum starts from 0.0,
    so no node is -0.0 and an absent sibling's 0.0 changes nothing."""
    r = np.random.default_rng(n)
    idx = (np.arange(n) % 2).astype(np.int64)
    idx[::97] = 2
    x = _values(r, n, 9)
    x[idx == 0] = -0.0
    x[idx == 2] = -0.0
    _hold_model(idx, 3, x)


def test_segment_sum_wrapper_on_the_cpu_takes_the_twin():
    r = np.random.default_rng(3)
    idx = torch.from_numpy(r.integers(0, 9, 500))
    x = torch.from_numpy(_values(r, 500, 4))
    before = dict(kern.LAUNCHES)
    np.testing.assert_array_equal(_bits(kern.segment_sum(idx, 9, x)),
                                  _bits(kern.segment_sum_plain(idx, 9, x)))
    assert kern.LAUNCHES == before
    # past one window of the kernel (refused until it summed by windows)
    wide = kern.segment_sum(idx, kern.SEG_WINDOW + 1, x)
    np.testing.assert_array_equal(_bits(wide[:9]), _bits(kern.segment_sum_plain(idx, 9, x)))
    assert not wide[9:].any()
    with pytest.raises(ValueError):
        kern.segment_sum(idx, 0, x)
    with pytest.raises(ValueError):
        kern.segment_sum(idx[:-1], 9, x)
    with pytest.raises(ValueError):
        kern.segment_sum(idx, 9, x.double())


# ---- K1 ----------------------------------------------------------------------

MODS = tetc.MODIFIER_TABLE.astype(np.int64)  # [8, (small, large)]


@pytest.mark.parametrize("table", range(8))
def test_k1_pass1_closed_form_is_the_four_code_minimum(table):
    """Exact integers, exhaustive over u = g - S in [-765, 765]: for the
    twin's q = s2 + 2m*S + 3m^2 - 2m*g over m = +-small, +-large, the
    least is s2 + min(3s^2 - 2s|u|, 3l^2 - 2l|u|)."""
    s, l = MODS[table]
    u = np.arange(-765, 766, dtype=np.int64)
    sb = np.random.default_rng(table).integers(0, 766, u.shape)  # base channel sums
    g = u + sb
    s2 = 3 * 255 * 255
    q = np.stack([s2 + 2 * m * sb + 3 * m * m - 2 * m * g for m in (s, l, -s, -l)])
    closed = s2 + np.minimum(3 * s * s - 2 * s * np.abs(u), 3 * l * l - 2 * l * np.abs(u))
    np.testing.assert_array_equal(q.min(0), closed)


def _pixels_and_bases(seed: int, n: int):
    r = np.random.default_rng(seed)
    p = r.integers(0, 256, (n, 8, 3)).astype(np.int64)
    b = r.integers(0, 256, (n, 3)).astype(np.int64)
    b[: n // 4] = r.integers(60, 196, (n // 4, 3))  # most tables unclipped here
    t = r.integers(0, 8, n)
    return p, b, t


def _twin_code_errors(p, b, t):
    """[n, 4 codes, 8 px]: the twin's sum over channels of
    (clamp(b + m) - p)^2 (etc.py `_best_table_and_codes`)."""
    mods = np.stack([MODS[t, 0], MODS[t, 1], -MODS[t, 0], -MODS[t, 1]], 1)  # [n, 4]
    cand = np.clip(b[:, None, :] + mods[:, :, None], 0, 255)  # [n, 4, 3]
    return ((cand[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1), mods


def test_k1_pass2_unclipped_form():
    """Exact integers: where b_c +- l stays within 0..255 for every
    channel, e = |b - p|^2 + 2m*sum(b - p) + 3m^2 for each of the 4 codes."""
    p, b, t = _pixels_and_bases(1, 4000)
    e, mods = _twin_code_errors(p, b, t)
    lg = MODS[t, 1]
    free = (b.min(1) >= lg) & (b.max(1) <= 255 - lg)
    assert free.sum() > 500
    d2 = ((b[:, None, :] - p) ** 2).sum(-1)  # [n, 8]
    sd = (b[:, None, :] - p).sum(-1)
    form = d2[:, None, :] + 2 * mods[:, :, None] * sd[:, None, :] + 3 * mods[:, :, None] ** 2
    np.testing.assert_array_equal(form[free], e[free])
    assert (form[~free] != e[~free]).any()  # a clipped table needs the other form
    # the kernel's closed form there: the first-minimum code has the sign
    # of u = g - S (+ at u = 0) and the large magnitude iff 2|u| > 3(s + l),
    # and its error is pass 1's term |b - p|^2 + min(3s^2 - 2s|u|, 3l^2 - 2l|u|)
    s_, l_ = MODS[t, 0][:, None], MODS[t, 1][:, None]
    u = -sd
    code = np.where(u < 0, 2, 0) + (2 * np.abs(u) > 3 * (s_ + l_))
    np.testing.assert_array_equal(code[free], e.argmin(1)[free])
    least = d2 + np.minimum(3 * s_ * s_ - 2 * s_ * np.abs(u), 3 * l_ * l_ - 2 * l_ * np.abs(u))
    np.testing.assert_array_equal(least[free], e.min(1)[free])


def test_k1_pass2_clip_aware_form_and_code_keys():
    """Exact integers, every base: with me_c = clamp(b_c + m) - b_c,
    e = |b - p|^2 + |me|^2 + 2 me.(b - p); and the least key 4(e - |b-p|^2)
    + code picks the twin's first-minimum code, with its error."""
    p, b, t = _pixels_and_bases(2, 4000)
    e, mods = _twin_code_errors(p, b, t)
    me = np.clip(b[:, None, :] + mods[:, :, None], 0, 255) - b[:, None, :]  # [n, 4, 3]
    dd = b[:, None, :] - p  # [n, 8, 3]
    d2 = (dd ** 2).sum(-1)
    form = (d2[:, None, :] + (me ** 2).sum(-1)[:, :, None]
            + 2 * np.einsum("nkc,npc->nkp", me, dd))
    np.testing.assert_array_equal(form, e)
    key = 4 * (form - d2[:, None, :]) + np.arange(4)[None, :, None]
    best = key.min(1)
    np.testing.assert_array_equal(best & 3, e.argmin(1))  # first minimum
    np.testing.assert_array_equal((best >> 2) + d2, e.min(1))
    assert (e == e.min(1, keepdims=True)).sum(1).max() > 1  # ties occur


# ---- K5 ----------------------------------------------------------------------

INTEN = np.array(kern.INTEN_TABLES, np.int64)  # [8, (-l, -s, s, l)]

BASE_REGIMES = {
    "mid_range": lambda r, n: r.integers(110, 146, (n, 3)),  # tables 0..6: no code clips
    "near_0": lambda r, n: r.integers(0, 12, (n, 3)),
    "near_255": lambda r, n: r.integers(244, 256, (n, 3)),
    "one_channel_clips": lambda r, n: np.stack(
        [r.integers(110, 146, n), r.choice([0, 3, 250, 255], n), r.integers(110, 146, n)], 1),
}


def _open_codes(base: np.ndarray, m: int):
    """The kernel's test, per block: (+m clips no channel, -m clips none)."""
    return base.max(1) <= 255 - m, base.min(1) >= m


def _k5_model(blocks: np.ndarray, base: np.ndarray, table: int) -> np.ndarray:
    """numpy model of K5's float32 arithmetic for one table, block by
    block as a warp of one: [N] int64."""
    f32 = np.float32
    b = base.astype(f32)
    # a byte v as the float 2^23 + v (its bits under 2^23's exponent), then
    # D = (2*base + 2^24) - 2*(2^23 + v)
    v = (np.uint32(0x4B000000) | blocks.astype(np.uint32)).view(f32)
    D = (f32(-2) * v + (f32(2) * b + f32(16777216))[:, None, :]).astype(f32)  # [N, 16, 3]
    np.testing.assert_array_equal(D, 2 * (base[:, None, :] - blocks.astype(np.int64)))
    S = (D[..., 0] + D[..., 1]) + D[..., 2]
    A = np.abs(S)
    lo, hi = -b, f32(255) - b

    def clipped(m):  # k + a.D, a_c = clamp(base_c + m) - base_c
        a = np.minimum(np.maximum(f32(m), lo), hi)  # [N, 3]
        k = a[:, 2] * a[:, 2] + (a[:, 1] * a[:, 1] + a[:, 0] * a[:, 0])
        return (a[:, None, 2] * D[..., 2] + (a[:, None, 1] * D[..., 1]
                + (a[:, None, 0] * D[..., 0] + k[:, None]))).astype(f32)

    least = []
    for m in INTEN[table, 2:]:  # the pairs +-s, +-l
        q = f32(3 * m * m)
        plus, minus = _open_codes(base, m)
        ep = np.where(plus[:, None], S * f32(m) + q, clipped(m))
        em = np.where(minus[:, None], S * f32(-m) + q, clipped(-m))
        pair = np.where((plus & minus)[:, None], A * f32(-m) + q, np.minimum(ep, em))
        assert pair.dtype == f32
        least.append(pair)
    total = np.minimum(*least).sum(1, dtype=f32)
    return total.astype(np.int64)


@pytest.mark.parametrize("regime", BASE_REGIMES)
@pytest.mark.parametrize("table", range(8))
def test_k5_code_forms_equal_the_twin(table, regime):
    """Exact: the closed form 3m^2 +- m*S of a code that clips no channel,
    the pair's 3m^2 - m*A, and the per-channel form of a clipping code, in
    float32 as the kernel computes them, sum to the twin's int32 column."""
    r = np.random.default_rng(100 * table + len(regime))
    n = 600
    blocks = r.integers(0, 256, (n, 16, 3)).astype(np.uint8)
    blocks[:40] = r.choice([0, 255], (40, 16, 3))  # the largest differences
    base = BASE_REGIMES[regime](r, n).astype(np.int64)
    want = kern.inten_errors_plain(torch.from_numpy(blocks),
                                   torch.from_numpy(base.astype(np.int32)))[:, table].numpy()
    np.testing.assert_array_equal(_k5_model(blocks, base, table), want)
    plus, minus = _open_codes(base, INTEN[table, 3])
    if regime == "mid_range" and table < 7:
        assert (plus & minus).all()  # min(3s^2 - s*A, 3l^2 - l*A) alone
    if regime != "mid_range":
        assert not (plus & minus).all()  # the clip-aware form is taken


@pytest.mark.parametrize("others", [0, 128, 255])
@pytest.mark.parametrize("channel", range(3))
def test_k5_open_code_test_is_the_definition(channel, others):
    """A code m is open for a base when no channel of base + m leaves
    0..255: the kernel tests bmax <= 255 - m for +m and bmin >= m for -m.
    One channel over 0..255, the other two pinned."""
    base = np.full((256, 3), others, np.int64)
    base[:, channel] = np.arange(256)
    for m in INTEN[:, 2:].reshape(-1):
        plus, minus = _open_codes(base, m)
        np.testing.assert_array_equal(plus, (np.clip(base + m, 0, 255) == base + m).all(1))
        np.testing.assert_array_equal(minus, (np.clip(base - m, 0, 255) == base - m).all(1))


def test_inten_errors_wrapper_on_the_cpu_takes_the_twin():
    r = np.random.default_rng(5)
    blocks = torch.from_numpy(r.integers(0, 256, (130, 16, 3)).astype(np.uint8))
    base = torch.from_numpy(r.integers(0, 256, (130, 3)).astype(np.int32))
    before = dict(kern.LAUNCHES)
    assert torch.equal(kern.inten_errors(blocks, base), kern.inten_errors_plain(blocks, base))
    assert kern.LAUNCHES == before
    with pytest.raises(ValueError):
        kern.inten_errors(blocks, base[:-1])
    with pytest.raises(ValueError):
        kern.inten_errors(blocks, base.long())


# ---- K2 ----------------------------------------------------------------------


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (nibble i of sel) of the 8 bytes b:a."""
    both = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    sel = np.broadcast_to(np.asarray(sel, np.uint64), both.shape)
    out = np.zeros(both.shape, np.uint64)
    for i in range(4):
        nib = (sel >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((both >> (np.uint64(8) * nib)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _channel_values(base, sm, lg):
    """The four values of a channel, one per byte in code order
    (+small, +large, -small, -large), clamped to 0..255."""
    vals = [np.clip(base + d, 0, 255).astype(np.uint32) for d in (sm, lg, -sm, -lg)]
    return vals[0] | vals[1] << 8 | vals[2] << 16 | vals[3] << 24


def _k2_block_rows(w1: np.ndarray, w2: np.ndarray) -> np.ndarray:
    """numpy model of one K2 thread per block: word pairs [n] uint32 →
    [n, 4 rows, 3] little-endian uint32 (12 bytes: 4 RGB pixels)."""
    w1, w2 = w1.astype(np.uint32), w2.astype(np.uint32)
    flip, diff = (w1 & 1).astype(bool), (w1 & 2).astype(bool)
    small = np.array([2, 5, 9, 13, 18, 24, 33, 47])
    large = np.array([8, 17, 29, 42, 60, 80, 106, 183])
    t0, t1 = (w1 >> 5) & 7, (w1 >> 2) & 7
    a_top, b_top, a_bot, b_bot = [], [], [], []
    for c in range(3):
        byte = ((w1 >> (24 - 8 * c)) & 0xFF).astype(np.int64)
        m0 = byte >> 3
        dd = ((byte & 7) ^ 4) - 4
        ext5 = lambda x: (x << 3) | (x >> 2)
        ext4 = lambda x: (x << 4) | x
        base0 = np.where(diff, ext5(m0), ext4(byte >> 4))
        base1 = np.where(diff, ext5(np.clip(m0 + dd, 0, 31)), ext4(byte & 15))
        v0 = _channel_values(base0, small[t0], large[t0])
        v1 = _channel_values(base1, small[t1], large[t1])
        a_top.append(v0)
        b_top.append(np.where(flip, v0, v1))
        a_bot.append(np.where(flip, v1, v0))
        b_bot.append(v1)
    rows = np.zeros((len(w1), 4, 3), np.uint32)
    for y in range(4):
        sel = ((w2 >> y) & 0x1111) | ((w2 >> (15 + y)) & 0x2222) | 0x4400
        a, b = (a_top, b_top) if y < 2 else (a_bot, b_bot)
        r4, g4, b4 = (_byte_perm(a[c], b[c], sel) for c in range(3))
        rows[:, y, 0] = _byte_perm(_byte_perm(r4, g4, 0x1040), b4, 0x3410)
        rows[:, y, 1] = _byte_perm(_byte_perm(g4, b4, 0x2051), r4, 0x3610)
        rows[:, y, 2] = _byte_perm(_byte_perm(b4, r4, 0x3072), g4, 0x3710)
    return rows


def _k2_model(words: np.ndarray, l: int, h: int, w: int, threads: int) -> np.ndarray:
    """numpy model of K2's grid and stores: a CTA per run of up to `threads`
    blocks of a block row stages 4 image rows and writes them in 16-byte
    pieces where W % 16 == 0, 4-byte pieces otherwise."""
    nbx = w // 4
    runs = -(-nbx // threads)
    img = np.full(l * h * w * 3, 0xAA, np.uint8)
    rows = _k2_block_rows(words[:, 0].view(np.uint32), words[:, 1].view(np.uint32))
    for cta in range(runs * l * (h // 4)):
        brow, x0 = cta // runs, (cta % runs) * threads
        nbw = min(threads, nbx - x0)
        staged = rows[brow * nbx + x0 : brow * nbx + x0 + nbw]  # [nbw, 4, 3]
        for y in range(4):
            dst = ((brow * 4 + y) * w + x0 * 4) * 3
            piece = 16 if w % 16 == 0 else 4
            assert dst % piece == 0 and (nbw * 12) % piece == 0
            img[dst : dst + nbw * 12] = np.ascontiguousarray(staged[:, y]).view(np.uint8).reshape(-1)
    return img.reshape(l, h, w, 3)


def _k2_words(kind: str, n: int, seed: int) -> np.ndarray:
    rw = np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint32)
    if kind == "differential_overflow":  # 5-bit colors at the ends, deltas of -4 and +3
        ends = np.random.default_rng(seed + 1).choice(
            [0x04, 0x03, 0xFC, 0xFB, 0x0C, 0xF3], (n, 3)).astype(np.uint32)
        rw[:, 0] = (rw[:, 0] & 0xFF) | 2 | ends[:, 0] << 24 | ends[:, 1] << 16 | ends[:, 2] << 8
    elif kind == "individual":
        rw[:, 0] &= ~np.uint32(2)
    return rw.view(np.int32)


@pytest.mark.parametrize("kind", ["random", "differential_overflow", "individual"])
@pytest.mark.parametrize("shape", [(4, 4), (8, 12), (12, 20), (16, 16), (4, 36), (4, 1028)])
def test_k2_row_packing_and_stores_equal_the_twin(shape, kind):
    """Exact bytes: a block decoded as four 12-byte rows of three
    little-endian words each, stored by the 16-byte path (W % 16 == 0) and
    by the 4-byte path, in runs of 256 blocks and of 4 (several runs and a
    short last one at these small widths)."""
    h, w = shape
    l = 2
    words = _k2_words(kind, l * (h // 4) * (w // 4), h * w)
    want = etc_cuda.decode_etc1_images_plain(torch.from_numpy(words), l, h, w).numpy()
    for threads in (256, 4):
        np.testing.assert_array_equal(_k2_model(words, l, h, w, threads), want)


def test_decode_wrapper_on_the_cpu_takes_the_twin():
    words = torch.from_numpy(_k2_words("random", 2 * 3 * 5, 7))
    before = dict(etc_cuda.LAUNCHES)
    assert torch.equal(etc_cuda.decode_etc1_images(words, 2, 12, 20),
                       etc_cuda.decode_etc1_images_plain(words, 2, 12, 20))
    assert etc_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        etc_cuda.decode_etc1_images(words, 2, 12, 24)
    with pytest.raises(ValueError):
        etc_cuda.decode_etc1_images(words, 2, 10, 24)


# ---- the geometry stage: minimum/maximum and K3's index arithmetic -----------

K3_THREADS, K3_PER_THREAD = 256, 4  # kThreads, kPerThread of csrc/geometry.cu
RED_THREADS, RED_UNROLL = 1024, 8  # kRedThreads, kRedUnroll


def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 -> int64 keys in the order fminf/fmaxf take: -0.0 < +0.0."""
    i = a.view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF) - 1, i)


def _minmax_model(x: np.ndarray, mask: np.ndarray):
    """geometry_minmax_kernel: thread t of a row's CTA takes vertices
    t + 1024 * j in steps of 8, a padded vertex as +-FLT_MAX, from
    +-inf; the threads' values are then reduced in the order of the zeros."""
    f, c, n = x.shape
    big = np.finfo(np.float32).max
    mn, mx = np.empty((f, c), np.float32), np.empty((f, c), np.float32)
    steps = -(-n // (RED_THREADS * RED_UNROLL))
    cols = (np.arange(RED_THREADS)[:, None]
            + RED_THREADS * np.arange(steps * RED_UNROLL)[None, :])  # [thread, load]
    inside = cols < n
    at = np.minimum(cols, n - 1)
    for i in range(f):
        for j in range(c):
            v, ok = x[i, j][at], inside & mask[i][at]
            lo = np.where(ok, v, np.where(inside, big, np.inf)).astype(np.float32)
            hi = np.where(ok, v, np.where(inside, -big, -np.inf)).astype(np.float32)
            mn[i, j] = lo.ravel()[np.argmin(_ordered(lo).ravel())]
            mx[i, j] = hi.ravel()[np.argmax(_ordered(hi).ravel())]
    return mn, mx


def _k3_model(x, mask, mn, mx, bits, aligned: bool):
    """quantize_delta_zigzag_kernel, thread by thread: returns (symbols,
    range, how often each output element was stored, the 16-byte stores'
    element offsets)."""
    f, c, n = x.shape
    out = np.full(f * c * n, -77, np.int64)
    stores = np.zeros(f * c * n, np.int32)
    rng = (mx - mn).max(1).astype(np.float32)
    rng = np.where(rng <= 0, np.float32(1), rng)
    inv = np.float32((1 << bits) - 1) / rng  # IEEE float32 quotients
    tiles = -(-(n + 3) // (K3_THREADS * K3_PER_THREAD))
    g = np.arange(tiles * K3_THREADS)
    vector_at = []

    def quantize(v, ok, lo, scale):
        xm = np.where(ok, v - lo, np.float32(0)).astype(np.float32)
        t = xm.astype(np.float64) * np.float64(scale) + 0.5  # one FMA, rounded once
        return np.floor(t.astype(np.float32)).astype(np.int64)

    for row in range(f * c):
        fr, row0 = row // c, row * n
        xr, mr, lo, scale = x.reshape(-1, n)[row], mask[fr], mn.reshape(-1)[row], inv[fr]
        pad = row0 & 3 if aligned else 0
        col0 = g * K3_PER_THREAD - pad
        cols = col0[:, None] + np.arange(K3_PER_THREAD)
        inside = (cols >= 0) & (cols < n)
        at = np.clip(cols, 0, n - 1)
        q = quantize(np.where(inside, xr[at], 0), inside & mr[at], lo, scale)
        prev = np.roll(q[:, -1], 1)  # __shfl_up_sync by 1: the lane below's last q
        seam = g % 32 == 0  # lane 0 keeps its own, then recomputes from memory
        left = col0[seam] - 1
        ok_left = (left >= 0) & (left < n)
        at_left = np.clip(left, 0, n - 1)
        prev[seam] = np.where(ok_left, quantize(xr[at_left], mr[at_left], lo, scale), 0)
        d = q - np.concatenate([prev[:, None], q[:, :-1]], 1)
        sym = ((d << 1) ^ (d >> 63)) & 0xFFFFFFFF
        whole = (col0 >= 0) & (col0 + K3_PER_THREAD <= n)
        vec = whole & aligned
        vector_at.append(row0 + col0[vec])
        for sel in (vec[:, None] & np.ones_like(inside), ~vec[:, None] & inside):
            np.add.at(stores, row0 + cols[sel], 1)
            out[row0 + cols[sel]] = sym[sel]
    return out.reshape(f, c, n), rng, stores, np.concatenate(vector_at)


def _stage_inputs(f, c, n, seed):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(f, c, n)) * 11).astype(np.float32)
    counts = r.integers(1, n + 1, f)
    counts[0] = n
    if f > 1:
        counts[1] = max(1, n - 1)
    if f > 2:
        x[2] = 1.5  # equal values: range 0 -> 1
    if n >= 3:  # both zeros as row 0's minimum, in both orders
        x[0] = np.abs(x[0]) + 1
        x[0, 0, [0, n - 1]] = 0.0, -0.0
        x[0, 1, [0, n - 1]] = -0.0, 0.0
    return x, np.arange(n)[None, :] < counts[:, None]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("f,c,n", [(1, 3, 1), (2, 2, 5), (3, 3, 127), (2, 3, 1021), (3, 2, 1024),
                                   (2, 3, 1025), (3, 3, 2051), (2, 3, 26145)])
def test_geometry_stage_index_arithmetic_equals_the_twin(f, c, n, aligned):
    x, mask = _stage_inputs(f, c, n, seed=n + f)
    syms, mn, rng = pk.geometry_quantize_stage_plain(torch.from_numpy(x), torch.from_numpy(mask), 11)
    m_mn, m_mx = _minmax_model(x, mask)
    np.testing.assert_array_equal(_bits(m_mn), _bits(mn))
    got, m_rng, stores, vector_at = _k3_model(x, mask, m_mn, m_mx, 11, aligned)
    np.testing.assert_array_equal(_bits(m_rng), _bits(rng))
    np.testing.assert_array_equal(got, syms.numpy().view(np.uint32).astype(np.int64))
    assert (stores == 1).all()  # every symbol stored once, none outside its row
    assert (vector_at % 4 == 0).all()  # a 16-byte store lies on the buffer's 16-byte grid
    if aligned and n >= 8:
        assert len(vector_at) >= f * c * (n // 4 - 1)  # all but a row's head and tail
    else:
        assert len(vector_at) == 0 or aligned


def test_geometry_stage_wrapper_on_the_cpu_takes_the_twin():
    x, mask = _stage_inputs(2, 3, 300, seed=5)
    before = dict(pk.LAUNCHES)
    got = pk.geometry_quantize_stage(torch.from_numpy(x), torch.from_numpy(mask), 11)
    want = pk.geometry_quantize_stage_plain(torch.from_numpy(x), torch.from_numpy(mask), 11)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and pk.LAUNCHES == before


# ---- K7: the rate sweep's frame stage ------------------------------------------

K7_PER = 4  # entries a thread prices (kSweepPer)


def _k7_inputs(nby, nbx, e, seed, dup=False, flat="mixed", prev=True):
    """One frame for K7: blocks decoded from random (entry, selector) pairs
    plus noise, a palette of e entries (with `dup`, its second half repeats
    its first: ties), 8 selector rows of which row 0 is uniform
    (`flat`: "mixed", "all" or "none" of the blocks on it), random incoming
    entries, and a previous pair that is the true one for half the blocks."""
    r = np.random.default_rng(seed)
    nb = nby * nbx
    c5 = r.integers(0, 32, (e, 3))
    inten = r.integers(0, 8, e)
    if dup and e > 1:
        c5[e - e // 2:], inten[e - e // 2:] = c5[:e // 2], inten[:e // 2]
    base = ((c5 << 3) | (c5 >> 2)).astype(np.int32)
    mods = INTEN[inten].astype(np.int32)
    sel_cb = r.integers(0, 4, (8, 16)).astype(np.int32)
    sel_cb[0] = 2
    true_ep = r.integers(0, e, nb)
    lo = {"mixed": 0, "all": 0, "none": 1}[flat]
    true_sel = r.integers(lo, 1 if flat == "all" else 8, nb)
    col = np.clip(base[true_ep][:, None, :] + mods[true_ep][np.arange(nb)[:, None],
                                                        sel_cb[true_sel]][:, :, None], 0, 255)
    blocks = np.clip(col + r.integers(-3, 4, col.shape), 0, 255).astype(np.uint8)
    ep = np.where(r.random(nb) < 0.3, true_ep, r.integers(0, e, nb)).astype(np.int32)
    sel = true_sel.astype(np.int32)
    half = r.random(nb) < 0.5
    other_sel = r.integers(lo, 1 if flat == "all" else 8, nb)
    pair = (np.where(half, true_ep, r.integers(0, e, nb)).astype(np.int32),
            np.where(half, true_sel, other_sel).astype(np.int32))
    return blocks, base, mods, sel_cb, ep, sel, pair if prev else None


def _ordered(cost: np.ndarray) -> np.ndarray:
    """ordered_bits: float32 bits as uint32 in the floats' order."""
    b = cost.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def _k7_pair_error(blocks, base, mods, sel_cb, ep, sel) -> np.ndarray:
    """pair_error: per pixel and channel (px - clamp(base + mod)) ^ 2, int."""
    mod = mods[ep[:, None], sel_cb[sel]]  # [nb, 16]
    d = blocks.astype(np.int64) - np.clip(base[ep][:, None, :] + mod[:, :, None], 0, 255)
    return (d * d).sum((1, 2))


def _k7_model(blocks, base, mods, sel_cb, bits, ep, sel, prev, s0_index, lam, lam_cr, nbx):
    """`rate_sweep_frame_kernel` written out in numpy: the rows go together,
    the columns in order; threads = 32 * ceil(E / 128), thread t holding
    entries t + j * threads (j < 4); past 2,048 entries (the wide path) 512
    threads, thread t pricing every entry t + j * 512 in turn."""
    e, nb = len(base), len(ep)
    nby = nb // nbx
    threads = 32 * -(-e // (32 * K7_PER)) if e <= kern.SWEEP_REG_MAX_E else 512
    per = K7_PER if e <= kern.SWEEP_REG_MAX_E else -(-e // threads)
    lam, lam_cr = np.float32(lam), np.float32(lam_cr)
    # the thread's entries in registers: col(k, c) as bytes (12, code-major),
    # |col(k, c)|^2 (4)
    col = np.clip(base[:, None, :].astype(np.int64) + mods[:, :, None], 0, 255).reshape(e, 12)
    sq = (col.reshape(e, 4, 3) ** 2).sum(2)
    # the prologue: per-code pixel sums as unsigned 16-bit halves, counts,
    # |p|^2, e_prev and the CR costs
    px = blocks.astype(np.int64)
    codes = sel_cb[sel]  # [nb, 16]
    sums = np.stack([(px * (codes == j)[:, :, None]).sum(1) for j in range(4)], 1).reshape(nb, 12)
    assert sums.max() < 1 << 16 and col.max() < 1 << 8  # the __dp2a operands
    n = (codes[:, :, None] == np.arange(4)).sum(1)
    p_sq = (px * px).sum((1, 2))
    has_prev = prev is not None
    pe, ps = prev if has_prev else (np.zeros(nb, np.int64), np.zeros(nb, np.int64))
    e_prev = (_k7_pair_error(blocks, base, mods, sel_cb, pe, ps) if has_prev
              else np.zeros(nb)).astype(np.float32)
    cost_cr = (e_prev + np.float32(lam * np.float32(0.5)) if has_prev
               else np.full(nb, 3.0e38, np.float32))
    # int32 errors: |p|^2 + n . |col|^2, less twice the six two-way dot
    # products of (S_2q, S_2q+1) with (col_2q, col_2q+1)
    acc = p_sq[:, None] + n @ sq.T  # [nb, E]
    dot = sum(sums[:, None, v] * col[None, :, v] + sums[:, None, v + 1] * col[None, :, v + 1]
              for v in range(0, 12, 2))
    assert acc.max() < 1 << 31 and dot.max() < 1 << 31
    errs = (acc - 2 * dot).astype(np.float32)
    assert (errs.astype(np.int64) == acc - 2 * dot).all()  # exact in float32
    grid = lambda a: a.reshape(nby, nbx, *a.shape[1:])  # noqa: E731
    errs, e_cr, pe_g = grid(errs), grid(cost_cr), grid(pe)
    ep_g = grid(ep)
    above = np.concatenate([ep_g[:1], ep_g[:-1]])
    slots = np.arange(per * threads)  # slot t + j * threads is entry t + j * threads
    live = slots < e
    left = ep_g[:, 0].astype(np.int64)
    choice, cr_all = np.zeros((nby, nbx), np.int64), np.zeros((nby, nbx), bool)
    for c in range(nbx):
        origin = left % e
        dm = slots[None, :] - origin[:, None]
        dm = np.where(dm < 0, dm + e, dm)
        b = bits[np.where(live, dm, 0)]
        b = np.where(slots[None, :] == above[:, c:c + 1], np.minimum(b, np.float32(1.4)), b)
        err_c = np.zeros((nby, len(slots)), np.float32)
        err_c[:, :e] = errs[:, c]
        cost = fma_f32(float(lam), torch.from_numpy(b), torch.from_numpy(err_c)).numpy()
        cost = np.where(live, cost, np.float32(np.inf))
        # a thread's first minimum over its ascending entries, then the warp's
        # and the CTA's: the least ordered cost, then the least entry among
        # the lanes that hold it (two redux.sync minima each time)
        per_thread = cost.reshape(nby, per, threads)
        jbest = np.argmin(per_thread, 1)  # first minimum: the lowest j
        key = _ordered(np.take_along_axis(per_thread, jbest[:, None, :], 1)[:, 0])
        entry = (jbest * threads + np.arange(threads)).astype(np.uint64)

        def first_min(key, entry):  # over the last axis
            least = key.min(-1, keepdims=True)
            return least[..., 0], np.where(key == least, entry, np.uint64(0xFFFFFFFF)).min(-1)

        warp_key, warp_entry = first_min(key.reshape(nby, -1, 32), entry.reshape(nby, -1, 32))
        best_key, best_entry = first_min(warp_key, warp_entry)
        best_cost = best_key.astype(np.uint32)
        best_cost = np.where(best_cost & 0x80000000, best_cost & 0x7FFFFFFF,
                             ~best_cost).astype(np.uint32).view(np.float32)
        cr = e_cr[:, c] <= best_cost  # CR wins ties
        left = np.where(cr, pe_g[:, c], best_entry.astype(np.int64))
        choice[:, c], cr_all[:, c] = left, cr
    # the epilogue: CR takes the previous selector, patterned blocks the CR snap
    new_ep, cr = choice.reshape(nb), cr_all.reshape(nb)
    new_sel = np.where(cr, ps, sel)
    if has_prev:
        e_new = _k7_pair_error(blocks, base, mods, sel_cb, new_ep, new_sel).astype(np.float32)
        gate = fma_f32(float(lam_cr), torch.from_numpy(e_new), 64.0).numpy()
        snap = (sel != s0_index) & (e_prev <= gate)
        new_ep, new_sel = np.where(snap, pe, new_ep), np.where(snap, ps, new_sel)
    return new_ep, new_sel


K7_CASES = {
    "random": dict(nby=3, nbx=7, e=256, seed=1),
    "ties_dup_lam0": dict(nby=4, nbx=5, e=256, seed=2, dup=True, lam=0.0),
    "ties_dup": dict(nby=4, nbx=5, e=130, seed=3, dup=True),
    "e1": dict(nby=2, nbx=6, e=1, seed=4),
    "e17": dict(nby=3, nbx=4, e=17, seed=5),
    "e2048": dict(nby=2, nbx=3, e=2048, seed=6),
    "e2049_wide": dict(nby=2, nbx=3, e=2049, seed=12),
    "e3000_wide_ties": dict(nby=3, nbx=4, e=3000, seed=13, dup=True),
    "one_column": dict(nby=6, nbx=1, e=64, seed=7),
    "frame0_or_break": dict(nby=3, nbx=5, e=200, seed=8, prev=False),
    "all_flat": dict(nby=3, nbx=5, e=96, seed=9, flat="all"),
    "no_flat": dict(nby=3, nbx=5, e=96, seed=10, flat="none"),
    "high_lam": dict(nby=3, nbx=6, e=300, seed=11, lam=4000.0),
}


@pytest.mark.parametrize("case", K7_CASES)
def test_k7_frame_design_equals_the_twin(case):
    """The kernel's design bit for bit against `rate_sweep_frame_plain`:
    the prologue's features and e_prev, int32 errors from 16 x 8-bit dot
    products, a thread's first minimum, the warps' and the CTA's minima of
    (ordered cost, entry) with CR winning ties, the snap's gate."""
    kw = dict(K7_CASES[case])
    lam = kw.pop("lam", 60.0)
    blocks, base, mods, sel_cb, ep, sel, prev = _k7_inputs(**kw)
    nbx = kw["nbx"]
    bits = tenc.sweep_bits_table(len(base))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    want = kern.rate_sweep_frame_plain(t(blocks), t(base), t(mods), t(sel_cb), t(bits), t(ep),
                                       t(sel), None if prev is None else tuple(map(t, prev)),
                                       0, lam, 1.5, nbx)
    got = _k7_model(blocks, base, mods, sel_cb, bits, ep, sel, prev, 0, lam, 1.5, nbx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    # the frame exercises what it is named for
    if prev is not None and len(base) > 1:
        assert (got[0] == prev[0]).any() and (got[0] != prev[0]).any()
    p_sq, feat, mat = kern.sweep_features(t(blocks), t(base), t(mods), t(sel_cb), t(sel))
    err = (p_sq[:, None] + feat.double() @ mat.double().T).numpy()
    assert (err >= 0).all() and err.max() < 1 << 24


@pytest.mark.parametrize("x", [0.0, 1.0, 1.5, 3.0e38, np.inf, -2.0, 5e-39])
def test_k7_ordered_key_keeps_the_float_order(x):
    """ordered_bits and from_ordered: a round trip, and the order of the
    floats is that of the integers."""
    ref = np.float32([-np.inf, -1.0, -0.5, 0.0, 0.25, 1.0, 7.0, 3.0e38, np.inf])
    u = _ordered(np.float32([x]))[0]
    back = np.uint32(u & 0x7FFFFFFF) if u & 0x80000000 else np.uint32(~u & 0xFFFFFFFF)
    assert back.view(np.float32) == np.float32(x)
    assert (np.argsort(_ordered(ref), kind="stable") == np.arange(len(ref))).all()


def test_rate_sweep_frame_wrapper_on_the_cpu_takes_the_twin():
    blocks, base, mods, sel_cb, ep, sel, prev = _k7_inputs(2, 4, 40, seed=12)
    t = torch.from_numpy
    args = (t(blocks), t(base), t(mods), t(sel_cb), t(tenc.sweep_bits_table(40)), t(ep), t(sel),
            (t(prev[0]), t(prev[1])), 0, 60.0, 1.5, 4)
    before = dict(kern.LAUNCHES)
    got = kern.rate_sweep_frame(*args)
    want = kern.rate_sweep_frame_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and kern.LAUNCHES == before


# ---- K8: the .drc window's unpack, dequantize and normals ---------------------------

_DRC_SRC = (Path(dd.__file__).resolve().parents[1] / "csrc" / "drc.cu").read_text()
K8_VALUES = int(re.search(r"constexpr int kValues = (\d+);", _DRC_SRC).group(1))
K8_META_CAP = int(re.search(r"constexpr int kMetaCap = (\d+);", _DRC_SRC).group(1))


def _k8_window(attrs, f: int, nmax: int, seed: int, lead: int = 0, pad: int = 0,
               maxv=(254.0, 0.0, -1.0)):
    """A packed window: `lead` bytes before its first attribute, then the
    attributes [(kind, mode, nc)] (signed values at both extremes in modes
    16 and 32), `pad` bytes, the metadata 4-aligned at its tail. Returns
    (packed uint8 array, specs, meta_off, meta_len)."""
    r = np.random.default_rng(seed)
    chunks, metas, specs = [np.full(lead, 0xA5, np.uint8)], [], []
    off, moff = lead, 0
    for t, (kind, mode, nc) in enumerate(attrs):
        n = f * nmax * nc
        hi = 1 << (mode - 1) if mode in (16, 32) else 1 << mode
        lo = -hi if mode in (16, 32) else 0
        ints = r.integers(lo, hi, n, dtype=np.int64)
        ints[:2] = (lo, hi - 1)[:min(n, 2)]
        meta = (np.concatenate([r.normal(size=f * nc) * 5, r.uniform(1e-4, 1e-2, f)])
                if kind == 1 else np.resize(np.asarray(maxv, np.float64), f))
        specs.append((t, kind, mode, f, nmax, nc, off, len(meta), moff))
        chunks.append(dd._pack_host(ints, mode))
        metas.append(meta.astype(np.float32))
        off += len(chunks[-1])
        moff += len(meta)
    pad += (-(off + pad)) % 4
    meta_all = np.concatenate(metas)
    packed = np.concatenate(chunks + [np.zeros(pad, np.uint8), meta_all.view(np.uint8)])
    return packed, tuple(specs), off + pad, len(meta_all)


def _k8_unpack(buf: np.ndarray, sb: np.ndarray, mode: int, run: int) -> np.ndarray:
    """[runs, run] values cut from the little-endian bit stream whose byte 0
    is buf[sb] (a run's words realigned by the kernel's funnel shifts)."""
    out = np.empty((len(sb), run), np.int64)
    for j in range(run):
        byte, shift = divmod(j * mode, 8)
        word = np.zeros(len(sb), np.uint64)
        for k in range(5):  # 40 bits hold any value's bits
            word |= buf[sb + byte + k].astype(np.uint64) << np.uint64(8 * k)
        v = (word >> np.uint64(shift)).astype(np.int64) & ((1 << mode) - 1)
        if mode in (16, 32):
            v = v - ((v >> (mode - 1)) << mode)
        out[:, j] = v
    return out


def _k8_model(packed: np.ndarray, specs, meta_off: int, base: int):
    """numpy model of drc_fused_batch_kernel on a window whose first byte
    lies `base` bytes past a 16-byte boundary: per CTA the first frame,
    offset and one-frame flag (64-bit), the staged metadata slice (or
    global past the cap), the bytes staged from the 16-byte boundary at or
    below the CTA's first byte (a piece wholly inside the window in one
    16-byte load, else its run's bytes one by one), then runs of 4 values
    (kind 1) or 4 vertices (kind 2) with the carried component, vertex and
    frame. Returns (outputs per spec, stats); asserts that no load leaves
    the window, that every output float is stored once and that each
    16-byte store is 16-byte aligned."""
    size = len(packed)
    meta = packed[meta_off:].view(np.float32)
    widths = [nc if kind == 1 else 3 for _t, kind, _m, _f, _n, nc, *_r in specs]
    offs, total = [], 0
    for (_t, _k, _m, f, nmax, *_r), w in zip(specs, widths):
        offs.append(total)
        total += -(-f * nmax * w // 4) * 4
    stores = np.zeros(total, np.int64)
    stats = {"vector_loads": 0, "byte_pieces": 0, "tail_byte_piece": False,
             "one_frame_ctas": 0, "crossing_ctas": 0, "staged": 0, "global": 0}
    jobs1, jobs2 = [], []  # (out index, q, scale, min), (out index, qu, qv, maxv)
    for (_t, kind, mode, f, nmax, nc, off, _ml, moff), oo in zip(specs, offs):
        n = f * nmax * nc
        m = meta[moff:]
        for v0 in range(0, n, K8_VALUES):
            nv = min(K8_VALUES, n - v0)
            # warp 0: frames and metadata
            per, u0, nu = (nmax * nc, v0, nv) if kind == 1 else (nmax, v0 // 2, nv // 2)
            fi0, fi1 = u0 // per, (u0 + nu - 1) // per
            nf = fi1 - fi0 + 1
            lo = m[fi0 * nc:(fi1 + 1) * nc] if kind == 1 else m[fi0:fi1 + 1]
            hi = m[f * nc + fi0:f * nc + fi1 + 1] if kind == 1 else np.zeros(0, np.float32)
            stats["staged" if len(lo) + len(hi) <= K8_META_CAP else "global"] += 1
            r0, one = u0 - fi0 * per, fi0 == fi1
            stats["one_frame_ctas" if one else "crossing_ctas"] += 1
            # staging
            b0 = off + v0 * mode // 8
            span = dd._packed_nbytes(nv, mode)
            first = base + b0
            head = first % 16
            pieces = (head + span + 15) // 16
            buf = np.full(pieces * 16 + 64, 0xCD, np.uint8)  # unstaged bytes: garbage
            for k in range(pieces):
                a = first - head + 16 * k - base  # window byte of the piece's first
                if a >= 0 and a + 16 <= size:
                    buf[16 * k:16 * k + 16] = packed[a:a + 16]
                    stats["vector_loads"] += 1
                else:
                    stats["byte_pieces"] += 1
                    stats["tail_byte_piece"] |= a + 16 > size
                    for b in range(16):
                        if b0 <= a + b < b0 + span:
                            assert 0 <= a + b < size
                            buf[16 * k + b] = packed[a + b]
            # runs
            run = 4 if kind == 1 else 8
            units = nv if kind == 1 else nv // 2  # values, or vertices
            lu = np.arange(0, units, 4)  # each run's first value (vertex), CTA-local
            valid = np.minimum(4, units - lu)
            q = _k8_unpack(buf, head + lu * (run // 4) * mode // 8, mode, run)
            rr, fl = r0 + lu, np.zeros(len(lu), np.int64)
            if not one:
                fv = nmax * nc if kind == 1 else nmax
                fl = rr // fv
                rr = rr - fl * fv
            if kind == 1:
                vert, c = rr // nc, rr % nc
                mi = fl * nc + c
            else:
                vert, c, mi = rr, 0, 0
            for j in range(4):
                live = j < valid
                if j > 0:  # carry: component (kind 1), vertex, frame
                    if kind == 1:
                        mi = mi + 1
                        c = c + 1
                        wrap = live & (c == nc)
                        c = np.where(wrap, 0, c)
                        mi = np.where(wrap, mi - nc, mi)
                        cross = wrap & (vert + 1 == nmax) & (not one)
                        vert = np.where(wrap, np.where(cross, 0, vert + 1), vert)
                        mi = np.where(cross, mi + nc, mi)
                    else:
                        cross = live & (vert + 1 == nmax) & (not one)
                        vert = np.where(cross, 0, vert + 1)
                    fl = np.where(cross, fl + 1, fl)
                at = lu[live] + j
                if kind == 1:
                    jobs1.append((oo + v0 + at, q[live, j], hi[fl[live]], lo[mi[live]]))
                else:
                    jobs2.append((oo + 3 * (u0 + at), q[live, 2 * j], q[live, 2 * j + 1],
                                  lo[fl[live]]))
            # stores: whole runs as 16-byte stores, the rest one float at a time
            w = 1 if kind == 1 else 3
            for start, ok in zip(oo + w * (u0 + lu), valid):
                stores[start:start + w * ok] += 1
                if ok == 4:
                    assert start % 4 == 0
    assert (stores <= 1).all()
    out = np.zeros(total, np.float32)
    if jobs1:
        at, q, scale, mn = (np.concatenate(x) for x in zip(*jobs1))
        out[at] = dd.dequantize(torch.from_numpy(q.reshape(-1, 1, 1)),
                                torch.from_numpy(mn.reshape(-1, 1)),
                                torch.from_numpy(scale)).numpy().reshape(-1)
    if jobs2:
        at, qu, qv, mv = (np.concatenate(x) for x in zip(*jobs2))
        st = torch.from_numpy(np.stack([qu, qv], -1).reshape(-1, 1, 2))
        nrm = dd.oct_to_unit(st, torch.from_numpy(mv)).numpy().reshape(-1, 3)
        for k in range(3):
            out[at + k] = nrm[:, k]
    outs = []
    for (_t, _k, _m, f, nmax, *_r), w, oo in zip(specs, widths, offs):
        assert (stores[oo:oo + f * nmax * w] == 1).all()  # each float stored once
        outs.append(out[oo:oo + f * nmax * w].reshape(f, nmax, w))
    return outs, offs, total, stats


def _hold_k8_model(packed, specs, mo, ml, base):
    got, offs, total, stats = _k8_model(packed, specs, mo, base)
    want = dd.fused_batch_plain(torch.from_numpy(packed), specs, mo, ml)
    for g, w in zip(got, want, strict=True):
        w = w.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(_bits(g[~np.isnan(g)]), _bits(w[~np.isnan(w)]))
    plan = dd._plan(specs, mo, ml)  # the wrapper's padded layout is the model's
    assert [at for _s, _st, at in plan.views] == offs and plan.total == total
    assert all(at % 4 == 0 for at in offs)
    return stats


K8_CASES = ([(1, mode, nc, nmax) for mode in (8, 10, 12, 16, 32) for nc in (1, 2, 3, 4)
             for nmax in (1, 3, 1001, 4096, 4097)]
            + [(2, mode, 2, nmax) for mode in (8, 10, 12, 16, 32)
               for nmax in (1, 3, 1001, 4096, 4097)])


@pytest.mark.parametrize("kind,mode,nc,nmax", K8_CASES)
def test_k8_design_equals_the_twin(kind, mode, nc, nmax):
    """Every mode and kind, nc 1-4, frames of 1, 3, 1,001, 4,096 and 4,097
    vertices (CTAs that cross frames: all but 4,096), the attribute at an
    odd residue mod 16 and the window off a 16-byte boundary."""
    lead = (mode * 7 + nc * 3 + nmax) % 16
    packed, specs, mo, ml = _k8_window([(kind, mode, nc)], 3, nmax, seed=lead + mode + nmax,
                                       lead=lead)
    base = (4 - mo) % 4 + 4 * (nmax % 4)  # the metadata stays 4-byte aligned
    stats = _hold_k8_model(packed, specs, mo, ml, base)
    fv = nmax * nc if kind == 1 else nmax
    assert stats["crossing_ctas"] == 0 or fv % (K8_VALUES if kind == 1 else K8_VALUES // 2)


@pytest.mark.parametrize("lead", range(16))
def test_k8_design_with_four_attributes_at_every_offset_residue(lead):
    """Four attributes in one window (the table's most), the first at each
    residue mod 16, the window at two bases; every CTA of the liam-scale
    bucket lies in one frame."""
    packed, specs, mo, ml = _k8_window([(1, 12, 3), (1, 10, 2), (2, 8, 2), (1, 16, 4)], 2, 4096,
                                       seed=lead, lead=lead, pad=lead % 4)
    for base in ((4 - mo) % 4, (4 - mo) % 4 + 8):
        stats = _hold_k8_model(packed, specs, mo, ml, base)
        assert stats["crossing_ctas"] == 0 and stats["global"] == 0


@pytest.mark.parametrize("base", range(0, 16, 4))
@pytest.mark.parametrize("nmax", [1001, 1003])
def test_k8_design_reads_nothing_past_a_window_that_ends_in_its_metadata(nmax, base):
    """Normals of one frame: 4 bytes of metadata after the attribute, so the
    16-byte piece of its last bytes reaches past the window for some bases
    and is read byte by byte there (the model asserts every load inside)."""
    packed, specs, mo, ml = _k8_window([(2, 8, 2)], 1, nmax, seed=nmax + base, maxv=(254.0,))
    stats = _hold_k8_model(packed, specs, mo, ml, base)
    end = base + dd._packed_nbytes(2 * nmax, 8)  # address just past the attribute
    assert stats["tail_byte_piece"] == (-(-end // 16) * 16 > base + len(packed))


def test_k8_design_stages_metadata_and_leaves_it_past_the_cap():
    """Frames of one vertex: a CTA touches hundreds of frames, whose mins
    and scales pass the staging cap; frames of 3 vertices fit under it."""
    packed, specs, mo, ml = _k8_window([(1, 12, 3)], 2048, 1, seed=1)
    assert _hold_k8_model(packed, specs, mo, ml, 0)["global"] > 0
    packed, specs, mo, ml = _k8_window([(1, 12, 3)], 700, 3, seed=2)
    stats = _hold_k8_model(packed, specs, mo, ml, 0)
    assert stats["global"] == 0 and stats["crossing_ctas"] > 0


def test_fused_batch_caches_its_plan_and_still_checks_each_window():
    """A cache hit returns the same plan; a window one byte short of a
    cached key still raises; the cache keeps at most PLANS_MAX keys."""
    packed, specs, mo, ml = _k8_window([(1, 12, 3), (2, 8, 2)], 2, 7, seed=3)
    t = torch.from_numpy(packed)
    first = dd.fused_batch(t, specs, mo, ml)
    assert dd._plan(specs, mo, ml) is dd._plan(list(specs), mo, ml)
    for g, w in zip(first, dd.fused_batch_plain(t, specs, mo, ml), strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    with pytest.raises(ValueError, match="outside a window"):
        dd.fused_batch(t[:-1], specs, mo, ml)
    short = (specs[0], specs[1][:6] + (len(packed),) + specs[1][7:])
    with pytest.raises(ValueError, match="outside a window"):
        dd.fused_batch(t, short, mo, ml)
    for k in range(dd.PLANS_MAX + 5):
        dd._plan(specs, mo + 4 * k, ml)
    assert len(dd._PLANS) == dd.PLANS_MAX
