"""The arithmetic of the segment-sum kernel (`csrc/etc1s.cu`), on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain twins there). What can be
checked here is that the decompositions they compute are the twins'
functions, bit for bit:

  - the segment-sum kernel (`csrc/etc1s.cu`: pass 1 over chunks of 16
    tiles, each tile's keys sorted by a warp, a walk per (run, columns)
    and per (present segment, columns); pass 2 over the chunk partials)
    against `segment_sum_plain`, through a numpy model of the two passes;
    past 2,048 segments its sparse path (each chunk's roots only for the
    segments it holds, found by presence words and slot bases; pass 2's
    counter over the present chunks, absent ones identities), and that
    model taken every chunk at once held to the one a chunk at a time.

Every comparison here is exact: integers compared as integers, floats
compared bit for bit (`view(int32)`), no tolerance.
"""

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from torch_design_models import (CHUNK, _bits, _chunk_roots, _pass1_roots, _sparse_model,
                                 _sparse_model_loop, _sparse_tree, _values)
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern


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
    """numpy model of the segment-sum kernel's two passes up to one window
    of 2,048 segments, as `csrc/etc1s.cu` computes them.

    Pass 1, one CTA per chunk of 1,024 rows (`_chunk_roots`), written as
    the chunk's dense [k, D] partial: 0.0 for a segment the chunk does not
    hold. Pass 2: the tree over the chunk partials in pieces of 256
    leaves, then the piece roots."""
    n, d = x.shape
    m = max(1, -(-n // CHUNK))
    part = np.zeros((m, k, d), np.float32)  # 0.0 for the segments a chunk does not hold
    for ch in range(m):
        segs, roots = _chunk_roots(idx, x, ch)
        part[ch, segs] = roots
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


# ---- the segment sum past one window: the sparse path ---------------------------


def _hold_sparse_model(idx: np.ndarray, k: int, x: np.ndarray) -> None:
    want = kern.segment_sum_plain(torch.from_numpy(idx), k, torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(_sparse_model(idx, k, x)), _bits(want))


@pytest.mark.parametrize("kind", ["random", "skewed", "sorted"])
@pytest.mark.parametrize("d", [9, 64])
@pytest.mark.parametrize("k", [2049, 4096, 16128])
@pytest.mark.parametrize("n", [1025, 3077, 5000])
def test_sparse_segment_sum_design_matches_segment_sum_plain(n, k, d, kind):
    """Bit-exact past one window: each chunk's roots of the segments it
    holds, found by presence words and slot bases, added over the present
    chunks only, equal the twin's tree over every chunk; empty segments,
    -0.0 values and n off the 1,024-row chunk grid included."""
    r = np.random.default_rng(n * 7 + k + d)
    idx = r.integers(0, k, n)
    if kind == "skewed":
        idx = np.where(r.random(n) < 0.9, k - 1, idx)
    elif kind == "sorted":
        idx = np.sort(idx)
    _hold_sparse_model(idx, k, _values(r, n, d))


@pytest.mark.parametrize("k", [2049, 4096])
def test_sparse_segment_sum_design_over_many_chunks(k):
    """70,001 rows (69 chunks): absent stretches that fold pending nodes
    from several levels, a segment in one chunk only, and one in every."""
    r = np.random.default_rng(k)
    n = 70001
    idx = r.integers(0, k, n)
    idx[::1000] = 0  # in every chunk
    idx[idx == 1] = 2
    idx[50000] = 1  # in one chunk
    _hold_sparse_model(idx, k, _values(r, n, 9))


@pytest.mark.parametrize("n", [64, 3000])
def test_sparse_segment_sum_design_with_negative_zeros(n):
    """A segment of -0.0 rows in every tile and one whose only rows are
    -0.0 in a single chunk: roots start from 0.0, so no node is -0.0 and
    an absent chunk's identity changes nothing."""
    r = np.random.default_rng(n)
    k = 4096
    idx = (np.arange(n) % 2).astype(np.int64)
    idx[::97] = 2
    idx[-5:] = 4095
    x = _values(r, n, 9)
    x[(idx == 0) | (idx == 2) | (idx == 4095)] = -0.0
    _hold_sparse_model(idx, k, x)


@pytest.mark.parametrize("k", [2049, 16128])
def test_sparse_pass_1_root_of_a_one_tile_segment_is_its_run_sum(k):
    """The sparse pass 1's shortcut: a segment that sits in one tile of the
    chunk has for root the in-order sum of its rows from 0.0 (the 16-tile
    walk adds only 0.0 beside it), -0.0 rows included."""
    r = np.random.default_rng(k)
    n, d = 3000, 9
    idx = r.integers(0, k, n)
    x = _values(r, n, d)
    for ch in range(-(-n // CHUNK)):
        segs, roots = _chunk_roots(idx, x, ch)
        rows = np.arange(ch * CHUNK, min(n, (ch + 1) * CHUNK))
        for seg, root in zip(segs, roots):
            mine = rows[idx[rows] == seg]
            if len(np.unique(mine // kern.SEG_TILE)) == 1:
                acc = np.zeros(d, np.float32)
                for i in mine:
                    acc = acc + x[i]
                np.testing.assert_array_equal(_bits(root), _bits(acc))


@pytest.mark.parametrize("m", [1, 2, 3, 5, 64, 257, 1000, 16384])
@pytest.mark.parametrize("density", [0.02, 0.3, 1.0])
def test_sparse_tree_over_present_chunks_is_the_twins_tree(m, density):
    """The counter with skipped absent leaves against the complete binary
    tree over m leaves padded with 0.0 (the twin's pairwise levels), for
    every present pattern: first, last, lone and dense chunks, up to the
    2^14 chunks of 2^24 rows."""
    r = np.random.default_rng(m * 10 + int(density * 10))
    k, d = 24, 3
    present = r.random((m, k)) < density
    present[0, 0] = present[-1, 1] = present[m // 2, 2] = True
    present[:, 3] = False
    vals = _values(r, m * k, d).reshape(m, k, d)
    vals[..., 0] = np.abs(vals[..., 0])  # roots are sums from 0.0: never -0.0
    vals[vals == 0] = 0.0
    c_of = [np.flatnonzero(present[c]) for c in range(m)]
    got = _sparse_tree(c_of, [vals[c, present[c]] for c in range(m)], k, d)
    leaves = list(np.where(present[..., None], vals, np.float32(0.0)))
    while len(leaves) > 1:
        if len(leaves) % 2:
            leaves.append(np.zeros((k, d), np.float32))
        leaves = [leaves[i] + leaves[i + 1] for i in range(0, len(leaves), 2)]
    np.testing.assert_array_equal(_bits(got), _bits(leaves[0]))


def test_sparse_segment_sum_scratch_holds_roots_and_presence():
    """The wrapper's scratch: dense partials up to one window; past it the
    roots of at most min(k, 1,024) segments a chunk, each column group of
    at most 16 at a pitch of 4 * ceil(columns / 4) floats, then a presence
    word and a slot base per 32 segments a chunk."""
    assert kern._segment_sum_scratch(3000, 64, 2048) == 3 * 2048 * 64
    assert kern._segment_sum_scratch(327680, 64, 16128) == 320 * 1024 * 64 + 2 * 320 * 504
    assert kern._segment_sum_scratch(0, 9, 4096) == 1 * 1024 * 12 + 2 * 128
    assert kern._segment_sum_scratch(5, 33, 70000) == 1 * 1024 * 3 * 12 + 2 * 2048


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


# ---- the sparse model taken every chunk at once, against its loop --------------


@pytest.mark.parametrize("kind", ["random", "all_equal"])
@pytest.mark.parametrize("k,n,d", [(2049, 3077, 9), (2049, 5000, 64), (4096, 70001, 9),
                                   (16128, 3077, 33)])
def test_sparse_model_equals_its_loop(k, n, d, kind):
    """Pass 1 on every chunk at once (`_pass1_roots`) gives each chunk's
    present segments and roots as `_chunk_roots` does chunk by chunk, bit
    for bit, and `_sparse_model` the sums of `_sparse_model_loop`;
    `all_equal` puts every row in the last segment."""
    r = np.random.default_rng(k + n + d)
    idx = np.full(n, k - 1) if kind == "all_equal" else r.integers(0, k, n)
    x = _values(r, n, d)
    chunk, seg, roots = _pass1_roots(idx, x)
    for ch in range(-(-n // CHUNK)):
        segs, want = _chunk_roots(idx, x, ch)
        np.testing.assert_array_equal(seg[chunk == ch], segs)
        np.testing.assert_array_equal(_bits(roots[chunk == ch]), _bits(want))
    np.testing.assert_array_equal(_bits(_sparse_model(idx, k, x)),
                                  _bits(_sparse_model_loop(idx, k, x)))
