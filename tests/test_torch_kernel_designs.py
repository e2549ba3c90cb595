"""The arithmetic the redesigned kernels of `uvol_tpu_torch` rely on, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain twins there). What can be
checked here is that the decompositions they compute are the twins'
functions, bit for bit:

  - the segment-sum kernel (`csrc/etc1s.cu`: pass 1 over chunks of 16
    tiles, pass 2 over the chunk partials) against `segment_sum_plain`,
    through a numpy model of the two passes;
  - K1 (`csrc/etc1.cu`): the closed form of pass 1's table ranking, and
    the forms of pass 2's code errors, against the twin's formulas in
    `codecs/basis/etc.py`.

Every comparison here is exact: integers compared as integers, floats
compared bit for bit (`view(int32)`), no tolerance.
"""

import numpy as np
import pytest
import torch

from uvol_tpu_torch.codecs.basis import etc as tetc
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
    `csrc/etc1s.cu` computes them."""
    n, d = x.shape
    m = max(1, -(-n // CHUNK))
    part = np.zeros((m, k, d), np.float32)
    for ch in range(m):  # pass 1: one CTA per chunk
        rows = np.arange(ch * CHUNK, min(n, (ch + 1) * CHUNK))
        keys = np.sort((idx[rows].astype(np.int64) << 10) | (rows - ch * CHUNK))
        tile = np.zeros((kern.SEG_CHUNK_TILES, k, d), np.float32)
        for key in keys:  # a segment's run, in row order: each tile from 0.0
            seg, r = int(key >> 10), int(key & 1023)
            t = r // kern.SEG_TILE
            tile[t, seg] = tile[t, seg] + x[ch * CHUNK + r]
        pend = [None] * 4
        for t in range(kern.SEG_CHUNK_TILES):  # levels 0..3: a binary counter
            node = tile[t]
            for lvl in range(4):
                if not (t >> lvl) & 1:
                    pend[lvl] = node
                    break
                node = pend[lvl] + node
        part[ch] = node
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


@pytest.mark.parametrize("n", [1, 65, 1023, 1025, 3077, 20000])
@pytest.mark.parametrize("k", [1, 7, 256, 2048])
def test_kernel_decomposition_matches_segment_sum_plain(k, n):
    """Bit-exact: chunk subtrees, then the outer levels, equal the twin's
    one tree, -0.0 inputs and long runs of one segment included."""
    r = np.random.default_rng(k * 100003 + n)
    idx = r.integers(0, k, n)
    idx[: n // 3] = np.sort(idx[: n // 3])
    x = _values(r, n, 3)
    want = kern.segment_sum_plain(torch.from_numpy(idx), k, torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(_kernel_model(idx, k, x)), _bits(want))


def test_segment_sum_wrapper_on_the_cpu_takes_the_twin():
    r = np.random.default_rng(3)
    idx = torch.from_numpy(r.integers(0, 9, 500))
    x = torch.from_numpy(_values(r, 500, 4))
    before = dict(kern.LAUNCHES)
    np.testing.assert_array_equal(_bits(kern.segment_sum(idx, 9, x)),
                                  _bits(kern.segment_sum_plain(idx, 9, x)))
    assert kern.LAUNCHES == before
    with pytest.raises(ValueError):
        kern.segment_sum(idx, kern.SEG_MAX_K + 1, x)
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
