"""The arithmetic of K1, K5 and K2 (`csrc/etc1.cu`, `csrc/etc1s.cu`), on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain twins there). What can be
checked here is that the decompositions they compute are the twins'
functions, bit for bit:

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
    arithmetic, against `decode_etc1_images_plain`.

Every comparison here is exact: integers compared as integers, floats
compared bit for bit (`view(int32)`), no tolerance.
"""

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu_torch.codecs.basis import etc as tetc
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern
from uvol_tpu_torch.codecs.basis import etc_cuda
from uvol_tpu_torch.models import drc_device as dd


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
