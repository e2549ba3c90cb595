"""The arithmetic of K6 past one window (`csrc/etc1s.cu`), on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain twins there). What can be
checked here is that the decompositions they compute are the twins'
functions, bit for bit:

  - K6 past 2,048 centroids (`csrc/etc1s.cu`, `kmeans_assign_wide_kernel`):
    the filter of four fused multiply-adds against the running best plus a
    margin (rounded up), the reference's dist re-checked where it passes,
    and the sums [f, 1.0] through the segment sum's sparse path, against
    `kmeans_iter_plain`; the margin's bound, and the vectorised model held to
    the loop over every centroid, counters included.

Every comparison here is exact: integers compared as integers, floats
compared bit for bit (`view(int32)`), no tolerance.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from torch_design_models import (KM_GROUPS, KM_KINDS, KM_ROWS, _add_ru, _bits, _c2, _fma_ru,
                                 _margin, _sparse_model, _wide_assign_loop, _wide_assign_model,
                                 _wide_kmeans_case)
from uvol_tpu_torch._device import fma_f32
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern


# ---- K6 past one window: the FMA filter, exact re-checks, the sparse sums ------

U24 = 2.0 ** -24


@pytest.mark.parametrize("kind", KM_KINDS)
@pytest.mark.parametrize("k,n", [(2049, 1500), (4096, 1100), (16128, 600)])
def test_wide_kmeans_design_matches_kmeans_iter_plain(k, n, kind):
    """Bit-exact past one window: the filter of fused multiply-adds with
    the exact re-check gives the twin's first minimum on every kind of
    input (duplicates in every chunk and across 2,048, an all-equal
    codebook where every pair is re-checked, one-ulp neighbours, the
    largest magnitudes), n off the 1,024-row chunk and the CTA's rows;
    the rows [f, 1.0] summed by the sparse path's model give the twin's
    sums and counts."""
    feats, cb = _wide_kmeans_case(kind, n, k, k + n)
    got, rechecks, slow = _wide_assign_model(feats, cb)
    sums, counts, want = kern.kmeans_iter_plain(torch.from_numpy(feats), torch.from_numpy(cb))
    np.testing.assert_array_equal(got, want.numpy())
    x5 = np.concatenate([feats, np.ones((n, 1), np.float32)], 1)
    s5 = _sparse_model(got.astype(np.int64), k, x5)
    np.testing.assert_array_equal(_bits(s5[:, :4]), _bits(sums))
    np.testing.assert_array_equal(_bits(s5[:, 4]), _bits(counts))
    grid_rows = -(-n // (32 * KM_ROWS * KM_GROUPS)) * 32 * KM_ROWS * KM_GROUPS
    if kind == "all_equal":  # every pair passes: exact, only slower
        assert rechecks == grid_rows * k
    else:
        assert rechecks < 0.05 * grid_rows * k


@pytest.mark.parametrize("kind", KM_KINDS)
@pytest.mark.parametrize("k,n", [(2049, 1500), (4096, 1100)])
def test_wide_assign_model_equals_its_loop(k, n, kind):
    """The model that scans a row's chunk from one change of its best to the
    next (`_wide_assign_model`: the design tests here and the card's
    counter test take it) against the loop over every centroid
    (`_wide_assign_loop`): the same assignment, the same pairs re-checked
    and the same warp steps that re-checked."""
    feats, cb = _wide_kmeans_case(kind, n, k, k + n)
    got, want = _wide_assign_model(feats, cb), _wide_assign_loop(feats, cb)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("kind", ["magnitudes", "signed", "zeros", "one_channel"])
def test_wide_kmeans_design_with_unlike_rows_in_a_thread(kind):
    """A thread's margin takes the largest sum |f_j| of its rows: rows of
    unlike size in one thread (magnitudes from 10^-3 to 10^3), signed
    features, rows of zeros, one channel alone still give the twin's
    assignment and, through the sparse path's model, its sums."""
    r = np.random.default_rng(len(kind))
    n, k = 1300, 2600
    if kind == "magnitudes":
        f = r.random((n, 4)) * 10.0 ** r.integers(-3, 4, (n, 1))
    elif kind == "signed":
        f = r.random((n, 4)) * 510 - 255
    elif kind == "zeros":
        f = np.where(r.random((n, 1)) < 0.5, 0.0, r.random((n, 4)) * 255)
    else:
        f = np.zeros((n, 4))
        f[:, 2] = r.random(n) * 255
    feats = f.astype(np.float32)
    cb = (feats[r.integers(0, n, k)] + r.normal(0, 1, (k, 4))).astype(np.float32)
    cb[k - 1], cb[2048] = cb[0], cb[7]
    got, _, _ = _wide_assign_model(feats, cb)
    sums, counts, want = kern.kmeans_iter_plain(torch.from_numpy(feats), torch.from_numpy(cb))
    np.testing.assert_array_equal(got, want.numpy())
    s5 = _sparse_model(got.astype(np.int64), k,
                       np.concatenate([feats, np.ones((n, 1), np.float32)], 1))
    np.testing.assert_array_equal(_bits(s5[:, :4]), _bits(sums))
    np.testing.assert_array_equal(_bits(s5[:, 4]), _bits(counts))


@pytest.mark.parametrize("kind", ["uniform", "cancelling", "magnitudes", "extremes"])
def test_wide_kmeans_filter_error_is_within_the_margin(kind):
    """|d~ - dist| <= 9 u M (1 + 2^-20) + 8 * 2^-150, M = c2 + sum_j |f_j
    w_j| bounding every partial sum, on 2^20 adversarial pairs (squares and
    products in the subnormal range included); and the kernel's margin,
    taken with the pair's own c2 and |c_j| as the chunk's largest (its least
    value), is above it: a pair with dist < best passes d~ < best + margin."""
    r = np.random.default_rng(len(kind))
    m = 1 << 20
    if kind == "uniform":
        f = r.random((m, 4)) * 255
        c = r.random((m, 4)) * 255
    elif kind == "cancelling":  # dist near -|f|^2: c near f, large partial sums
        f = r.random((m, 4)) * 255
        c = f + r.normal(0, 1e-3, (m, 4))
    elif kind == "magnitudes":
        f = r.random((m, 4)) * 10.0 ** r.integers(-30, 3, (m, 1))
        c = r.normal(size=(m, 4)) * 10.0 ** r.integers(-30, 4, (m, 1))
    else:
        f = np.where(r.random((m, 4)) < 0.5, 255.0, 0.0)
        c = r.choice([-1000.0, -255.0, -0.0, 0.0, 1e-3, 255.0, 1000.0], (m, 4))
    f, c = torch.from_numpy(f.astype(np.float32)), torch.from_numpy(c.astype(np.float32))
    fp, c2 = -2.0 * f, _c2(c)
    dt = c2.clone()
    dist = c2.clone()
    for j in range(4):
        dt = fma_f32(fp[:, j], c[:, j], dt)
        dist = dist + fp[:, j] * c[:, j]
    err = (dt.double() - dist.double()).abs()
    big_m = c2.double() + (f.double().abs() * (2.0 * c.double()).abs()).sum(1)
    assert (err <= 9 * U24 * big_m * (1 + 2.0 ** -20) + 8 * 2.0 ** -150).all()
    nf2 = 2.0 * _add_ru(_add_ru(_add_ru(  # each row's own sum_j |f_j|
        f[:, 0].abs().double(), f[:, 1].abs().double()).double(), f[:, 2].abs().double()
    ).double(), f[:, 3].abs().double())
    mg = _margin(nf2, c2, c.abs().amax(1))
    assert (err < mg.double()).all()
    assert (16 * U24 * big_m + 2.0 ** -120 <= mg.double()).all()


def test_wide_kmeans_margin_rounding_helpers_round_up():
    """The model's __fadd_ru and __fmaf_ru: the least float32 at or above
    the exact value, against exact rationals."""
    from fractions import Fraction

    r = np.random.default_rng(5)
    a, b, c = ((r.normal(size=2000) * 10.0 ** r.integers(-20, 20, 2000)).astype(np.float32)
               for _ in range(3))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    s = _add_ru(ta.double(), tb.double()).numpy()
    p = _fma_ru(ta, tb, tc).numpy()
    for i in range(2000):
        for got, exact in ((s[i], Fraction(float(a[i])) + Fraction(float(b[i]))),
                           (p[i], Fraction(float(a[i])) * Fraction(float(b[i]))
                            + Fraction(float(c[i])))):
            below = np.nextafter(got, np.float32(-np.inf))
            assert Fraction(float(got)) >= exact > Fraction(float(below))


def test_wide_kmeans_scratch_holds_rows_and_the_sparse_scratch():
    """K6's scratch past one window: the rows [f, 1.0] padded to 16 bytes,
    then the sparse segment sum's scratch for 5 columns (one group at a
    pitch of 8)."""
    assert kern._kmeans_scratch(3000, 2048) == 3 * 2048 * 5
    assert kern._kmeans_scratch(327680, 4096) == 327680 * 5 + 320 * 1024 * 8 + 2 * 320 * 128
    assert kern._kmeans_scratch(3, 16128) == 16 + 1024 * 8 + 2 * 504


def test_wide_kmeans_filter_floor_reads_the_steady_block():
    """The smoke's filter floor (`chip_smoke.steady_block`) takes the
    unrolled loop's most frequent block, not the one that also carries the
    loop's counter: 23 instructions for 4 pairs in the SASS below (the
    library's, from a card run), the fewer on a tie."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    blocks = [{"instructions": v, "entry_rows": 4.0} for v in (26, 23, 23, 23, 37, 23, 23)]
    assert cs.steady_block(blocks) is blocks[1]
    tie = [{"instructions": v, "entry_rows": 4.0} for v in (30, 24, 30, 24)]
    assert cs.steady_block(tie) is tie[1]


def test_kmeans_iter_wrapper_on_the_cpu_takes_the_twin_past_one_window():
    feats, cb = _wide_kmeans_case("random", 900, 2049, 3)
    before = dict(kern.LAUNCHES)
    got = kern.kmeans_iter(torch.from_numpy(feats), torch.from_numpy(cb))
    want = kern.kmeans_iter_plain(torch.from_numpy(feats), torch.from_numpy(cb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.numpy().view(np.int32))
    assert kern.LAUNCHES == before
