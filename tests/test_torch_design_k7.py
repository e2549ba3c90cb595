"""The arithmetic of K7 (`csrc/etc1s.cu`), on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain twins there). What can be
checked here is that the decompositions they compute are the twins'
functions, bit for bit:

  - K7 (`csrc/etc1s.cu`, the rate sweep's frame stage): the per-row
    prologue (features, e_prev), int32 errors, a thread's first minimum
    over its entries, the warps' minima of (ordered cost, entry) with CR
    winning ties, and the CR snap's gate, against
    `rate_sweep_frame_plain`; past 2,048 entries two block rows a CTA and
    the count terms of the error as exact float multiply-adds.

Every comparison here is exact: integers compared as integers, floats
compared bit for bit (`view(int32)`), no tolerance.
"""

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu_torch._device import fma_f32
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern
from uvol_tpu_torch.codecs.basis import etc1s_encode as tenc


# ---- K7: the rate sweep's frame stage ------------------------------------------

INTEN = np.array(kern.INTEN_TABLES, np.int64)  # [8, (-l, -s, s, l)]
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


def _k7_model(blocks, base, mods, sel_cb, bits, ep, sel, prev, s0_index, lam, lam_cr, nbx,
              rows: int = 1):
    """`rate_sweep_frame_kernel` written out in numpy: the rows go together,
    the columns in order; threads = 32 * ceil(E / 128), thread t holding
    entries t + j * threads (j < 4); past 2,048 entries (the wide path,
    `rate_sweep_rows_kernel`) 512 threads, thread t pricing every entry t +
    j * 512 in turn for each of the `rows` block rows of its CTA, one read
    of the entry for all of them; the frame's rows padded to a multiple of
    `rows` with rows whose results are dropped: a row's prices depend on
    no other row of its CTA."""
    e, nb = len(base), len(ep)
    nby = nb // nbx
    dead = -nby % rows
    if dead:  # the last CTA's rows past the frame
        nbd = dead * nbx
        got = _k7_model(np.concatenate([blocks, np.zeros((nbd, 16, 3), np.uint8)]), base, mods,
                        sel_cb, bits, np.concatenate([ep, np.zeros(nbd, ep.dtype)]),
                        np.concatenate([sel, np.zeros(nbd, sel.dtype)]),
                        None if prev is None else tuple(
                            np.concatenate([p, np.zeros(nbd, p.dtype)]) for p in prev),
                        s0_index, lam, lam_cr, nbx)
        return tuple(g[:nb] for g in got)
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
    "e2049_wide_rows2": dict(nby=5, nbx=3, e=2049, seed=14, rows=2),
    "e2049_wide_rows2_frame0": dict(nby=3, nbx=4, e=2049, seed=15, rows=2, prev=False),
    "e4096_wide_rows2": dict(nby=3, nbx=5, e=4096, seed=16, rows=2),
    "e4096_wide_rows1_frame0": dict(nby=2, nbx=4, e=4096, seed=17, prev=False),
    "e4096_wide_rows2_ties_lam0": dict(nby=4, nbx=3, e=4096, seed=18, rows=2, dup=True, lam=0.0),
    "e16128_wide_rows2": dict(nby=3, nbx=3, e=16128, seed=19, rows=2),
    "e16128_wide_rows2_frame0": dict(nby=2, nbx=3, e=16128, seed=20, rows=2, prev=False),
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
    rows = kw.pop("rows", 1)
    blocks, base, mods, sel_cb, ep, sel, prev = _k7_inputs(**kw)
    nbx = kw["nbx"]
    bits = tenc.sweep_bits_table(len(base))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    want = kern.rate_sweep_frame_plain(t(blocks), t(base), t(mods), t(sel_cb), t(bits), t(ep),
                                       t(sel), None if prev is None else tuple(map(t, prev)),
                                       0, lam, 1.5, nbx)
    got = _k7_model(blocks, base, mods, sel_cb, bits, ep, sel, prev, 0, lam, 1.5, nbx, rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    # the frame exercises what it is named for
    if prev is not None and len(base) > 1:
        assert (got[0] == prev[0]).any() and (got[0] != prev[0]).any()
    p_sq, feat, mat = kern.sweep_features(t(blocks), t(base), t(mods), t(sel_cb), t(sel))
    err = (p_sq[:, None] + feat.double() @ mat.double().T).numpy()
    assert (err >= 0).all() and err.max() < 1 << 24


@pytest.mark.parametrize("kind", ["random", "extremes"])
def test_k7_wide_error_in_float_is_the_integer_error(kind):
    """The wide path's error (`entry_error_f`): |p|^2 + sum_c n_c |col_c|^2
    as float multiply-adds from |p|^2, then fma(-2, float(dot), acc), is the
    int32 error exactly, also where every term is at its largest (pixels
    255 against entries of 0, one code on all 16 pixels)."""
    r = np.random.default_rng(len(kind))
    nb, e = 4096, 64
    blocks, base, mods, sel_cb, _ep, sel, _p = _k7_inputs(64, 64, e, seed=21)
    if kind == "extremes":
        blocks = np.where(r.random(blocks.shape) < 0.5, 255, 0).astype(np.uint8)
        blocks[:8] = 255
        base[:8], mods[:8] = 0, INTEN[0]
        sel_cb[1:] = r.integers(0, 4, (7, 16))
        sel_cb[1, :] = 3
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    p_sq, feat, mat = kern.sweep_features(t(blocks), t(base), t(mods), t(sel_cb), t(sel))
    want = (p_sq.double()[:, None] + feat.double() @ mat.double().T).numpy()  # [nb, E] exact
    n = feat[:, 12:].numpy().astype(np.float32)
    sq = mat[:, 12:].numpy().astype(np.float32)
    acc = np.broadcast_to(p_sq.numpy().astype(np.float32)[:, None], (nb, e)).copy()
    for c in range(4):
        acc = fma_f32(torch.from_numpy(n[:, c:c + 1].repeat(e, 1)),
                      torch.from_numpy(np.broadcast_to(sq[None, :, c], (nb, e)).copy()),
                      torch.from_numpy(acc)).numpy()
    dot = -(feat[:, :12].double() @ mat[:, :12].double().T).numpy() / 2  # the __dp2a sums
    assert dot.max() < 1 << 24 and acc.max() < 1 << 24
    got = fma_f32(-2.0, torch.from_numpy(dot.astype(np.float32)), torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert (want >= 0).all() and want.max() < 1 << 24


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
