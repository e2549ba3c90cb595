"""The arithmetic of the geometry stage (`csrc/geometry.cu`), on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against their plain twins there). What can be
checked here is that the decompositions they compute are the twins'
functions, bit for bit:

  - the geometry stage (`csrc/geometry.cu`): the strided masked
    minimum/maximum with its order of the zeros, and K3's index
    arithmetic (4 vertices a thread on the buffer's 16-byte grid, the
    left neighbour by warp shuffle or recomputed at a warp's seam, row
    heads and tails, both store paths), against
    `geometry_quantize_stage_plain`.

Every comparison here is exact: integers compared as integers, floats
compared bit for bit (`view(int32)`), no tolerance.
"""

import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from torch_design_models import _bits
from uvol_tpu_torch.ops import pallas_kernels as pk


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
