"""K3, the fused quantize + delta + zigzag, and the geometry encode's whole
device stage (`geometry_quantize_stage`) against the JAX package (CPU).

The port's plain twin (`fused_quantize_delta_zigzag_plain`, what a CPU
tensor runs) is held against the Pallas kernel in interpret mode, as
tests/test_pallas_parity.py runs it, and against the symbols of the JAX
codec's own device stage (`GeometrySequenceCodec._encode_device`). The
symbols are integers: the tolerance is 0. The CUDA kernel is held against
the twin on the card (tests/test_torch_cuda.py, chip_smoke.py). The
stage's twin (symbols, per-row minimum, per-frame range) is held bit for
bit against the JAX codec's `_syms`, the sign of a zero minimum included:
the minimum is written onto the wire as its bits.

XLA on the CPU compiles `floor(xm * inv + 0.5)` into one fused
multiply-add: always in the Pallas kernel, and in the codec's loop too
except, for some batch shapes, in one of its two evaluations of each q
(`test_twin_symbols_match_jax_codec_device_stage`). The boundary inputs
include values where a rounded multiply followed by a rounded add gives
another integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvol_tpu.models import sequence as jseq
from uvol_tpu.ops.pallas_kernels import fused_quantize_delta_zigzag as jax_k3
from uvol_tpu_torch.models import sequence as tseq
from uvol_tpu_torch.ops import pallas_kernels as pk


def _fma_floor(x: np.ndarray, inv) -> np.ndarray:
    """floor(fma(x, inv, 0.5)) with one rounding to float32 (exact in
    float64 for x >= 0 where the floor can change)."""
    t = x.astype(np.float64) * np.float64(np.float32(inv)) + 0.5
    return np.floor(t.astype(np.float32))


def _split_floor(x: np.ndarray, inv) -> np.ndarray:
    """floor(round(x * inv) + 0.5): the multiply rounded before the add."""
    return np.floor((x * np.float32(inv)).astype(np.float32) + np.float32(0.5))


def boundary_offsets(inv: float, max_q: int) -> np.ndarray:
    """float32 offsets xm >= 0 whose product with `inv` lies at k + 0.5,
    within 3 ulp either side, for every k < max_q, and the offsets (near
    k + 0.5 for k + 1 a power of two) where the fused and the split
    rounding give different integers."""
    inv = np.float32(inv)
    ks = np.arange(max_q, dtype=np.float64)
    x0 = ((ks + 0.5) / np.float64(inv)).astype(np.float32)
    near = [(x0.view(np.int32) + d).view(np.float32) for d in range(-3, 4)]
    split = []
    for e in range(int(np.log2(max_q)) + 1):
        c = np.float32((2.0 ** e - 0.5) / float(inv))
        x = (c.view(np.int32) + np.arange(-4000, 4000, dtype=np.int32)).view(np.float32)
        x = x[x >= 0]
        split.append(x[_fma_floor(x, inv) != _split_floor(x, inv)])
    out = np.concatenate(near + split)
    return out[(out >= 0) & (out * inv <= max_q)]


def _planar(f, c, n, seed):
    """Min-subtracted planar offsets [F, C, N], zero on padded rows, and
    inv [F], as the codec's `quantize_offsets` makes them."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(f, c, n)).astype(np.float32) * 40
    counts = np.maximum(1, n - r.integers(0, max(1, n // 3), f))
    counts[0] = n
    mask = np.arange(n)[None, :] < counts[:, None]
    xm, inv, _, _ = pk.quantize_offsets(
        torch.from_numpy(x), 11, torch.from_numpy(mask))
    return xm.numpy(), inv.numpy(), counts


def _jax_k3(xm_planar: np.ndarray, inv: np.ndarray) -> np.ndarray:
    """The Pallas kernel in interpret mode, on the interleaved layout it
    takes, returned planar as uint32."""
    c = xm_planar.shape[1]
    out = jax_k3(jnp.asarray(xm_planar.transpose(0, 2, 1)), jnp.asarray(inv), c, True)
    return np.asarray(out).view(np.uint32).transpose(0, 2, 1)


def _twin(xm: np.ndarray, inv: np.ndarray) -> np.ndarray:
    out = pk.fused_quantize_delta_zigzag(torch.from_numpy(xm), torch.from_numpy(inv))
    assert out.dtype == torch.int32
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("f,c,n", [
    (1, 3, 1), (2, 2, 511), (3, 3, 512), (4, 2, 513), (1, 3, 1300), (2, 2, 26145),
])
def test_twin_matches_pallas_kernel_interpret(f, c, n):
    xm, inv, counts = _planar(f, c, n, seed=f * 1000 + n)
    got = _twin(xm, inv)
    want = _jax_k3(xm, inv)
    for i, cnt in enumerate(counts):  # the valid region, as test_pallas_parity reads it
        np.testing.assert_array_equal(got[i, :, :cnt], want[i, :, :cnt])
    # padded rows quantize to 0 in both; the first of them carries -q[count-1]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inv", [1.0, 2047 / 1.7345, 1023 / 0.9871, 2047 / 3.0e-3])
def test_twin_matches_pallas_kernel_at_rounding_boundaries(inv):
    xm = boundary_offsets(inv, 2047)
    assert len(xm) >= 2047 * 7
    inv = np.array([inv], np.float32)
    planar = np.ascontiguousarray(xm[None, None, :])
    got = _twin(planar, inv)
    np.testing.assert_array_equal(got, _jax_k3(planar, inv))
    q = np.cumsum(np.where(got % 2 == 0, got // 2, -(got.astype(np.int64) + 1) // 2), -1)
    np.testing.assert_array_equal(q[0, 0], _fma_floor(xm, inv[0]))


def test_boundary_inputs_tell_fused_from_split_rounding():
    """The boundary set holds inputs where a rounded multiply followed by
    a rounded add gives another integer: the twin must take the FMA."""
    inv = np.float32(2047 / 1.7345)
    xm = boundary_offsets(inv, 2047)
    differ = _fma_floor(xm, inv) != _split_floor(xm, inv)
    assert differ.any()
    got = _twin(np.ascontiguousarray(xm[None, None, :]), np.array([inv], np.float32))
    q = np.cumsum(np.where(got % 2 == 0, got // 2, -(got.astype(np.int64) + 1) // 2), -1)
    np.testing.assert_array_equal(q[0, 0][differ], _fma_floor(xm, inv)[differ])


def _codec_batch(seed: int, f: int, n: int, boundary: bool):
    """Planar positions [F, 3, N] and UVs [F, 2, N] with a mask. With
    `boundary`, frame 0 holds 0 and R in every component, so its min is 0
    and its range R, and its other values are the boundary offsets of
    inv = (2^bits - 1) / R."""
    r = np.random.default_rng(seed)
    pos = (r.normal(size=(f, 3, n)) * 5).astype(np.float32)
    uv = r.uniform(size=(f, 2, n)).astype(np.float32)
    counts = np.array([n, n - 7, n // 2])[:f]
    if boundary:  # ranges whose inv has offsets where fused != split rounding
        for arr, bits, rng_ in ((pos, 11, 2.9687), (uv, 10, 2.9749)):
            inv = np.float32((1 << bits) - 1) / np.float32(rng_)
            vals = boundary_offsets(inv, (1 << bits) - 1)
            vals = vals[vals <= np.float32(rng_)]
            assert (_fma_floor(vals, inv) != _split_floor(vals, inv)).any()
            for ch in range(arr.shape[1]):
                arr[0, ch] = np.resize(vals[r.permutation(len(vals))], n)
                arr[0, ch, n - 2] = 0.0
                arr[0, ch, n - 1] = rng_
    mask = np.arange(n)[None, :] < counts[:, None]
    return pos, uv, mask


def _split_positions(x: np.ndarray, inv) -> np.ndarray:
    """[C, N] bool: the offsets where fused and split rounding differ,
    and the offsets right after them (whose delta reads them as prev)."""
    at = _fma_floor(x, inv) != _split_floor(x, inv)
    return at | np.pad(at[:, :-1], ((0, 0), (1, 0)))


@pytest.mark.parametrize("f,boundary", [(3, False), (1, True), (3, True)])
def test_twin_symbols_match_jax_codec_device_stage(f, boundary):
    """The port's symbols equal the JAX codec's, except where XLA's CPU
    code for the codec rounds the two evaluations of one q differently.

    The codec computes each q twice in one fused loop (as q[n], and as
    the shifted q[n-1]); for some batch shapes LLVM contracts only the
    second into an FMA (here: F = 3, the UVs), so at a fused/split
    boundary offset its delta mixes the two roundings. Its symbols then
    decode to q off by one step from there on. The Pallas kernel rounds
    both as one FMA, and so does the port; elsewhere, and at F = 1, the
    symbols are identical."""
    n = 20000
    pos, uv, mask = _codec_batch(3 + boundary, f, n, boundary)
    jc = jseq.GeometrySequenceCodec(position_bits=11, uv_bits=10)
    want = jc._encode_device(jnp.asarray(pos), jnp.asarray(uv), jnp.asarray(mask))
    got = tseq.encode_device(torch.from_numpy(pos), torch.from_numpy(uv),
                             torch.from_numpy(mask), 11, 10)
    for k in ("pos_min", "pos_range", "uv_min", "uv_range"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k, arr, bits in (("pos_syms", pos, 11), ("uv_syms", uv, 10)):
        w = np.asarray(want[k])
        g = got[k].numpy().view(np.uint32)
        inv = np.float32((1 << bits) - 1) / np.asarray(want[k[:-5] + "_range"])
        ok = g == w
        ok[0] |= _split_positions(arr[0], inv[0]) if boundary else False
        assert ok.all(), (k, np.argwhere(~ok)[:5])
        xm = pk.quantize_offsets(torch.from_numpy(arr), bits, torch.from_numpy(mask))[0]
        np.testing.assert_array_equal(g, _jax_k3(xm.numpy(), inv), err_msg=k)
    if boundary and f == 1:
        np.testing.assert_array_equal(got["uv_syms"].numpy().view(np.uint32),
                                      np.asarray(want["uv_syms"]))


def test_wrapper_checks_and_counts_no_cpu_launch():
    before = dict(pk.LAUNCHES)
    xm, inv, _ = _planar(2, 3, 100, seed=1)
    pk.fused_quantize_delta_zigzag(torch.from_numpy(xm), torch.from_numpy(inv))
    assert pk.LAUNCHES == before  # a CPU tensor takes the twin
    with pytest.raises(ValueError):
        pk.fused_quantize_delta_zigzag(torch.zeros((2, 3, 4), dtype=torch.float64),
                                       torch.ones(2))
    with pytest.raises(ValueError):
        pk.fused_quantize_delta_zigzag(torch.zeros((2, 3, 4)), torch.ones(3))
    with pytest.raises(ValueError, match="device"):
        pk.fused_quantize_delta_zigzag(torch.zeros((2, 3, 4), device="meta"),
                                       torch.ones(2, device="meta"))


# ---- the whole stage: minimum/maximum, range, offsets, K3 -----------------------


def _stage_batch(kind: str):
    """Planar positions [F, 3, N], UVs [F, 2, N] and mask [F, N] for one
    of the stage's corner cases."""
    r = np.random.default_rng(sorted(STAGE_CASES).index(kind))
    f, n = 4, 1500
    pos = (r.normal(size=(f, 3, n)) * 9).astype(np.float32)
    uv = r.uniform(size=(f, 2, n)).astype(np.float32)
    counts = np.array([n, n - 1, n // 3, 17])
    if kind == "count_one":
        counts = np.array([1, n, 1, 2])
    elif kind == "equal_values":  # a frame of one point: range 0 -> 1
        pos[1], uv[1] = 2.75, 0.5
        pos[2, :, : counts[2]] = -1.0  # equal on the valid vertices only
    elif kind.startswith("zeros"):
        # the minimum of a row is zero, and the row holds both zeros; the
        # other valid values are positive, the padded ones are not
        pos, uv = np.abs(pos) + 0.5, np.abs(uv) + 0.5
        first, second = (0.0, -0.0) if kind == "zeros_plus_first" else (-0.0, 0.0)
        for arr in (pos, uv):
            for i, cnt in enumerate(counts):
                a, b = sorted(r.choice(cnt, 2, replace=False))
                arr[i, :, a], arr[i, :, b] = first, second
                arr[i, 1, a] = arr[i, 1, b] = first  # one sign only in component 1
                arr[i, :, cnt:] = -3.0
    mask = np.arange(n)[None, :] < counts[:, None]
    return pos, uv, mask


STAGE_CASES = ("ragged", "count_one", "equal_values", "zeros_plus_first", "zeros_minus_first")


@pytest.mark.parametrize("kind", STAGE_CASES)
def test_stage_twin_matches_jax_codec_syms_bit_for_bit(kind):
    """syms, min and range of the stage's twin equal the JAX codec's
    `_syms`, as its `_encode_device` runs it: tolerance 0, compared as
    bits (a zero minimum is -0.0 wherever the row holds one)."""
    pos, uv, mask = _stage_batch(kind)
    jc = jseq.GeometrySequenceCodec(position_bits=11, uv_bits=10)
    want = jc._encode_device(jnp.asarray(pos), jnp.asarray(uv), jnp.asarray(mask))
    for name, arr, bits in (("pos", pos, 11), ("uv", uv, 10)):
        syms, mn, rng = pk.geometry_quantize_stage(
            torch.from_numpy(arr), torch.from_numpy(mask), bits)
        assert syms.dtype == torch.int32
        for got, key in ((syms, "_syms"), (mn, "_min"), (rng, "_range")):
            w = np.asarray(want[name + key])
            np.testing.assert_array_equal(got.numpy().view(np.uint32), w.view(np.uint32),
                                          err_msg=f"{kind} {name}{key}")
    if kind.startswith("zeros"):
        mn = pk.geometry_quantize_stage(torch.from_numpy(pos), torch.from_numpy(mask), 11)[1]
        assert np.signbit(mn.numpy()[:, [0, 2]]).all()  # both zeros in the row: -0.0
        assert (np.signbit(mn.numpy()[:, 1]) == (kind == "zeros_minus_first")).all()
    if kind == "equal_values":
        rng = pk.geometry_quantize_stage(torch.from_numpy(pos), torch.from_numpy(mask), 11)[2]
        np.testing.assert_array_equal(rng.numpy()[1:3], [1.0, 1.0])


def test_stage_twin_is_quantize_offsets_then_k3_twin():
    pos, _, mask = _stage_batch("ragged")
    xt, m = torch.from_numpy(pos), torch.from_numpy(mask)
    xm, inv, mn, rng = pk.quantize_offsets(xt, 11, m)
    syms, mn2, rng2 = pk.geometry_quantize_stage_plain(xt, m, 11)
    assert torch.equal(syms, pk.fused_quantize_delta_zigzag_plain(xm, inv))
    assert torch.equal(mn, mn2) and torch.equal(rng, rng2)
    got = tseq.encode_device(xt, None, m, 11, 10)  # the codec's stage is this entry
    assert torch.equal(got["pos_syms"], syms) and torch.equal(got["pos_min"], mn)


def test_stage_gives_float_max_for_a_frame_without_a_valid_vertex():
    pos, _, mask = _stage_batch("ragged")
    mask[2] = False
    syms, mn, rng = pk.geometry_quantize_stage(torch.from_numpy(pos), torch.from_numpy(mask), 11)
    big = np.finfo(np.float32).max
    np.testing.assert_array_equal(mn.numpy()[2], [big] * 3)
    assert rng.numpy()[2] == 1.0 and not syms[2].any()


def test_stage_wrapper_checks_and_counts_no_cpu_launch():
    pos, _, mask = _stage_batch("ragged")
    xt, m = torch.from_numpy(pos), torch.from_numpy(mask)
    before = dict(pk.LAUNCHES)
    pk.geometry_quantize_stage(xt, m, 11)
    assert pk.LAUNCHES == before and set(before) == {"geometry_minmax", "quantize_delta_zigzag"}
    with pytest.raises(ValueError, match="float32"):
        pk.geometry_quantize_stage(xt.double(), m, 11)
    with pytest.raises(ValueError, match="mask"):
        pk.geometry_quantize_stage(xt, m[:, :-1], 11)
    with pytest.raises(ValueError, match="mask"):
        pk.geometry_quantize_stage(xt, m.to(torch.uint8), 11)
    with pytest.raises(ValueError, match="bits"):
        pk.geometry_quantize_stage(xt, m, 31)
    with pytest.raises(ValueError, match="device"):
        pk.geometry_quantize_stage(xt.to("meta"), m.to("meta"), 11)
    f0 = pk.geometry_quantize_stage(xt[:0], m[:0], 11)  # an empty batch
    assert [tuple(t.shape) for t in f0] == [(0, 3, 1500), (0, 3), (0,)]
