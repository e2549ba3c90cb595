"""Quantize / zigzag / delta of the port against the JAX package (CPU).

Integer outputs must be identical; the float transform (min, range) is
computed by the same float32 ops in the same order, so it is identical
as well.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvol_tpu_torch._device import true_div
from uvol_tpu_torch.ops import prediction as tpred

# both packages' ops re-export functions under the submodules' names
tq = importlib.import_module("uvol_tpu_torch.ops.quantize")
jpred = importlib.import_module("uvol_tpu.ops.prediction")
jq = importlib.import_module("uvol_tpu.ops.quantize")


def _attr(seed=0, f=3, n=700, d=3):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(f, n, d)) * 30).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([700, 500, 1])[:f, None]
    return x, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits", [10, 11])
def test_quantize_matches_jax(masked, bits):
    x, mask = _attr(seed=bits)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    ref = jq.quantize(jnp.asarray(x), bits, mask=jm)
    out = tq.quantize(torch.from_numpy(x), bits, mask=tm)
    assert out.values.dtype == torch.int32
    np.testing.assert_array_equal(out.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(out.min_value.numpy(), np.asarray(ref.min_value))
    np.testing.assert_array_equal(out.range_value.numpy(), np.asarray(ref.range_value))


def test_quantize_with_a_given_transform_matches_jax():
    """`min_value=`/`range_value=` skip the transform, as in the reference
    (the inputs of tests/test_pallas_parity.py's K3 test): tolerance 0."""
    r = np.random.default_rng(0)
    f, n, c = 3, 1300, 3
    x = (r.normal(size=(f, n, c)) * 50).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([1300, 900, 1111])[:, None]
    mn, rng = jq.compute_quantization_transform(jnp.asarray(x), jnp.asarray(mask))
    ref = jq.quantize(jnp.asarray(x), 11, mask=jnp.asarray(mask), min_value=mn, range_value=rng)
    tmn, trng = tq.compute_quantization_transform(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(mn))
    np.testing.assert_array_equal(trng.numpy(), np.asarray(rng))
    out = tq.quantize(torch.from_numpy(x), 11, mask=torch.from_numpy(mask),
                      min_value=tmn, range_value=trng)
    np.testing.assert_array_equal(out.values.numpy(), np.asarray(ref.values))
    assert out.min_value is tmn and out.range_value is trng
    # a transform that is not the data's own: another frame's, and half the range
    other_mn, other_rng = np.asarray(mn)[::-1].copy(), np.asarray(rng) * np.float32(0.5)
    ref = jq.quantize(jnp.asarray(x), 10, mask=jnp.asarray(mask),
                      min_value=jnp.asarray(other_mn), range_value=jnp.asarray(other_rng))
    out = tq.quantize(torch.from_numpy(x), 10, mask=torch.from_numpy(mask),
                      min_value=torch.from_numpy(other_mn),
                      range_value=torch.from_numpy(other_rng))
    np.testing.assert_array_equal(out.values.numpy(), np.asarray(ref.values))
    # one of the two alone is ignored, as in the reference
    alone = tq.quantize(torch.from_numpy(x), 11, mask=torch.from_numpy(mask),
                        min_value=torch.from_numpy(other_mn))
    np.testing.assert_array_equal(alone.min_value.numpy(), np.asarray(mn))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("minus_first", [False, True])
def test_zero_minimum_takes_the_sign_the_reference_gives_it(masked, minus_first):
    """A row whose minimum is zero and which holds both zeros: XLA's
    minimum is -0.0 whatever their order, and the port's follows it (the
    minimum is written to the wire as bits)."""
    r = np.random.default_rng(9)
    x = (np.abs(r.normal(size=(3, 400, 3))) + 1).astype(np.float32)
    a, b = (-0.0, 0.0) if minus_first else (0.0, -0.0)
    x[:, 5, :], x[:, 250, :] = a, b
    x[:, 5, 1] = x[:, 250, 1] = 0.0  # +0.0 only in component 1
    mask = np.arange(400)[None, :] < np.array([400, 300, 251])[:, None]
    if masked:
        x[1, 300:], x[2, 251:] = -5.0, -0.0  # padded rows count for nothing
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    mn, rng = jq.compute_quantization_transform(jnp.asarray(x), jm)
    tmn, trng = tq.compute_quantization_transform(torch.from_numpy(x), tm)
    np.testing.assert_array_equal(tmn.numpy().view(np.uint32), np.asarray(mn).view(np.uint32))
    np.testing.assert_array_equal(trng.numpy(), np.asarray(rng))
    assert np.signbit(tmn.numpy()[:, [0, 2]]).all() and not np.signbit(tmn.numpy()[:, 1]).any()


def test_degenerate_frame_range_is_one():
    x = np.ones((2, 5, 3), np.float32)
    _, rng = tq.compute_quantization_transform(torch.from_numpy(x))
    np.testing.assert_array_equal(rng.numpy(), [1.0, 1.0])


def test_dequantize_matches_jax_within_fma_tolerance():
    x, mask = _attr(seed=4)
    ref = jq.quantize(jnp.asarray(x), 11, mask=jnp.asarray(mask))
    out = tq.quantize(torch.from_numpy(x), 11, mask=torch.from_numpy(mask))
    a = tq.dequantize(out, 11).numpy()
    b = np.asarray(jq.dequantize(ref, 11))
    # XLA's CPU backend may contract min + q*delta into one FMA; eager
    # torch rounds the product first: at most a few ulp of max|x|.
    atol = 4 * np.finfo(np.float32).eps * np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_zigzag_matches_jax_at_int32_extremes():
    vals = np.array(
        [0, 1, -1, 2, -2, 1000, -1000, 2**30 - 1, 2**30, -(2**30), -(2**30) - 1,
         2**31 - 1, -(2**31)],
        np.int32,
    )
    vals = np.concatenate(
        [vals, np.random.default_rng(5).integers(-(2**31), 2**31, 1000).astype(np.int32)]
    )
    ref = np.asarray(jq.zigzag_encode(jnp.asarray(vals)))
    sym = tq.zigzag_encode(torch.from_numpy(vals))
    assert sym.dtype == torch.int32
    np.testing.assert_array_equal(tq.symbols_to_numpy(sym), ref)
    dec = tq.zigzag_decode(tq.symbols_from_numpy(ref))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jq.zigzag_decode(jnp.asarray(ref))))
    np.testing.assert_array_equal(dec.numpy(), vals)


def test_delta_roundtrip_matches_jax():
    x, mask = _attr(seed=6)
    q = jq.quantize(jnp.asarray(x), 11, mask=jnp.asarray(mask)).values
    qt = torch.from_numpy(np.array(q))
    d_ref = np.asarray(jpred.delta_encode(q))
    d = tpred.delta_encode(qt)
    np.testing.assert_array_equal(d.numpy(), d_ref)
    back = tpred.delta_decode(d)
    assert back.dtype == torch.int32  # cumsum must not promote to int64
    np.testing.assert_array_equal(back.numpy(), np.asarray(jpred.delta_decode(jnp.asarray(d_ref))))
    np.testing.assert_array_equal(back.numpy(), qt.numpy())


def test_delta_along_planar_vertex_dim_matches_jax():
    """`dim=-1` on the codec's planar [F, C, N] layout gives the
    reference's interleaved [F, N, C] result, transposed."""
    x, mask = _attr(seed=8)
    q = np.asarray(jq.quantize(jnp.asarray(x), 11, mask=jnp.asarray(mask)).values)
    d_ref = np.asarray(jpred.delta_encode(jnp.asarray(q)))
    planar = torch.from_numpy(np.ascontiguousarray(q.transpose(0, 2, 1)))
    d = tpred.delta_encode(planar, dim=-1)
    np.testing.assert_array_equal(d.numpy().transpose(0, 2, 1), d_ref)
    back = tpred.delta_decode(d, torch.int32, dim=-1)
    np.testing.assert_array_equal(back.numpy(), planar.numpy())


def test_delta_decode_wraps_in_int32_like_jax():
    big = np.full((1, 4, 1), 2**30, np.int32)
    ref = np.asarray(jpred.delta_decode(jnp.asarray(big)))
    out = tpred.delta_decode(torch.from_numpy(big))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_true_div_is_ieee_where_torch_shortcuts_are_not():
    """`2047 / t` in PyTorch is reciprocal(t) * 2047, one ulp off the IEEE
    quotient for some t; `true_div` matches numpy's float32 division."""
    x = np.random.default_rng(7).uniform(0.01, 100.0, 100_000).astype(np.float32)
    t = torch.from_numpy(x)
    want = np.float32(2047.0) / x
    np.testing.assert_array_equal(true_div(2047.0, t).numpy(), want)
    np.testing.assert_array_equal(true_div(t, 255.0).numpy(), x / np.float32(255.0))
    assert ((2047.0 / t).numpy() != want).any()  # the shortcut exists
