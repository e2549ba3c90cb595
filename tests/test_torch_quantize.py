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
from uvol_tpu_torch.ops import quantize as tq

# uvol_tpu.ops re-exports functions under the submodules' names
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
