"""The port's point-cloud codec and `convert` against the JAX package (CPU).

`PointCloudSequenceCodec` (device stage on the CPU twins, `.crt` through
the copied Corto code) must write the reference's `.crt` bytes and decode
to its points. Its quantize is the port's `ops.quantize.quantize`, each
float32 step rounded on its own, as the reference's eager `quantize`
computes it. The reference's jitted `_device_stage` may take two other
roundings: XLA folds `range / max_q` into a multiply by f32(1 / max_q) and
may contract `xm * inv + 0.5` into one FMA (ROADMAP.md §3). Either moves
a q only for a point whose offset lies within an ulp of k + 0.5. The
tests compute that set (`_divergence_set`: the points whose q is not the
same under all four roundings), require the port's integers to equal the
reference's on every other point and its permutation and bytes to equal
the reference's on every frame where the set is empty, and report its
size rather than choosing data that avoids it.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu_torch import convert
from uvol_tpu_torch.models.pointcloud import PointCloudSequenceCodec
from uvol_tpu_torch.models.trajectory import TrajectoryGroup, fit_trajectories
from uvol_tpu_torch.ops.morton import morton_key

from uvol_tpu.models.pointcloud import PointCloudSequenceCodec as JaxPointCloudCodec
from uvol_tpu.models.trajectory import fit_trajectories as jax_fit_trajectories

tq = importlib.import_module("uvol_tpu_torch.ops.quantize")
jq = importlib.import_module("uvol_tpu.ops.quantize")


def _clouds(seed, f, n, dup=False):
    r = np.random.default_rng(seed)
    pos = (r.normal(size=(f, n, 3)) * r.uniform(1, 50, (f, 1, 3))).astype(np.float32)
    if dup:  # repeated points: ties in the Morton sort
        pos[:, n // 2:] = pos[:, : n - n // 2]
    return pos


def _divergence_set(pos, bits):
    """[F, N] bool: points whose q differs between the four float32
    roundings of the reference's quantize (delta = range / max_q or range
    * f32(1 / max_q); floor(round(xm * inv) + 0.5) or floor(fma(xm, inv,
    0.5)))."""
    max_q = (1 << bits) - 1
    mn = pos.min(axis=1)
    rng = (pos.max(axis=1) - mn).max(axis=-1)
    rng = np.where(rng <= 0, np.float32(1), rng).astype(np.float32)
    xm = (pos - mn[:, None, :]).astype(np.float32)
    qs = []
    for delta in (rng / np.float32(max_q), rng * np.float32(1.0 / max_q)):
        inv = (np.float32(1) / delta.astype(np.float32)).astype(np.float32)[:, None, None]
        plain = np.floor((xm * inv).astype(np.float32) + np.float32(0.5))
        fused = np.floor((xm.astype(np.float64) * inv + 0.5).astype(np.float32))
        qs += [np.clip(plain, 0, max_q), np.clip(fused, 0, max_q)]
    return np.any([(q != qs[0]).any(-1) for q in qs[1:]], axis=0)


@pytest.mark.parametrize("seed,f,n,dup,bits", [
    (0, 3, 2000, False, 11), (1, 2, 5000, True, 11), (2, 4, 1, False, 11),
    (3, 2, 3001, False, 16), (4, 3, 700, True, 21), (5, 1, 26145 // 8, False, 11)])
def test_device_stage_matches_reference(seed, f, n, dup, bits):
    pos = _clouds(seed, f, n, dup)
    sorted_pos, perm = PointCloudSequenceCodec(bits, device="cpu").device_stage(
        torch.from_numpy(pos))
    jsorted, jperm = JaxPointCloudCodec(bits)._device_stage(jnp.asarray(pos))
    jsorted, jperm = np.asarray(jsorted), np.asarray(jperm)
    # integers: the reference's q (its jitted quantize) equal off the set
    s = _divergence_set(pos, bits)
    jvals = np.array(jq.quantize(jnp.asarray(pos), bits).values)
    tkey = morton_key(torch.from_numpy(jvals)).numpy()
    tvals = tq.quantize(torch.from_numpy(pos), bits).values.numpy()
    assert np.array_equal(tvals[~s], jvals[~s])
    assert np.array_equal(morton_key(torch.from_numpy(tvals)).numpy()[~s], tkey[~s])
    for i in range(f):
        if not s[i].any():
            np.testing.assert_array_equal(perm[i].numpy(), jperm[i])
            np.testing.assert_array_equal(sorted_pos[i].numpy(), jsorted[i])
    print(f"points within an ulp of k + 0.5 under some rounding: {int(s.sum())} of {s.size}")


@pytest.mark.parametrize("seed,f,n,dup", [(0, 3, 1500, False), (1, 2, 4000, True),
                                           (2, 2, 1, False)])
def test_crt_bytes_match_reference(seed, f, n, dup):
    """The same `.crt` bytes (frames off the divergence set) and decoded
    points as the reference codec's, attributes reordered with the points."""
    pos = _clouds(seed, f, n, dup)
    r = np.random.default_rng(seed + 10)
    colors = r.integers(0, 256, (f, n, 4))
    blobs = PointCloudSequenceCodec(device="cpu").encode(pos, colors=colors)
    jcodec = JaxPointCloudCodec()
    jblobs = jcodec.encode(pos, colors=colors)
    s = _divergence_set(pos, 11)
    assert len(blobs) == len(jblobs) == f
    for i in range(f):
        if not s[i].any():
            assert blobs[i] == jblobs[i]
    for got, want in zip(PointCloudSequenceCodec(device="cpu").decode(blobs),
                         jcodec.decode(blobs), strict=True):
        np.testing.assert_array_equal(got, want)


def test_point_cloud_codec_defaults_to_the_card():
    """No device named: the card, or an error without one."""
    if torch.cuda.is_available():
        assert PointCloudSequenceCodec().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            PointCloudSequenceCodec()
        with pytest.raises(RuntimeError):
            fit_trajectories(np.zeros((3, 4, 3), np.float32))


def test_convert_carries_the_point_cloud_codec():
    got = convert.from_jax_codec(JaxPointCloudCodec(position_bits=14), device="cpu")
    assert isinstance(got, PointCloudSequenceCodec)
    assert got.position_bits == 14 and got.device.type == "cpu"
    pos = _clouds(7, 2, 300)
    assert got.encode(pos) == JaxPointCloudCodec(position_bits=14).encode(pos)
    with pytest.raises(ValueError):
        convert.from_jax_codec(JaxPointCloudCodec(), device="cpu", mesh=object())


def test_convert_carries_a_trajectory_group():
    r = np.random.default_rng(3)
    pos = (r.normal(size=(12, 40, 3)) * 3).astype(np.float32)
    jg = jax_fit_trajectories(pos, degree=3)
    g = convert.from_jax_trajectory_group(jg)
    assert isinstance(g, TrajectoryGroup)
    assert (g.frame_count, g.degree) == (jg.frame_count, jg.degree)
    assert g.coefficients.dtype == np.float32
    np.testing.assert_array_equal(g.coefficients, np.asarray(jg.coefficients))
    assert g.coefficients is not jg.coefficients
    for k in (0, 5.5, 11):
        np.testing.assert_array_equal(g.sample(k), jg.sample(k))
    with pytest.raises(TypeError):
        convert.from_jax_trajectory_group(object())
