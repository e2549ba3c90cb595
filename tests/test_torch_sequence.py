"""Sequence codecs of the port against the JAX package, on the CPU.

Wire bytes (`.uvtg`, `.ktx2`) must be identical, each package must decode
the other's blobs, and decoded integers and faces must be identical.
Decoded geometry floats agree within 4 ulp of max|x| (see `_atol`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu.codecs.basis.etc_pallas import (
    decode_etc1_images_pallas,
    encode_etc1_images_pallas,
)
from uvol_tpu.containers.ktx2 import read_ktx2
from uvol_tpu.models import sequence as jseq
from uvol_tpu_torch.codecs.basis.etc_cuda import LAUNCHES
from uvol_tpu_torch.convert import from_jax_codec
from uvol_tpu_torch.models import sequence as tseq


def _frames(F=4, N=2000, seed=0):
    """The data of tests/test_sequence.py `_frames`."""
    r = np.random.default_rng(seed)
    theta, phi = r.uniform(0, np.pi, N), r.uniform(0, 2 * np.pi, N)
    base = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1
    )
    pos = np.stack([base * (1 + 0.05 * k) for k in range(F)]).astype(np.float32)
    uv = np.tile(r.uniform(0, 1, (1, N, 2)).astype(np.float32), (F, 1, 1))
    faces = [r.integers(0, N, (2 * N, 3)).astype(np.int32) for _ in range(F)]
    return pos, uv, np.full(F, N), faces


def _atol(x: np.ndarray) -> float:
    # XLA's CPU backend may contract the dequantize multiply-add
    # (min + q*scale) into one FMA; eager torch rounds the product first.
    # The two differ by at most a few ulp of the largest magnitude.
    return 4 * float(np.finfo(np.float32).eps) * float(np.abs(x).max())


def _textures(l, size, seed=3):
    """Channel-correlated noise (gray + small tint), as tests/test_sequence.py."""
    r = np.random.default_rng(seed)
    gray = r.uniform(0, 1, (l, size, size, 1)) * 40 + 100
    tint = r.uniform(-1, 1, (l, size, size, 3)) * 4
    return np.clip(gray + tint, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_geo():
    return jseq.GeometrySequenceCodec(position_bits=11, uv_bits=10)


@pytest.fixture(scope="module")
def torch_geo():
    return tseq.GeometrySequenceCodec(position_bits=11, uv_bits=10, device="cpu")


@pytest.mark.parametrize("ragged", [False, True])
def test_geometry_blobs_identical_and_cross_decode(ragged, jax_geo, torch_geo):
    pos, uv, counts, faces = _frames()
    if ragged:
        counts = np.array([2000, 1500, 1000, 2000])
    jfs = jseq.GeometryFrameSet(pos, uv, counts, faces)
    tfs = tseq.GeometryFrameSet(pos, uv, counts, faces)
    jb = jax_geo.encode(jfs)
    tb = torch_geo.encode(tfs)
    assert tb == jb
    jdec = jax_geo.decode(tb)  # JAX decodes the port's blobs
    tdec = torch_geo.decode(jb)  # and the port decodes JAX's
    np.testing.assert_array_equal(tdec.counts, jdec.counts)
    for a, b in zip(tdec.faces, jdec.faces):
        np.testing.assert_array_equal(a, b)
    for a, b in ((tdec.positions, jdec.positions), (tdec.uvs, jdec.uvs)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=_atol(b))
    step = float((pos[0].max(0) - pos[0].min(0)).max()) / 2047
    assert np.abs(tdec.positions[0, :2000] - pos[0]).max() <= step


def test_geometry_decode_on_device_is_planar(torch_geo):
    pos, uv, counts, faces = _frames(F=2, N=300)
    blobs = torch_geo.encode(tseq.GeometryFrameSet(pos, uv, counts, faces))
    dev = torch_geo.decode(blobs, as_numpy=False)
    host = torch_geo.decode(blobs)
    assert isinstance(dev.positions, torch.Tensor)
    assert tuple(dev.positions.shape) == (2, 3, 300)
    assert tuple(dev.uvs.shape) == (2, 2, 300)
    np.testing.assert_array_equal(dev.positions.numpy().transpose(0, 2, 1), host.positions)


def test_geometry_without_uvs_identical(jax_geo, torch_geo):
    pos, _, counts, faces = _frames(F=2, N=500, seed=1)
    jb = jax_geo.encode(jseq.GeometryFrameSet(pos, None, counts, faces))
    tb = torch_geo.encode(tseq.GeometryFrameSet(pos, None, counts, faces))
    assert tb == jb
    assert torch_geo.decode(jb).uvs is None


def test_encode_bucketed_identical(jax_geo, torch_geo):
    r = np.random.default_rng(3)
    counts = np.array([100, 120, 2000, 110, 1900, 130, 2100, 105])
    positions = [r.normal(size=(c, 3)).astype(np.float32) for c in counts]
    uvs = [r.uniform(size=(c, 2)).astype(np.float32) for c in counts]
    faces = [
        np.stack([np.arange(c - 2), np.arange(1, c - 1), np.arange(2, c)], 1).astype(np.int32)
        for c in counts
    ]
    assert torch_geo.encode_bucketed(positions, uvs, faces) == jax_geo.encode_bucketed(
        positions, uvs, faces
    )


def test_bucket_frames_copy_matches_jax():
    from uvol_tpu.parallel.mesh import bucket_frames_by_count

    counts = np.random.default_rng(9).integers(1, 5000, 40)
    for mesh_size in (1, 2, 4):
        for max_waste in (0.1, 0.25, 0.5):
            ref = bucket_frames_by_count(counts, mesh_size, max_waste)
            got = tseq.bucket_frames_by_count(counts, mesh_size, max_waste)
            assert [list(b) for b in got] == [list(b) for b in ref]


@pytest.mark.parametrize(
    "size,supercompression", [(64, "none"), (64, "zstd"), (128, "none")]
)
def test_texture_segment_identical(size, supercompression):
    frames = _textures(5, size)
    jc = jseq.TextureSequenceCodec(sequence_size=5, supercompression=supercompression)
    tc = tseq.TextureSequenceCodec(
        sequence_size=5, supercompression=supercompression, device="cpu"
    )
    before = dict(LAUNCHES)
    jblob = jc.encode_segment(frames)
    tblob = tc.encode_segment(frames)
    assert tblob == jblob
    f = read_ktx2(tblob)
    assert f.header.layer_count == 5 and f.header.vk_format == 147
    out = tc.decode_segment(f)
    np.testing.assert_array_equal(out, jc.decode_segment(f))
    dev = tc.decode_segment(f, as_numpy=False)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), out)
    assert np.abs(out.astype(int) - frames.astype(int)).mean() < 6
    assert LAUNCHES == before  # CPU tensors never launch a kernel


def test_texture_matches_jax_strip_kernels_interpret():
    """At nbx = 32 the JAX package's production form is the strip-planar
    Pallas pair; the port's words and pixels equal it too."""
    frames = _textures(1, 128, seed=4)[:, :16]  # one grid step of 4 strips
    words2 = encode_etc1_images_pallas(jnp.asarray(frames), True)  # [2, L*nb]
    tc = tseq.TextureSequenceCodec(sequence_size=1, device="cpu")
    words = tc.encode_words(frames)
    np.testing.assert_array_equal(words.numpy().T, np.asarray(words2))
    imgs = decode_etc1_images_pallas(words2, 1, 16, 128, True)
    out = tc.decode_segment(read_ktx2(tc.segment_from_words(words, 1, 16, 128)))
    np.testing.assert_array_equal(out, np.asarray(imgs))


@pytest.mark.parametrize("kind", ["geometry", "texture-zstd"])
def test_from_jax_codec_same_bytes(kind):
    if kind == "geometry":
        jc = jseq.GeometrySequenceCodec(position_bits=12, uv_bits=9)
        tc = from_jax_codec(jc, device="cpu")
        assert isinstance(tc, tseq.GeometrySequenceCodec)
        pos, uv, counts, faces = _frames(F=2, N=400, seed=2)
        args = (pos, uv, counts, faces)
        assert tc.encode(tseq.GeometryFrameSet(*args)) == jc.encode(
            jseq.GeometryFrameSet(*args)
        )
    else:
        jc = jseq.TextureSequenceCodec(sequence_size=2, supercompression="zstd")
        tc = from_jax_codec(jc, device="cpu")
        assert isinstance(tc, tseq.TextureSequenceCodec)
        frames = _textures(2, 32, seed=5)
        assert tc.encode_segment(frames) == jc.encode_segment(frames)


def test_from_jax_codec_rejects_mesh_and_strangers():
    """A meshed JAX codec needs the port's mesh of the same frames-axis
    size (tests/test_torch_multichip.py converts with one); without it
    the sizes differ and the conversion raises ValueError naming both."""
    from uvol_tpu.parallel.mesh import make_mesh

    jc = jseq.GeometrySequenceCodec(position_bits=11, uv_bits=10, mesh=make_mesh(2))
    with pytest.raises(ValueError, match="2 devices.*1 ranks"):
        from_jax_codec(jc, device="cpu")
    with pytest.raises(TypeError):
        from_jax_codec(object())


def test_codec_rejects_missing_card_and_bad_options():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tseq.GeometrySequenceCodec(device="cuda")
    with pytest.raises(ValueError):
        tseq.TextureSequenceCodec(supercompression="lz4", device="cpu")
