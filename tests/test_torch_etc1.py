"""ETC1 port (uvol_tpu_torch) against the JAX package, on the CPU.

The plain PyTorch twins must give the JAX reference's words and pixels
exactly — both its XLA formulation and its Pallas kernels, run here in
interpret mode as tests/test_pallas_parity.py runs them. The CUDA kernels
are held against the twins on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu.codecs.basis import etc as jetc
from uvol_tpu.codecs.basis import etc_pallas as jpallas
from uvol_tpu_torch.codecs.basis import etc as tetc
from uvol_tpu_torch.codecs.basis import etc_cuda


def _test_blocks() -> np.ndarray:
    """2048 random blocks, the rounding-boundary blocks of
    test_pallas_parity.py, and 256 flat blocks (one per value)."""
    r = np.random.default_rng(1)
    blocks = np.asarray(r.integers(0, 256, (2048, 4, 4, 3)), np.uint8)
    blocks[0, :, :, :] = 127
    blocks[0, 0, 0, :] = 131  # sum near a half-ulp mean boundary
    blocks[1, :, :, 1] = 128  # mean*31/255 close to n+0.5
    blocks[2] = 0
    blocks[3] = 255
    flat = np.broadcast_to(
        np.arange(256, dtype=np.uint8)[:, None, None, None], (256, 4, 4, 3)
    )
    return np.concatenate([blocks, flat])


def _words_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def blocks():
    return _test_blocks()


@pytest.fixture(scope="module")
def ref_words(blocks):
    return np.asarray(jetc.encode_etc1_blocks(jnp.asarray(blocks)))


@pytest.fixture(scope="module")
def hostile_words():
    """Arbitrary word pairs: individual-mode and clamp paths the encoder
    never emits must still decode identically."""
    return np.random.default_rng(2).integers(0, 2**32, (1536, 2), dtype=np.uint32)


def test_encode_matches_jax_xla(blocks, ref_words):
    out = _words_u32(tetc.encode_etc1_blocks(torch.from_numpy(blocks)))
    np.testing.assert_array_equal(out, ref_words)


def test_encode_matches_jax_pallas_interpret(blocks, ref_words):
    pallas = np.asarray(jpallas.encode_etc1_blocks_pallas(jnp.asarray(blocks), True))
    out = _words_u32(tetc.encode_etc1_blocks(torch.from_numpy(blocks)))
    np.testing.assert_array_equal(out, pallas)
    np.testing.assert_array_equal(pallas, ref_words)


@pytest.mark.parametrize("source", ["encoded", "random"])
def test_decode_matches_jax(source, ref_words, hostile_words):
    words = ref_words if source == "encoded" else hostile_words
    ref = np.asarray(jetc.decode_etc1_blocks(jnp.asarray(words)))
    pallas = np.asarray(jpallas.decode_etc1_blocks_pallas(jnp.asarray(words), True))
    out = tetc.decode_etc1_blocks(torch.from_numpy(words.view(np.int32).copy())).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pallas)


def test_chunked_twins_match_single_chunk(blocks, monkeypatch):
    whole = tetc.encode_etc1_blocks(torch.from_numpy(blocks))
    monkeypatch.setattr(tetc, "CHUNK", 300)  # ragged last chunk
    np.testing.assert_array_equal(
        tetc.encode_etc1_blocks(torch.from_numpy(blocks)).numpy(), whole.numpy()
    )
    np.testing.assert_array_equal(
        tetc.decode_etc1_blocks(whole).numpy(),
        np.asarray(jetc.decode_etc1_blocks(jnp.asarray(_words_u32(whole)))),
    )


def test_modifier_table_and_payload_match_jax(hostile_words):
    np.testing.assert_array_equal(tetc.MODIFIER_TABLE, jetc.MODIFIER_TABLE)
    words = hostile_words[:7]
    p = tetc.pack_etc1_payload(words)
    assert p == jetc.pack_etc1_payload(words)
    assert len(p) == 56
    assert p[0] == words[0, 0] >> 24  # big-endian: MSB of word1 first
    assert tetc.pack_etc1_payload(words.view(np.int32)) == p
    np.testing.assert_array_equal(tetc.unpack_etc1_payload(p), words)


def test_image_blocks_roundtrip_matches_jax():
    img = np.random.default_rng(3).integers(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    ref = np.asarray(jetc.image_to_blocks(jnp.asarray(img)))
    blocks = tetc.image_to_blocks(torch.from_numpy(img))
    np.testing.assert_array_equal(blocks.numpy(), ref)
    np.testing.assert_array_equal(
        tetc.blocks_to_image(blocks, 16, 24).numpy(),
        np.asarray(jetc.blocks_to_image(jnp.asarray(ref), 16, 24)),
    )


def test_cuda_wrappers_on_cpu_use_twins():
    img = np.random.default_rng(4).integers(0, 256, (3, 8, 12, 3)).astype(np.uint8)
    x = torch.from_numpy(img)
    before = dict(etc_cuda.LAUNCHES)
    words = etc_cuda.encode_etc1_images(x)
    assert words.dtype == torch.int32 and tuple(words.shape) == (3 * 6, 2)
    ref = tetc.encode_etc1_blocks(tetc.image_to_blocks(x).reshape(-1, 4, 4, 3))
    np.testing.assert_array_equal(words.numpy(), ref.numpy())
    dec = etc_cuda.decode_etc1_images(words, 3, 8, 12)
    np.testing.assert_array_equal(
        dec.numpy(),
        tetc.blocks_to_image(tetc.decode_etc1_blocks(ref).reshape(3, 6, 4, 4, 3), 8, 12)
        .numpy(),
    )
    assert etc_cuda.LAUNCHES == before  # the twins are not kernel launches


def test_cuda_wrappers_validate_inputs():
    with pytest.raises(ValueError):
        etc_cuda.encode_etc1_images(torch.zeros((1, 6, 8, 3), dtype=torch.uint8))
    with pytest.raises(ValueError):
        etc_cuda.encode_etc1_images(torch.zeros((1, 8, 8, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        etc_cuda.decode_etc1_images(torch.zeros((3, 2), dtype=torch.int32), 1, 8, 8)


def test_words2_pack_roundtrip():
    words = np.random.default_rng(5).integers(0, 2**32, (3, 10, 2), dtype=np.uint32)
    dev = etc_cuda.unpack_words2(words)
    assert dev.dtype == np.int32 and dev.shape == (30, 2)
    np.testing.assert_array_equal(etc_cuda.pack_words2(torch.from_numpy(dev), 3), words)
