"""CUDA kernels of the port against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA card and skips elsewhere. This file
imports neither JAX nor the JAX package's device code, so it runs on a
machine without JAX; `tests/conftest.py` does import JAX, so run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from uvol_tpu_torch.codecs.basis import etc as tetc
from uvol_tpu_torch.codecs.basis import etc1s_cuda, etc_cuda
from uvol_tpu_torch.entry import entry
from uvol_tpu_torch.models import sequence as tseq

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _blocks() -> np.ndarray:
    r = np.random.default_rng(1)
    blocks = r.integers(0, 256, (2048, 4, 4, 3)).astype(np.uint8)
    blocks[0] = 127
    blocks[0, 0, 0, :] = 131  # sum near a half-ulp mean boundary
    blocks[1, :, :, 1] = 128  # mean*31/255 close to n+0.5
    blocks[2] = 0
    blocks[3] = 255
    flat = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None, None],
                           (256, 4, 4, 3))
    return np.concatenate([blocks, flat])


@pytest.mark.parametrize("shape", [(1, 4, 4 * 2304), (3, 64, 96), (2, 128, 128)])
def test_encode_kernel_matches_twin(card, shape):
    l, h, w = shape
    if shape[1] == 4:  # the boundary/flat/random blocks as one strip
        img = tetc.blocks_to_image(torch.from_numpy(_blocks())[None], h, w)
    else:
        img = torch.from_numpy(
            np.random.default_rng(l).integers(0, 256, (l, h, w, 3)).astype(np.uint8)
        )
    before = etc_cuda.LAUNCHES["etc1_encode"]
    got = etc_cuda.encode_etc1_images(img.to(card))
    torch.cuda.synchronize()
    assert etc_cuda.LAUNCHES["etc1_encode"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  etc_cuda.encode_etc1_images_plain(img).numpy())
    np.testing.assert_array_equal(
        got.cpu().numpy(), etc_cuda.encode_etc1_images_plain(img.to(card)).cpu().numpy()
    )


@pytest.mark.parametrize("source", ["encoded", "random"])
def test_decode_kernel_matches_twin(card, source):
    if source == "encoded":
        words = tetc.encode_etc1_blocks(torch.from_numpy(_blocks()))
    else:
        rw = np.random.default_rng(2).integers(0, 2**32, (1536, 2), dtype=np.uint32)
        words = torch.from_numpy(rw.view(np.int32))
    n = len(words)
    before = etc_cuda.LAUNCHES["etc1_decode"]
    got = etc_cuda.decode_etc1_images(words.to(card), 1, 4, 4 * n)
    torch.cuda.synchronize()
    assert etc_cuda.LAUNCHES["etc1_decode"] == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), etc_cuda.decode_etc1_images_plain(words, 1, 4, 4 * n).numpy()
    )


def test_kernels_reject_other_layouts(card):
    with pytest.raises(ValueError):
        etc_cuda.decode_etc1_images(torch.zeros((5, 2), dtype=torch.int32, device=card),
                                    1, 8, 8)


def test_entry_on_card_matches_cpu(card):
    fwd, args = entry("cpu")
    ref = fwd(*args)
    fwd, args = entry("cuda")
    out = fwd(*args)
    torch.cuda.synchronize()
    for k in ref:
        np.testing.assert_array_equal(out[k].cpu().numpy(), ref[k].numpy(), err_msg=k)


def test_texture_codec_on_card_matches_cpu(card):
    frames = np.random.default_rng(5).integers(0, 256, (3, 64, 128, 3)).astype(np.uint8)
    cuda_codec = tseq.TextureSequenceCodec(sequence_size=3, device="cuda")
    cpu_codec = tseq.TextureSequenceCodec(sequence_size=3, device="cpu")
    blob = cuda_codec.encode_segment(frames)
    assert blob == cpu_codec.encode_segment(frames)
    from uvol_tpu.containers.ktx2 import read_ktx2

    f = read_ktx2(blob)
    np.testing.assert_array_equal(cuda_codec.decode_segment(f), cpu_codec.decode_segment(f))


# ---- ETC1S palette-build kernels K4-K6 ------------------------------------


def _etc1s_inputs(n: int, e: int, seed: int):
    r = np.random.default_rng(seed)
    blocks = _blocks()[:n] if n <= len(_blocks()) else r.integers(0, 256, (n, 16, 3))
    blocks = torch.from_numpy(np.ascontiguousarray(blocks.reshape(n, 16, 3), np.uint8))
    base = torch.from_numpy(r.integers(0, 256, (e, 3)).astype(np.int32))
    inten = torch.from_numpy(r.integers(0, 8, e).astype(np.int32))
    return blocks, base, inten


@pytest.mark.parametrize("e", [256, 1024, 2048])
def test_etc1s_assign_endpoints_kernel_matches_twin(card, e):
    blocks, base, inten = _etc1s_inputs(2304, e, e)
    table = etc1s_cuda.endpoint_table(base, inten)
    before = etc1s_cuda.LAUNCHES["etc1s_assign_endpoints"]
    got = etc1s_cuda.assign_endpoints(blocks.to(card), table.to(card))
    torch.cuda.synchronize()
    assert etc1s_cuda.LAUNCHES["etc1s_assign_endpoints"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  etc1s_cuda.assign_endpoints_plain(blocks, table).numpy())


def test_etc1s_inten_errors_kernel_matches_twin(card):
    blocks, base, _ = _etc1s_inputs(2304, 2304, 3)
    got = etc1s_cuda.inten_errors(blocks.to(card), base.to(card))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  etc1s_cuda.inten_errors_plain(blocks, base).numpy())


@pytest.mark.parametrize("k", [256, 1024, 2048])
def test_etc1s_kmeans_iter_kernel_matches_twin(card, k):
    r = np.random.default_rng(k)
    feats = torch.from_numpy((r.random((70001, 4)) * 255).astype(np.float32))
    cb = feats[torch.from_numpy(r.choice(len(feats), k, replace=False))] + 0.25
    got = etc1s_cuda.kmeans_iter(feats.to(card), cb.to(card))
    torch.cuda.synchronize()
    for g, w in zip(got, etc1s_cuda.kmeans_iter_plain(feats, cb)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_etc1s_encode_on_card_is_deterministic(card):
    from uvol_tpu_torch.codecs.basis.etc1s_encode import encode_ktx2_etc1s

    frames = np.random.default_rng(9).integers(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    first = encode_ktx2_etc1s(frames, num_endpoints=64, num_selectors=64, device="cuda")
    assert encode_ktx2_etc1s(frames, num_endpoints=64, num_selectors=64,
                             device="cuda") == first
