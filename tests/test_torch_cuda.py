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
from uvol_tpu_torch.containers.ktx2 import read_ktx2
from uvol_tpu_torch.entry import entry
from uvol_tpu_torch.models import sequence as tseq
from uvol_tpu_torch.ops import pallas_kernels

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
    f = read_ktx2(blob)
    np.testing.assert_array_equal(cuda_codec.decode_segment(f), cpu_codec.decode_segment(f))


# ---- K3: fused quantize + delta + zigzag -------------------------------------


def _offsets(f: int, c: int, n: int, seed: int):
    """Min-subtracted planar offsets and inv, as the geometry encode makes
    them, with offsets at k + 0.5 (+-1 ulp) of inv in frame 0."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy((r.normal(size=(f, c, n)) * 3).astype(np.float32))
    mask = torch.from_numpy(np.arange(n)[None, :] < np.array([n] + [n - 5] * (f - 1))[:, None])
    xm, inv, _, _ = pallas_kernels.quantize_offsets(x, 11, mask)
    half = ((np.arange(n) % 2047 + 0.5) / np.float64(inv[0])).astype(np.float32)
    steps = (np.arange(n) % 3 - 1).astype(np.int32)
    xm[0, 0] = torch.from_numpy((half.view(np.int32) + steps).view(np.float32))
    return xm, inv


@pytest.mark.parametrize("f,c,n", [(1, 3, 1), (2, 2, 513), (4, 3, 26145), (32, 2, 26145)])
def test_k3_kernel_matches_twin(card, f, c, n):
    xm, inv = _offsets(f, c, n, seed=n)
    before = pallas_kernels.LAUNCHES["quantize_delta_zigzag"]
    got = pallas_kernels.fused_quantize_delta_zigzag(xm.to(card), inv.to(card))
    torch.cuda.synchronize()
    assert pallas_kernels.LAUNCHES["quantize_delta_zigzag"] == before + 1
    want = pallas_kernels.fused_quantize_delta_zigzag_plain(xm, inv)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_geometry_codec_on_card_matches_cpu(card):
    r = np.random.default_rng(6)
    pos = r.normal(size=(3, 5000, 3)).astype(np.float32)
    uv = r.uniform(size=(3, 5000, 2)).astype(np.float32)
    counts = np.array([5000, 4000, 4999])
    faces = [r.integers(0, 4000, (3000, 3)).astype(np.int32) for _ in range(3)]
    fs = tseq.GeometryFrameSet(pos, uv, counts, faces)
    before = dict(pallas_kernels.LAUNCHES)
    blobs = tseq.GeometrySequenceCodec(device="cuda").encode(fs)
    assert pallas_kernels.LAUNCHES == {k: v + 2 for k, v in before.items()}
    assert blobs == tseq.GeometrySequenceCodec(device="cpu").encode(fs)


def _stage_inputs(f: int, c: int, n: int, seed: int):
    """A planar batch with ragged counts (one frame full, one of a single
    vertex), a frame of equal values, and rows whose minimum is both
    zeros, in both orders."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=(f, c, n)) * 11).astype(np.float32)
    counts = r.integers(1, n + 1, f)
    counts[0] = n
    if f > 1:
        counts[1] = 1
    if f > 2:
        x[2] = 1.5
    if n >= 3:
        x[0] = np.abs(x[0]) + 1
        x[0, 0, [0, n - 1]] = 0.0, -0.0
        x[0, 1, [0, n - 1]] = -0.0, 0.0
    return torch.from_numpy(x), torch.from_numpy(np.arange(n)[None, :] < counts[:, None])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("f,c,n", [(1, 3, 1), (3, 2, 5), (3, 3, 1023), (4, 2, 1024), (3, 3, 1025),
                                   (4, 3, 26145), (32, 2, 26145), (2, 3, 26144)])
def test_geometry_stage_kernels_match_twin(card, f, c, n, offset):
    """syms, min and range bit for bit (the sign of a zero minimum too),
    two launches; `offset` 1 puts the batch 4 bytes off a 16-byte boundary
    (K3's scalar loads and stores)."""
    x, mask = _stage_inputs(f, c, n, seed=n + f + c)
    flat = torch.zeros(x.numel() + offset)
    flat[offset:] = x.reshape(-1)
    xd = flat.to(card)[offset:].view(f, c, n)
    assert xd.data_ptr() % 16 == 4 * offset
    before = dict(pallas_kernels.LAUNCHES)
    got = pallas_kernels.geometry_quantize_stage(xd, mask.to(card), 11)
    torch.cuda.synchronize()
    assert pallas_kernels.LAUNCHES == {k: v + 1 for k, v in before.items()}
    twins = (pallas_kernels.geometry_quantize_stage_plain(x, mask, 11),
             pallas_kernels.geometry_quantize_stage_plain(xd, mask.to(card), 11))
    for want in twins:
        for g, w, name in zip(got, want, ("syms", "min", "range")):
            np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                          w.cpu().numpy().view(np.int32), err_msg=name)


def test_geometry_stage_kernels_on_a_frame_without_a_valid_vertex(card):
    x, mask = _stage_inputs(3, 3, 700, seed=2)
    mask[1] = False
    got = pallas_kernels.geometry_quantize_stage(x.to(card), mask.to(card), 10)
    torch.cuda.synchronize()
    for g, w in zip(got, pallas_kernels.geometry_quantize_stage_plain(x, mask, 10)):
        np.testing.assert_array_equal(g.cpu().numpy().view(np.int32), w.numpy().view(np.int32))


# ---- ETC1S palette-build kernels K4-K6 ------------------------------------


def _etc1s_inputs(n: int, e: int, seed: int):
    r = np.random.default_rng(seed)
    blocks = _blocks()[:n] if n <= len(_blocks()) else r.integers(0, 256, (n, 16, 3))
    blocks = torch.from_numpy(np.ascontiguousarray(blocks.reshape(n, 16, 3), np.uint8))
    base = torch.from_numpy(r.integers(0, 256, (e, 3)).astype(np.int32))
    inten = torch.from_numpy(r.integers(0, 8, e).astype(np.int32))
    return blocks, base, inten


@pytest.mark.parametrize("e", [256, 1024, 2048, 2049, 4096, 16128])
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


@pytest.mark.parametrize("k", [256, 1024, 2048, 2049, 4096, 16128])
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


# ---- the fixed-order segment sum, K6 and K1 as redesigned ------------------


def _seg_inputs(n: int, k: int, d: int, seed: int):
    r = np.random.default_rng(seed)
    idx = torch.from_numpy(r.integers(0, k, n))
    x = r.normal(size=(n, d)) * 10.0 ** r.integers(-3, 8, (n, d))
    x[r.random((n, d)) < 0.1] = -0.0
    return idx, torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("k,d", [(1, 9), (128, 33), (256, 9), (256, 33), (256, 8), (256, 4),
                                 (256, 64), (2048, 64), (2049, 64), (4096, 9), (4096, 64),
                                 (16128, 64)])
@pytest.mark.parametrize("n", [65, 20000])
def test_segment_sum_kernel_matches_twin(card, n, k, d):
    """Bit for bit, signed zeros included, at the palette build's (k, D)."""
    idx, x = _seg_inputs(n, k, d, n + k + d)
    before = etc1s_cuda.LAUNCHES["etc1s_segment_sum"]
    got = etc1s_cuda.segment_sum(idx.to(card), k, x.to(card))
    torch.cuda.synchronize()
    assert etc1s_cuda.LAUNCHES["etc1s_segment_sum"] == before + 1
    want = etc1s_cuda.segment_sum_plain(idx, k, x)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("n,k", [(1, 256), (63, 256), (65, 256), (1025, 256), (70001, 256),
                                 (1025, 1), (1025, 2048), (1025, 2049), (3, 16128)])
def test_etc1s_kmeans_iter_kernel_at_odd_rows(card, n, k):
    r = np.random.default_rng(n + k)
    feats = torch.from_numpy((r.random((n, 4)) * 255).astype(np.float32))
    cb = feats[torch.from_numpy(r.integers(0, n, k))] + 0.5
    got = etc1s_cuda.kmeans_iter(feats.to(card), cb.to(card))
    torch.cuda.synchronize()
    for g, w in zip(got, etc1s_cuda.kmeans_iter_plain(feats, cb)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _hold_segment_sum(card, idx, k, x):
    before = etc1s_cuda.LAUNCHES["etc1s_segment_sum"]
    got = etc1s_cuda.segment_sum(idx.to(card), k, x.to(card))
    torch.cuda.synchronize()
    assert etc1s_cuda.LAUNCHES["etc1s_segment_sum"] == before + 1
    want = etc1s_cuda.segment_sum_plain(idx, k, x)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("d", [1, 4, 8, 9, 33, 64])
@pytest.mark.parametrize("k", [1, 7, 1024, 2048])
@pytest.mark.parametrize("n", [1, 63, 1023, 1025, 3077])
def test_segment_sum_kernel_at_tile_chunk_and_group_edges(card, n, k, d):
    """Bit for bit at every column-group layout (one group; 3 of 11
    columns; 4 of 16) and chunk count, absent segments included."""
    idx, x = _seg_inputs(n, k, d, 7 * n + k + d)
    _hold_segment_sum(card, idx, k, x)


@pytest.mark.parametrize("k,d", [(2, 9), (256, 64), (1024, 64)])
@pytest.mark.parametrize("n", [1025, 70001])
def test_segment_sum_kernel_on_skewed_assignments(card, n, k, d):
    """90% of the rows in one segment: its runs are whole tiles."""
    idx, x = _seg_inputs(n, k, d, n + 3 * k)
    r = np.random.default_rng(n)
    idx = torch.where(torch.from_numpy(r.random(n) < 0.9), k // 2, idx)
    _hold_segment_sum(card, idx, k, x)


@pytest.mark.parametrize("n", [64, 1000, 1024, 3000])
def test_segment_sum_kernel_with_negative_zeros_beside_absent_tiles(card, n):
    idx = torch.from_numpy(np.arange(n) % 2)
    idx[::97] = 2
    _, x = _seg_inputs(n, 3, 9, n)
    x[(idx == 0) | (idx == 2)] = -0.0
    _hold_segment_sum(card, idx, 3, x)


def test_segment_sum_kernel_reads_values_off_a_16_byte_boundary(card):
    """x one float into its buffer: the 4-byte copies, D = 64."""
    idx, x = _seg_inputs(3000, 256, 64, 4)
    xd = torch.cat([x.reshape(-1)[:1], x.reshape(-1)]).to(card)[1:].reshape(3000, 64)
    assert xd.data_ptr() % 16 == 4
    got = etc1s_cuda.segment_sum(idx.to(card), 256, xd)
    want = etc1s_cuda.segment_sum_plain(idx, 256, x)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("k", [1, 7, 1024])
@pytest.mark.parametrize("n", [63, 1024, 3077])
def test_etc1s_kmeans_iter_kernel_at_tile_and_chunk_edges(card, n, k):
    r = np.random.default_rng(n * 5 + k)
    feats = torch.from_numpy((r.random((n, 4)) * 255).astype(np.float32))
    feats[::5] = feats[0]  # duplicate rows: long runs of one centroid
    cb = feats[torch.from_numpy(r.integers(0, n, k))] + 0.5
    before = etc1s_cuda.LAUNCHES["etc1s_kmeans_iter"]
    got = etc1s_cuda.kmeans_iter(feats.to(card), cb.to(card))
    torch.cuda.synchronize()
    assert etc1s_cuda.LAUNCHES["etc1s_kmeans_iter"] == before + 1
    for g, w in zip(got, etc1s_cuda.kmeans_iter_plain(feats, cb)):
        np.testing.assert_array_equal(g.cpu().numpy().view(np.int32), w.numpy().view(np.int32))


@pytest.mark.parametrize("shape,offset", [((2, 8, 1028, 3), 0), ((1, 16, 1024, 3), 3)])
def test_encode_kernel_other_widths_and_offsets(card, shape, offset):
    """A width whose rows are not 16-byte aligned (two runs per block row),
    and an image whose data starts off a 16-byte boundary."""
    n = int(np.prod(shape))
    flat = np.random.default_rng(offset).integers(0, 256, n + offset).astype(np.uint8)
    img = torch.from_numpy(flat).to(card)[offset:].view(shape)
    got = etc_cuda.encode_etc1_images(img)
    torch.cuda.synchronize()
    want = etc_cuda.encode_etc1_images_plain(torch.from_numpy(flat[offset:].reshape(shape)))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_etc1s_encode_on_card_matches_cpu_at_256(card):
    from uvol_tpu_torch.codecs.basis.etc1s_encode import encode_ktx2_etc1s

    yy, xx = np.mgrid[0:256, 0:256]
    frames = np.stack([(xx // 4) % 256, (yy // 4) % 256, ((xx + yy) // 8) % 256],
                      -1)[None].astype(np.uint8)
    kw = dict(num_endpoints=256, num_selectors=256)
    first = encode_ktx2_etc1s(frames, device="cuda", **kw)
    assert encode_ktx2_etc1s(frames, device="cuda", **kw) == first
    assert encode_ktx2_etc1s(frames, device="cpu", **kw) == first


# ---- K2 and K5 as redesigned ---------------------------------------------------


def _hostile_words(n: int, seed: int) -> torch.Tensor:
    """Random bit patterns: both modes, both flips, every table, differential
    sums outside 0..31."""
    rw = np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint32)
    return torch.from_numpy(rw.view(np.int32))


@pytest.mark.parametrize("shape", [(1, 4, 4), (3, 12, 20), (1, 4, 36), (2, 16, 16),
                                   (2, 1024, 1028), (1, 8, 4 * 300), (4, 1024, 1024)])
def test_decode_kernel_on_hostile_words_at_every_store_path(card, shape):
    """One block; widths whose rows are not 16-byte aligned (4-byte
    stores), one of them two runs wide; widths that are (16-byte stores),
    one with a short second run."""
    l, h, w = shape
    words = _hostile_words(l * (h // 4) * (w // 4), l + h + w)
    got = etc_cuda.decode_etc1_images(words.to(card), l, h, w)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(), etc_cuda.decode_etc1_images_plain(words, l, h, w).numpy())


def test_decode_kernel_takes_words_that_are_only_8_byte_aligned(card):
    l, h, w = 2, 64, 80
    words = _hostile_words(l * (h // 4) * (w // 4) + 1, 11)
    shifted = words.to(card)[1:]  # a contiguous slice: 8 bytes off a 16-byte boundary
    assert shifted.data_ptr() % 16 == 8
    got = etc_cuda.decode_etc1_images(shifted, l, h, w)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(), etc_cuda.decode_etc1_images_plain(words[1:], l, h, w).numpy())


@pytest.mark.parametrize("bases", ["zero", "full", "mixed", "one_channel_clips"])
@pytest.mark.parametrize("n", [1, 255, 257, 70001])
def test_etc1s_inten_errors_kernel_at_odd_rows_and_pinned_bases(card, n, bases):
    r = np.random.default_rng(n)
    blocks = torch.from_numpy(r.integers(0, 256, (n, 16, 3), dtype=np.uint8))
    base = r.integers(0, 256, (n, 3)).astype(np.int32)
    if bases == "zero":
        base[:] = 0
    elif bases == "full":
        base[:] = 255
    elif bases == "one_channel_clips":
        base = r.integers(110, 146, (n, 3)).astype(np.int32)
        base[:, 1] = r.integers(0, 256, n)
    else:
        base[::2] = r.integers(110, 146, (len(base[::2]), 3))  # tables 0..6 open
    base = torch.from_numpy(base)
    before = etc1s_cuda.LAUNCHES["etc1s_inten_errors"]
    got = etc1s_cuda.inten_errors(blocks.to(card), base.to(card))
    torch.cuda.synchronize()
    assert etc1s_cuda.LAUNCHES["etc1s_inten_errors"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  etc1s_cuda.inten_errors_plain(blocks, base).numpy())


def test_etc1s_inten_errors_kernel_takes_blocks_off_a_16_byte_boundary(card):
    r = np.random.default_rng(12)
    flat = torch.from_numpy(r.integers(0, 256, 300 * 48 + 4, dtype=np.uint8))
    base = torch.from_numpy(r.integers(0, 256, (300, 3)).astype(np.int32))
    blocks = flat.to(card)[4:].view(300, 16, 3)
    assert blocks.data_ptr() % 16 == 4
    got = etc1s_cuda.inten_errors(blocks, base.to(card))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        etc1s_cuda.inten_errors_plain(flat[4:].view(300, 16, 3), base).numpy())


# ---- above the row limit ------------------------------------------------------------


def test_segment_sum_and_kmeans_above_the_row_limit_match_twins(card, monkeypatch):
    """The limit passed down small: the card sums chunks of so many rows
    and adds them in the twin's order, bit for bit."""
    monkeypatch.setattr(etc1s_cuda, "SEG_MAX_ROWS", 2048)
    idx, x = _seg_inputs(7001, 256, 9, 5)
    before = etc1s_cuda.LAUNCHES["etc1s_segment_sum"]
    got = etc1s_cuda.segment_sum(idx.to(card), 256, x.to(card))
    torch.cuda.synchronize()
    assert etc1s_cuda.LAUNCHES["etc1s_segment_sum"] == before + 4  # one per chunk
    want = etc1s_cuda.segment_sum_plain(idx, 256, x)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), want.numpy().view(np.int32))
    r = np.random.default_rng(8)
    feats = torch.from_numpy((r.random((7001, 4)) * 255).astype(np.float32))
    cb = feats[torch.from_numpy(r.integers(0, 7001, 64))] + 0.5
    got = etc1s_cuda.kmeans_iter(feats.to(card), cb.to(card))
    torch.cuda.synchronize()
    for g, w in zip(got, etc1s_cuda.kmeans_iter_plain(feats, cb)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_palette_core_on_card_refuses_tf32(card):
    from uvol_tpu_torch.codecs.basis.etc1s_encode import palette_core

    blocks = torch.from_numpy(_blocks()[:256].reshape(256, 16, 3)).to(card)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            palette_core(blocks, 16, 16, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    assert len(palette_core(blocks, 16, 16, 2)) == 5


def test_redesigned_kernels_use_no_stack(card):
    from uvol_tpu_torch import _build

    attrs = _build.kernel_attrs()
    for fn in ("etc1_encode_kernel", "etc1_decode_kernel", "inten_errors_kernel",
               "geometry_minmax_kernel", "quantize_delta_zigzag_kernel", "rate_sweep_frame_kernel",
               "uastc_device_fit_kernel", "weight_index_kernel", "seg_sum_chunk_kernel",
               "seg_sum_tree_kernel", "seg_sum_tree_kernel_small", "drc_fused_batch_kernel"):
        assert attrs[fn]["stack_bytes"] == 0, (fn, attrs[fn])


# ---- K7: the rate sweep's frame stage ------------------------------------------


def _sweep_frame(nby: int, nbx: int, e: int, seed: int, dup: bool = False, prev: bool = True):
    """One frame for K7: blocks decoded from random (entry, selector) pairs
    plus noise, a palette of e entries (with `dup`, its second half repeats
    its first: ties), 8 selector rows (row 0 uniform, the flat blocks'),
    random incoming entries, and a previous pair that is the true one for
    half the blocks (CR competes there). Returns the wrapper's arguments
    before s0_index = 0, as CPU tensors."""
    from uvol_tpu_torch.codecs.basis.etc1s_encode import sweep_bits_table

    r = np.random.default_rng(seed)
    nb = nby * nbx
    c5 = r.integers(0, 32, (e, 3))
    inten = r.integers(0, 8, e)
    if dup and e > 1:
        c5[e - e // 2:], inten[e - e // 2:] = c5[:e // 2], inten[:e // 2]
    base = ((c5 << 3) | (c5 >> 2)).astype(np.int32)
    mods = np.array(etc1s_cuda.INTEN_TABLES, np.int32)[inten]
    sel_cb = r.integers(0, 4, (8, 16)).astype(np.int32)
    sel_cb[0] = 2
    true_ep, true_sel = r.integers(0, e, nb), r.integers(0, 8, nb)
    col = np.clip(base[true_ep][:, None, :]
                  + mods[true_ep][np.arange(nb)[:, None], sel_cb[true_sel]][:, :, None], 0, 255)
    blocks = np.clip(col + r.integers(-3, 4, col.shape), 0, 255).astype(np.uint8)
    ep = np.where(r.random(nb) < 0.3, true_ep, r.integers(0, e, nb)).astype(np.int32)
    half = r.random(nb) < 0.5
    pair = (np.where(half, true_ep, r.integers(0, e, nb)).astype(np.int32),
            np.where(half, true_sel, r.integers(0, 8, nb)).astype(np.int32))
    t = torch.from_numpy
    return (t(blocks), t(base), t(mods), t(sel_cb), t(sweep_bits_table(e)), t(ep),
            t(true_sel.astype(np.int32)), (t(pair[0]), t(pair[1])) if prev else None)


def _on(card, args):
    return tuple(_on(card, a) if isinstance(a, tuple) else a.to(card) if a is not None else None
                 for a in args)


@pytest.mark.parametrize("prev", [True, False])
@pytest.mark.parametrize("nby,nbx", [(1, 1), (1, 300), (257, 3), (64, 256)])
@pytest.mark.parametrize("e", [17, 512, 2048, 2049, 4096, 16128])
def test_rate_sweep_kernel_matches_twin(card, e, nby, nbx, prev):
    """New entries and selectors bit for bit, one launch per frame, with
    and without a previous frame; on a frame with one, some blocks keep
    the previous pair and some do not."""
    args = _sweep_frame(nby, nbx, e, e + nbx + nby, prev=prev)
    before = etc1s_cuda.LAUNCHES["etc1s_rate_sweep"]
    got = etc1s_cuda.rate_sweep_frame(*_on(card, args), 0, 60.0, 1.5, nbx)
    torch.cuda.synchronize()
    assert etc1s_cuda.LAUNCHES["etc1s_rate_sweep"] == before + 1
    small = nby * nbx * e <= 1 << 20
    twin = etc1s_cuda.rate_sweep_frame_plain(*(args if small else _on(card, args)), 0, 60.0,
                                             1.5, nbx)
    for g, w in zip(got, twin):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    if prev and nby * nbx > 64:
        kept = got[0].cpu() == args[7][0]
        assert kept.any() and not kept.all()


@pytest.mark.parametrize("e", [40, 512, 2048, 4096])
def test_rate_sweep_kernel_breaks_ties_to_the_first_entry(card, e):
    """lam 0 over a palette whose second half repeats its first: every tie
    between two equal entries goes to the first, on the card as in the
    twin, so a block ends on a second-half entry only by taking its
    previous one."""
    args = _sweep_frame(65, 19, e, e, dup=True)
    got = etc1s_cuda.rate_sweep_frame(*_on(card, args), 0, 0.0, 1.5, 19)
    torch.cuda.synchronize()
    for g, w in zip(got, etc1s_cuda.rate_sweep_frame_plain(*args, 0, 0.0, 1.5, 19)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    ep = got[0].cpu()
    assert ((ep < e // 2) | (ep == args[7][0])).all()  # a second-half entry only by CR


@pytest.mark.parametrize("kind", ["rgb_512", "rgba_1024"])
def test_etc1s_delta_encode_on_card_matches_cpu(card, kind):
    """The delta-aware stage on 2 x 64x64 (RGBA: 1,024 blocks, so 1,024
    entries): the card's bytes equal the CPU port's, with K7 once per
    frame of each of 3 sweeps."""
    from uvol_tpu_torch.codecs.basis.etc1s_encode import encode_ktx2_etc1s

    yy, xx = np.mgrid[0:64, 0:64]
    r = np.random.default_rng(3)
    frames = np.stack([np.clip(np.stack([(xx * 4 + i * 8) % 256, (yy * 4) % 256,
                                         ((xx + yy) * 2) % 256], -1)
                               + r.integers(-6, 7, (64, 64, 3)), 0, 255)
                       for i in range(2)]).astype(np.uint8)
    if kind == "rgba_1024":
        alpha = np.clip(xx * 4 - np.arange(2)[:, None, None], 0, 255).astype(np.uint8)
        frames = np.concatenate([frames, alpha[..., None]], -1)
    e_n = int(kind.split("_")[1])
    kw = dict(num_endpoints=e_n, num_selectors=e_n)
    etc1s_cuda.reset_launches()
    got = encode_ktx2_etc1s(frames, device="cuda", **kw)
    sweeps = etc1s_cuda.LAUNCHES["etc1s_rate_sweep"]
    assert sweeps > 0 and sweeps % (3 * 2) == 0
    assert got == encode_ktx2_etc1s(frames, device="cpu", **kw)


# ---- K8: the real-.drc decode's device stage ---------------------------------------

#: (kind, mode, values hi) of random K8 attributes: every mode; mode 16 and 32
#: signed, at their extremes
_DRC_ATTRS = ((1, 8, 1 << 8), (1, 10, 1 << 10), (1, 12, 1 << 12), (1, 16, 1 << 16),
              (1, 32, 1 << 32), (2, 8, 1 << 8), (2, 10, 1 << 10), (2, 16, 1 << 16))


def _drc_window(specs_in, f: int, nmax: int, seed: int, maxv=(254.0,), pad: int = 0,
                lead: int = 0):
    """A packed K8 window of random attributes: specs_in is [(kind, mode,
    hi[, nc])]; kind 1 takes nc (default 3) components, kind 2 the
    normals' 2; mode 16 and 32 values are signed, with both extremes
    present; `maxv` cycles over the frames; `lead` bytes before the first
    attribute and `pad` extra bytes before the 4-aligned metadata. Returns
    (packed uint8 tensor, specs, meta_off, meta_len)."""
    from uvol_tpu_torch.models.drc_device import _pack_host

    r = np.random.default_rng(seed)
    chunks, metas, specs = [np.full(lead, 0xA5, np.uint8)], [], []
    off, moff = lead, 0
    for t, (kind, mode, hi, *nc) in enumerate(specs_in):
        nc = nc[0] if nc else 3 if kind == 1 else 2
        n = f * nmax * nc
        lo = -(hi // 2) if mode in (16, 32) else 0
        ints = r.integers(lo, lo + hi, n, dtype=np.int64)
        ints[:2] = lo, lo + hi - 1
        by = _pack_host(ints, mode)
        if kind == 1:
            meta = np.concatenate([r.normal(size=f * nc) * 5, r.uniform(1e-4, 1e-2, f)])
        else:
            meta = np.resize(np.asarray(maxv, np.float64), f)
        specs.append((t, kind, mode, f, nmax, nc, off, len(meta), moff))
        chunks.append(by)
        metas.append(meta.astype(np.float32))
        off += len(by)
        moff += len(meta)
    pad += (-(off + pad)) % 4
    meta_all = np.concatenate(metas)
    packed = np.concatenate(chunks + [np.zeros(pad, np.uint8), meta_all.view(np.uint8)])
    return torch.from_numpy(packed), tuple(specs), off + pad, len(meta_all)


def _hold_bits(got, want):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    gn, wn = np.isnan(g), np.isnan(w)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(g[~gn].view(np.int32), w[~wn].view(np.int32))


@pytest.mark.parametrize("attr", range(len(_DRC_ATTRS)))
@pytest.mark.parametrize("nmax", [1, 3, 1001, 4096, 4097])
def test_drc_fused_batch_kernel_matches_twin(card, attr, nmax):
    """K8 against its twin bit for bit, NaN positions included: every mode
    and kind, value counts off every group size and off a CTA's 1,024,
    mode 16 and 32 at their extremes, maxv 254, 0 and -1 (0/0, ±inf)."""
    from uvol_tpu_torch.models import drc_device as dd

    packed, specs, mo, ml = _drc_window([_DRC_ATTRS[attr]], 3, nmax, attr + nmax,
                                        maxv=(254.0, 0.0, -1.0))
    before = dd.LAUNCHES["drc_fused_batch"]
    got = dd.fused_batch(packed.to(card), specs, mo, ml)
    torch.cuda.synchronize()
    assert dd.LAUNCHES["drc_fused_batch"] == before + 1
    for g, w, w2 in zip(got, dd.fused_batch_plain(packed.to(card), specs, mo, ml),
                        dd.fused_batch_plain(packed, specs, mo, ml)):
        _hold_bits(g, w)
        _hold_bits(g, w2)


@pytest.mark.parametrize("pad", [0, 1, 2, 3])
def test_drc_fused_batch_kernel_on_a_whole_window(card, pad):
    """Four attributes in one launch (the table's most), the metadata at
    an offset that only just meets the 4-byte alignment."""
    from uvol_tpu_torch.models import drc_device as dd

    packed, specs, mo, ml = _drc_window([(1, 12, 1 << 11), (1, 10, 1 << 10), (2, 8, 255),
                                         (1, 16, 1 << 16)], 8, 4097, pad, pad=pad)
    got = dd.fused_batch(packed.to(card), specs, mo, ml)
    for g, w in zip(got, dd.fused_batch_plain(packed, specs, mo, ml)):
        _hold_bits(g, w)
    with pytest.raises(ValueError, match="at most"):
        dd.fused_batch(packed.to(card), specs + specs[:1], mo, ml)


def _on_card_at(card, packed: torch.Tensor, base: int) -> torch.Tensor:
    """The window on the card as a view whose first byte lies `base` bytes
    past a 16-byte boundary (the caching allocator's blocks are 512-aligned)."""
    big = torch.zeros(len(packed) + 32, dtype=torch.uint8, device=card)
    view = big[base:base + len(packed)]
    view.copy_(packed.to(card))
    assert view.data_ptr() % 16 == base
    return view


def _hold_k8(card, packed, specs, mo, ml, base):
    from uvol_tpu_torch.models import drc_device as dd

    got = dd.fused_batch(_on_card_at(card, packed, base), specs, mo, ml)
    for g, w in zip(got, dd.fused_batch_plain(packed, specs, mo, ml), strict=True):
        assert g.is_contiguous() and g.data_ptr() % 16 == 0
        _hold_bits(g, w)
    return got


@pytest.mark.parametrize("nmax", [1, 3, 1001, 4096, 4097])
@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", [8, 10, 12, 16, 32])
def test_drc_fused_batch_kernel_at_every_component_count(card, mode, nc, nmax):
    """Kind 1 at 1-4 components, frames that CTAs cross (all but 4,096),
    the attribute at a residue mod 16 and the window off a 16-byte boundary."""
    lead = (mode * 7 + nc * 3 + nmax) % 16
    packed, specs, mo, ml = _drc_window([(1, mode, 1 << min(mode, 31), nc)], 3, nmax,
                                        mode + nc + nmax, lead=lead)
    _hold_k8(card, packed, specs, mo, ml, (4 - mo) % 4 + 4 * (nmax % 4))


@pytest.mark.parametrize("lead", range(16))
def test_drc_fused_batch_kernel_at_every_offset_residue(card, lead):
    """Four attributes, the first at each residue mod 16, the window at two
    offsets from a 16-byte boundary."""
    packed, specs, mo, ml = _drc_window([(1, 12, 1 << 12), (1, 10, 1 << 10, 2), (2, 8, 255),
                                         (1, 16, 1 << 16, 4)], 2, 4096, lead, pad=lead % 4,
                                        lead=lead)
    for base in ((4 - mo) % 4, (4 - mo) % 4 + 8):
        _hold_k8(card, packed, specs, mo, ml, base)


@pytest.mark.parametrize("base", range(0, 16, 4))
@pytest.mark.parametrize("nmax", [1001, 1003])
def test_drc_fused_batch_kernel_on_a_window_that_ends_in_its_metadata(card, nmax, base):
    """One frame of normals: 4 bytes of metadata after the attribute, so
    the 16-byte piece of its last bytes reaches past the window's end."""
    packed, specs, mo, ml = _drc_window([(2, 8, 255)], 1, nmax, nmax + base)
    _hold_k8(card, packed, specs, mo, ml, base)


def test_drc_fused_batch_caches_its_plan_and_checks_every_window(card):
    """A cache hit and a miss on a new meta_len give the outputs of a fresh
    call; a window one byte short of a cached key raises ValueError."""
    from uvol_tpu_torch.models import drc_device as dd

    packed, specs, mo, ml = _drc_window([(1, 12, 1 << 12), (2, 8, 255)], 8, 4096, 5)
    dd._PLANS.clear()
    fresh = _hold_k8(card, packed, specs, mo, ml, 0)
    hit = _hold_k8(card, packed, specs, mo, ml, 4)
    assert len(dd._PLANS) == 1
    longer = torch.cat([packed, torch.zeros(4, dtype=torch.uint8)])
    miss = _hold_k8(card, longer, specs, mo, ml + 1, 0)
    assert len(dd._PLANS) == 2
    for a, b, c in zip(fresh, hit, miss, strict=True):
        _hold_bits(a, b)
        _hold_bits(a, c)
    with pytest.raises(ValueError, match="outside a window"):
        dd.fused_batch(packed.to(card)[:-1], specs, mo, ml)


def _grid_blobs(count: int, ny: int = 9, nx: int = 13):
    from uvol_tpu_torch.codecs.draco.grid import grid_drc

    return [grid_drc(ny, nx, seed) for seed in range(count)]


def _hold_batch(got, want):
    assert got.num_points == want.num_points
    for a, b in zip(got.faces, want.faces):
        np.testing.assert_array_equal(a, b)
    assert got.counts.keys() == want.counts.keys()
    for t, v in want.values.items():
        np.testing.assert_array_equal(got.counts[t], want.counts[t])
        if isinstance(v, list):
            for a, b in zip(got.values[t], v):
                np.testing.assert_array_equal(a, b)
        else:
            _hold_bits(got.values[t], v)


def test_drc_decode_on_card_matches_cpu(card):
    """decode_drc_batch: one H2D copy and one K8 launch a window; the
    card's batch equals the CPU port's bit for bit."""
    from uvol_tpu_torch.models import drc_device as dd

    blobs = _grid_blobs(5)
    before = dd.LAUNCHES["drc_fused_batch"]
    got = dd.decode_drc_batch(blobs)
    assert dd.LAUNCHES["drc_fused_batch"] == before + 1
    assert isinstance(got.token, torch.cuda.Event) and got.token.query()
    _hold_batch(got, dd.decode_drc_batch(blobs, device="cpu"))
    host = dd.decode_drc_batch(blobs, as_numpy=True)
    for t, v in host.values.items():
        assert isinstance(v, np.ndarray)
        _hold_bits(torch.from_numpy(v), got.values[t])


def test_drc_stream_reuses_the_pinned_pool(card):
    """36 windows through a pool of 6 pinned buffers: every window equals
    the CPU batch of its slice, so no buffer was overwritten while its
    copy was in flight."""
    from uvol_tpu_torch.models import drc_device as dd

    blobs = _grid_blobs(12)
    blobs = [blobs[i % 12] for i in range(72)]
    want = {s: dd.decode_drc_batch(blobs[s:s + 2], device="cpu") for s in range(0, 24, 2)}
    seen = 0
    for start, batch in dd.decode_drc_stream(blobs, window=2, lookahead=4):
        _hold_batch(batch, want[start % 24])
        seen += len(batch.faces)
    assert seen == 72
    assert dd._POOL._made <= dd.PINNED_POOL_SIZE


def test_ring_buffer_on_card(card):
    from uvol_tpu_torch.runtime.device_stream import DeviceRingBuffer, stream_frames

    frames = [np.full((64, 64), i, np.float32) for i in range(7)]
    out = list(stream_frames(frames, lambda x: (x * 2.0).sum()))
    assert [i for i, _ in out] == list(range(7))
    for i, r in out:
        assert float(r) == float(np.sum(frames[i] * 2.0))
    ring = DeviceRingBuffer()
    dev = ring.put(0, (frames[1], {"a": frames[2]}))
    assert dev[0].device.type == "cuda" and float(dev[1]["a"][0, 0]) == 2.0


# ---- the encoder CLI and the player on the card ------------------------------------


def _png(path, img: np.ndarray) -> None:
    """An RGB PNG with zlib alone (Pillow may be absent where the card is)."""
    import struct
    import zlib

    h, w, _ = img.shape
    raw = b"".join(b"\0" + img[y].tobytes() for y in range(h))

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                                     0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _cli_project(root, out_dir, **over) -> str:
    """5 OBJ frames of 6 x 8 grids and 5 layers of 32 x 32, 3 layers a segment."""
    import json

    from uvol_tpu_torch.codecs.draco.grid import grid_mesh

    (root / "OBJ").mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    r = np.random.default_rng(9)
    for i in range(5):
        pos, uv, nrm, faces = grid_mesh(6, 8, seed=i)
        lines = [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in pos.tolist()]
        lines += [f"vt {a:.6f} {b:.6f}" for a, b in uv.tolist()]
        lines += [f"vn {a:.6f} {b:.6f} {c:.6f}" for a, b, c in nrm.tolist()]
        lines += ["f {0}/{0}/{0} {1}/{1}/{1} {2}/{2}/{2}".format(*f) for f in (faces + 1).tolist()]
        (root / "OBJ" / f"{i:05d}.obj").write_text("\n".join(lines) + "\n")
        _png(root / "images" / f"{i:05d}.png", r.integers(40, 220, (32, 32, 3)).astype(np.uint8))
    cfg = {"name": "card", "OBJFilesPath": f"{root}/OBJ/[#####].obj",
           "ImagesPath": f"{root}/images/[#####].png", "OutputDirectory": str(out_dir),
           "KTX2_BATCH_SIZE": 3, "ETC1S_ENDPOINTS": 16, "ETC1S_SELECTORS": 16,
           "ENCODE_WORKERS": 2, **over}
    path = root / f"{out_dir.name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("geometry,texture", [("draco", "etc1s,etc"), ("uvtg", "etc1s,etc")])
def test_encoder_cli_on_card_writes_the_cpu_files(card, tmp_path, monkeypatch, geometry, texture):
    from uvol_tpu_torch.encoder_cli import main as cli_main

    files = {}
    for where in ("cuda", "cpu"):
        if where == "cpu":
            monkeypatch.setenv("UVT_PLATFORM", "cpu")
        else:
            monkeypatch.delenv("UVT_PLATFORM", raising=False)
        out = tmp_path / where
        before = {**etc_cuda.LAUNCHES, **pallas_kernels.LAUNCHES}
        assert cli_main([_cli_project(tmp_path, out, GEOMETRY_CODEC=geometry,
                                      TEXTURE_CODEC=texture)]) == 0
        after = {**etc_cuda.LAUNCHES, **pallas_kernels.LAUNCHES}
        launched = {k for k in after if after[k] > before[k]}
        if where == "cuda":
            assert "etc1_encode" in launched
            assert ("quantize_delta_zigzag" in launched) == (geometry == "uvtg")
        else:
            assert not launched
        files[where] = {str(p.relative_to(out)): p.read_bytes() for p in out.rglob("*")
                        if p.is_file()}
    assert sorted(files["cuda"]) == sorted(files["cpu"])
    for name, data in files["cpu"].items():
        assert files["cuda"][name] == data, name


def test_player_on_card_plays_like_the_cpu_player(card, tmp_path, monkeypatch):
    from uvol_tpu_torch.encoder_cli import main as cli_main
    from uvol_tpu_torch.interfaces import PlayMode
    from uvol_tpu_torch.player import PlaybackClock, Player, VirtualClock

    monkeypatch.setenv("UVT_PLATFORM", "cpu")
    out = tmp_path / "out"
    assert cli_main([_cli_project(tmp_path, out, GEOMETRY_CODEC="uvtg", TEXTURE_CODEC="etc")]) == 0
    runs = {}
    for device in ("cuda", "cpu"):
        vc, ended = VirtualClock(), []
        p = Player(play_mode=PlayMode.single, paths=[str(out / "card.uvol.json")],
                   on_track_end=lambda: ended.append(1), device=device,
                   v2_player_kwargs={"clock": PlaybackClock(now=vc), "async_prefetch": True})
        p.set_track_path()
        ticks = []
        while not ended and len(ticks) < 200:
            p.v2_instance._geo_pool.wait_idle()
            p.v2_instance._tex_pool.wait_idle()
            vc.advance(1 / 60)
            ticks.append(p.update())
        p.dispose()
        runs[device] = ticks
    keys = {d: [(r.status, r.geometry_frame, r.texture_segment, r.texture_layer) for r in t]
            for d, t in runs.items()}
    assert keys["cuda"] == keys["cpu"] and [k[0] for k in keys["cpu"]].count("ok") >= 4
    for a, b in zip(runs["cuda"], runs["cpu"]):
        if a.status == "ok":
            np.testing.assert_array_equal(a.geometry.positions, b.geometry.positions)
            np.testing.assert_array_equal(np.asarray(a.texture), np.asarray(b.texture))


# ---- U1: the UASTC device fit, and the UASTC transcode's ETC refit (K1) ----------


def _uastc_blocks(n: int, seed: int) -> np.ndarray:
    """Random, smooth, solid, opaque and alpha-ramp blocks, [n, 16, 4] uint8."""
    r = np.random.default_rng(seed)
    k = n // 5
    lo = r.integers(0, 200, (n, 1, 4))
    px = np.clip(lo + r.integers(0, 56, (n, 16, 4)), 0, 255).astype(np.uint8)
    px[:k] = r.integers(0, 256, (k, 16, 4))
    px[k:2 * k] = px[k:2 * k, :1]
    px[2 * k:3 * k, :, 3] = 255
    px[3 * k:4 * k, :, 3] = np.linspace(0, 255, 16).astype(np.uint8)
    return px


@pytest.mark.parametrize("modes", [[0, 5], [10, 12], [0, 1, 2, 5, 10, 11, 12, 13, 14, 17, 18],
                                   [18, 2]])
@pytest.mark.parametrize("n", [1, 127, 129, 70001])
def test_uastc_device_fit_kernel_matches_twin(card, modes, n):
    from uvol_tpu_torch.codecs.basis import uastc_cuda

    px = torch.from_numpy(_uastc_blocks(n, seed=n))
    before = uastc_cuda.LAUNCHES["uastc_device_fit"]
    got = uastc_cuda.device_fit(px.to(card), modes)
    torch.cuda.synchronize()
    assert uastc_cuda.LAUNCHES["uastc_device_fit"] == before + 1
    for twin in (uastc_cuda.device_fit_select_plain(px.to(card), modes),
                 uastc_cuda.device_fit_select_plain(px, modes)):
        for g, w in zip(got, twin, strict=True):
            g, w = g.cpu(), w.cpu()
            assert g.dtype == w.dtype
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w)


def test_uastc_device_fit_kernel_reads_unaligned_blocks(card):
    from uvol_tpu_torch.codecs.basis import uastc_cuda

    px = torch.from_numpy(_uastc_blocks(301, seed=4)).to(card)
    shifted = torch.cat([px.reshape(-1)[:4], px.reshape(-1)])[4:].reshape(301, 16, 4)
    assert shifted.data_ptr() % 16 == 4
    for g, w in zip(uastc_cuda.device_fit(shifted, [0, 5]), uastc_cuda.device_fit(px, [0, 5])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("modes", [[0, 5], [10, 12], [0, 1, 2, 5, 10, 11, 12, 13, 14, 17, 18]])
@pytest.mark.parametrize("n", [1, 3, 127, 128, 129, (1 << 16) + 5])
def test_uastc_device_fit_kernel_at_quad_and_cta_edges(card, modes, n):
    """Blocks on 4 lanes, 64 a CTA: counts off both, against the twin."""
    from uvol_tpu_torch.codecs.basis import uastc_cuda

    px = torch.from_numpy(_uastc_blocks(n, seed=n + 1))
    got = uastc_cuda.device_fit(px.to(card), modes)
    torch.cuda.synchronize()
    for g, w in zip(got, uastc_cuda.device_fit_select_plain(px, modes), strict=True):
        g = g.cpu()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("offset", [4, 8, 12])
def test_uastc_device_fit_kernel_off_16_byte_alignment(card, offset):
    from uvol_tpu_torch.codecs.basis import uastc_cuda

    px = torch.from_numpy(_uastc_blocks(1001, seed=offset)).to(card)
    flat = px.reshape(-1)
    shifted = torch.cat([flat[:offset], flat])[offset:].reshape(1001, 16, 4)
    assert shifted.data_ptr() % 16 == offset
    for g, w in zip(uastc_cuda.device_fit(shifted, [0, 5]),
                    uastc_cuda.device_fit_select_plain(px, [0, 5])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("levels", [2, 3, 4, 5, 8, 16])
def test_uastc_weight_index_kernel_equals_the_scan(card, levels):
    """The kernel's closed form on 2^24 floats spread over [0, 64] and the
    4,096 either side of each entry and midpoint (chip_smoke.py takes
    every float32 in [0, 64])."""
    from uvol_tpu_torch.codecs.basis import uastc_cuda
    from uvol_tpu_torch.codecs.basis.uastc import WEIGHT_TABLES

    t = np.asarray(WEIGHT_TABLES[levels], np.float32)
    marks = np.concatenate([t, (t[1:] + t[:-1]) / 2]).astype(np.float32).view(np.int32)
    near = (marks[:, None] + np.arange(-4096, 4097, dtype=np.int32)).ravel()
    top = int(np.float32(64).view(np.int32))
    bits = np.concatenate([near, np.linspace(0, top, 1 << 24).astype(np.int32)])
    w = torch.from_numpy(bits[(bits >= 0) & (bits <= top)].view(np.float32)).to(card)
    assert torch.equal(uastc_cuda.weight_index(w, levels), uastc_cuda.weight_index_plain(w, levels))


@pytest.mark.parametrize("legacy", [False, True])
def test_uastc_encode_and_transcode_on_card_match_cpu(card, legacy):
    from uvol_tpu_torch.codecs.basis import uastc

    yy, xx = np.mgrid[0:64, 0:96]
    img = np.stack([xx * 4 % 256, yy * 4 % 256, (xx + yy) * 2 % 256, (xx * 4) % 256], -1)
    imgs = np.stack([img, np.roll(img, 7, 1)]).astype(np.uint8)
    wire = "legacy" if legacy else "spec"
    blob = uastc.encode_uastc_ktx2(imgs, wire=wire, device_fit=legacy, device=card)
    assert blob == uastc.encode_uastc_ktx2(imgs, wire=wire, device_fit=legacy, device="cpu")
    f = read_ktx2(blob)
    for target in ("etc1", "etc2-eac"):
        before = etc_cuda.LAUNCHES["etc1_encode"]
        got = uastc.transcode_uastc(f, target, device=card)
        assert etc_cuda.LAUNCHES["etc1_encode"] == before + 1  # one K1 call per file
        np.testing.assert_array_equal(got, uastc.transcode_uastc(f, target, device="cpu"))


# ---- U3-U5: the mesh and point-cloud ops (ops/mesh_cuda.py) --------------------


def _grid_faces(ny, nx):
    i = (np.arange(ny - 1)[:, None] * nx + np.arange(nx - 1)[None, :]).ravel()
    faces = np.concatenate([np.stack([i, i + 1, i + nx], 1), np.stack([i + 1, i + nx + 1, i + nx], 1)])
    return faces.astype(np.int32)


def _u3_cases():
    r = np.random.default_rng(4)
    pos = r.normal(size=(83 * 315, 3)).astype(np.float32) * 10
    faces = _grid_faces(83, 315)
    yield "grid", pos, faces
    padded = np.concatenate([faces[:500], np.full((7, 3), -1), [[3, 3, 3], [2, 4, 2], [1, 10 ** 6, 2]]])
    yield "padded_degenerate_out_of_range", pos[:600], padded.astype(np.int32)
    fan = np.stack([np.zeros(1000), np.arange(1, 1001), np.arange(2, 1002)], 1).astype(np.int32)
    yield "fan_1000", r.normal(size=(1005, 3)).astype(np.float32), fan  # 3 isolated vertices
    yield "random", r.normal(size=(70, 3)).astype(np.float32), r.integers(0, 70, (5000, 3)).astype(np.int32)


@pytest.mark.parametrize("case", ["grid", "padded_degenerate_out_of_range", "fan_1000", "random"])
def test_estimate_normals_kernel_matches_twin(card, case):
    from uvol_tpu_torch.ops import mesh_cuda

    _, pos, faces = next(c for c in _u3_cases() if c[0] == case)
    p, f = torch.from_numpy(pos), torch.from_numpy(faces)
    before = mesh_cuda.LAUNCHES["estimate_normals"]
    got = mesh_cuda.estimate_normals(p.to(card), f.to(card))
    torch.cuda.synchronize()
    assert mesh_cuda.LAUNCHES["estimate_normals"] == before + 1
    want = mesh_cuda.estimate_normals_plain(p, f)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("f,n,bits", [(1, 1, 11), (3, 255, 11), (2, 257, 21), (32, 26145, 11),
                                      (2, 1000, 1), (65537, 3, 11)])
def test_morton_keys_kernel_matches_twin(card, f, n, bits):
    from uvol_tpu_torch._device import true_div
    from uvol_tpu_torch.ops import mesh_cuda
    from uvol_tpu_torch.ops.quantize import compute_quantization_transform

    r = np.random.default_rng(n)
    x = torch.from_numpy((r.normal(size=(f, n, 3)) * 30).astype(np.float32))
    x[:, n // 2:] = x[:, : n - n // 2]  # duplicate points
    mn, rng = compute_quantization_transform(x)
    inv = true_div(1.0, true_div(rng, (1 << bits) - 1))
    got = mesh_cuda.morton_keys(x.to(card), mn.to(card), inv.to(card), bits)
    assert torch.equal(got.cpu(), mesh_cuda.morton_keys_plain(x, mn, inv, bits))


@pytest.mark.parametrize("f,n,d", [(1, 1, 1), (2, 1025, 2), (3, 2048, 3), (1, 3000, 4),
                                   (1, 54016, 3), (2, 54017, 2), (8, 200000, 3), (65536, 3, 1),
                                   (70001, 2, 2)])
def test_parallelogram_decode_kernel_matches_twin(card, f, n, d):
    from uvol_tpu_torch.ops import mesh_cuda

    r = np.random.default_rng(n + d)
    res = r.integers(-(1 << 31), (1 << 31) - 1, (f, n, d), dtype=np.int64).astype(np.int32)
    i = np.arange(n)
    a = np.where(r.random((f, n)) < 0.2, -1, i - r.integers(-3, 5, (f, n)))  # forward refs too
    b, c = i - r.integers(-2, 6, (f, n)), i + r.integers(-5, 40, (f, n))  # past N as well
    p = torch.from_numpy(np.stack([a, b, c], -1).astype(np.int32))
    res = torch.from_numpy(res)
    got = mesh_cuda.parallelogram_decode(res.to(card), p.to(card))
    assert torch.equal(got.cpu(), mesh_cuda.parallelogram_decode_plain(res, p))
