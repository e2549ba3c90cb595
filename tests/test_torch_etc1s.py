"""ETC1S encoder port (uvol_tpu_torch) against the JAX package, on the CPU.

The plain twins of K4, K5 and K6 (`etc1s_cuda`) are held against the
Pallas kernels of `etc1s_pallas.py`, run in interpret mode as
tests/test_pallas_parity.py runs them. The palette core, the RDO refine
and the whole `.ktx2` encode are held against the JAX package's Pallas
path, also in interpret mode: on the CPU the reference's
`build_palettes` takes its XLA fallback instead (bf16 k-means dots), and
the port follows the kernel path. The CUDA kernels are held against the
twins on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvol_tpu.codecs.basis import etc1s_encode as jenc
from uvol_tpu.codecs.basis import etc1s_pallas as jpallas
from uvol_tpu.codecs.basis.transcoder import transcode_ktx2_etc1s
from uvol_tpu.containers.ktx2 import read_ktx2
from uvol_tpu_torch.codecs.basis import etc1s_cuda as kern
from uvol_tpu_torch.codecs.basis import etc1s_encode as tenc

INTEN = np.asarray(jenc.INTEN_TABLES, np.int32)


def _blocks(n: int, seed: int) -> np.ndarray:
    """n random [16, 3] blocks with flat blocks (0, 255, mid-gray) and
    saturating ones at the front."""
    b = np.random.default_rng(seed).integers(0, 256, (n, 16, 3)).astype(np.uint8)
    b[0], b[1], b[2] = 0, 255, 128
    b[3, :, 0], b[3, :, 1], b[3, :, 2] = 255, 0, 7
    b[4] = b[5]  # duplicate blocks tie on every candidate
    return b


def _segment_a() -> np.ndarray:
    """2 frames of 64x64: shifted gradients with noise."""
    r = np.random.default_rng(3)
    yy, xx = np.mgrid[0:64, 0:64]
    out = np.zeros((2, 64, 64, 3), np.uint8)
    for i in range(2):
        img = np.stack([(xx * 4 + i * 8) % 256, (yy * 4) % 256, ((xx + yy) * 2) % 256], -1)
        out[i] = np.clip(img + r.integers(-6, 7, img.shape), 0, 255)
    return out


def _segment_b() -> np.ndarray:
    """1 frame of 96x64, noise with flat regions (many tied blocks)."""
    img = np.random.default_rng(4).integers(0, 256, (1, 96, 64, 3)).astype(np.uint8)
    img[0, :48, :32] = 40
    img[0, 48:, 32:] = [200, 10, 90]
    img[0, :16, 32:] = 255
    img[0, 80:, :16] = 0
    return img


SEGMENTS = {"a": _segment_a, "b": _segment_b}


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """Makes the JAX package's `build_palettes` take its Pallas path, in
    interpret mode, on the CPU (its own rule picks it on a TPU only)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jenc, "_palette_core_fn",
                        functools.partial(jenc._palette_core_fn, pallas_interpret=True))
    monkeypatch.setattr(jenc, "_PALETTE_JIT_CACHE", {})


def _jax_core(blocks: np.ndarray, e: int, s: int, iters: int = 6):
    core = jax.jit(jenc._palette_core_fn(e, s, iters, use_pallas=True, pallas_interpret=True))
    return [np.asarray(x).astype(np.int64) for x in core(jnp.asarray(blocks))]


def _psnr(blob: bytes, frames: np.ndarray) -> float:
    out = transcode_ktx2_etc1s(read_ktx2(blob))[..., : frames.shape[-1]]
    mse = ((out.astype(np.float64) - frames) ** 2).mean()
    return float(10 * np.log10(255.0**2 / mse))


# ---- the kernels' twins against the Pallas kernels ------------------------


def test_inten_errors_twin_matches_pallas():
    n = 300
    blocks = _blocks(n, 11)
    base = np.random.default_rng(12).integers(0, 256, (n, 3)).astype(np.int32)
    base[:8] = [[0, 0, 0], [255, 255, 255], [8, 8, 8], [247, 247, 247]] * 2  # clipping
    want = np.asarray(jpallas.inten_errors_pallas(
        jnp.asarray(np.transpose(blocks, (2, 1, 0)).reshape(48, n)),
        jnp.asarray(base.T.astype(np.float32)),
        tuple(tuple(int(v) for v in row) for row in INTEN), True))
    got = kern.inten_errors(torch.from_numpy(blocks), torch.from_numpy(base))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("e", [40, 1024])
def test_assign_endpoints_twin_matches_pallas(e):
    n = 300
    r = np.random.default_rng(e)
    blocks = _blocks(n, 21)
    base = r.integers(0, 256, (e, 3)).astype(np.int32)
    inten = r.integers(0, 8, e).astype(np.int32)
    base[e // 2], inten[e // 2] = base[3], inten[3]  # a duplicate endpoint: ties
    base[:2] = [[0, 0, 0], [255, 255, 255]]
    basef = base.astype(np.float32)
    me = (np.clip(basef[:, None, :] + INTEN[inten][:, :, None], 0, 255)
          - basef[:, None, :]).astype(np.float32)
    q = (2.0 * np.einsum("ec,ejc->ej", basef, me) + (me**2).sum(-1)).astype(np.float32)
    const = jpallas.endpoint_const_rows(jnp.asarray(basef), jnp.asarray(me), jnp.asarray(q), e)
    want = np.asarray(jpallas.assign_endpoints_pallas(
        jnp.asarray(blocks.reshape(n * 16, 3)), const, True))
    table = kern.endpoint_table(torch.from_numpy(base), torch.from_numpy(inten))
    np.testing.assert_array_equal(np.asarray(const)[:, :e].T, table.numpy())
    got = kern.assign_endpoints(torch.from_numpy(blocks), table)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("e", [2049, 3000])
def test_assign_endpoints_twin_matches_pallas_above_the_window(e):
    """Wider than one window of the segment-sum and K6 kernels (2,048):
    K4 streams its endpoints in chunks and needs no change; its twin
    takes the Pallas kernel's first minimum over every entry."""
    n = 300
    r = np.random.default_rng(e)
    blocks = _blocks(n, 23)
    base = r.integers(0, 256, (e, 3)).astype(np.int32)
    inten = r.integers(0, 8, e).astype(np.int32)
    t = min(e, 2068) - 2048  # flat blocks whose best entry lies past 2,047
    blocks[10:10 + t] = r.integers(0, 256, (t, 1, 3))
    base[2048:2048 + t], inten[2048:2048 + t] = blocks[10:10 + t, 0], 0
    base[e - 1] = base[2048] if e > 2049 else base[e - 1]  # a tie past 2,048 (3,000)
    basef = base.astype(np.float32)
    me = (np.clip(basef[:, None, :] + INTEN[inten][:, :, None], 0, 255)
          - basef[:, None, :]).astype(np.float32)
    q = (2.0 * np.einsum("ec,ejc->ej", basef, me) + (me**2).sum(-1)).astype(np.float32)
    const = jpallas.endpoint_const_rows(jnp.asarray(basef), jnp.asarray(me), jnp.asarray(q), e)
    want = np.asarray(jpallas.assign_endpoints_pallas(
        jnp.asarray(blocks.reshape(n * 16, 3)), const, True))
    table = kern.endpoint_table(torch.from_numpy(base), torch.from_numpy(inten))
    got = kern.assign_endpoints(torch.from_numpy(blocks), table)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 2048).any()


@pytest.mark.parametrize("k", [2049, 3000])
def test_kmeans_iter_twin_matches_pallas_above_the_window(k):
    """K centroids past one window: the assignment (first minimum over
    every centroid) and the counts equal the Pallas kernel's, the sums
    agree to rounding (rtol 1e-6, as at 40 centroids)."""
    r = np.random.default_rng(k)
    n = 5000
    feats = (r.integers(0, 256, (n, 4)) + r.random((n, 4))).astype(np.float32)
    cb = feats[r.choice(n, k, replace=False)] + np.float32(0.25)
    cb[k - 2] = cb[0]  # a duplicate centroid: ties go to the first
    want = [np.asarray(x) for x in jpallas.kmeans_iter_pallas(
        jnp.asarray(feats), jnp.asarray(cb), True)]
    sums, counts, assign = [x.numpy() for x in kern.kmeans_iter(
        torch.from_numpy(feats), torch.from_numpy(cb))]
    np.testing.assert_array_equal(assign, want[2])
    np.testing.assert_array_equal(counts, want[1])
    assert counts[k - 2] == 0 and (assign >= 2048).any()
    np.testing.assert_allclose(sums, want[0], rtol=1e-6)


@pytest.mark.parametrize("integer", [True, False])
def test_kmeans_iter_twin_matches_pallas(integer):
    r = np.random.default_rng(7)
    n, k = 1300, 40  # non-multiples of the TPU tile and of SEG_TILE
    feats = r.integers(0, 256, (n, 4)).astype(np.float32)
    cb = r.integers(0, 256, (k, 4)).astype(np.float32)
    if not integer:
        feats += r.random((n, 4)).astype(np.float32)
        cb += r.random((k, 4)).astype(np.float32)
    cb[k - 1] = cb[0]  # duplicate centroid: ties go to the first
    want = [np.asarray(x) for x in jpallas.kmeans_iter_pallas(
        jnp.asarray(feats), jnp.asarray(cb), True)]
    sums, counts, assign = [x.numpy() for x in kern.kmeans_iter(
        torch.from_numpy(feats), torch.from_numpy(cb))]
    np.testing.assert_array_equal(assign, want[2])
    np.testing.assert_array_equal(counts, want[1])
    assert counts[k - 1] == 0
    if integer:  # exact sums: any order gives the same bits
        np.testing.assert_array_equal(sums, want[0])
    else:  # an MXU product there, a fixed tile order here: rounding apart
        np.testing.assert_allclose(sums, want[0], rtol=1e-6)


@pytest.mark.parametrize("n", [1, 64, 200, 1300])
def test_segment_sum_takes_its_documented_order(n):
    r = np.random.default_rng(n)
    k, d = 7, 3
    idx = r.integers(0, k, n)
    x = (r.random((n, d)) * 1e4).astype(np.float32)
    tiles = []  # the order, written as loops
    for t0 in range(0, n, kern.SEG_TILE):
        acc = np.zeros((k, d), np.float32)
        for i in range(t0, min(n, t0 + kern.SEG_TILE)):
            acc[idx[i]] = acc[idx[i]] + x[i]
        tiles.append(acc)
    while len(tiles) > 1:
        if len(tiles) % 2:
            tiles.append(np.zeros((k, d), np.float32))
        tiles = [tiles[i] + tiles[i + 1] for i in range(0, len(tiles), 2)]
    got = kern.segment_sum(torch.from_numpy(idx), k, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), tiles[0])


def _order_inputs(n: int, k: int, d: int, seed: int):
    """Values over many magnitudes, so every change of order shows."""
    r = np.random.default_rng(seed)
    idx = torch.from_numpy(r.integers(0, k, n))
    x = r.normal(size=(n, d)) * 10.0 ** r.integers(-3, 8, (n, d))
    x[r.random((n, d)) < 0.1] = -0.0
    return idx, torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("n,rows", [(1000, 128), (1000, 999), (1025, 512), (257, 64), (130, 1)])
def test_segment_sum_above_the_row_limit_adds_chunk_sums_in_order(n, rows):
    """Above the limit the sum is ((S0 + S1) + S2) + ... over consecutive
    chunks of `rows` rows, each chunk summed as a whole input is; the
    limit is passed down small. Bits, signed zeros included."""
    k, d = 5, 3
    idx, x = _order_inputs(n, k, d, n + rows)
    got = kern.segment_sum_plain(idx, k, x, _chunk_rows=rows)
    acc = None
    for a in range(0, n, rows):
        part = kern.segment_sum_plain(idx[a:a + rows], k, x[a:a + rows])
        acc = part if acc is None else acc + part
    np.testing.assert_array_equal(got.numpy().view(np.int32), acc.numpy().view(np.int32))


def test_segment_sum_chunk_order_is_another_order_than_the_whole_sum():
    """(2^24 + 1) + 1 = 2^24 across the chunk seam at row 96, where the
    whole sum adds 2^24 + (1 + 1): the row limit decides the bits."""
    x = torch.zeros((128, 1))
    x[0], x[64], x[96] = 2.0 ** 24, 1.0, 1.0
    idx = torch.zeros(128, dtype=torch.int64)
    assert float(kern.segment_sum_plain(idx, 1, x)) == 2.0 ** 24 + 2
    assert float(kern.segment_sum_plain(idx, 1, x, _chunk_rows=96)) == 2.0 ** 24


@pytest.mark.parametrize("n,rows", [(64, 64), (1000, 1000), (1000, 1 << 24)])
def test_segment_sum_at_or_below_the_row_limit_is_unchanged(n, rows):
    idx, x = _order_inputs(n, 5, 3, n)
    np.testing.assert_array_equal(
        kern.segment_sum_plain(idx, 5, x, _chunk_rows=rows).numpy().view(np.int32),
        kern.segment_sum_plain(idx, 5, x).numpy().view(np.int32))


def test_kmeans_iter_above_the_row_limit_sums_its_chunks_in_the_same_order(monkeypatch):
    """K6's twin sums through the segment sum, so above the limit its sums
    and counts are the chunk sums added in order; its assignments do not
    depend on the limit."""
    r = np.random.default_rng(21)
    feats = torch.from_numpy((r.random((700, 4)) * 255 * 10.0 ** r.integers(-2, 3, (700, 4)))
                             .astype(np.float32))
    cb = feats[torch.from_numpy(r.integers(0, 700, 6))] + 0.5
    whole = kern.kmeans_iter(feats, cb)
    monkeypatch.setattr(kern, "SEG_MAX_ROWS", 250)
    sums, counts, assign = kern.kmeans_iter(feats, cb)
    assert torch.equal(assign, whole[2])
    ones = torch.cat([feats, feats.new_ones((700, 1))], 1)
    acc = None
    for a in range(0, 700, 250):
        part = kern.segment_sum_plain(assign[a:a + 250], 6, ones[a:a + 250])
        acc = part if acc is None else acc + part
    assert torch.equal(sums, acc[:, :4]) and torch.equal(counts, acc[:, 4])
    assert torch.equal(counts, whole[1]) and not torch.equal(sums, whole[0])


def test_row_chunks_cover_the_rows_once():
    assert kern._row_chunks(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert kern._row_chunks(8, 4) == [(0, 4), (4, 8)]
    assert kern._row_chunks((1 << 24) + 1, 1 << 24) == [(0, 1 << 24), (1 << 24, (1 << 24) + 1)]


def test_palette_core_refuses_tf32():
    """The selector errors are exact only in full float32: a caller that
    switched TF32 on after the import gets an error, not other argmins."""
    from uvol_tpu_torch._device import require_full_f32

    blocks = torch.from_numpy(_blocks(64, 1))
    require_full_f32()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="allow_tf32|float32_matmul_precision"):
            require_full_f32()
        with pytest.raises(RuntimeError, match="allow_tf32|float32_matmul_precision"):
            tenc.palette_core(blocks, 8, 8, 2)
    finally:
        torch.set_float32_matmul_precision("highest")
    try:
        torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(RuntimeError, match="cudnn.allow_tf32"):
            require_full_f32()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    require_full_f32()
    assert len(tenc.palette_core(blocks, 8, 8, 2)) == 5


def _wide_layer(h: int, w: int) -> np.ndarray:
    """One random layer: 108 x 304 is 2,052 blocks and 200 x 240 3,000,
    the least segments a palette of 2,049 or 3,000 entries fits uncapped."""
    return np.random.default_rng(0).integers(0, 256, (1, h, w, 3)).astype(np.uint8)


def _encode_on_the_reference_core(monkeypatch, frames, kw) -> bytes:
    """The port's encode with its palette core replaced by the reference's
    (Pallas, interpret mode): every stage after it (the RDO refine, the
    delta-aware stage, the lam ladder's rebuilds, the emission) is exact
    integer arithmetic, so the bytes must be the reference's."""
    blocks = tenc._blocks_of(frames)
    core = _jax_core(blocks, min(kw["num_endpoints"], len(blocks)),
                     min(kw["num_selectors"], len(blocks)))
    cores = []
    monkeypatch.setattr(tenc, "palette_core", lambda *a, **k: cores.append(1) or tuple(
        torch.from_numpy(c.astype(np.int32)) for c in core))
    got = tenc.encode_ktx2_etc1s(frames, device="cpu", **kw)
    assert cores
    return got


@pytest.mark.parametrize("arg", ["num_endpoints", "num_selectors"])
def test_build_palettes_names_the_entry_limit_at_its_top(arg, jax_kernel_path, monkeypatch):
    """A palette of 2,049 entries, one past the kernels' window (refused
    until the kernels summed by windows): from the reference's palette
    core every later stage writes the reference's bytes (the endpoint
    case runs the delta-aware stage at E = 2,049). The core itself is held
    by its kernels' tests: K4 bit for bit and K6's sums to rtol 1e-6
    (`*_above_the_window`); its float sums (features, squares, the Lloyd
    centroids) agree with the reference's only to rounding, and one ulp
    there may move a cluster's 5-bit color, so the whole encode is not
    compared bit for bit."""
    frames = _wide_layer(108, 304)
    kw = {"num_endpoints": 64, "num_selectors": 64, arg: 2049}
    pal = tenc.build_palettes(frames, device="cpu", **kw)  # its own core: no refusal
    assert len(pal.color5 if arg == "num_endpoints" else pal.selectors) == 2049
    want = jenc.encode_ktx2_etc1s(frames, **kw)
    assert _encode_on_the_reference_core(monkeypatch, frames, kw) == want


def test_encode_at_3000_entries_matches_jax_kernel_path(jax_kernel_path, monkeypatch):
    """3,000 endpoints and selectors on 3,000 blocks, as above: from the
    reference's core the encode (RDO, the delta-aware stage at E = 3,000,
    emission) writes the reference's bytes."""
    frames = _wide_layer(200, 240)
    kw = {"num_endpoints": 3000, "num_selectors": 3000}
    want = jenc.encode_ktx2_etc1s(frames, **kw)
    assert _encode_on_the_reference_core(monkeypatch, frames, kw) == want


def test_kernel_wrappers_refuse_other_devices_and_layouts():
    meta = torch.empty((4, 16, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        kern.inten_errors(meta, torch.empty((4, 3), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        kern.assign_endpoints(torch.zeros((4, 16, 4), dtype=torch.uint8),
                              torch.zeros((2, 20), dtype=torch.int32))
    with pytest.raises(ValueError):
        kern.kmeans_iter(torch.zeros((4, 4)), torch.zeros((0, 4)))


# ---- float rules of the reference, as XLA compiles it ---------------------


def test_reference_divisions_by_constants_are_folded():
    """XLA compiles the reference's divisions by constants into
    multiplies: `x * 31.0 / 255.0` into x * (31 * f32(1/255)), `x / 3.0`
    into x * f32(1/3). At these inputs an IEEE division (`true_div`)
    would round to another 5-bit color than the reference does."""
    x = np.array([0x42EE8C63, 0x429C4A52], np.uint32).view(np.float32)
    want = np.asarray(jax.jit(lambda c: jnp.round(c * 31.0 / 255.0))(jnp.asarray(x)))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(torch.round(t * tenc._Q5).numpy(), want)
    ieee = torch.round(torch.div(t * 31.0, torch.full_like(t, 255.0))).numpy()
    assert (ieee != want).all()
    y = np.random.default_rng(0).random(1000).astype(np.float32) * 100
    want3 = np.asarray(jax.jit(lambda c: c / 3.0)(jnp.asarray(y)))
    np.testing.assert_array_equal((torch.from_numpy(y) * tenc._THIRD).numpy(), want3)


def test_block_features_match_the_reference():
    """Means exact; the contrast (population std, as `jnp.std`) mostly
    exact and never more than 2 ulps off: XLA's f32 sqrt on the CPU is
    not correctly rounded (one ulp of the sqrt is up to 2 ulps of the
    contrast, a third of it)."""
    blocks = _blocks(2000, 31)

    @jax.jit
    def ref(b):  # etc1s_encode.py:215-223
        x = b.astype(jnp.float32)
        means = jnp.mean(x, axis=1)
        s_pix = jnp.sum(x, axis=2) - jnp.sum(means, axis=1)[:, None]
        return jnp.concatenate([means, (jnp.std(s_pix, axis=1) / 3.0)[:, None]], 1)

    want = np.asarray(ref(jnp.asarray(blocks)))
    got = tenc.block_features(torch.from_numpy(blocks)).numpy()
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_array_max_ulp(got[:, 3], want[:, 3], maxulp=2)
    assert (got[:, 3] == want[:, 3]).mean() > 0.99
    torch_std = torch.std(torch.from_numpy(blocks).float().sum(2), dim=1)  # correction=1
    assert not np.allclose(torch_std.numpy() / 3.0, want[:, 3])


# ---- the palette core, the refine and the whole encode ---------------------


@pytest.mark.parametrize("segment", sorted(SEGMENTS))
def test_palette_core_matches_jax_kernel_path(segment):
    blocks = tenc._blocks_of(SEGMENTS[segment]())
    want = _jax_core(blocks, 32, 32)
    got = tenc.palette_core(torch.from_numpy(blocks), 32, 32, 6)
    names = ["base5", "inten", "sel_cb", "assign", "sel_assign"]
    for name, w, g in zip(names, want, got):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_bisection_breaks_count_ties_by_leaf_order():
    """Equal leaf counts keep leaf order, as the reference's stable
    `jnp.argsort(-cnt)` does."""
    x = torch.arange(8, dtype=torch.float32)[:, None]
    mean, good = tenc._bisect_leaves(x, 4)  # 4 leaves of 2 rows each
    assert good.all()
    np.testing.assert_array_equal(mean[:, 0].numpy(), [0.5, 2.5, 4.5, 6.5])


def test_rdo_refine_matches_jax():
    frames = np.concatenate([_segment_a(), _segment_a()[::-1]])  # 4 frames
    f, h, w, _ = frames.shape
    nby, nbx = h // 4, w // 4
    blocks = tenc._blocks_of(frames)
    base5, inten, sel_cb, assign, sel_assign = [
        x.numpy() for x in tenc.palette_core(torch.from_numpy(blocks), 32, 32, 6)]
    r = np.random.default_rng(5)
    noisy = np.where(r.random(assign.shape) < 0.2, r.integers(0, 32, assign.shape), assign)

    def pal():
        return jenc.Palettes(
            color5=base5.astype(np.uint8), inten=inten.astype(np.uint8),
            selectors=sel_cb.astype(np.uint8),
            block_endpoint=noisy.reshape(f, -1).astype(np.int32),
            block_selector=sel_assign.reshape(f, -1).astype(np.int32))

    for breaks in [(), (2,)]:
        want, got = pal(), pal()
        jenc.rdo_refine_assignments(blocks, want, nby, nbx, chain_breaks=breaks)
        tenc.rdo_refine_assignments(blocks, got, nby, nbx, chain_breaks=breaks, device="cpu")
        np.testing.assert_array_equal(got.block_endpoint, want.block_endpoint)
        np.testing.assert_array_equal(got.block_selector, want.block_selector)
        assert (got.block_endpoint != noisy.reshape(f, -1)).any()


@pytest.mark.parametrize("channels", [3, 4])
def test_encode_matches_jax_kernel_path(jax_kernel_path, monkeypatch, channels):
    """The whole `.ktx2` encode, RGB and RGBA: the bytes equal the JAX
    package's, and they decode through its transcoder at >= 24 dB."""
    frames = _segment_a()
    if channels == 4:
        alpha = np.clip(np.mgrid[0:64, 0:64][1] * 4 - np.arange(2)[:, None, None], 0, 255)
        frames = np.concatenate([frames, alpha[..., None].astype(np.uint8)], -1)
    want = jenc.encode_ktx2_etc1s(frames, num_endpoints=32, num_selectors=32)
    builds = []
    build = tenc.build_palettes
    monkeypatch.setattr(tenc, "build_palettes",
                        lambda *a, **kw: builds.append(1) or build(*a, **kw))
    got = tenc.encode_ktx2_etc1s(frames, num_endpoints=32, num_selectors=32, device="cpu")
    assert got == want
    assert len(builds) == 4  # under 35 dB the floor rebuilt the same palette
    psnr = _psnr(got, frames)
    assert psnr >= 24.0
    assert abs(psnr - _psnr(want, frames)) <= 0.05


@pytest.mark.parametrize("kwargs", [
    {"mesh": "one gloo rank on the CPU"},
    {"endpoint_quads": True},
    {"num_endpoints": 512, "num_selectors": 64},
])
def test_unported_options_raise(jax_kernel_path, kwargs):
    """`mesh=`, the endpoint quads and the delta-aware stage (512
    endpoints) raised before they were ported; now they encode the
    reference's bytes. The mesh is a one-rank gloo group made in this
    process (tests/test_torch_multichip.py runs 2 and 4 ranks)."""
    frames = np.random.default_rng(0).integers(0, 256, (1, 96, 96, 3)).astype(np.uint8)
    if "mesh" in kwargs:
        import torch.distributed as dist

        from uvol_tpu_torch.parallel.mesh import make_mesh

        try:
            got = tenc.encode_ktx2_etc1s(frames, mesh=make_mesh(device_type="cpu"))
        finally:
            dist.destroy_process_group()
        assert got == jenc.encode_ktx2_etc1s(frames)
        return
    got = tenc.encode_ktx2_etc1s(frames, device="cpu", **kwargs)
    assert got == jenc.encode_ktx2_etc1s(frames, **kwargs)
