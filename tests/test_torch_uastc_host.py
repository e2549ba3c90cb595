"""The port's copies of the UASTC host modules against the originals, on
the CPU.

`uvol_tpu_torch/codecs/basis/` holds copies of the reference's
`uastc.py` (all but its XLA device fit), `uastc_spec.py`, `astc.py`,
`bc7.py`, `blockfit.py` and `pvrtc.py`, with their imports rewritten to
the port. Every function the port's paths call must give the original's
bytes: the BISE and partition tables, the legacy and spec wires' encode
and decode at quality 0-2, the `.ktx2` encode, the ASTC and BC7
transcodes, the block fits, the PVRTC packing, and `transcode_uastc` for
all seven targets (its ETC1 refit through K1's plain twin on the CPU).
The reference's own tests of these modules (tests/test_uastc.py,
test_uastc_spec.py, test_astc.py, test_bc7.py, test_pvrtc.py) have their
counterparts here, each run on the port and held to the reference.
"""

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu.codecs.basis import astc as jastc
from uvol_tpu.codecs.basis import bc7 as jbc7
from uvol_tpu.codecs.basis import blockfit as jfit
from uvol_tpu.codecs.basis import pvrtc as jpvrtc
from uvol_tpu.codecs.basis import uastc as J
from uvol_tpu.codecs.basis import uastc_spec as JS
from uvol_tpu.containers import ktx2 as jktx2
from uvol_tpu_torch.codecs.basis import astc as tastc
from uvol_tpu_torch.codecs.basis import bc7 as tbc7
from uvol_tpu_torch.codecs.basis import blockfit as tfit
from uvol_tpu_torch.codecs.basis import pvrtc as tpvrtc
from uvol_tpu_torch.codecs.basis import uastc as T
from uvol_tpu_torch.codecs.basis import uastc_spec as TS
from uvol_tpu_torch.containers import ktx2 as tktx2

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TARGETS = ["rgba", "astc", "bc7", "etc1", "etc2-eac", "bc1-bc3", "pvrtc1"]


def _smooth(h=64, w=64, alpha=False):
    yy, xx = np.mgrid[0:h, 0:w]
    a = (xx * 4) % 256 if alpha else np.full_like(xx, 255)
    return np.stack([xx * 4 % 256, yy * 4 % 256, (xx + yy) * 2 % 256, a], -1).astype(np.uint8)


def _outcome(fn):
    """What fn() gives: its array, or its exception's type and message."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return (type(e).__name__, str(e))


def _assert_same(got, want):
    if isinstance(want, tuple):
        assert got == want
        return
    assert not isinstance(got, tuple), got
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- tables ---------------------------------------------------------------------


def test_bise_weight_and_mode_tables_match():
    for name in ("_TRIT_ENC", "_QUINT_ENC", "_TRIT_DEC", "_QUINT_DEC"):
        np.testing.assert_array_equal(getattr(T, name), getattr(J, name))
    for a, b in zip(T._TRIT_ENC_PARTIAL + T._QUINT_ENC_PARTIAL,
                    J._TRIT_ENC_PARTIAL + J._QUINT_ENC_PARTIAL, strict=True):
        np.testing.assert_array_equal(a, b)
    assert T.WEIGHT_TABLES.keys() == J.WEIGHT_TABLES.keys()
    for k in J.WEIGHT_TABLES:
        np.testing.assert_array_equal(T.WEIGHT_TABLES[k], J.WEIGHT_TABLES[k])
    assert {k: dataclasses.asdict(m) for k, m in T.MODES.items()} == {
        k: dataclasses.asdict(m) for k, m in J.MODES.items()}
    assert T.UASTC_QUALITY_MODES == J.UASTC_QUALITY_MODES
    assert TS.SPEC_QUALITY_MODES == JS.SPEC_QUALITY_MODES
    assert TS.mode_codes() == JS.mode_codes()
    assert (T.UASTC_PROFILE_KEY, T.UASTC_PROFILE_VALUE) == (J.UASTC_PROFILE_KEY,
                                                            J.UASTC_PROFILE_VALUE)


@pytest.mark.parametrize("pc", [2, 3])
def test_partition_patterns_match_for_every_seed(pc):
    seeds = np.arange(1024)
    parts = T.astc_partition_4x4(seeds, pc)
    np.testing.assert_array_equal(parts, J.astc_partition_4x4(seeds, pc))
    assert parts.min() >= 0 and parts.max() < pc
    np.testing.assert_array_equal(T.astc_partition_4x4(7, pc), parts[7])


def test_trit_quint_packs_exhaustive():
    tv = np.indices((3, 3, 3, 3, 3)).reshape(5, -1).T
    qv = np.indices((5, 5, 5)).reshape(3, -1).T
    for vals, base, n in ((tv, 3, 5), (qv, 5, 3)):
        bits, jbits = (np.zeros((len(vals), 128), np.uint8) for _ in range(2))
        end = T._put_bise(bits, 0, vals, base)
        assert end == J._put_bise(jbits, 0, vals, base) == T.bise_bits(n, base)
        np.testing.assert_array_equal(bits, jbits)
        got, end2 = T._get_bise(bits, 0, n, base)
        assert end2 == end
        np.testing.assert_array_equal(got, vals)


@pytest.mark.parametrize("base,maxn", [(3, 11), (5, 8), (8, 6)])
def test_bise_partial_groups(base, maxn):
    r = np.random.default_rng(base)
    for n in range(1, maxn):
        vals = r.integers(0, base, (7, n))
        bits, jbits = np.zeros((7, 128), np.uint8), np.zeros((7, 128), np.uint8)
        end = T._put_bise(bits, 3, vals, base)
        assert end == J._put_bise(jbits, 3, vals, base)
        np.testing.assert_array_equal(bits, jbits)
        got, _ = T._get_bise(bits, 3, n, base)
        np.testing.assert_array_equal(got, vals)


# ---- the legacy wire -------------------------------------------------------------


@pytest.mark.parametrize("mode_id", sorted(J.MODES))
def test_every_mode_encodes_and_decodes_like_the_reference(mode_id):
    px = T.image_to_blocks_rgba(_smooth(alpha=True)).reshape(-1, 16, 4).astype(np.int64)
    blocks, mse = T._encode_mode_blocks(px, mode_id)
    jblocks, jmse = J._encode_mode_blocks(px, mode_id)
    np.testing.assert_array_equal(blocks, jblocks)
    np.testing.assert_array_equal(mse, jmse)
    np.testing.assert_array_equal(T.decode_uastc_blocks(blocks), J.decode_uastc_blocks(blocks))


@pytest.mark.parametrize("modes", [None, [3], [4], [7], [9], [16], [15], [18], [6],
                                   [0, 5, 6, 3, 7], [10, 12, 11, 17, 9]])
def test_host_encode_matches(modes):
    px = np.concatenate([T.image_to_blocks_rgba(_smooth(32, 32)),
                         T.image_to_blocks_rgba(_smooth(32, 32, alpha=True))])
    px[:4] = 77  # solid blocks
    got = T.encode_uastc_blocks(px, modes, device_fit=False)
    np.testing.assert_array_equal(got, J.encode_uastc_blocks(px, modes, device=False))
    np.testing.assert_array_equal(T.decode_uastc_blocks(got), J.decode_uastc_blocks(got))


def test_unknown_mode_raises_like_the_reference():
    bits = np.zeros((1, 128), np.uint8)
    T._put_field(bits, 0, 5, np.array([19]))
    blk = T._pack_bits(bits)
    assert _outcome(lambda: T.decode_uastc_blocks(blk)) == _outcome(
        lambda: J.decode_uastc_blocks(blk))
    with pytest.raises(NotImplementedError):
        T.decode_uastc_blocks(blk)


def test_multi_subset_beats_single_on_two_color_blocks():
    px = np.zeros((8, 16, 4), np.int64)
    px[..., 3] = 255
    for b in range(8):
        for j in range(16):
            x = j % 4
            px[b, j, :3] = ((200 + 10 * (j // 4), 30 + 12 * x, 20) if x < 2
                            else (15, 220 - 12 * x, 180 + 8 * (j // 4)))
    _, mse_single = T._encode_mode_blocks(px, 0)
    _, mse_multi = T._encode_mode_blocks(px, 3)
    assert mse_multi.mean() < mse_single.mean() * 0.55
    np.testing.assert_array_equal(mse_multi, J._encode_mode_blocks(px, 3)[1])


# ---- the spec wire ---------------------------------------------------------------


def _random_fields(mode_id, B, rng):
    lay = TS.mode_layouts()[mode_id]
    cfg = lay.cfg
    L = tastc._levels(lay.color_tq)
    cq = rng.integers(0, L, (B, cfg.subsets, 2 * cfg.ncomp))
    wq = rng.integers(0, 1 << cfg.weight_bits, (B, 16))
    wq2 = rng.integers(0, 1 << cfg.weight_bits, (B, 16)) if cfg.planes == 2 else None
    seed = rng.integers(0, 1024, B) if cfg.subsets > 1 else None
    ccs = None
    if cfg.planes == 2:
        ccs = rng.integers(0, 3, B) if cfg.cem == 8 else np.full(B, 3)
    return cq, wq, wq2, seed, ccs


@pytest.mark.parametrize("mode_id", sorted(JS.MODE_CONFIGS))
def test_spec_pack_parse_decode_and_astc_match(mode_id):
    rng = np.random.default_rng(7 + mode_id)
    fields = _random_fields(mode_id, 48, rng)
    blocks = TS.pack_spec_blocks(mode_id, *fields)
    np.testing.assert_array_equal(blocks, JS.pack_spec_blocks(mode_id, *fields))
    f = TS.parse_mode_payload(TS._bits_of(blocks), mode_id)
    assert (f.cq == fields[0]).all() and (f.wq == fields[1]).all()
    dec = TS.decode_spec_blocks(blocks)
    np.testing.assert_array_equal(dec, JS.decode_spec_blocks(blocks))
    astc = TS.spec_to_astc(blocks)
    np.testing.assert_array_equal(astc, JS.spec_to_astc(blocks))
    np.testing.assert_array_equal(tastc.decode_astc_blocks(astc).reshape(dec.shape), dec)


def test_spec_solid_blocks_match():
    rgba = np.array([[1, 2, 3, 4], [250, 0, 128, 255]], np.uint8)
    blocks = TS.pack_solid_blocks(rgba)
    np.testing.assert_array_equal(blocks, JS.pack_solid_blocks(rgba))
    assert (TS.decode_spec_blocks(blocks) == rgba[:, None, None, :]).all()
    np.testing.assert_array_equal(TS.spec_to_astc(blocks), JS.spec_to_astc(blocks))


@pytest.mark.parametrize("quality", [0, 1, 2])
@pytest.mark.parametrize("alpha", [False, True])
def test_spec_encode_and_decode_match(quality, alpha):
    rng = np.random.default_rng(11 + quality)
    px = T.image_to_blocks_rgba(_smooth(32, 48, alpha))
    px[:6] = rng.integers(0, 256, (6, 4, 4, 4))
    px[6:8] = 200
    modes = None
    if quality:
        modes = list(TS.SPEC_QUALITY_MODES[quality][1 if alpha else 0])
    blocks = TS.encode_spec_blocks(px, modes=modes)
    np.testing.assert_array_equal(blocks, JS.encode_spec_blocks(px, modes=modes))
    np.testing.assert_array_equal(TS.decode_spec_blocks(blocks), JS.decode_spec_blocks(blocks))


def test_invalid_and_random_spec_blocks_fail_like_the_reference():
    rng = np.random.default_rng(3)
    for _ in range(40):
        blk = rng.integers(0, 256, (4, 16)).astype(np.uint8)
        _assert_same(_outcome(lambda: TS.decode_spec_blocks(blk)),
                     _outcome(lambda: JS.decode_spec_blocks(blk)))


# ---- the .ktx2 encode --------------------------------------------------------------


@pytest.mark.parametrize("size", [(32, 32), (66, 70)], ids=["32x32", "66x70"])
@pytest.mark.parametrize("quality", [0, 1, 2])
@pytest.mark.parametrize("wire", ["spec", "legacy"])
def test_ktx2_encode_matches(wire, quality, size):
    h, w = size
    imgs = np.stack([_smooth(68, 72)[:h, :w], np.roll(_smooth(68, 72, True), 3, 1)[:h, :w]])
    got = T.encode_uastc_ktx2(imgs, quality=quality, wire=wire)
    assert got == J.encode_uastc_ktx2(imgs, quality=quality, wire=wire)
    assert T.encode_uastc_ktx2(imgs[..., :3], zstd=False, wire=wire) == J.encode_uastc_ktx2(
        imgs[..., :3], zstd=False, wire=wire)
    f = tktx2.read_ktx2(got)
    assert f.dfd_color_model() == tktx2.KHR_DF_MODEL_UASTC
    assert f.header.supercompression_scheme == tktx2.SUPERCOMPRESSION_ZSTD
    assert (T.UASTC_PROFILE_KEY in f.key_value) == (wire == "legacy")


def test_unknown_wire_refused_like_the_reference():
    img = _smooth(8, 8)[None]
    assert _outcome(lambda: T.encode_uastc_ktx2(img, wire="x")) == _outcome(
        lambda: J.encode_uastc_ktx2(img, wire="x"))


# ---- transcode_uastc, all seven targets -------------------------------------------


def _files():
    """name -> .ktx2 bytes: both fixtures, and fresh encodes (RGB, alpha,
    66 x 70, legacy with alpha)."""
    imgs = np.stack([_smooth(32, 32), np.roll(_smooth(32, 32), 5, 0)])
    alpha = np.stack([_smooth(32, 32, True), _smooth(32, 32, True)[::-1]])
    odd = np.stack([_smooth(68, 72)[:66, :70]] * 2)
    return {
        "video_uastc": (FIXTURES / "video_uastc.ktx2").read_bytes(),
        "video_uastc_legacy": (FIXTURES / "video_uastc_legacy.ktx2").read_bytes(),
        "fresh_rgb": J.encode_uastc_ktx2(imgs),
        "fresh_alpha": J.encode_uastc_ktx2(alpha, quality=1),
        "fresh_66x70": J.encode_uastc_ktx2(odd, zstd=False),
        "fresh_legacy_alpha": J.encode_uastc_ktx2(alpha, wire="legacy"),
    }


FILES = _files()


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name", list(FILES))
def test_transcode_uastc_matches_the_reference(name, target):
    data = FILES[name]
    want = _outcome(lambda: J.transcode_uastc(jktx2.read_ktx2(data), target))
    got = _outcome(lambda: T.transcode_uastc(tktx2.read_ktx2(data), target, device="cpu"))
    _assert_same(got, want)
    if target == "pvrtc1" and "alpha" in name:
        assert got == ("NotImplementedError", "pvrtc1 target: file carries alpha")


def test_transcode_uastc_refit_is_one_k1_call_per_file(monkeypatch):
    from uvol_tpu_torch.codecs.basis import etc_cuda

    calls = []
    enc = etc_cuda.encode_etc1_images
    monkeypatch.setattr(etc_cuda, "encode_etc1_images",
                        lambda x: calls.append(tuple(x.shape)) or enc(x))
    f = tktx2.read_ktx2(FILES["fresh_66x70"])
    for target in ("etc1", "etc2-eac"):
        T.transcode_uastc(f, target, device="cpu")
    # two layers of 66 x 70 as one padded [2, 68, 72, 3] image batch
    assert calls == [(2, 68, 72, 3)] * 2


def test_transcode_uastc_refit_needs_the_card_unless_told(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = tktx2.read_ktx2(FILES["fresh_rgb"])
    with pytest.raises(RuntimeError, match="cuda"):
        T.transcode_uastc(f, "etc1")
    # the host targets need no device
    _assert_same(T.transcode_uastc(f, "bc7"), J.transcode_uastc(jktx2.read_ktx2(FILES["fresh_rgb"]),
                                                                "bc7"))


def test_unknown_target_refused_like_the_reference():
    data = FILES["fresh_rgb"]
    assert _outcome(lambda: T.transcode_uastc(tktx2.read_ktx2(data), "dxt9")) == _outcome(
        lambda: J.transcode_uastc(jktx2.read_ktx2(data), "dxt9"))


def test_foreign_speclike_file_warns_like_the_reference():
    yy, xx = np.mgrid[0:8, 0:8]
    img = np.stack([xx * 20, yy * 20, xx * 0 + 90], -1).astype(np.uint8)[None]
    spec = T.encode_uastc_ktx2(img)
    fs = tktx2.read_ktx2(spec)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # our own file: no warning
        T.transcode_uastc(fs)
    fs.key_value.pop(b"KTXwriter", None)
    with pytest.warns(RuntimeWarning, match="reconstructed spec layout"):
        out = T.transcode_uastc(fs)
    jf = jktx2.read_ktx2(spec)
    jf.key_value.pop(b"KTXwriter", None)
    with pytest.warns(RuntimeWarning):
        np.testing.assert_array_equal(out, J.transcode_uastc(jf))


def test_quality_levels_widen_candidates():
    yy, xx = np.mgrid[0:64, 0:64]
    img = np.stack([xx * 4 % 256, yy * 4 % 256, (xx + yy) * 2 % 256], -1).astype(np.uint8)
    imgs = np.stack([np.roll(img, k * 3, 1) for k in range(2)])

    def psnr(q):
        dec = T.transcode_uastc(tktx2.read_ktx2(T.encode_uastc_ktx2(imgs, quality=q)))
        mse = ((dec[..., :3].astype(float) - imgs.astype(float)) ** 2).mean()
        return 10 * np.log10(255**2 / max(mse, 1e-9))

    p0, p1, p2 = psnr(0), psnr(1), psnr(2)
    assert p0 > 30 and p1 >= p0 - 1e-9 and p2 >= p1 - 1e-9 and p2 > p0 + 0.5


# ---- ASTC, BC7, the block fits, PVRTC ---------------------------------------------


def _legacy_blocks_for_mode(mode_id, r, n=4):
    m = J.MODES[mode_id]
    nc = J._ncomp(m)
    shape = (n, m.subsets, nc) if m.subsets > 1 else (n, nc)
    q0 = r.integers(0, 1 << m.ep_bits, shape)
    q1 = r.integers(0, 1 << m.ep_bits, shape)
    seed = r.integers(0, 1024, n) if m.subsets > 1 else None
    wmain = r.integers(0, m.weight_levels, (n, 16))
    walpha = r.integers(0, m.weight_levels, (n, 16)) if m.dual_plane else None
    ub = T._pack_mode_blocks(mode_id, q0, q1, wmain, walpha, seed)
    np.testing.assert_array_equal(ub, J._pack_mode_blocks(mode_id, q0, q1, wmain, walpha, seed))
    return ub


@pytest.mark.parametrize("mode_id", sorted(J.MODES))
def test_astc_and_bc7_transcodes_match(mode_id):
    ub = _legacy_blocks_for_mode(mode_id, np.random.default_rng(100 + mode_id), 8)
    ab = tastc.transcode_uastc_to_astc(ub)
    np.testing.assert_array_equal(ab, jastc.transcode_uastc_to_astc(ub))
    np.testing.assert_array_equal(tastc.decode_astc_blocks(ab), jastc.decode_astc_blocks(ab))
    b7 = tbc7.transcode_uastc_to_bc7(ub)
    np.testing.assert_array_equal(b7, jbc7.transcode_uastc_to_bc7(ub))
    np.testing.assert_array_equal(tbc7.decode_bc7_blocks(b7), jbc7.decode_bc7_blocks(b7))


def test_astc_packers_and_unquantization_match():
    assert tastc._COLOR_RANGES == jastc._COLOR_RANGES
    for tq in jastc._COLOR_RANGES:
        assert tastc._levels(tq) == jastc._levels(tq)
        np.testing.assert_array_equal(tastc._color_unquant_lut(tq), jastc._color_unquant_lut(tq))
    for rgba in ([1, 2, 3, 4], [250, 0, 128, 255]):
        assert tastc.pack_void_extent(rgba) == jastc.pack_void_extent(rgba)


def test_fit_mode6_blocks_matches():
    rng = np.random.default_rng(11)
    px = rng.integers(0, 256, (64, 4, 4, 4)).astype(np.uint8)
    px[0], px[2], px[3] = 128, 0, 255
    px[1, ..., 3] = 255
    got = tbc7.fit_mode6_blocks(px)
    np.testing.assert_array_equal(got, jbc7.fit_mode6_blocks(px))
    for i in range(4):  # the vectorized fit is the scalar one's
        np.testing.assert_array_equal(got[i], np.frombuffer(tbc7._fit_mode6(px[i]), np.uint8))


def test_block_fits_match():
    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, (200, 16, 4)).astype(np.uint8)
    px[:5] = 90  # flat blocks
    px[5:10, :, 3] = 255
    np.testing.assert_array_equal(tfit.fit_eac_blocks(px[..., 3]), jfit.fit_eac_blocks(px[..., 3]))
    np.testing.assert_array_equal(tfit.fit_bc4_blocks(px[..., 3]), jfit.fit_bc4_blocks(px[..., 3]))
    np.testing.assert_array_equal(tfit.fit_bc1_blocks(px[..., :3]),
                                  jfit.fit_bc1_blocks(px[..., :3]))


@pytest.mark.parametrize("size", [(16, 16), (16, 64), (64, 16), (32, 32)])
def test_pvrtc1_fit_and_morton_order_match(size):
    h, w = size
    img = _smooth(h, w)[..., :3]
    words = tfit.fit_pvrtc1_from_rgba(img)
    np.testing.assert_array_equal(words, jfit.fit_pvrtc1_from_rgba(img))
    np.testing.assert_array_equal(tpvrtc.decode_pvrtc1_4bpp(words, w, h),
                                  jpvrtc.decode_pvrtc1_4bpp(words, w, h))
    gy, gx = np.mgrid[0:h // 4, 0:w // 4]
    m = tpvrtc._morton_interleave(gx.ravel(), gy.ravel(), w // 4, h // 4)
    np.testing.assert_array_equal(m, jpvrtc._morton_interleave(gx.ravel(), gy.ravel(),
                                                               w // 4, h // 4))
    assert sorted(m.tolist()) == list(range(len(m)))
