"""The port's host layers against the JAX package's, on the CPU.

Every module the port copied (varint/buffer, rANS and symbol coding, the
native library, KTX2, the Huffman coder, the ETC1S host emission, the
transcoder's RGBA decode, zstd; the Python Draco codec in
tests/test_torch_draco.py) must emit the same bytes as the original, on
the native path and on the Python path. The `path` fixture
switches both packages together: "python" makes each package's native
loader report no library, so both take their Python code.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import uvol_tpu.native as jnative
from uvol_tpu.codecs import buffer as jbuffer
from uvol_tpu.codecs import symbol_coding as jsym
from uvol_tpu.codecs.basis import etc1s_encode as jenc
from uvol_tpu.codecs.basis import huffman as jhuff
from uvol_tpu.codecs.basis import transcoder as jtrans
from uvol_tpu.containers import ktx2 as jktx2
from uvol_tpu.models import sequence as jseq
from uvol_tpu.native import zstd as jzstd
from uvol_tpu_torch import native as tnative
from uvol_tpu_torch.codecs import buffer as tbuffer
from uvol_tpu_torch.codecs import symbol_coding as tsym
from uvol_tpu_torch.codecs.basis import etc1s_encode as tenc
from uvol_tpu_torch.codecs.basis import huffman as thuff
from uvol_tpu_torch.codecs.basis import transcoder as ttrans
from uvol_tpu_torch.containers import ktx2 as tktx2
from uvol_tpu_torch.models import sequence as tseq
from uvol_tpu_torch.native import zstd as tzstd


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_etc1s_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_corto_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_draco_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_corto_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_draco_lib", lambda: None)
    else:
        assert tnative.get_lib() is not None  # g++ builds the port's library
    return request.param


# ---- rANS symbol coding ------------------------------------------------------


def _symbols(kind: str, width: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    n = 3000 * width
    if kind == "geometric":  # zigzag residuals: small values dominate
        return r.geometric(0.05, n).astype(np.uint32) - 1
    if kind == "wide":  # over 18 bits: the TAGGED scheme
        return r.integers(0, 1 << 22, n).astype(np.uint32)
    return np.full(n, 7, np.uint32)  # one symbol


def _encoded(sym_mod, buf_mod, symbols, width) -> bytes:
    out = buf_mod.EncoderBuffer()
    sym_mod.encode_symbols(symbols, width, out)
    return out.getvalue()


@pytest.mark.parametrize("kind", ["geometric", "wide", "constant"])
@pytest.mark.parametrize("width", [1, 2, 3])
def test_encode_symbols_identical(path, width, kind):
    s = _symbols(kind, width, seed=width)
    got = _encoded(tsym, tbuffer, s, width)
    assert got == _encoded(jsym, jbuffer, s, width)
    assert got[0] == (jsym.TAGGED if kind == "wide" else jsym.RAW)


@pytest.mark.parametrize("width", [1, 2, 3])
def test_decode_symbols_round_trips(path, width):
    s = _symbols("geometric", width, seed=10 + width)
    blob = _encoded(tsym, tbuffer, s, width)
    for sym_mod, buf_mod in ((tsym, tbuffer), (jsym, jbuffer)):
        got = sym_mod.decode_symbols(len(s), width, buf_mod.DecoderBuffer(blob))
        np.testing.assert_array_equal(got, s)
    wide = _symbols("wide", width, seed=20 + width)
    blob = _encoded(jsym, jbuffer, wide, width)
    np.testing.assert_array_equal(
        tsym.decode_symbols(len(wide), width, tbuffer.DecoderBuffer(blob)), wide)


def test_native_and_python_paths_emit_the_same_bytes(monkeypatch):
    s = _symbols("geometric", 3, seed=5)
    native = _encoded(tsym, tbuffer, s, 3)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert _encoded(tsym, tbuffer, s, 3) == native


def test_buffer_primitives_identical():
    outs = []
    for mod in (tbuffer, jbuffer):
        b = mod.EncoderBuffer()
        b.u8(200), b.u16(65000), b.u32(2**31 + 5), b.u64(2**60 + 3), b.f32(-1.25)
        b.varint(0), b.varint(300), b.varint(2**40), b.raw(b"xyz")
        b.start_bit_encoding(), b.put_bits(5, 3), b.put_bits(1023, 11)
        b.end_bit_encoding()
        outs.append(b.getvalue())
    assert outs[0] == outs[1]
    d = tbuffer.DecoderBuffer(outs[0])
    assert (d.u8(), d.u16(), d.u32(), d.u64(), d.f32()) == (200, 65000, 2**31 + 5,
                                                            2**60 + 3, -1.25)
    assert (d.varint(), d.varint(), d.varint(), d.raw(3)) == (0, 300, 2**40, b"xyz")
    assert d.start_bit_decoding(True) == 2
    assert (d.get_bits(3), d.get_bits(11)) == (5, 1023)


# ---- the port's native library build ------------------------------------------


def test_native_library_is_named_after_its_sources(monkeypatch, tmp_path):
    first = tnative.library_path()
    assert first.parent == tnative.BUILD_DIR and "_host_" in first.name
    src = tmp_path / "entropy.cpp"
    src.write_text("// one\n")
    monkeypatch.setattr(tnative, "SOURCES", (src,))
    a = tnative.library_path()
    src.write_text("// two\n")
    assert tnative.library_path() != a != first


def test_failed_native_build_is_not_sticky(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert tnative.get_lib() is None  # no g++: the Python paths run
    assert not (tmp_path / "build").exists()
    monkeypatch.undo()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    lib = tnative.get_lib()  # the next call builds
    assert lib is not None
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".so"]  # no .tmp left


# ---- zstd, KTX2 --------------------------------------------------------------


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_identical(level):
    data = np.random.default_rng(level).integers(0, 8, 50_000).astype(np.uint8).tobytes()
    blob = tzstd.compress(data, level)
    assert blob == jzstd.compress(data, level)
    assert tzstd.decompress(blob) == data == tzstd.decompress(blob, len(data))


def _ktx2_args(mod, kind: str):
    r = np.random.default_rng(len(kind))
    payload = r.integers(0, 256, 4096).astype(np.uint8).tobytes()
    scheme = {"etc1": mod.SUPERCOMPRESSION_NONE, "etc1-zstd": mod.SUPERCOMPRESSION_ZSTD,
              "basislz-rgb": 1, "basislz-rgba": 1}[kind]
    level = mod.KTX2Level(tzstd.compress(payload) if kind == "etc1-zstd" else payload,
                          len(payload))
    header = mod.KTX2Header(vk_format=147 if kind.startswith("etc1") else 0, type_size=1,
                            pixel_width=64, pixel_height=32, pixel_depth=0, layer_count=2,
                            face_count=1, level_count=1, supercompression_scheme=scheme)
    kw = {}
    if kind.startswith("basislz"):
        alpha = kind.endswith("rgba")
        descs = [mod.KTX2ImageDesc(mod.KTX2ImageDesc.IS_P_FRAME if i else 0, 100 * i, 90,
                                   200 + i if alpha else 0, 7 if alpha else 0)
                 for i in range(2)]
        kw = dict(dfd=mod.make_basis_dfd(srgb=not alpha, has_alpha=alpha),
                  basis_lz=mod.BasisLZGlobalData(40, 24, b"e" * 13, b"s" * 9, b"t" * 5,
                                                 b"", descs))
    return header, [level], kw, payload


@pytest.mark.parametrize("kind", ["etc1", "etc1-zstd", "basislz-rgb", "basislz-rgba"])
def test_ktx2_write_identical_and_read_back(kind):
    th, tl, tkw, payload = _ktx2_args(tktx2, kind)
    jh, jl, jkw, _ = _ktx2_args(jktx2, kind)
    blob = tktx2.write_ktx2(th, tl, **tkw)
    assert blob == jktx2.write_ktx2(jh, jl, **jkw)
    f = tktx2.read_ktx2(blob)
    assert f.header == th
    assert f.level_payload(0) == (payload if kind.startswith("etc1") else tl[0].data)
    if kind.startswith("basislz"):
        assert f.basis_lz == tkw["basis_lz"]
        assert f.dfd == tkw["dfd"] and f.dfd_color_model() == tktx2.KHR_DF_MODEL_ETC1S
    j = jktx2.read_ktx2(blob)
    assert (j.dfd, j.key_value, j.raw_sgd) == (f.dfd, f.key_value, f.raw_sgd)


# ---- Huffman -------------------------------------------------------------------


def _freqs(kind: str):
    r = np.random.default_rng(len(kind))
    if kind == "skewed":
        return [int(v) for v in r.geometric(0.3, 300) * (r.random(300) < 0.7)]
    if kind == "long":  # Fibonacci counts: unlimited lengths would pass 16
        fib = [1, 1]
        while len(fib) < 30:
            fib.append(fib[-1] + fib[-2])
        return fib
    if kind == "single":
        return [0, 0, 5, 0]
    return [int(v) for v in r.integers(1, 50, 257)]


@pytest.mark.parametrize("kind", ["skewed", "long", "single", "flat"])
def test_huffman_coder_identical(kind):
    freqs = _freqs(kind)
    te, je = thuff.HuffmanEncoder(freqs), jhuff.HuffmanEncoder(freqs)
    assert te.code_sizes == je.code_sizes and te.codes == je.codes
    assert max(te.code_sizes) <= thuff.MAX_CODE_LENGTH
    blobs = []
    for mod, enc in ((thuff, te), (jhuff, je)):
        bw = mod.BitWriter()
        enc.write_table(bw)
        for sym in np.nonzero(freqs)[0]:
            enc.encode(bw, int(sym))
        mod.write_vlc(bw, 1000, 4)
        blobs.append(bw.getvalue())
    assert blobs[0] == blobs[1]
    table = ttrans.read_huffman_table(ttrans.BitReader(blobs[0]))
    assert table.code_sizes == te.code_sizes


# ---- ETC1S host emission --------------------------------------------------------


def _palette(mod, f: int, nby: int, nbx: int, e: int = 40, s: int = 24, seed: int = 0):
    """A palette with spatially and temporally coherent grids, so every
    prediction (left, above, CR, explicit) and selector coding (history,
    RLE, literal) occurs."""
    r = np.random.default_rng(seed)
    ep = np.zeros((f, nby, nbx), np.int32)
    sel = np.zeros((f, nby, nbx), np.int32)
    for i in range(f):
        for y in range(nby):
            for x in range(nbx):
                u = r.random()
                if i and u < 0.3:
                    ep[i, y, x], sel[i, y, x] = ep[i - 1, y, x], sel[i - 1, y, x]
                elif x and u < 0.7:
                    ep[i, y, x] = ep[i, y, x - 1]
                    sel[i, y, x] = sel[i, y, x - 1] if r.random() < 0.6 else r.integers(0, s)
                elif y and u < 0.8:
                    ep[i, y, x], sel[i, y, x] = ep[i, y - 1, x], r.integers(0, s)
                else:
                    ep[i, y, x], sel[i, y, x] = r.integers(0, e), r.integers(0, s)
    return mod.Palettes(
        color5=r.integers(0, 32, (e, 3)).astype(np.uint8),
        inten=r.integers(0, 8, e).astype(np.uint8),
        selectors=r.integers(0, 4, (s, 16)).astype(np.uint8),
        block_endpoint=ep.reshape(f, -1), block_selector=sel.reshape(f, -1))


@pytest.mark.parametrize("p_slice", [False, True])
def test_encode_etc1s_slice_bits_identical(path, p_slice):
    pal = _palette(tenc, 2, 9, 11)
    eps, sels = pal.block_endpoint.reshape(2, 9, 11), pal.block_selector.reshape(2, 9, 11)
    prev = (eps[0], sels[0]) if p_slice else None
    args = (eps[1], sels[1], prev, 40, 24, 64)
    tf, jf = ({"pred": [0] * 257, "delta": [0], "sel": [0] * 89, "rle": [0] * 64}
              for _ in range(2))
    tenc.encode_etc1s_slice_bits(*args, freq_out=tf)
    jenc.encode_etc1s_slice_bits(*args, freq_out=jf)
    assert tf == jf
    tf["delta"] += [0] * (40 - len(tf["delta"]))
    for k in tf:
        if sum(tf[k]) == 0:
            tf[k][0] = 1
    t_enc = {k: thuff.HuffmanEncoder(v) for k, v in tf.items()}
    j_enc = {k: jhuff.HuffmanEncoder(v) for k, v in tf.items()}
    bits = tenc.encode_etc1s_slice_bits(*args, encoders=t_enc)
    assert bits == jenc.encode_etc1s_slice_bits(*args, encoders=j_enc)
    assert len(bits) > 10


def test_palette_host_functions_identical():
    pal = _palette(tenc, 3, 8, 8, seed=4)
    tp, jp = copy.deepcopy(pal), jenc.Palettes(**copy.deepcopy(vars(pal)))
    tenc.reorder_endpoint_palette(tp)
    jenc.reorder_endpoint_palette(jp)
    for k in vars(tp):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k), err_msg=k)
    assert (tenc.encode_endpoints_stream(tp.color5, tp.inten)
            == jenc.encode_endpoints_stream(tp.color5, tp.inten))
    assert tenc.encode_selectors_stream(tp.selectors) == jenc.encode_selectors_stream(
        tp.selectors)
    frames = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    assert tenc._palette_psnr(frames, tp, 8, 8) == jenc._palette_psnr(frames, jp, 8, 8)
    for scale in (0, 10, 40, 255):
        img = (np.random.default_rng(scale).random((2, 64, 64, 3)) * scale).astype(np.uint8)
        assert tenc.choose_codebook_sizes(img) == jenc.choose_codebook_sizes(img)


def _segment_with_fixed_palette(monkeypatch, channels: int):
    """Both encoders' whole `.ktx2` emission from one palette: each
    package's `build_palettes` is replaced by a copy of the same one."""
    f, nby, nbx = 2, 8, 12
    n_slices = 2 * f if channels == 4 else f
    pal = _palette(tenc, n_slices, nby, nbx, seed=channels)
    monkeypatch.setattr(tenc, "build_palettes", lambda *a, **kw: copy.deepcopy(pal))
    monkeypatch.setattr(jenc, "build_palettes",
                        lambda *a, **kw: jenc.Palettes(**copy.deepcopy(vars(pal))))
    frames = np.random.default_rng(7).integers(0, 256, (f, nby * 4, nbx * 4, channels))
    return frames.astype(np.uint8)


@pytest.mark.parametrize("channels", [3, 4])
def test_etc1s_segment_emission_identical(path, monkeypatch, channels):
    frames = _segment_with_fixed_palette(monkeypatch, channels)
    got = tenc.encode_ktx2_etc1s(frames, num_endpoints=40, num_selectors=24, device="cpu")
    assert got == jenc.encode_ktx2_etc1s(frames, num_endpoints=40, num_selectors=24)


@pytest.mark.parametrize("channels", [3, 4])
def test_transcode_of_a_port_segment_identical(path, monkeypatch, channels):
    frames = _segment_with_fixed_palette(monkeypatch, channels)
    blob = tenc.encode_ktx2_etc1s(frames, num_endpoints=40, num_selectors=24, device="cpu")
    got = ttrans.transcode_ktx2_etc1s(tktx2.read_ktx2(blob))
    assert got.shape == frames.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jtrans.transcode_ktx2_etc1s(jktx2.read_ktx2(blob)))
    if channels == 4:  # alpha slices have no etc1 target, in the reference either
        with pytest.raises(NotImplementedError):
            ttrans.transcode_ktx2_etc1s(tktx2.read_ktx2(blob), target="etc1")
    else:
        np.testing.assert_array_equal(
            ttrans.transcode_ktx2_etc1s(tktx2.read_ktx2(blob), target="etc1"),
            jtrans.transcode_ktx2_etc1s(jktx2.read_ktx2(blob), target="etc1"))
    np.testing.assert_array_equal(  # BC1 words, or BC3 (BC4 alpha + BC1) for alpha
        ttrans.transcode_ktx2_etc1s(tktx2.read_ktx2(blob), target="bc1-bc3"),
        jtrans.transcode_ktx2_etc1s(jktx2.read_ktx2(blob), target="bc1-bc3"))


# ---- whole codecs on both paths ----------------------------------------------------


def test_geometry_blobs_identical_on_both_paths(path):
    r = np.random.default_rng(2)
    pos = r.normal(size=(3, 900, 3)).astype(np.float32)
    uv = r.uniform(size=(3, 900, 2)).astype(np.float32)
    counts = np.array([900, 700, 880])
    faces = [r.integers(0, 700, (600, 3)).astype(np.int32) for _ in range(3)]
    jb = jseq.GeometrySequenceCodec().encode(jseq.GeometryFrameSet(pos, uv, counts, faces))
    codec = tseq.GeometrySequenceCodec(device="cpu")
    tb = codec.encode(tseq.GeometryFrameSet(pos, uv, counts, faces))
    assert tb == jb
    assert tseq.host_rans_is_native() == (path == "native")
    dec = codec.decode(jb)
    np.testing.assert_array_equal(dec.counts, counts)
    step = float((pos[0].max(0) - pos[0].min(0)).max()) / 2047
    assert np.abs(dec.positions[0] - pos[0]).max() <= step


@pytest.mark.parametrize("supercompression", ["none", "zstd"])
def test_etc1_segment_identical_on_both_paths(path, supercompression):
    frames = np.random.default_rng(3).integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    jc = jseq.TextureSequenceCodec(sequence_size=2, supercompression=supercompression)
    tc = tseq.TextureSequenceCodec(sequence_size=2, supercompression=supercompression,
                                   device="cpu")
    blob = tc.encode_segment(frames)
    assert blob == jc.encode_segment(frames)
    np.testing.assert_array_equal(tc.decode_segment(tseq.read_ktx2(blob)),
                                  jc.decode_segment(jktx2.read_ktx2(blob)))


# ---- the Draco frame codec (native library copy) ------------------------------------


def _drc_case(case: str) -> bytes:
    from uvol_tpu_torch.codecs.draco.grid import grid_drc

    if case == "grid_fixture":
        return (Path(__file__).parent / "fixtures" / "grid.drc").read_bytes()
    ny, nx, seed, bits = {"grid_11_17": (11, 17, 0, (11, 10, 8)),
                          "grid_9_23": (9, 23, 1, (14, 12, 10)),
                          "grid_2_2": (2, 2, 2, (11, 10, 8)),
                          "grid_16_bits": (12, 12, 3, (16, 16, 12))}[case]
    return grid_drc(ny, nx, seed, bits)


DRC_CASES = ["grid_fixture", "grid_11_17", "grid_9_23", "grid_2_2", "grid_16_bits"]


@pytest.mark.parametrize("case", DRC_CASES)
def test_drc_portable_decode_matches_the_python_decoder(case):
    """The port's native decode with `portable=True`: faces and corner maps
    as the full native decode gives them, integer attributes identical, and
    the quantized stages rebuilt in float64 equal the reference's pure
    Python `decode_drc` floats (tests/test_drc_device.py's check)."""
    from uvol_tpu.codecs.draco.decoder import decode_drc

    blob = _drc_case(case)
    port = tnative.drc_decode_native(blob, portable=True)
    full = tnative.drc_decode_native(blob)
    mesh = decode_drc(blob)
    assert port[:2] == full[:2] == (len(mesh.faces), mesh.num_points)
    np.testing.assert_array_equal(port[2], full[2])
    np.testing.assert_array_equal(port[2].reshape(-1, 3), mesh.faces)
    kinds = set()
    for pa, fa in zip(port[3], full[3], strict=True):
        assert pa[:5] == fa[:5]
        np.testing.assert_array_equal(pa[6], fa[6])
        kind = pa[7][0]
        kinds.add(kind)
        want = mesh.attribute_by_type(pa[0]).values
        if kind == 0:
            np.testing.assert_array_equal(pa[5], fa[5])
        elif kind == 1:
            _k, bits, _mq, rng, mins = pa[7]
            recon = mins[None, :pa[5].shape[1]] + pa[5].astype(np.float64) * (
                rng / ((1 << bits) - 1))
            np.testing.assert_allclose(recon.astype(np.float32), want, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(fa[5], want)
        else:  # octahedral: the ints the C float path decodes
            assert pa[5].shape[1] == 2 and pa[7][2] > 0
            np.testing.assert_array_equal(fa[5], want)
    assert kinds == {1, 2}


@pytest.mark.parametrize("case", DRC_CASES[1:])
def test_drc_encode_native_matches_the_python_encoder(case):
    """The port's native encoder emits the reference Python encoder's bytes
    (tests/test_native_draco.py holds the reference's native encoder to
    the same)."""
    from uvol_tpu.codecs.draco import encoder as jdenc
    from uvol_tpu_torch.codecs.draco.grid import grid_attributes

    ny, nx, seed, bits = {"grid_11_17": (11, 17, 0, (11, 10, 8)),
                          "grid_9_23": (9, 23, 1, (14, 12, 10)),
                          "grid_2_2": (2, 2, 2, (11, 10, 8)),
                          "grid_16_bits": (12, 12, 3, (16, 16, 12))}[case]
    faces, atts = grid_attributes(ny, nx, seed, bits)
    jatts = [jdenc.AttributeToEncode(a.attribute_type, a.values, a.corner_to_value,
                                     a.quantization_bits, a.integer) for a in atts]
    blob = tnative.drc_encode_native(faces, atts)
    assert blob == _drc_case(case) == jdenc.encode_drc(faces, jatts)


@pytest.mark.parametrize("mode", [8, 10, 12, 16, 32])
def test_window_packers_match_the_reference_numpy_packing(mode):
    """`pack_bits_native` and `pack_frames_native` against the reference's
    `_pack_host` on its numpy path (int64 input): group-aligned and tail
    lengths, values at the mode's bit edges, and the signed values that
    ride modes 16 and 32."""
    from uvol_tpu.models.drc_device import _pack_host, _packed_nbytes

    rng = np.random.default_rng(mode)
    hi = {8: 1 << 8, 10: 1 << 10, 12: 1 << 12, 16: 1 << 15, 32: 1 << 20}[mode]
    lengths = (0, 1, 2, 3, 4, 5, 7, 12, 1000, 1001, 1002, 1003)
    runs = [rng.integers(0, hi, n).astype(np.int64) for n in lengths]
    for v in runs:
        if len(v):
            v[0] = hi - 1
    if mode in (16, 32):
        runs.append(np.asarray([-1, -32768, 32767, 0, -5] if mode == 16 else
                               [-1, -(2**31), 2**31 - 1, 0, -5], np.int64))
    for v in runs:
        got = tnative.pack_bits_native(v.astype(np.int32), mode, _packed_nbytes(len(v), mode))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pack_host(v, mode), err_msg=f"{mode=} {len(v)=}")
    # whole frames into their padded slots of one window, at an odd offset
    stride = 1004
    frames = [v for v in runs if len(v) <= stride]
    ints = np.zeros((len(frames), stride), np.int64)
    for i, v in enumerate(frames):
        ints[i, :len(v)] = v
    want = _pack_host(ints.reshape(-1), mode)
    out = np.full(len(want) + 3, 0xAB, np.uint8)
    assert tnative.pack_frames_native([v.astype(np.int32) for v in frames], mode, stride,
                                      out, 3)
    assert (out[:3] == 0xAB).all()
    np.testing.assert_array_equal(out[3:], want)
    with pytest.raises(ValueError, match="do not fit"):
        tnative.pack_frames_native([v.astype(np.int32) for v in frames], mode, stride, out, 4)


def test_draco_library_is_a_second_library_and_not_sticky(monkeypatch, tmp_path):
    assert tnative.library_path(tnative.DRACO_SOURCES, "draco") != tnative.library_path()
    monkeypatch.setattr(tnative, "_draco_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert tnative.get_draco_lib() is None  # no g++: no .drc decode, no packer
    assert tnative.drc_decode_native(_drc_case("grid_fixture")) is None
    assert not tnative.pack_frames_native([np.zeros(3, np.int32)], 8, 4, np.zeros(4, np.uint8),
                                          0)
    assert not (tmp_path / "build").exists()


# ---- entry points need the card unless the caller names the CPU -------------------


@pytest.mark.parametrize("call", ["resolve_device", "geometry", "texture", "etc1s", "entry",
                                  "drc_batch", "drc_stream", "ring"])
def test_entry_points_default_to_the_card(monkeypatch, call):
    from uvol_tpu_torch._device import resolve_device
    from uvol_tpu_torch.entry import entry
    from uvol_tpu_torch.models import drc_device as tdrc
    from uvol_tpu_torch.runtime.device_stream import DeviceRingBuffer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = np.zeros((1, 8, 8, 3), np.uint8)
    blobs = [_drc_case("grid_fixture")]
    fn = {"resolve_device": lambda: resolve_device(None),
          "geometry": tseq.GeometrySequenceCodec,
          "texture": tseq.TextureSequenceCodec,
          "etc1s": lambda: tenc.encode_ktx2_etc1s(frames, num_endpoints=4, num_selectors=4),
          "entry": entry,
          "drc_batch": lambda: tdrc.decode_drc_batch(blobs),
          "drc_stream": lambda: list(tdrc.decode_drc_stream(blobs)),
          "ring": DeviceRingBuffer}[call]
    with pytest.raises(RuntimeError, match="cuda"):
        fn()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


# ---- the encoder CLI's and the player's host modules ---------------------------
#
# Copies (paths, interfaces, manifest I/O, meshio, audio, stats, the player's
# clock and scheduler, the prefetch pool, the Draco frame decoder, the
# transcoder's ETC1/EAC targets) against their originals, and the PNG reader
# that replaces the reference's Pillow call against Pillow itself.

import json as _json
import struct as _struct
import wave as _wave
import zlib as _zlib

from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from uvol_tpu import interfaces as jifc
from uvol_tpu.codecs.draco import decoder as jdrc
from uvol_tpu.containers import manifest as jman
from uvol_tpu.io import audio as jaudio
from uvol_tpu.io import meshio as jmesh
from uvol_tpu.player import clock as jclock
from uvol_tpu.player import scheduler as jsched
from uvol_tpu.runtime import prefetch as jprefetch
from uvol_tpu.utils import paths as jpaths
from uvol_tpu.utils import stats as jstats
from uvol_tpu_torch import interfaces as tifc
from uvol_tpu_torch.codecs.draco import decoder as tdrc
from uvol_tpu_torch.containers import manifest as tman
from uvol_tpu_torch.io import audio as taudio
from uvol_tpu_torch.io import image as timage
from uvol_tpu_torch.io import meshio as tmesh
from uvol_tpu_torch.player import clock as tclock
from uvol_tpu_torch.player import scheduler as tsched
from uvol_tpu_torch.runtime import prefetch as tprefetch
from uvol_tpu_torch.utils import paths as tpaths
from uvol_tpu_torch.utils import stats as tstats

FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.mark.parametrize("template,kw", [
    ("geometry_[target]/[#####][ext]", {"index": 42, "target": "draco", "ext": ".drc"}),
    ("texture_[target]_[type]_[tag]/[#####][ext]",
     {"index": 7, "target": "etc1s-tpu", "type": "baseColor", "tag": "default"}),
    ("a/[##]/[#####].x", {"index": 123456}),
    ("plain/path.bin", {"index": 3, "ext": ".y"}),
])
def test_paths_match(template, kw):
    assert tpaths.expand_template(template, **kw) == jpaths.expand_template(template, **kw)
    for fn in ("pattern_to_glob", "pattern_to_printf", "count_hash_char"):
        assert getattr(tpaths, fn)(template) == getattr(jpaths, fn)(template)
    for base in ("https://cdn/x/liam.uvol.json", "/data/out/p.uvol.json", "p.json"):
        assert tpaths.get_absolute_url(base, template) == jpaths.get_absolute_url(base, template)
    assert tpaths.pad(7, 5) == jpaths.pad(7, 5) and tpaths.pad(123456, 3) == "123456"


def _manifest(**over):
    d = {"version": "v2",
         "geometry": {"targets": {"draco": {"frameRate": 30, "frameCount": 32,
                                            "format": "draco"}},
                      "path": "geometry_[target]/[#####][ext]"},
         "texture": {"targets": {"etc1s-tpu": {"format": "ktx2", "frameRate": 30,
                                               "resolution": [1024, 1024], "sequenceSize": 5,
                                               "sequenceCount": 7, "type": "baseColor",
                                               "tag": "default"}},
                     "path": "texture_[target]_[type]_[tag]/[#####][ext]"}}
    for k, v in over.items():  # section__target__field, "_" in a target name for "-"
        sec, key, field = k.split("__")
        d[sec]["targets"][key.replace("_", "-")][field] = v
    return d


MANIFESTS = {
    "liam": _manifest(),
    "audio": {**_manifest(), "audio": {"path": "a.mp3", "format": ["mp3", "wav"]}},
    "duration_mismatch": _manifest(texture__etc1s_tpu__sequenceCount=2),
    "rates": _manifest(geometry__draco__frameRate=25),
    "empty_counts": _manifest(geometry__draco__frameCount=0, texture__etc1s_tpu__sequenceSize=0),
}


@pytest.mark.parametrize("name", list(MANIFESTS))
def test_manifest_parse_validate_and_save_match(name, tmp_path):
    d = MANIFESTS[name]
    tm, jm = tifc.parse_manifest(_json.dumps(d)), jifc.parse_manifest(d)
    assert tm.to_json() == jm.to_json()
    assert tman.validate_v2_manifest(tm) == jman.validate_v2_manifest(jm)
    tman.save_manifest(tm, str(tmp_path / "t.uvol.json"))
    jman.save_manifest(jm, str(tmp_path / "j.uvol.json"))
    assert (tmp_path / "t.uvol.json").read_bytes() == (tmp_path / "j.uvol.json").read_bytes()
    assert tman.load_manifest(str(tmp_path / "j.uvol.json")).to_json() == jm.to_json()


def test_interface_tables_and_v1_parse_match():
    assert tifc.FORMATS_TO_EXT == jifc.FORMATS_TO_EXT
    assert tifc.TEXTURE_FORMAT_PRIORITY == jifc.TEXTURE_FORMAT_PRIORITY
    assert [m.value for m in tifc.PlayMode] == [m.value for m in jifc.PlayMode]
    v1 = {"maxVertices": 9, "maxTriangles": 4, "frameRate": 25,
          "frameData": [{"frameNumber": i, "keyframeNumber": 0, "startBytePosition": 10 * i,
                         "vertices": 9, "faces": 4, "meshLength": 10} for i in range(3)]}
    t, j = tifc.parse_manifest(v1), jifc.parse_manifest(v1)
    assert isinstance(t, tifc.V1Schema) and t.to_json() == j.to_json()
    with pytest.raises(ValueError):
        tifc.parse_manifest(_manifest(geometry__draco__format="corto"))


OBJ_TEXT = """mtllib scene.mtl
o body
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 1 0
usemtl skin
f 1/1/1 2/2/1 3/3/1 4/4/1
g top
f -1/4/2 1/1/2 2/2/2
f 3//1 4//1 5//1
f 2 3 5
"""


def _ply(binary: bool, wedge: bool) -> bytes:
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0.5]], np.float32)
    nrm = np.array([[0, 0, 1]] * 4, np.float32)
    faces = [[0, 1, 2], [0, 2, 3, 1]]
    head = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
            "comment TextureFile tex.png", "element vertex 4", "property float x",
            "property float y", "property float z", "property float nx", "property float ny",
            "property float nz"]
    if not wedge:
        head += ["property float u", "property float v"]
    head += ["element face 2", "property list uchar int vertex_indices"]
    if wedge:
        head += ["property list uchar float texcoord"]
    head += ["end_header"]
    uv = pos[:, :2] * 0.5
    out = ("\r\n" if binary else "\n").join(head).encode() + (b"\r\n" if binary else b"\n")
    rows = []
    for i in range(4):
        vals = list(pos[i]) + list(nrm[i]) + ([] if wedge else list(uv[i]))
        rows.append(vals)
    for i, vals in enumerate(rows):
        out += (_struct.pack(f"<{len(vals)}f", *vals) if binary
                else (" ".join(f"{v:g}" for v in vals) + "\n").encode())
    for f in faces:
        tc = [float(c) for k in f for c in uv[k] + 0.25]
        if binary:
            out += _struct.pack(f"<B{len(f)}i", len(f), *f)
            if wedge:
                out += _struct.pack(f"<B{len(tc)}f", len(tc), *tc)
        else:
            line = f"{len(f)} " + " ".join(map(str, f))
            if wedge:
                line += f" {len(tc)} " + " ".join(f"{v:g}" for v in tc)
            out += (line + "\n").encode()
    return out


@pytest.mark.parametrize("kind", ["obj", "obj_cli_grid", "ply_ascii", "ply_binary",
                                  "ply_ascii_wedge", "ply_binary_wedge"])
def test_load_mesh_matches(kind, tmp_path):
    if kind.startswith("obj"):
        path = tmp_path / "m.obj"
        if kind == "obj":
            path.write_text(OBJ_TEXT)
        else:
            pos, uv, nrm, faces = _grid_mesh()
            lines = [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in pos]
            lines += [f"vt {a:.6f} {b:.6f}" for a, b in uv]
            lines += [f"vn {a:.6f} {b:.6f} {c:.6f}" for a, b, c in nrm]
            lines += ["f " + " ".join(f"{k + 1}/{k + 1}/{k + 1}" for k in f) for f in faces]
            path.write_text("\n".join(lines) + "\n")
    else:
        path = tmp_path / "m.ply"
        path.write_bytes(_ply("binary" in kind, "wedge" in kind))
    got, want = tmesh.load_mesh(str(path)), jmesh.load_mesh(str(path))
    for field in ("positions", "faces", "uvs", "uv_faces", "normals", "normal_faces"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.groups, got.exif) == (want.groups, want.exif)


def _grid_mesh():
    from uvol_tpu_torch.codecs.draco.grid import grid_mesh

    return grid_mesh(4, 6, seed=3)


def _wav(path, seconds: float, rate: int = 8000):
    with _wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(b"\0\0" * int(seconds * rate))


def _mp3(path, frames: int, id3: bool):
    """MPEG-1 layer III frames at 128 kbit/s, 44.1 kHz (417 bytes each)."""
    head = b"ID3\x03\x00\x00\x00\x00\x00\x0a" + b"\0" * 10 if id3 else b""
    frame = bytes([0xFF, 0xFB, 0x90, 0x00]) + b"\0" * 413
    path.write_bytes(head + frame * frames)


@pytest.mark.parametrize("kind", ["wav", "mp3", "mp3_id3", "missing"])
def test_audio_duration_matches(kind, tmp_path):
    path = tmp_path / ("a.wav" if kind == "wav" else "a.mp3")
    if kind == "wav":
        _wav(path, 1.25)
    elif kind != "missing":
        _mp3(path, 40, kind == "mp3_id3")
    got, want = taudio.audio_duration(str(path)), jaudio.audio_duration(str(path))
    assert got == want
    assert (got is None) == (kind == "missing")


def test_stats_registry_matches():
    regs = (tstats.StatsRegistry(), jstats.StatsRegistry())
    for reg in regs:
        reg.count("v2.frames_ok")
        reg.count("v2.frames_ok", 3)
        reg.gauge("buffer", 0.5)
        for v in (0.25, 1.0, 0.5):
            reg.observe("draco.decode_s", v)
    assert regs[0].snapshot() == regs[1].snapshot()
    regs[0].reset()
    assert regs[0].snapshot() == {"counters": {}, "gauges": {}, "timings": {}}


def test_playback_clocks_match():
    t = [0.0]
    clocks = (tclock.PlaybackClock(now=lambda: t[0]), jclock.PlaybackClock(now=lambda: t[0]))
    trace = []
    for step, action in ((0.0, "start"), (1.0, None), (0.5, "pause"), (2.0, None),
                         (0.0, "play"), (0.25, None), (0.0, "pause"), (0.0, "play")):
        t[0] += step
        for c in clocks:
            if action:
                getattr(c, action)()
        trace.append([(c.current_time, c.is_paused) for c in clocks])
    assert all(a == b for a, b in trace)
    vt, vj = tclock.VirtualClock(), jclock.VirtualClock()
    for dt in (1 / 60, 0.5, 1 / 30):
        vt.advance(dt)
        vj.advance(dt)
    assert vt() == vj()


_rates = st.sampled_from([10, 15, 24, 25, 30, 60])


@settings(max_examples=200, deadline=None)
@given(rate=_rates, t=st.floats(0, 120, allow_nan=False))
def test_get_current_frame_matches(rate, t):
    assert tsched.get_current_frame(rate, t) == jsched.get_current_frame(rate, t)


@settings(max_examples=150, deadline=None)
@given(g_rate=_rates, t_rate=_rates, g_count=st.integers(1, 400), seq=st.integers(1, 8),
       seq_count=st.integers(1, 80), buffer=st.floats(0.1, 6),
       times=st.lists(st.floats(0, 20, allow_nan=False), min_size=1, max_size=6))
def test_plan_prefetch_and_eviction_match(g_rate, t_rate, g_count, seq, seq_count, buffer,
                                          times):
    ts, js = tsched.PrefetchState(), jsched.PrefetchState()
    for now in sorted(times):
        kw = dict(current_time=now, geometry_frame_rate=g_rate, geometry_frame_count=g_count,
                  texture_frame_rate=t_rate, texture_sequence_size=seq,
                  texture_sequence_count=seq_count, buffer_duration=buffer)
        got, want = tsched.plan_prefetch(ts, **kw), jsched.plan_prefetch(js, **kw)
        assert (got.geometry_frames, got.texture_segments) == (
            want.geometry_frames, want.texture_segments)
        assert dataclasses_astuple(ts) == dataclasses_astuple(js)
        ev = dict(current_time=now, geometry_frame_rate=g_rate, texture_frame_rate=t_rate,
                  texture_sequence_size=seq)
        assert tsched.eviction_thresholds(**ev) == jsched.eviction_thresholds(**ev)


def dataclasses_astuple(x):
    import dataclasses

    return dataclasses.astuple(x)


@pytest.mark.parametrize("max_in_flight", [None, 2])
def test_prefetch_pool_matches(max_in_flight):
    def work(x):
        if x == 5:
            raise ValueError("boom")
        return x * 3

    results = []
    for mod in (tprefetch, jprefetch):
        pool = mod.PrefetchPool(work, workers=4, max_in_flight=max_in_flight)
        accepted = [pool.request(i % 7, i % 7) for i in range(10)]
        pool.wait_idle()
        done = pool.poll()
        pool.forget(2)
        again = pool.request(2, 2)
        pool.wait_idle()
        done2 = pool.poll()
        pool.close()
        results.append((accepted, {k: (r, type(e).__name__) for k, (r, e) in done.items()},
                        again, {k: r for k, (r, e) in done2.items()}, pool.request(9, 9)))
    assert results[0] == results[1]
    assert results[0][1][5] == (None, "ValueError")


# ---- the player's Draco frame decoder and texture targets --------------------------


def test_decode_drc_matches_the_reference_on_the_fixture():
    data = (FIXTURES / "grid.drc").read_bytes()
    got, want = tdrc.decode_drc(data), jdrc.decode_drc(data)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.num_points == want.num_points
    for att in (0, 1, 3):  # POSITION, NORMAL, TEX_COORD where present
        a, b = got.point_attribute(att), want.point_attribute(att)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_decode_drc_of_a_stream_off_the_native_path_raises():
    """grid_std.drc uses the standard edgebreaker coder, which the native
    decoder does not take: both packages fall back to their Python stages
    (the port raised before it copied them) and return the same arrays
    (tests/test_torch_draco.py holds every stream kind on both paths)."""
    data = (FIXTURES / "grid_std.drc").read_bytes()
    assert tnative.drc_decode_native(data) is None
    got, want = tdrc.decode_drc(data), jdrc.decode_drc(data)
    assert got.num_points == want.num_points > 0
    np.testing.assert_array_equal(got.faces, want.faces)
    for a, b in zip(got.attributes, want.attributes, strict=True):
        assert a.values.dtype == b.values.dtype
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.corner_to_value, b.corner_to_value)


@pytest.mark.parametrize("n", [0, 1, 200, 5000])
def test_rans_bit_coder_identical(path, n):
    """The binary rABS coder the Draco stack calls, copied: the same bytes
    (the native emit above 256 bits) and the same bits back."""
    from uvol_tpu.codecs import rans as jrans
    from uvol_tpu_torch.codecs import rans as trans

    bits = (np.random.default_rng(n).random(n) < 0.3).astype(np.uint8)
    blobs = []
    for rans, buf in ((jrans, jbuffer), (trans, tbuffer)):
        enc = rans.RansBitEncoder()
        enc.encode_bits(bits[: n // 2])
        for b in bits[n // 2:]:
            enc.encode_bit(int(b))
        out = buf.EncoderBuffer()
        enc.flush(out)
        blobs.append(out.getvalue())
    assert blobs[1] == blobs[0]
    dec = trans.RansBitDecoder(tbuffer.DecoderBuffer(blobs[1]))
    assert [dec.decode_bit() for _ in range(n)] == bits.tolist()


def test_python_draco_codec_runs_without_jax_or_the_reference(tmp_path):
    """The copied Draco codec alone: a subprocess that refuses `jax` and
    `uvol_tpu` and holds every Draco caller on its Python path
    (`UVT_DISABLE_NATIVE_DRACO=1`) decodes grid_std.drc and encodes and
    decodes a grid, and loads nothing of either."""
    import os
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent("""
        import importlib.abc, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "uvol_tpu"):
                    raise ImportError(f"refused: {name}")
                return None

        sys.meta_path.insert(0, Refuse())
        import numpy as np
        from uvol_tpu_torch import native
        from uvol_tpu_torch.codecs.draco.decoder import decode_drc
        from uvol_tpu_torch.codecs.draco.grid import grid_attributes
        from uvol_tpu_torch.codecs.draco.encoder import encode_drc
        assert native.get_draco_lib() is None
        assert decode_drc(open(sys.argv[1], "rb").read()).num_points == 72
        faces, atts = grid_attributes(6, 9, 1)
        mesh = decode_drc(encode_drc(faces, atts, traversal_encoding="standard"))
        assert mesh.num_points == 54 and len(mesh.faces) == len(faces)
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "uvol_tpu")]
        assert not loaded, loaded
        print("ok")
        """)
    env = dict(os.environ, PYTHONPATH=str(FIXTURES.parents[1]), UVT_DISABLE_NATIVE_DRACO="1")
    proc = subprocess.run([sys.executable, "-c", script, str(FIXTURES / "grid_std.drc")],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_signed_symbol_converters_identical():
    v = np.random.default_rng(1).integers(-(1 << 30), 1 << 30, 1000)
    v[:4] = [0, -1, 1, -(1 << 30)]
    sym = tsym.convert_signed_to_symbols(v)
    np.testing.assert_array_equal(sym, jsym.convert_signed_to_symbols(v))
    assert sym.dtype == np.uint32
    np.testing.assert_array_equal(tsym.convert_symbols_to_signed(sym),
                                  jsym.convert_symbols_to_signed(sym))
    np.testing.assert_array_equal(tsym.convert_symbols_to_signed(sym), v)


def test_srgb_vertex_colors_match():
    c = np.linspace(0, 1, 101, dtype=np.float32)
    np.testing.assert_array_equal(tdrc.srgb_to_linear(c), jdrc.srgb_to_linear(c))
    assert tdrc.integer_dtype(tdrc.K.DT_UINT16) == jdrc.integer_dtype(jdrc.K.DT_UINT16)


_CAPS = ("astc", "bptc", "dxt", "etc2", "etc1", "pvrtc")


@pytest.mark.parametrize("is_uastc", [False, True])
@pytest.mark.parametrize("size", [(1024, 1024), (1024, 768), (0, 0)])
def test_select_transcode_target_matches_on_every_capability_set(is_uastc, size):
    import itertools

    assert ttrans.FORMAT_OPTIONS == jtrans.FORMAT_OPTIONS
    for n in range(len(_CAPS) + 1):
        for caps in itertools.combinations(_CAPS, n):
            kw = dict(is_uastc=is_uastc, width=size[0], height=size[1])
            assert ttrans.select_transcode_target(caps, **kw) == \
                jtrans.select_transcode_target(caps, **kw), caps


@pytest.mark.parametrize("target", ["etc1", "etc2-eac", "rgba", "bc1-bc3", "pvrtc1"])
@pytest.mark.parametrize("fixture", ["video.ktx2", "video_legacy_r3.ktx2"])
def test_transcode_targets_match_on_fixtures(path, fixture, target):
    data = (FIXTURES / fixture).read_bytes()
    got = ttrans.transcode_ktx2_etc1s(tktx2.read_ktx2(data), target=target)
    want = jtrans.transcode_ktx2_etc1s(jktx2.read_ktx2(data), target=target)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_transcode_of_an_alpha_segment_to_etc2_eac(path):
    frames = np.random.default_rng(4).integers(0, 256, (2, 12, 20, 4)).astype(np.uint8)
    frames[..., 3] = np.linspace(0, 255, 20, dtype=np.uint8)[None, None, :]
    blob = tenc.encode_ktx2_etc1s(frames, num_endpoints=12, num_selectors=12, device="cpu")
    got = ttrans.transcode_ktx2_etc1s(tktx2.read_ktx2(blob), target="etc2-eac")
    np.testing.assert_array_equal(
        got, jtrans.transcode_ktx2_etc1s(jktx2.read_ktx2(blob), target="etc2-eac"))
    with pytest.raises(NotImplementedError, match="alpha"):
        ttrans.transcode_ktx2_etc1s(tktx2.read_ktx2(blob), target="etc1")
    np.testing.assert_array_equal(
        ttrans.transcode_ktx2_etc1s(tktx2.read_ktx2(blob), target="bc1-bc3"),
        jtrans.transcode_ktx2_etc1s(jktx2.read_ktx2(blob), target="bc1-bc3"))
    # PVRTC1 has no alpha: both refuse the file alike
    outcomes = []
    for trans, ktx in ((ttrans, tktx2), (jtrans, jktx2)):
        with pytest.raises(NotImplementedError, match="alpha") as e:
            trans.transcode_ktx2_etc1s(ktx.read_ktx2(blob), target="pvrtc1")
        outcomes.append(str(e.value))
    assert outcomes[0] == outcomes[1]


def test_etc1_and_eac_entry_tables_match():
    r = np.random.default_rng(6)
    data = (FIXTURES / "video.ktx2").read_bytes()
    g = tktx2.read_ktx2(data).basis_lz
    eps = ttrans.decode_endpoints(g.endpoints_data, g.endpoint_count)
    jeps = jtrans.decode_endpoints(g.endpoints_data, g.endpoint_count)
    sels = ttrans.decode_selectors(g.selectors_data, g.selector_count)
    for a, b in zip(ttrans.etc1_word_tables(eps, sels), jtrans.etc1_word_tables(jeps, sels)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ttrans.eac_entry_tables(eps), jtrans.eac_entry_tables(jeps)):
        np.testing.assert_array_equal(a, b)
    blocks = np.stack([r.integers(0, g.endpoint_count, (4, 5)),
                       r.integers(0, g.selector_count, (4, 5))], -1).astype(np.int32)
    np.testing.assert_array_equal(ttrans.blocks_to_etc1_words(blocks, eps, sels),
                                  jtrans.blocks_to_etc1_words(blocks, jeps, sels))
    np.testing.assert_array_equal(ttrans.alpha_blocks_to_eac_words(blocks, eps, sels),
                                  jtrans.alpha_blocks_to_eac_words(blocks, jeps, sels))


def test_etc1s_words_native_matches_the_gather():
    r = np.random.default_rng(8)
    w1 = r.integers(0, 2**32, 40, dtype=np.uint32)
    w2 = r.integers(0, 2**32, 17, dtype=np.uint32)
    blocks = np.stack([r.integers(0, 40, (6, 9)), r.integers(0, 17, (6, 9))], -1)
    got = tnative.etc1s_words_native(blocks, w1, w2)
    want = np.stack([w1[blocks[..., 0].reshape(-1)], w2[blocks[..., 1].reshape(-1)]], 1)
    np.testing.assert_array_equal(got, want)
    blocks[2, 3, 0] = 40  # out of its table
    assert tnative.etc1s_words_native(blocks, w1, w2) is None


# ---- the PNG reader against Pillow -------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_bytes(rows: np.ndarray, width: int, ctype: int, depth: int, filters,
               palette=None, interlace: int = 0) -> bytes:
    """A PNG of raw scanline bytes rows [H, stride], each row filtered with
    filters[y % len(filters)] (a writer of this test's own: Pillow picks its
    filters itself)."""
    h, stride = rows.shape
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, nch * depth // 8)
    raw = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = rows[y].astype(np.int64)
        out = []
        for x in range(stride):
            a = int(cur[x - bpp]) if x >= bpp else 0
            b = int(prev[x])
            c = int(prev[x - bpp]) if x >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ft]
            out.append((int(cur[x]) - pred) & 0xFF)
        raw += bytes([ft]) + bytes(out)
        prev = cur

    def chunk(kind, body):
        return (_struct.pack(">I", len(body)) + kind + body
                + _struct.pack(">I", _zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = timage.PNG_SIGNATURE + chunk(
        b"IHDR", _struct.pack(">IIBBBBB", width, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", _zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("width", [1, 5, 13])
@pytest.mark.parametrize("ctype,depth", [(0, 8), (2, 8), (3, 8), (3, 4), (3, 2), (3, 1),
                                         (4, 8), (6, 8)])
def test_png_reader_matches_pillow_for_every_filter(tmp_path, ctype, depth, width):
    r = np.random.default_rng(width * 100 + ctype * 10 + depth)
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    h = 10
    palette = None
    if ctype == 3:
        palette = r.integers(0, 256, (1 << depth, 3))
        idx = r.integers(0, 1 << depth, (h, width)).astype(np.uint8)
        rows = np.packbits(np.unpackbits(idx[..., None], axis=-1)[..., 8 - depth:]
                           .reshape(h, -1), axis=1)
    else:
        rows = r.integers(0, 256, (h, width * nch)).astype(np.uint8)
        rows[::3] = rows[::3] // 8 + 100  # smooth rows: small differences
    path = tmp_path / "t.png"
    path.write_bytes(_png_bytes(rows, width, ctype, depth, [0, 1, 2, 3, 4], palette))
    got = timage.read_png(str(path))
    want = np.asarray(Image.open(path).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == want.shape == (h, width, 3)
    np.testing.assert_array_equal(got, want)
    assert timage.png_size(str(path)) == Image.open(path).size


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_reader_matches_pillow_on_pillow_files(tmp_path, mode):
    """Pillow's own writer, which picks each row's filter adaptively."""
    yy, xx = np.mgrid[0:37, 0:53]
    rgb = np.stack([(xx * 5) % 256, (yy * 7) % 256, (xx * yy) % 256], -1).astype(np.uint8)
    img = Image.fromarray(rgb).convert(mode)
    path = tmp_path / "p.png"
    img.save(path)
    np.testing.assert_array_equal(timage.read_png(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("case,match", [
    ("16bit", "16-bit"), ("adam7", "Adam7"), ("gray4", "4-bit"), ("jpeg", "not a PNG")])
def test_png_reader_refuses_what_it_does_not_read(tmp_path, case, match):
    path = tmp_path / "x.png"
    rows = np.zeros((2, 4), np.uint8)
    data = {"16bit": lambda: _png_bytes(rows, 2, 0, 16, [0]),
            "adam7": lambda: _png_bytes(rows, 4, 0, 8, [0], interlace=1),
            "gray4": lambda: _png_bytes(rows, 8, 0, 4, [0]),
            "jpeg": lambda: b"\xff\xd8\xff\xe0" + b"\0" * 40}[case]()
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        timage.read_png(str(path))


# ---- the Corto codec (codecs/corto/ and native/corto_*.cpp) ------------------------


def _corto_grid(w, seed=0):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:w, 0:w]
    pos = np.stack([xx.ravel() * 0.1, yy.ravel() * 0.1,
                    r.normal(size=w * w) * 0.05], -1).astype(np.float32)
    faces = [[y * w + x, y * w + x + 1, y * w + x + w] for y in range(w - 1) for x in range(w - 1)]
    faces += [[y * w + x + 1, y * w + x + w + 1, y * w + x + w]
              for y in range(w - 1) for x in range(w - 1)]
    return pos, np.asarray(faces, np.int64)


def _corto_case(case):
    """(positions, faces, keyword arguments) of one `encode_crt` call, and
    the keyword arguments built from the `CrtCustomAttr` of the package
    given (each package has its own class)."""
    r = np.random.default_rng(5)
    if case == "point_cloud":
        pos = (r.normal(size=(3000, 3)) * 4).astype(np.float32)
        return pos, np.zeros((0, 3), np.int64), {"colors": r.integers(0, 256, (3000, 4))}
    pos, faces = _corto_grid(14 if case != "multigroup" else 16)
    n = len(pos)
    nrm = r.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    kw = {"uvs": r.uniform(0, 1, (n, 2)).astype(np.float32), "normals": nrm,
          "colors": r.integers(0, 256, (n, 4))}
    if case == "multigroup":
        kw["groups"] = [100, 250, len(faces)]
    elif case.startswith("entropy_"):
        kw["entropy"] = int(case.split("_")[1])
    elif case.startswith("normals_"):
        kw["normal_prediction"] = case.split("_")[1]
    elif case == "custom":
        kw["custom_attributes"] = {
            "heat": (r.normal(size=(n, 1)).astype(np.float32), {"step": 1e-3}),
            "flags": (r.integers(-5, 200, (n, 2)).astype(np.int64), {}),
            "auto": (r.normal(size=(n, 1)).astype(np.float32) * 40, {"bits": 14}),
        }
    elif case == "trajectory":  # polynomial coefficients as xPos/yPos/zPos (16 bits)
        coef = r.normal(size=(3, n, 4)).astype(np.float32)
        kw["custom_attributes"] = {name: (np.ascontiguousarray(coef[a]), {"bits": 16})
                                   for a, name in enumerate(("xPos", "yPos", "zPos"))}
    return pos, faces, kw


def _with_custom(kw, attr_cls):
    kw = dict(kw)
    if "custom_attributes" in kw:
        kw["custom_attributes"] = {k: attr_cls(v, **o) for k, (v, o) in
                                   kw["custom_attributes"].items()}
    return kw


CORTO_CASES = ["mesh", "point_cloud", "multigroup", "entropy_0", "entropy_3", "entropy_4",
               "normals_estimated", "normals_border", "custom", "trajectory"]


def _same_mesh(a, b):
    assert (a.nvert, a.nface) == (b.nvert, b.nface)
    np.testing.assert_array_equal(np.asarray(a.faces), np.asarray(b.faces))
    assert set(a.attributes) == set(b.attributes)
    for k, v in a.attributes.items():
        assert v.dtype == b.attributes[k].dtype
        np.testing.assert_array_equal(v, b.attributes[k])


@pytest.mark.parametrize("case", CORTO_CASES)
def test_corto_copy_bytes_match(path, case):
    """`encode_crt` of the copy writes the original's bytes, and both
    decoders give the same mesh, on the native and the Python paths."""
    from uvol_tpu.codecs import corto as jcorto
    from uvol_tpu.codecs.corto.encoder import CrtCustomAttr as JAttr
    from uvol_tpu_torch.codecs import corto as tcorto
    from uvol_tpu_torch.codecs.corto.encoder import CrtCustomAttr as TAttr

    pos, faces, kw = _corto_case(case)
    blob = tcorto.encode_crt(pos, faces, **_with_custom(kw, TAttr))
    assert blob == jcorto.encode_crt(pos, faces, **_with_custom(kw, JAttr))
    _same_mesh(tcorto.decode_crt(blob), jcorto.decode_crt(blob))


@pytest.mark.parametrize("staged", [False, True])
def test_corto_copy_decodes_the_fixture(path, staged, monkeypatch):
    """tests/fixtures/grid.crt through both decoders, whole-frame and staged
    (`UVT_CRT_STAGED=1`)."""
    from uvol_tpu.codecs import corto as jcorto
    from uvol_tpu_torch.codecs import corto as tcorto

    if staged:
        monkeypatch.setenv("UVT_CRT_STAGED", "1")
    blob = (Path(__file__).parent / "fixtures" / "grid.crt").read_bytes()
    got = tcorto.decode_crt(blob)
    _same_mesh(got, jcorto.decode_crt(blob))
    assert got.nface > 0 and got.attributes["position"].shape == (got.nvert, 3)


def test_corto_native_library_builds():
    """g++ builds the port's Corto library (zlib linked)."""
    assert tnative.get_corto_lib() is not None
