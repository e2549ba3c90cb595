"""The port's host layers against the JAX package's, on the CPU.

Every module the port copied (varint/buffer, rANS and symbol coding, the
native library, KTX2, the Huffman coder, the ETC1S host emission, the
transcoder's RGBA decode, zstd) must emit the same bytes as the
original, on the native path and on the Python path. The `path` fixture
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
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
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
    with pytest.raises(NotImplementedError):
        ttrans.transcode_ktx2_etc1s(tktx2.read_ktx2(blob), target="etc1")


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
