"""The port's players (`uvol_tpu_torch.player`) against the reference's
(`uvol_tpu.player`), on the CPU.

Projects are made once per module by the port's encoder CLI on the CPU
(tests/test_torch_cli.py holds its files byte for byte against the
reference CLI's). The reference's facade `Player` and the port's, the
port's on `device="cpu"`, play the same project on the same
`VirtualClock` ticks of 1/60 s until the track ends. On every tick they
must give the same status, geometry frame, texture segment and layer. On
every `ok` tick the geometry must match (`.drc`: faces, values and corner
maps exactly; `.uvtg`: faces and counts exactly, floats within the port's
stated geometry decode tolerance, 4 float32 ulps of the largest
magnitude, as tests/test_torch_sequence.py) and so must the texture: its
format, and the ETC1 words or the RGB layers exactly. With
`async_prefetch=True` the decoders run on prefetch threads; the tests wait
for the pools after each tick, so the async run's ticks and frames must
equal the sync run's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu.interfaces import PlayMode as JPlayMode
from uvol_tpu.player import v2 as jv2
from uvol_tpu.player.clock import PlaybackClock as JClock
from uvol_tpu.player.clock import VirtualClock as JVirtual
from uvol_tpu.player.facade import Player as JPlayer
from uvol_tpu_torch import encoder_cli as tcli
from uvol_tpu_torch.codecs.basis import etc1s_encode as tenc
from uvol_tpu_torch.interfaces import PlayMode
from uvol_tpu_torch.player import PlaybackClock, Player, V2Player, VirtualClock
from uvol_tpu_torch.player import v2 as tv2

FIXTURES = Path(__file__).resolve().parent / "fixtures"
#: project name -> config overrides
PROJECTS = {
    "draco_etc1s": {},
    "uvtg_etc": {"GEOMETRY_CODEC": "uvtg", "TEXTURE_CODEC": "etc"},
    "multi_target": {"TEXTURE_CODEC": "etc1s,etc"},
    # textures at half the geometry's rate: 6 layers span 0.4 s, 6 frames 0.2 s
    "half_rate_texture": {"TEXTURE_FRAME_RATE": 15},
    # UASTC segments: the ETC device's etc2-eac refit (K1's twin on the CPU)
    "uastc": {"TEXTURE_CODEC": "uastc"},
}


def _make_project(root: Path, over: dict) -> str:
    """6 frames of a 5 x 4 grid that moves, 32 x 32 PNGs, 3 layers a segment."""
    (root / "OBJ").mkdir(parents=True)
    (root / "images").mkdir()
    r = np.random.default_rng(5)
    nx, ny = 5, 4
    for f in range(6):
        lines = [f"v {i} {j} {0.1 * f * (i - j)}" for i in range(nx) for j in range(ny)]
        lines += [f"vt {i/(nx-1):.3f} {j/(ny-1):.3f}" for i in range(nx) for j in range(ny)]
        for i in range(nx - 1):
            for j in range(ny - 1):
                a, b, c, d = (i * ny + j + 1, (i + 1) * ny + j + 1, (i + 1) * ny + j + 2,
                              i * ny + j + 2)
                lines += [f"f {a}/{a} {b}/{b} {c}/{c}", f"f {a}/{a} {c}/{c} {d}/{d}"]
        (root / "OBJ" / f"{f:05d}.obj").write_text("\n".join(lines) + "\n")
        img = (r.uniform(0, 1, (32, 32, 3)) * 120 + 60).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"{f:05d}.png")
    cfg = {"name": "proj", "OBJFilesPath": f"{root}/OBJ/[#####].obj",
           "ImagesPath": f"{root}/images/[#####].png", "OutputDirectory": f"{root}/output",
           "KTX2_BATCH_SIZE": 3, "ETC1S_ENDPOINTS": 16, "ETC1S_SELECTORS": 16,
           "ENCODE_WORKERS": 1, **over}
    (root / "config.json").write_text(json.dumps(cfg))
    return str(root / "config.json")


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """name -> manifest path, each encoded by the port's CLI on the CPU."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UVT_PLATFORM", "cpu")
        for name, over in PROJECTS.items():
            root = tmp_path_factory.mktemp(name)
            assert tcli.main([_make_project(root, over)]) == 0
            out[name] = str(root / "output" / "proj.uvol.json")
    return out


def _play(make_player, clock, virtual, mode, path, async_prefetch=False, **kw):
    """Every tick's FrameResult until the track ends (or 120 ticks)."""
    vc = virtual()
    ended = []
    p = make_player(play_mode=mode.single, paths=[path], on_track_end=lambda: ended.append(1),
                    v2_player_kwargs={"clock": clock(now=vc), "async_prefetch": async_prefetch},
                    **kw)
    p.set_track_path()

    def settle():
        if async_prefetch:
            p.v2_instance._geo_pool.wait_idle()
            p.v2_instance._tex_pool.wait_idle()

    settle()
    ticks = []
    for _ in range(120):
        vc.advance(1 / 60)
        ticks.append(p.update())
        settle()
        if ended:
            break
    p.dispose()
    assert ended, "the track never ended"
    return ticks


def _ref_ticks(path, async_prefetch=False):
    return _play(JPlayer, JClock, JVirtual, JPlayMode, path, async_prefetch)


def _port_ticks(path, async_prefetch=False):
    return _play(Player, PlaybackClock, VirtualClock, PlayMode, path, async_prefetch,
                 device="cpu")


def _key(r):
    return (r.status, r.geometry_frame, r.texture_segment, r.texture_layer)


def _assert_geometry_equal(got, want):
    if hasattr(want, "attributes"):  # a DracoMesh
        assert got.num_points == want.num_points
        np.testing.assert_array_equal(got.faces, want.faces)
        assert len(got.attributes) == len(want.attributes)
        for a, b in zip(got.attributes, want.attributes):
            assert (a.attribute_type, a.data_type, a.num_components) == (
                b.attribute_type, b.data_type, b.num_components)
            assert a.values.dtype == b.values.dtype
            np.testing.assert_array_equal(a.values, b.values)
            np.testing.assert_array_equal(a.corner_to_value, b.corner_to_value)
        return
    np.testing.assert_array_equal(got.counts, want.counts)
    for a, b in zip(got.faces, want.faces):
        np.testing.assert_array_equal(a, b)
    for a, b in ((got.positions, want.positions), (got.uvs, want.uvs)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=4 * float(np.finfo(np.float32).eps) * np.abs(b).max())


def _assert_texture_equal(got, want):
    assert got.format == want.format
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("async_prefetch", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("name", list(PROJECTS))
def test_port_player_plays_like_the_reference(projects, name, async_prefetch):
    ref = _ref_ticks(projects[name], async_prefetch)
    got = _port_ticks(projects[name], async_prefetch)
    assert [_key(r) for r in got] == [_key(r) for r in ref]
    ok = [(g, w) for g, w in zip(got, ref) if g.status == "ok"]
    assert len(ok) >= 5
    for g, w in ok:
        _assert_geometry_equal(g.geometry, w.geometry)
        _assert_texture_equal(g.texture, w.texture)
    want_format = {"uvtg_etc": "rgba", "uastc": "etc2-eac"}.get(name, "etc1")
    assert {g.texture.format for g, _ in ok} == {want_format}


@pytest.mark.parametrize("name", ["draco_etc1s", "uvtg_etc"])
def test_async_ticks_equal_sync_ticks(projects, name):
    sync = _port_ticks(projects[name])
    asyn = _port_ticks(projects[name], async_prefetch=True)
    assert [_key(r) for r in asyn] == [_key(r) for r in sync]
    for a, s in zip(asyn, sync):
        if s.status == "ok":
            _assert_geometry_equal(a.geometry, s.geometry)
            _assert_texture_equal(a.texture, s.texture)


def test_layer_index_is_frame_modulo_sequence_size(projects):
    """The array-texture layer is `frame % sequenceSize` of the segment
    `frame // sequenceSize`, and it is the layer the codec decodes."""
    from uvol_tpu_torch.containers.ktx2 import read_ktx2
    from uvol_tpu_torch.models.sequence import TextureSequenceCodec

    path = Path(projects["uvtg_etc"])
    codec = TextureSequenceCodec(device="cpu")
    ticks = [r for r in _port_ticks(str(path)) if r.status == "ok"]
    for r in ticks:
        assert r.texture_segment == r.geometry_frame // 3
        assert r.texture_layer == r.geometry_frame % 3
        seg = path.parent / "texture_etc-tpu_baseColor_default" / f"{r.texture_segment:05d}.ktx2"
        layers = codec.decode_segment(read_ktx2(seg.read_bytes()))
        np.testing.assert_array_equal(np.asarray(r.texture)[r.texture_layer],
                                      layers[r.texture_layer])


def test_v2_player_picks_the_same_texture_target(projects):
    m = json.loads(Path(projects["multi_target"]).read_text())
    from uvol_tpu.interfaces import parse_manifest as jparse
    from uvol_tpu_torch.interfaces import parse_manifest

    tp = V2Player(clock=PlaybackClock(now=VirtualClock()), device="cpu")
    jp = jv2.V2Player(clock=JClock(now=JVirtual()))
    tp.play_track(parse_manifest(m), projects["multi_target"])
    jp.play_track(jparse(m), projects["multi_target"])
    assert (tp.geometry_target, tp.texture_target) == (jp.geometry_target, jp.texture_target)
    assert tp.texture_url(1) == jp.texture_url(1) and tp.geometry_url(5) == jp.geometry_url(5)
    tp.dispose()
    jp.dispose()


# ---- the default decoders -----------------------------------------------------


@pytest.mark.parametrize("fixture", ["video.ktx2", "video_legacy_r3.ktx2"])
def test_default_texture_decoder_on_basis_fixtures(fixture):
    data = (FIXTURES / fixture).read_bytes()
    got = tv2.default_texture_decoder(data, device="cpu")
    want = jv2.default_texture_decoder(data)
    _assert_texture_equal(got, want)
    assert got.format == "etc1" and got.dtype == np.uint32


def test_default_texture_decoder_takes_alpha_to_etc2_eac():
    r = np.random.default_rng(2)
    frames = r.integers(0, 256, (2, 16, 24, 4)).astype(np.uint8)
    blob = tenc.encode_ktx2_etc1s(frames, num_endpoints=8, num_selectors=8, device="cpu")
    got = tv2.default_texture_decoder(blob, device="cpu")
    want = jv2.default_texture_decoder(blob)
    _assert_texture_equal(got, want)
    assert got.format == "etc2-eac" and got.shape == (2, 24, 4)


def test_default_decoders_refuse_what_is_not_ported():
    """A `.drc` frame off the native decoder's path (the standard edge
    coder): the port's player decodes it with the copied Python Draco
    decoder, to the reference's arrays (it was refused before the copy)."""
    data = (FIXTURES / "grid_std.drc").read_bytes()
    _assert_geometry_equal(tv2.default_geometry_decoder(data, device="cpu"),
                           jv2.default_geometry_decoder(data))


_CAPS = ("astc", "bptc", "dxt", "etc2", "etc1", "pvrtc")


def _caching(transcode):
    """`transcode_uastc` computed once per file payload and target: the
    decoders below are called for every capability set, which picks one
    of seven targets."""
    cache = {}

    def call(f, target="rgba", **kw):
        key = (f.level_payload(0), f.header.pixel_width, target)
        if key not in cache:
            try:
                cache[key] = transcode(f, target, **kw)
            except NotImplementedError as e:
                cache[key] = e
        if isinstance(cache[key], NotImplementedError):
            raise cache[key]
        return cache[key]

    return call


@pytest.mark.parametrize("fixture", ["video_uastc.ktx2", "video_uastc_legacy.ktx2",
                                     "alpha_uastc"])
def test_default_texture_decoder_on_uastc_for_every_capability_set(monkeypatch, fixture):
    import itertools

    from uvol_tpu.codecs.basis import uastc as juastc
    from uvol_tpu_torch.codecs.basis import uastc as tuastc

    if fixture == "alpha_uastc":  # alpha content: etc2-eac carries it, pvrtc1 refuses it
        img = np.zeros((2, 16, 16, 4), np.uint8)
        img[..., 1] = np.arange(16)[:, None] * 15
        img[..., 3] = np.arange(16)[None, :] * 16
        data = juastc.encode_uastc_ktx2(img)
    else:
        data = (FIXTURES / fixture).read_bytes()
    monkeypatch.setattr(juastc, "transcode_uastc", _caching(juastc.transcode_uastc))
    monkeypatch.setattr(tuastc, "transcode_uastc", _caching(tuastc.transcode_uastc))
    formats = set()
    for n in range(len(_CAPS) + 1):
        for caps in itertools.combinations(_CAPS, n):
            monkeypatch.setattr(jv2, "DEVICE_TEXTURE_CAPABILITIES", caps)
            monkeypatch.setattr(tv2, "DEVICE_TEXTURE_CAPABILITIES", caps)
            got = tv2.default_texture_decoder(data, device="cpu")
            _assert_texture_equal(got, jv2.default_texture_decoder(data))
            formats.add(got.format)
    assert formats >= {"astc-4x4", "bc7", "etc2-eac", "etc1", "bc1-bc3", "rgba"}
    assert ("pvrtc1" in formats) == (fixture != "alpha_uastc")


def test_default_texture_decoder_refits_uastc_through_k1(monkeypatch):
    """The player's default capabilities take a UASTC segment to etc2-eac,
    whose ETC1 fit is one K1 call for the whole segment."""
    from uvol_tpu_torch.codecs.basis import etc_cuda

    calls = []
    enc = etc_cuda.encode_etc1_images
    monkeypatch.setattr(etc_cuda, "encode_etc1_images",
                        lambda x: calls.append(tuple(x.shape)) or enc(x))
    data = (FIXTURES / "video_uastc.ktx2").read_bytes()
    got = tv2.default_texture_decoder(data, device="cpu")
    assert got.format == "etc2-eac" and got.shape == (3, 64, 4)
    _assert_texture_equal(got, jv2.default_texture_decoder(data))
    assert calls == [(3, 32, 32, 3)]


def test_default_geometry_decoder_on_grid_fixture():
    data = (FIXTURES / "grid.drc").read_bytes()
    _assert_geometry_equal(tv2.default_geometry_decoder(data, device="cpu"),
                           jv2.default_geometry_decoder(data))


def test_v1_manifest_raises(tmp_path):
    """A V1 manifest, once refused by the port, plays as in the reference:
    three Corto frames in a `.drcs` beside it, no `.mp4` (the track plays
    on the clock, untextured), read through the default file fetcher."""
    from uvol_tpu_torch.codecs.corto.encoder import encode_crt
    from uvol_tpu_torch.containers.drcs import DrcsWriter

    w = DrcsWriter(frame_rate=30)
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    for f in range(3):
        w.add_frame(encode_crt(pos + 0.1 * f, faces), vertices=4, faces=2)
    w.save(str(tmp_path / "track.drcs"))
    path = str(tmp_path / "track.manifest")
    runs = []
    for make, clock, virtual, mode in (
            (lambda **kw: Player(device="cpu", **kw), PlaybackClock, VirtualClock, PlayMode),
            (JPlayer, JClock, JVirtual, JPlayMode)):
        vc = virtual()
        p = make(play_mode=mode.single, paths=[path], on_track_end=lambda: None,
                 v1_player_kwargs={"clock": clock(now=vc)})
        p.set_track_path()
        assert not p.is_v2 and p.v1_instance.video is None
        ticks = []
        for _ in range(12):
            r = p.update()
            if r is None:
                break
            geo = r.geometry
            ticks.append((r.status, r.frame, None if geo is None else
                          (geo.faces.tolist(), geo.attributes["position"].tolist())))
            vc.advance(1 / 60)
        runs.append(ticks)
    assert runs[0] == runs[1]
    assert [t[1] for t in runs[0] if t[0] == "ok"][-1] == 2


@pytest.mark.parametrize("make", ["player", "v2_player"])
def test_players_need_the_card_unless_told_the_cpu(monkeypatch, projects, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"player": lambda **kw: Player(play_mode=PlayMode.single,
                                        paths=[projects["draco_etc1s"]], **kw),
          "v2_player": lambda **kw: V2Player(**kw)}[make]
    with pytest.raises(RuntimeError, match="cuda"):
        fn()
    assert fn(device="cpu").device == torch.device("cpu")


def test_codec_cache_is_per_device(projects):
    geo = Path(projects["uvtg_etc"]).parent / "geometry_uvtg" / "00002.uvtg"
    tv2.default_geometry_decoder(geo.read_bytes(), device="cpu")
    keys = [k for k in tv2._CODEC_CACHE if k[0] == "uvtg"]
    assert ("uvtg", "cpu") in keys
    assert tv2._CODEC_CACHE[("uvtg", "cpu")].device == torch.device("cpu")

