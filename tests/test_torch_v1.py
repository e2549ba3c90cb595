"""The port's V1 player (`uvol_tpu_torch.player.v1`, `V1RequestPacer`, the
`.drcs` container and the facade's V1 branch) against the JAX package's,
on the CPU.

A V1 track is a `.drcs` blob of Corto `.crt` frames, its `.manifest`,
and an H.264 `.mp4` texture with a baked frame counter. The port's
writers must give the reference's bytes, and the port's facade `Player`
and the reference's must play the same track on the same `VirtualClock`
ticks with the same statuses, frames and geometry arrays, with the video
(frames read from its baked counters) and without it (frames from the
clock). Geometry is a small grid that moves, its heights drawn from a
seed.
"""

import json

import numpy as np
import pytest

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu.codecs.corto import encoder as jcorto_enc
from uvol_tpu.containers import drcs as jdrcs
from uvol_tpu.interfaces import PlayMode as JPlayMode
from uvol_tpu.player import scheduler as jsched
from uvol_tpu.player import v1 as jv1
from uvol_tpu.player.clock import PlaybackClock as JClock
from uvol_tpu.player.clock import VirtualClock as JVirtual
from uvol_tpu.player.facade import Player as JPlayer
from uvol_tpu_torch.codecs.corto import encoder as tcorto_enc
from uvol_tpu_torch.containers import drcs as tdrcs
from uvol_tpu_torch.interfaces import PlayMode
from uvol_tpu_torch.io.video import encode_v1_texture_video
from uvol_tpu_torch.player import Player, scheduler as tsched
from uvol_tpu_torch.player import v1 as tv1
from uvol_tpu_torch.player.clock import PlaybackClock, VirtualClock

N_FRAMES, FPS = 9, 30.0


def _grid_frames(n=N_FRAMES, nx=6, ny=5):
    r = np.random.default_rng(11)
    xx, yy = np.mgrid[0:nx, 0:ny].astype(np.float32)
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a, b, c, d = i * ny + j, (i + 1) * ny + j, (i + 1) * ny + j + 1, i * ny + j + 1
            faces += [[a, b, c], [a, c, d]]
    uv = np.stack([xx.ravel() / nx, yy.ravel() / ny], -1).astype(np.float32)
    out = []
    for f in range(n):
        z = np.sin(xx.ravel() * 0.7 + 0.2 * f) + r.normal(size=nx * ny) * 0.01
        pos = np.stack([xx.ravel(), yy.ravel(), z], -1).astype(np.float32)
        out.append((pos, np.asarray(faces, np.int32), uv))
    return out


def _drcs(enc, drcs_mod, frames, keyframe_every=None):
    w = drcs_mod.DrcsWriter(frame_rate=FPS)
    for i, (pos, faces, uv) in enumerate(frames):
        w.add_frame(enc.encode_crt(pos, faces, uvs=uv), vertices=len(pos), faces=len(faces),
                    is_keyframe=keyframe_every is None or i % keyframe_every == 0)
    return w


@pytest.mark.parametrize("keyframe_every", [None, 4])
def test_drcs_writer_bytes_and_manifest_match(tmp_path, keyframe_every):
    frames = _grid_frames()
    t = _drcs(tcorto_enc, tdrcs, frames, keyframe_every)
    j = _drcs(jcorto_enc, jdrcs, frames, keyframe_every)
    assert t.getvalue() == j.getvalue()
    assert t.manifest.to_json() == j.manifest.to_json()
    t.save(str(tmp_path / "port.drcs"))
    j.save(str(tmp_path / "ref.drcs"))
    for ext in (".drcs", ".manifest"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"ref{ext}").read_bytes()
    with tdrcs.DrcsReader.open(str(tmp_path / "port.drcs")) as tr, \
            jdrcs.DrcsReader.open(str(tmp_path / "ref.drcs")) as jr:
        assert tr.byte_range(2, 6) == jr.byte_range(2, 6)
        assert tr.read_frames(2, 6) == jr.read_frames(2, 6)
        assert [tr.read_frame(i) for i in range(N_FRAMES)] == \
            [jr.read_frame(i) for i in range(N_FRAMES)]


def test_request_pacer_matches():
    """The same ranges, refusals and start gates on one sequence of calls."""
    log = []
    for mod in (tsched, jsched):
        p = mod.V1RequestPacer(target_frames_to_request=90, frame_count=500)
        steps = []
        for buffered in (0, 0, 0, 0, 100, 300, 460, 0, 0, 0, 0, 0):
            steps.append((p.next_range(buffered), p.can_start_playback(buffered)))
            if len(steps) % 2 == 0:
                p.on_response()
        log.append(steps)
    assert log[0] == log[1]


@pytest.mark.parametrize("frame", [0, 1, 255, 65533])
def test_baked_counter_matches(frame):
    img = np.random.default_rng(frame).integers(0, 256, (32, 128, 3)).astype(np.uint8)
    baked = tv1.bake_frame_number(img, frame)
    np.testing.assert_array_equal(baked, jv1.bake_frame_number(img, frame))
    assert tv1.decode_baked_frame_number(baked) == jv1.decode_baked_frame_number(baked) == frame


def _track(with_video: bool) -> dict:
    w = _drcs(tcorto_enc, tdrcs, _grid_frames())
    files = {"/t/track.manifest": json.dumps(w.manifest.to_json()).encode(),
             "/t/track.drcs": w.getvalue()}
    if with_video:
        tex = [np.full((64, 128, 3), 40 * (i % 5), np.uint8) for i in range(N_FRAMES)]
        files["/t/track.mp4"] = encode_v1_texture_video(tex, fps=FPS, codec="h264", qp=28,
                                                        gop=4)
    return files


def _play(make_player, clock_cls, virtual_cls, files, ticks):
    """(status, frame, geometry) of each tick, and the number of track ends."""
    vc = virtual_cls()
    ends = []
    p = make_player(paths=["/t/track.manifest"], fetcher=lambda u: files[u],
                    play_mode=PlayMode.single if make_player is Player else JPlayMode.single,
                    on_track_end=lambda: ends.append(1),
                    v1_player_kwargs={"clock": clock_cls(now=vc)})
    p.set_track_path()
    assert not p.is_v2
    out = []
    for _ in range(ticks):
        r = p.update()
        if r is None:
            break
        out.append((r.status, r.frame, r.geometry))
        vc.advance(1 / 60)
    has_video = p.v1_instance.video is not None if p.manifest is not None else None
    p.dispose()
    return out, len(ends), has_video


def _same_geometry(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.nvert, a.nface, a.exif) == (b.nvert, b.nface, b.exif)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert set(a.attributes) == set(b.attributes)
    for k, v in a.attributes.items():
        assert v.dtype == b.attributes[k].dtype, k
        np.testing.assert_array_equal(v, b.attributes[k], err_msg=k)


@pytest.mark.parametrize("with_video", [True, False])
def test_facade_plays_a_v1_track_as_the_reference(with_video):
    files = _track(with_video)
    port = _play(lambda **kw: Player(device="cpu", **kw), PlaybackClock, VirtualClock, files,
                 ticks=40)
    ref = _play(JPlayer, JClock, JVirtual, files, ticks=40)
    (pt, pends, pvideo), (rt, rends, rvideo) = port, ref
    assert pends == rends == 1 and pvideo == rvideo
    assert [s[:2] for s in pt] == [s[:2] for s in rt]
    shown = [f for s, f, _ in pt if s == "ok"]
    assert sorted(set(shown)) == list(range(N_FRAMES))  # every frame shows
    for (_, _, a), (_, _, b) in zip(pt, rt):
        _same_geometry(a, b)


def test_facade_reads_the_baked_counter_of_each_frame():
    """With the video, each shown frame is the one its texture's counter
    names, and its geometry is `decode_crt` of its own `.crt`."""
    from uvol_tpu_torch.codecs.corto.decoder import decode_crt
    from uvol_tpu_torch.containers.drcs import DrcsReader
    from uvol_tpu_torch.interfaces import parse_manifest

    files = _track(True)
    vc = VirtualClock()
    counters = []
    p = Player(paths=["/t/track.manifest"], fetcher=lambda u: files[u],
               play_mode=PlayMode.single, on_track_end=lambda: None, device="cpu",
               v1_player_kwargs={"clock": PlaybackClock(now=vc)})
    p.set_track_path()
    reader = DrcsReader(parse_manifest(files["/t/track.manifest"]), files["/t/track.drcs"])
    for _ in range(40):
        if p.manifest is None:
            break
        video = p.v1_instance.video
        r = p.update()
        if r.status == "ok":
            counters.append(video.read_baked_frame_number())
            assert counters[-1] == r.frame
            _same_geometry(r.geometry, decode_crt(reader.read_frame(r.frame)))
        vc.advance(1 / 60)
    assert sorted(set(counters)) == list(range(N_FRAMES))


@pytest.mark.parametrize("async_prefetch", [False, True])
def test_v1_player_matches_the_reference(async_prefetch):
    """`V1Player` alone, ranges of 4 frames, synchronous or on a pool
    (`async_prefetch=True`, drained after each tick): the reference's
    ticks and geometry."""
    from uvol_tpu.codecs.corto.decoder import decode_crt as jdecode
    from uvol_tpu.interfaces import parse_manifest as jparse
    from uvol_tpu_torch.codecs.corto.decoder import decode_crt
    from uvol_tpu_torch.interfaces import parse_manifest

    files = _track(False)
    runs = []
    for mod, dec, parse, clock_cls, virtual_cls in (
            (tv1, decode_crt, parse_manifest, PlaybackClock, VirtualClock),
            (jv1, jdecode, jparse, JClock, JVirtual)):
        vc = virtual_cls()
        p = mod.V1Player(range_fetcher=lambda u, a, b: files[u][a:b], geometry_decoder=dec,
                         clock=clock_cls(now=vc), target_frames_to_request=4,
                         async_prefetch=async_prefetch)
        p.play_track(parse(files["/t/track.manifest"]), 4, "/t/track.manifest")
        ticks = []
        for _ in range(60):
            r = p.update()
            if p._pool is not None:
                p._pool.wait_idle(timeout=10)
            ticks.append((r.status, r.frame, r.geometry))
            if r.status == "ended":
                break
            vc.advance(1 / 60)
        if p._pool is not None:
            p._pool.close()
        runs.append(ticks)
    assert [t[:2] for t in runs[0]] == [t[:2] for t in runs[1]]
    assert runs[0][-1][0] == "ended" and sum(t[0] == "ok" for t in runs[0]) >= N_FRAMES
    for a, b in zip(runs[0], runs[1]):
        _same_geometry(a[2], b[2])
