"""The port's V1 texture track (`uvol_tpu_torch.io.video`, the H.264 stack
`codecs/h264*.py`, `native/h264c.py` and `containers/mp4.py`) against the
JAX package's, on the CPU.

`encode_v1_texture_video` must write the reference's MP4 bytes (H.264
with CAVLC and CABAC, all-intra and with P slices, and Motion-JPEG), and
`Mp4VideoTexture` must decode the reference's RGB frame for frame and
read back the same baked counters, on the native library and on the
Python path (`UVT_DISABLE_NATIVE_H264=1` for the port; the reference's
loader made to report no library). The H.264 encode needs no Pillow.
Frames are a moving gradient with seeded noise.
"""

import sys

import numpy as np
import pytest

import torch_cpu_share  # noqa: F401  (each xdist worker's share of the cores)
from uvol_tpu.containers import mp4 as jmp4
from uvol_tpu.io import video as jvideo
from uvol_tpu.native import h264c as jh264c
from uvol_tpu.player.clock import PlaybackClock as JClock
from uvol_tpu.player.clock import VirtualClock as JVirtual
from uvol_tpu_torch import native as tnative
from uvol_tpu_torch.containers import mp4 as tmp4
from uvol_tpu_torch.io import video as tvideo
from uvol_tpu_torch.native import h264c as th264c
from uvol_tpu_torch.player.clock import PlaybackClock, VirtualClock


def _frames(n: int, size: int, seed: int = 0, width=None):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:width or size]
    out = []
    for i in range(n):
        f = np.stack([(xx * 2 + i * 5) % 256, (yy * 3 + i) % 256, (xx + yy + i * 9) % 256], -1)
        out.append(np.clip(f + r.integers(-8, 9, f.shape), 0, 255).astype(np.uint8))
    return out


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setenv("UVT_DISABLE_NATIVE_H264", "1")
        monkeypatch.setattr(jh264c, "get_h264_lib", lambda: None)
        assert th264c.get_h264_lib() is None
    else:
        assert th264c.get_h264_lib() is not None  # g++ builds the port's library
    return request.param


H264_CASES = [(64, "cavlc", None, 28), (64, "cabac", 3, 28), (96, "cavlc", 3, 26),
              (96, "cabac", None, 30), (128, "cavlc", 3, 28), (128, "cabac", 3, 28),
              (64, "cavlc", 2, None)]


@pytest.mark.parametrize("size,entropy,gop,qp", H264_CASES)
def test_h264_texture_bytes_match(size, entropy, gop, qp):
    frames = _frames(5, size)
    kw = dict(codec="h264", entropy=entropy, gop=gop, qp=qp, fps=30.0)
    blob = tvideo.encode_v1_texture_video(frames, **kw)
    assert blob == jvideo.encode_v1_texture_video(frames, **kw)


def test_h264_python_encode_matches_the_reference(path):
    """The Python slice coders write what the native library writes."""
    frames = _frames(3, 64, seed=1)
    kw = dict(codec="h264", gop=2, qp=28)
    assert tvideo.encode_v1_texture_video(frames, **kw) == \
        jvideo.encode_v1_texture_video(frames, **kw)


@pytest.mark.parametrize("size", [(64, None), (48, 64)])
def test_jpeg_texture_bytes_match(size):
    """Motion-JPEG samples, also resized to `video_size` (Pillow)."""
    frames = _frames(4, size[0])
    kw = dict(video_size=size[1], quality=85, fps=24.0)
    blob = tvideo.encode_v1_texture_video(frames, **kw)
    assert blob == jvideo.encode_v1_texture_video(frames, **kw)


def test_h264_encode_needs_no_pillow(monkeypatch):
    """With Pillow refused the H.264 encode writes the reference's bytes;
    the JPEG path and a resize ask for it and raise."""
    frames = _frames(3, 64, seed=2)
    want = jvideo.encode_v1_texture_video(frames, codec="h264", gop=3, qp=28)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    assert tvideo.encode_v1_texture_video(frames, codec="h264", gop=3, qp=28) == want
    with pytest.raises(RuntimeError, match="Pillow"):
        tvideo.encode_v1_texture_video(frames)
    with pytest.raises(RuntimeError, match="Pillow"):
        tvideo.encode_v1_texture_video(frames, codec="h264", video_size=32)


@pytest.mark.parametrize("entropy,gop", [("cavlc", 3), ("cabac", 3), ("cavlc", None)])
def test_mp4_texture_decodes_like_the_reference(path, entropy, gop):
    """Every frame's RGB and baked counter, read in order and again out of
    order (the decode walks forward from the last sync sample). 64 x 128
    pixels: the counter strip is 8 x 16 = 128 pixels long."""
    n = 5
    blob = jvideo.encode_v1_texture_video(_frames(n, 64, seed=3, width=128), codec="h264",
                                          entropy=entropy, gop=gop, qp=28)
    t, j = tvideo.Mp4VideoTexture(blob), jvideo.Mp4VideoTexture(blob)
    assert t.duration == j.duration and t.track.sync_samples == j.track.sync_samples
    for i in list(range(n)) + [4, 1]:
        a, b = t.frame_rgb(i), j.frame_rgb(i)
        assert a.dtype == b.dtype == np.uint8 and a.shape == (64, 128, 3)
        np.testing.assert_array_equal(a, b)
    vt, vj = VirtualClock(), JVirtual()
    t = tvideo.Mp4VideoTexture(blob, clock=PlaybackClock(now=vt))
    j = jvideo.Mp4VideoTexture(blob, clock=JClock(now=vj))
    t.play(), j.play()
    counters = []
    for _ in range(n):
        counters.append(t.read_baked_frame_number())
        assert counters[-1] == j.read_baked_frame_number()
        vt.advance(1 / 30), vj.advance(1 / 30)
    assert counters == list(range(n))


def test_jpeg_texture_decodes_like_the_reference():
    blob = jvideo.encode_v1_texture_video(_frames(3, 64, seed=4))
    t, j = tvideo.Mp4VideoTexture(blob), jvideo.Mp4VideoTexture(blob)
    for i in range(3):
        np.testing.assert_array_equal(t.frame_rgb(i), j.frame_rgb(i))


def test_mp4_container_matches():
    """The container alone: `write_mp4_video` bytes and what
    `read_mp4_video` finds in them."""
    samples = [bytes([i]) * (100 + 7 * i) for i in range(9)]
    kw = dict(width=32, height=16, fps=25.0, sync_samples=[0, 4, 8])
    blob = tmp4.write_mp4_video(samples, **kw)
    assert blob == jmp4.write_mp4_video(samples, **kw)
    t, j = tmp4.read_mp4_video(blob), jmp4.read_mp4_video(blob)
    for name in ("samples", "codec", "width", "height", "timescale", "sample_deltas", "avcc",
                 "duration", "sync_samples"):
        assert getattr(t, name) == getattr(j, name), name
    assert [t.frame_at(x) for x in (0.0, 0.1, 0.35, 9.0)] == \
        [j.frame_at(x) for x in (0.0, 0.1, 0.35, 9.0)]


def test_h264_library_is_built_by_the_port(monkeypatch):
    """A fourth library under build/, named after the source and the table
    file it includes; the switch turns it off on every call."""
    so = tnative.library_path(tnative.H264_SOURCES, "h264", headers=tnative.H264_HEADERS)
    assert so.name.startswith("libuvol_tpu_torch_h264_")
    assert so != tnative.library_path(tnative.H264_SOURCES, "h264")
    assert th264c.get_h264_lib() is not None and so.exists()
    monkeypatch.setenv("UVT_DISABLE_NATIVE_H264", "1")
    assert th264c.get_h264_lib() is None
    monkeypatch.delenv("UVT_DISABLE_NATIVE_H264")
    assert th264c.get_h264_lib() is not None
