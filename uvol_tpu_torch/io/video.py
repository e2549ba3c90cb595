"""UVOL 1.0 video texture: MJPEG-MP4 encode + decode with the baked
binary frame counter.

Capability match for the reference's V1 texture pipeline:
  - `example/texture_encoder.py` bakes a 16-bit frame index as 8x8
    black/white blocks into the bottom rows of each frame, then ffmpeg
    packs H.264 MP4 (deprecated/README.md:63).
  - `src/V1/player.ts:305-334` reads the counter back from canvas pixels
    when `requestVideoFrameCallback` is unavailable.

Two sample codecs:
  - ``codec="jpeg"`` (default): Motion-JPEG samples — compact, lossy.
  - ``codec="h264"``: REAL compressed H.264/AVC (codecs/h264_intra.py —
    I_4x4 intra + CAVLC at ``qp`` (default 26), with the counter strip
    forced to lossless I_PCM macroblocks so readback stays bit-exact;
    ``gop=N`` adds zero-motion P slices between IDRs (P_Skip for
    unchanged macroblocks — near-free on static texture regions, the
    inter form the reference's MP4 actually uses); ``qp=None`` selects
    the all-I_PCM lossless/raw-rate form).
The counter blocks are 8x8-aligned, which keeps them intact under both
JPEG's DCT and 4:2:0 subsampling.

The port's copy of `uvol_tpu/io/video.py`, with one change: Pillow is
asked for only where it is used (a JPEG sample written or read, or a
frame resized to `video_size`), not on every encode. An H.264 texture at
its own size therefore encodes without Pillow, with the same bytes.
"""

from __future__ import annotations

import io as _io
from typing import List, Optional, Sequence

import numpy as np

from uvol_tpu_torch.containers.mp4 import Mp4VideoTrack, read_mp4_video, write_mp4_video
from uvol_tpu_torch.player.v1 import bake_frame_number, decode_baked_frame_number


def _require_pil():
    try:
        from PIL import Image  # noqa: F401

        return Image
    except Exception as e:  # pragma: no cover
        raise RuntimeError("JPEG video texture requires Pillow") from e


def encode_v1_texture_video(
    frames_rgb: Sequence[np.ndarray],
    *,
    fps: float = 30.0,
    video_size: Optional[int] = None,
    encoder_window_size: int = 8,
    encoder_byte_length: int = 16,
    quality: int = 92,
    codec: str = "jpeg",
    qp: Optional[int] = 26,
    gop: Optional[int] = None,
    entropy: str = "cavlc",
) -> bytes:
    """Bake per-frame counters and pack an MJPEG or H.264 MP4 (V1 texture
    stream).

    Mirrors example/texture_encoder.py's output contract: frame i carries
    stored value i+1 in its bottom-row counter strip. Warns (like
    src/V1/player.ts:338-345) when the frame count exceeds counter capacity.
    """
    n = len(frames_rgb)
    capacity = (1 << encoder_byte_length) - 2
    if n > capacity:
        raise ValueError(
            f"{n} frames exceed counter capacity {capacity} "
            f"(2^{encoder_byte_length}-2)"
        )
    baked: List[np.ndarray] = []
    width = height = None
    for i, frame in enumerate(frames_rgb):
        img = np.asarray(frame, np.uint8)
        if video_size is not None and img.shape[:2] != (video_size, video_size):
            Image = _require_pil()
            img = np.asarray(
                Image.fromarray(img).resize(
                    (video_size, video_size), Image.BILINEAR
                ),
                np.uint8,
            )
        img = bake_frame_number(
            img,
            i,
            encoder_window_size=encoder_window_size,
            encoder_byte_length=encoder_byte_length,
        )
        height, width = img.shape[:2]
        baked.append(img)
    if codec == "h264":
        from uvol_tpu_torch.codecs import h264

        # qp set (default): real intra compression with the counter strip
        # forced to I_PCM macroblocks (bit-exact readback); qp=None keeps
        # the all-I_PCM lossless form
        # gop=N adds zero-motion P slices between IDRs (the reference's
        # MP4 is inter video) — unchanged counter-strip MBs skip only
        # when BIT-EXACT, so readback stays exact in every frame
        strip = max(encoder_window_size // 2, 1) if qp is not None else 0
        samples = h264.encode_avc_samples(
            np.stack(baked), qp=qp, pcm_rows=strip, gop=gop,
            entropy=entropy,
        )
        syncs = [i for i, s in enumerate(samples) if h264.sample_is_sync(s)]
        return write_mp4_video(
            samples,
            width=width,
            height=height,
            fps=fps,
            codec=b"avc1",
            avcc=h264.make_avcc(width, height, cabac=(entropy == "cabac")),
            sync_samples=syncs,
        )
    if codec != "jpeg":
        raise ValueError(f"unknown V1 texture codec {codec!r}")
    Image = _require_pil()
    samples: List[bytes] = []
    for img in baked:
        buf = _io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality)
        samples.append(buf.getvalue())
    return write_mp4_video(samples, width=width, height=height, fps=fps)


class Mp4VideoTexture:
    """Headless stand-in for the V1 player's <video> element.

    Exposes the reference sync surface: `current_time` / `ended` (the
    MediaPlayer clock consumed at src/V1/player.ts:120-132 and
    deprecated/android Actor.java:60-62) plus pixel read-back for the
    baked-counter path. Decoded frames are LRU-cached — playback touches
    each frame once, in order.
    """

    def __init__(self, mp4_bytes: bytes, *, cache_frames: int = 8, clock=None):
        self.track: Mp4VideoTrack = read_mp4_video(mp4_bytes)
        self._sps = None
        self._pps = None
        codec = self.track.codec.strip()
        if codec == "avc1":
            from uvol_tpu_torch.codecs import h264

            self._sps = h264.parse_avcc(self.track.avcc)
            self._pps = h264.parse_avcc_pps(self.track.avcc)
        elif codec != "jpeg":
            raise NotImplementedError(
                f"cannot pixel-decode codec {self.track.codec!r} "
                "(only 'jpeg'/'avc1' samples; container parse succeeded)"
            )
        self._cache: dict = {}
        self._cache_frames = cache_frames
        self._sync = None  # per-sample IDR flags (built lazily)
        self._recon = None  # decode chain state for P samples
        self._recon_index = -2
        self._clock = clock  # PlaybackClock: video time follows it when set
        self._time = 0.0
        self.playing = False

    # -- clock surface (duck-typed for V1Player.video) -----------------------
    @property
    def current_time(self) -> float:
        if self._clock is not None:
            return min(self._clock.current_time, self.track.duration)
        return self._time

    @current_time.setter
    def current_time(self, t: float) -> None:
        if self._clock is not None:
            # clock-driven time: a seek to 0 restarts the epoch (track
            # replay); other seeks are unsupported rather than silent
            if t == 0.0:
                self._clock.start()
                return
            raise NotImplementedError(
                "seek on a clock-driven video (only rewind-to-0 supported)"
            )
        self._time = t

    @property
    def duration(self) -> float:
        return self.track.duration

    @property
    def ended(self) -> bool:
        return self.current_time >= self.track.duration - 1e-9

    def play(self) -> None:
        self.playing = True
        if self._clock is not None:
            self._clock.play()

    def pause(self) -> None:
        self.playing = False
        if self._clock is not None:
            self._clock.pause()

    def advance(self, dt: float) -> None:
        if self.playing and self._clock is None:
            self._time = min(self._time + dt, self.track.duration)

    # -- pixels ---------------------------------------------------------------
    def _decode_avc_planes(self, i: int):
        """Decode sample i to YUV planes, walking forward from the nearest
        sync sample when the track holds P samples (recon chain cached)."""
        from uvol_tpu_torch.codecs import h264

        if self._sync is None:
            if self.track.sync_samples is not None:
                syncset = set(self.track.sync_samples)
                self._sync = [
                    i in syncset for i in range(len(self.track.samples))
                ]
            else:  # no stss box: inspect the NAL types directly
                self._sync = [
                    h264.sample_is_sync(s) for s in self.track.samples
                ]
        if self._recon_index == i and self._recon is not None:
            return self._recon  # repeated reads of the playing frame
        if self._recon_index != i - 1 or self._recon is None:
            if self._sync[i]:
                start = i
            else:
                start = max(
                    (j for j in range(i + 1) if self._sync[j]), default=0
                )
            if (
                self._recon is not None
                and start <= self._recon_index < i
            ):
                # the cached chain already covers the prefix — continue
                start = self._recon_index + 1
            else:
                self._recon = None
                self._recon_index = start - 1
            for j in range(start, i):
                self._recon = h264.decode_avc_sample_planes(
                    self.track.samples[j], self._sps, prev=self._recon,
                    pps=self._pps,
                )
                self._recon_index = j
        self._recon = h264.decode_avc_sample_planes(
            self.track.samples[i], self._sps, prev=self._recon,
            pps=self._pps,
        )
        self._recon_index = i
        return self._recon

    def _decode_avc_frame(self, i: int) -> np.ndarray:
        y, cb, cr = self._decode_avc_planes(i)
        from uvol_tpu_torch.codecs import h264

        return h264.yuv420_to_rgb(y, cb, cr)[
            : self._sps.height, : self._sps.width
        ]

    def frame_rgb(self, i: int) -> np.ndarray:
        if i in self._cache:
            return self._cache[i]
        if self._sps is not None:  # avc1
            img = self._decode_avc_frame(i)
        else:
            Image = _require_pil()
            img = np.asarray(
                Image.open(_io.BytesIO(self.track.samples[i])).convert("RGB"),
                np.uint8,
            )
        if len(self._cache) >= self._cache_frames:
            self._cache.pop(next(iter(self._cache)))
        self._cache[i] = img
        return img

    def current_frame_rgb(self) -> np.ndarray:
        return self.frame_rgb(self.track.frame_at(self.current_time))

    def read_baked_frame_number(
        self, *, encoder_window_size: int = 8, encoder_byte_length: int = 16
    ) -> int:
        """The drawVideoAndGetCurrentFrameNumber path (player.ts:305-334).

        avc1 fast path: the reference reads a byteLength×1 canvas
        downsample, never the full frame — mirror that by converting
        ONLY the counter strip to RGB (the strip is row/column-aligned
        to the 2×2 chroma grid whenever the strip height and width are
        even, so nearest-upsampled chroma is local: strip conversion is
        value-exact vs full-frame yuv420_to_rgb). Saves the ~7 ms/frame
        full-frame color convert at 1024² on the counter-sync path."""
        i = self.track.frame_at(self.current_time)
        strip_h = max(encoder_window_size // 2, 1)
        strip_w = encoder_window_size * encoder_byte_length
        if (
            self._sps is not None
            and i not in self._cache
            and self._sps.height % 2 == 0
            and strip_h % 2 == 0
            and strip_w % 2 == 0
            and strip_w <= self._sps.width
        ):
            from uvol_tpu_torch.codecs import h264

            y, cb, cr = self._decode_avc_planes(i)
            h = self._sps.height
            strip = h264.yuv420_to_rgb(
                np.ascontiguousarray(y[h - strip_h : h, :strip_w]),
                np.ascontiguousarray(
                    cb[(h - strip_h) // 2 : h // 2, : strip_w // 2]
                ),
                np.ascontiguousarray(
                    cr[(h - strip_h) // 2 : h // 2, : strip_w // 2]
                ),
            )
            return decode_baked_frame_number(
                strip,
                encoder_window_size=encoder_window_size,
                encoder_byte_length=encoder_byte_length,
            )
        return decode_baked_frame_number(
            self.current_frame_rgb(),
            encoder_window_size=encoder_window_size,
            encoder_byte_length=encoder_byte_length,
        )
