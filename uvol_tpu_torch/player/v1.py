"""Headless UVOL 1.0 player.

Behavioral port of src/V1/player.ts + src/V1/worker.ts: the worker's
byte-range fetch over the `.drcs` blob and per-frame Corto decode become a
synchronous (or caller-driven) decode service; request pacing keeps ≤3
ranges in flight with `targetFramesToRequest`-sized windows
(src/V1/player.ts:206-246); the MP4 texture sync is modeled by either an
injected video clock (`requestVideoFrameCallback` analog) or the baked
binary frame counter decoded from frame pixels
(`drawVideoAndGetCurrentFrameNumber`, :305-334).

The port's copy of `uvol_tpu/player/v1.py`. A V1 track is host work
only (Corto decode, H.264 decode): it has no device stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from uvol_tpu_torch.interfaces import V1Schema
from uvol_tpu_torch.player.clock import PlaybackClock
from uvol_tpu_torch.player.scheduler import V1RequestPacer


def decode_baked_frame_number(
    frame_rgb: np.ndarray, *, encoder_window_size: int = 8, encoder_byte_length: int = 16
) -> int:
    """Read the binary frame counter baked into the bottom-left pixel rows.

    Exact behavior of the player's canvas read-back
    (src/V1/player.ts:305-334): the strip x ∈ [0, windowSize·byteLength),
    y ∈ [H − windowSize/2, H) is downsampled to byteLength×1; bit i =
    round(red/255) of block i with weight 2^i (LSB first); the result is
    `max(value − 1, 0)`.
    """
    h = frame_rgb.shape[0]
    strip_h = max(encoder_window_size // 2, 1)
    strip = frame_rgb[h - strip_h :, : encoder_window_size * encoder_byte_length, 0]
    value = 0
    for i in range(encoder_byte_length):
        block = strip[:, i * encoder_window_size : (i + 1) * encoder_window_size]
        bit = int(round(float(block.mean()) / 255.0))
        value += bit * (1 << i)
    return max(value - 1, 0)


def bake_frame_number(
    frame_rgb: np.ndarray,
    frame_number: int,
    *,
    encoder_window_size: int = 8,
    encoder_byte_length: int = 16,
) -> np.ndarray:
    """Bake `frame_number` so `decode_baked_frame_number` reads it back.

    Capability match for example/texture_encoder.py (whose own coordinate
    math is broken relative to the player; we write what the player reads:
    LSB-first blocks at the bottom-left, stored value = frame+1)."""
    out = frame_rgb.copy()
    h = out.shape[0]
    strip_h = max(encoder_window_size // 2, 1)
    stored = frame_number + 1
    for i in range(encoder_byte_length):
        bit = (stored >> i) & 1
        out[
            h - strip_h :, i * encoder_window_size : (i + 1) * encoder_window_size
        ] = (255 if bit else 0)
    return out


@dataclasses.dataclass
class V1FrameResult:
    status: str  # 'buffering' | 'ended' | 'skipped' | 'ok'
    frame: Optional[int] = None
    geometry: Any = None
    buffering_progress: Optional[float] = None


class V1Player:
    def __init__(
        self,
        *,
        range_fetcher: Callable[[str, int, int], bytes],
        geometry_decoder: Callable[[bytes], Any],
        on_mesh_buffering=None,
        on_frame_show=None,
        on_track_end=None,
        video: Any = None,  # object with .current_time/.ended, or None
        clock: Optional[PlaybackClock] = None,
        target_frames_to_request: int = 90,
        encoder_window_size: int = 8,
        encoder_byte_length: int = 16,
        video_size: int = 1024,
        async_prefetch: bool = False,
    ) -> None:
        self.range_fetcher = range_fetcher
        self.geometry_decoder = geometry_decoder
        self.on_mesh_buffering = on_mesh_buffering
        self.on_frame_show = on_frame_show
        self.on_track_end = on_track_end
        self.video = video
        self.clock = clock or PlaybackClock()
        self.target_frames_to_request = target_frames_to_request
        self.encoder_window_size = encoder_window_size
        self.encoder_byte_length = encoder_byte_length
        self.video_size = video_size

        self.manifest: Optional[V1Schema] = None
        self.drcs_url = ""
        self.mesh_buffer: Dict[int, Any] = {}
        self._pacer: Optional[V1RequestPacer] = None
        self._playing = False
        self._ended = False
        # async mode: the worker's range fetch+decode runs off the tick with
        # the reference's ≤3-in-flight pacing actually constraining real
        # concurrency (src/V1/player.ts:209-227)
        self._pool = None
        if async_prefetch:
            from uvol_tpu_torch.runtime.prefetch import PrefetchPool

            self._pool = PrefetchPool(
                self._fetch_decode_range, workers=3, max_in_flight=3
            )

    def _fetch_decode_range(self, start_f: int, end_f: int):
        fd = self.manifest.frameData
        start_byte = fd[start_f].startBytePosition
        end_byte = fd[end_f].startBytePosition + fd[end_f].meshLength
        blob = self.range_fetcher(self.drcs_url, start_byte, end_byte)
        out: Dict[int, Any] = {}
        for i in range(start_f, end_f + 1):
            o = fd[i].startBytePosition - start_byte
            payload = blob[o : o + fd[i].meshLength]
            try:
                out[i] = self.geometry_decoder(payload)
            except Exception:  # worker posts empty payloads on error
                out[i] = None  # (src/V1/worker.ts:70-73)
        return out

    def play_track(
        self, manifest: V1Schema, target_frames_to_request: int, manifest_path: str
    ) -> None:
        """Derives the .drcs URL from the manifest path like the reference
        (src/V1/player.ts:192,337 replaces 'manifest' with 'drcs')."""
        self.manifest = manifest
        self.target_frames_to_request = target_frames_to_request
        self.drcs_url = manifest_path.replace(".manifest", ".drcs")
        if manifest.frameData and manifest.frameData[-1].frameNumber >= (
            1 << self.encoder_byte_length
        ) - 1:
            import warnings

            warnings.warn(
                "frame count exceeds binary counter capacity "
                f"2^{self.encoder_byte_length}-2 (src/V1/player.ts:338-345)"
            )
        self._pacer = V1RequestPacer(
            target_frames_to_request=self.target_frames_to_request,
            frame_count=len(manifest.frameData),
        )
        self.mesh_buffer.clear()
        self._playing = False
        self._ended = False
        # replay/track-change: generation-scope the pool keys so the
        # dedup cache never refuses this track's ranges and late results
        # from the previous track are dropped, not merged
        self._track_gen = getattr(self, "_track_gen", 0) + 1

    # -- the worker loop (src/V1/player.ts:206-246 + worker) -----------------
    def buffer_loop(self) -> None:
        assert self.manifest is not None and self._pacer is not None
        if self._pool is not None:
            # drain completed ranges, releasing their in-flight slots
            gen = self._track_gen
            for key, (result, err) in self._pool.poll().items():
                if key[0] != gen:
                    continue  # stale: a previous track's range
                if err is None:
                    self.mesh_buffer.update(result)
                self._pacer.on_response()
            while True:
                rng = self._pacer.next_range(len(self.mesh_buffer))
                if rng is None:
                    break
                if not self._pool.request((gen,) + rng, rng[0], rng[1]):
                    self._pacer.on_response()  # refused: release the slot
        else:
            while True:
                rng = self._pacer.next_range(len(self.mesh_buffer))
                if rng is None:
                    break
                start_f, end_f = rng
                self.mesh_buffer.update(
                    self._fetch_decode_range(start_f, end_f)
                )
                self._pacer.on_response()

        if not self._playing and self._pacer.can_start_playback(len(self.mesh_buffer)):
            self._playing = True
            # restart the epoch so a replayed track begins at t=0 (the
            # reference swaps in a fresh <video>; our clock is shared)
            self.clock.start()
            if self.video is not None and hasattr(self.video, "play"):
                self.video.play()

    @property
    def current_time(self) -> float:
        if self.video is not None:
            return self.video.current_time
        return self.clock.current_time

    def current_frame(self, frame_image: Optional[np.ndarray] = None) -> int:
        """Video-synced frame number: from the baked counter when a frame
        image is given, else from the clock (requestVideoFrameCallback
        analog: round(time * frameRate))."""
        if frame_image is not None:
            return decode_baked_frame_number(
                frame_image,
                encoder_window_size=self.encoder_window_size,
                encoder_byte_length=self.encoder_byte_length,
            )
        import math

        return int(math.floor(self.current_time * self.manifest.frameRate + 0.5))

    def update(self, frame_image: Optional[np.ndarray] = None) -> V1FrameResult:
        if self.manifest is None:
            return V1FrameResult("buffering", buffering_progress=0.0)
        self.buffer_loop()
        if not self._playing:
            progress = len(self.mesh_buffer) / (
                3 * self.target_frames_to_request
            )
            if self.on_mesh_buffering:
                self.on_mesh_buffering(min(progress, 1.0))
            return V1FrameResult("buffering", buffering_progress=min(progress, 1.0))
        if self.video is not None and getattr(self.video, "ended", False):
            self._ended = True
            if self.on_track_end:
                self.on_track_end()
            return V1FrameResult("ended")
        frame = None
        if frame_image is None and hasattr(self.video, "read_baked_frame_number"):
            # baked-counter sync (the reference's canvas read-back path:
            # a byteLength×1 downsample, never a full-frame read —
            # player.ts:305-334); the texture converts only the counter
            # strip. Sampled after buffer_loop so a freshly restarted
            # clock is already in effect.
            frame = self.video.read_baked_frame_number(
                encoder_window_size=self.encoder_window_size,
                encoder_byte_length=self.encoder_byte_length,
            )
        elif frame_image is None and hasattr(self.video, "current_frame_rgb"):
            frame_image = self.video.current_frame_rgb()
        if frame is None:
            frame = self.current_frame(frame_image)
        if frame >= len(self.manifest.frameData):
            self._ended = True
            if self.on_track_end:
                self.on_track_end()
            return V1FrameResult("ended")
        if frame not in self.mesh_buffer or self.mesh_buffer[frame] is None:
            return V1FrameResult("skipped", frame=frame)
        if self.on_frame_show:
            self.on_frame_show(frame)
        geometry = self.mesh_buffer[frame]
        self.remove_played_buffer(frame)
        return V1FrameResult("ok", frame=frame, geometry=geometry)

    def remove_played_buffer(self, frame: int) -> None:
        for k in [k for k in self.mesh_buffer if k < frame]:
            del self.mesh_buffer[k]

    def dispose(self) -> None:
        self.mesh_buffer.clear()
