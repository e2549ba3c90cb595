"""Dual-rate streaming scheduler — pure index arithmetic.

Extracted verbatim-in-behavior from the reference's V2 player
(src/V2/player.ts): `getCurrentFrame` (:43-45), the leaky-bucket prefetch
window computation (`fetchBuffers`, :272-323), and the eviction margins
(`update`, :533-546). Keeping this pure makes it trivially testable against
a virtual clock and usable from both the host player and device pipelines.

The port's copy of `uvol_tpu/player/scheduler.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple


def get_current_frame(frame_rate: float, current_time: float) -> int:
    """round(frameRate * t) — src/V2/player.ts:43-45 (JS Math.round)."""
    x = frame_rate * current_time
    # JS Math.round: half-up (toward +inf)
    return int(math.floor(x + 0.5))


@dataclasses.dataclass
class PrefetchState:
    """Monotonic request cursors (src/V2/player.ts:237-238)."""

    last_requested_geometry_frame: int = -1
    last_requested_texture_segment: int = -1


@dataclasses.dataclass
class PrefetchPlan:
    geometry_frames: List[int]
    texture_segments: List[int]


def plan_prefetch(
    state: PrefetchState,
    *,
    current_time: float,
    geometry_frame_rate: float,
    geometry_frame_count: int,
    texture_frame_rate: float,
    texture_sequence_size: int,
    texture_sequence_count: int,
    buffer_duration: float,
) -> PrefetchPlan:
    """Leaky-bucket window extension (src/V2/player.ts:272-316).

    Mirrors the reference's loop: for i in 0..bufferDuration, extend the
    geometry request window by `frameRate` frames and the texture window by
    ceil(frameRate / sequenceSize) segments, clamped to the track end;
    cursors only move forward.
    """
    geometry_frames: List[int] = []
    texture_segments: List[int] = []

    geometry_buffer_size = geometry_frame_rate  # frames per second of buffer
    current_geometry_frame = get_current_frame(geometry_frame_rate, current_time)
    texture_buffer_size = math.ceil(texture_frame_rate / texture_sequence_size)
    current_texture_frame = get_current_frame(texture_frame_rate, current_time)
    current_texture_segment = current_texture_frame // texture_sequence_size

    # the reference's `for (i = 0; i < bufferDuration; i++)` ceils
    # fractional durations (JS compares the float); int() would truncate
    # and a duration < 1 would disable prefetch entirely
    for i in range(math.ceil(buffer_duration)):
        geometry_request_end = min(
            int(current_geometry_frame + (i + 1) * geometry_buffer_size),
            geometry_frame_count - 1,
        )
        if (
            state.last_requested_geometry_frame != geometry_frame_count - 1
            and state.last_requested_geometry_frame < geometry_request_end
        ):
            start = state.last_requested_geometry_frame + 1
            state.last_requested_geometry_frame = geometry_request_end
            geometry_frames.extend(range(start, geometry_request_end + 1))

        texture_request_end = min(
            current_texture_segment + (i + 1) * texture_buffer_size,
            texture_sequence_count - 1,
        )
        if (
            state.last_requested_texture_segment != texture_sequence_count - 1
            and state.last_requested_texture_segment < texture_request_end
        ):
            start = state.last_requested_texture_segment + 1
            state.last_requested_texture_segment = texture_request_end
            texture_segments.extend(range(start, texture_request_end + 1))

    return PrefetchPlan(geometry_frames, texture_segments)


def eviction_thresholds(
    *,
    current_time: float,
    geometry_frame_rate: float,
    texture_frame_rate: float,
    texture_sequence_size: int,
) -> Tuple[int, int]:
    """Frames/segments strictly below these may be evicted.

    Mirrors src/V2/player.ts:542-545: a ≥120 Hz-safe render-count margin.
    """
    current_geometry_frame = get_current_frame(geometry_frame_rate, current_time)
    current_texture_frame = get_current_frame(texture_frame_rate, current_time)
    current_texture_segment = current_texture_frame // texture_sequence_size
    geometry_render_count = math.ceil(120 / geometry_frame_rate)
    texture_render_count = math.ceil(
        120 / (texture_frame_rate * texture_sequence_size)
    )
    return (
        current_geometry_frame - geometry_render_count,
        current_texture_segment - texture_render_count,
    )


@dataclasses.dataclass
class V1RequestPacer:
    """V1 worker request pacing (src/V1/player.ts:206-246).

    At most 3 requests in flight, `targetFramesToRequest`-sized ranges,
    stop at `frameCount`; playback is allowed to start once the buffer
    holds 3× target frames (or the track end was reached).
    """

    target_frames_to_request: int
    frame_count: int
    next_request_frame: int = 0
    in_flight: int = 0

    BUFFER_FULL_FACTOR = 5  # reference: stop when buffered > 5× target
    PLAY_FACTOR = 3

    def next_range(self, buffered: int) -> Tuple[int, int] | None:
        """Returns the next inclusive (start, end) frame range or None."""
        if self.in_flight >= 3:
            return None
        if buffered > self.BUFFER_FULL_FACTOR * self.target_frames_to_request:
            return None
        if self.next_request_frame >= self.frame_count:
            return None
        start = self.next_request_frame
        end = min(start + self.target_frames_to_request - 1, self.frame_count - 1)
        self.next_request_frame = end + 1
        self.in_flight += 1
        return start, end

    def on_response(self) -> None:
        self.in_flight = max(0, self.in_flight - 1)

    def can_start_playback(self, buffered: int) -> bool:
        return (
            buffered >= self.PLAY_FACTOR * self.target_frames_to_request
            or self.next_request_frame >= self.frame_count
        )
