"""Playback clocks: wall clock with pause accounting + virtual test clock.

Mirrors the reference V2 player's wall-clock path (src/V2/player.ts:258-265,
368-386, 411-416): `startVideo` stamps a start time; pause/play accumulate
`totalPausedDuration`; currentTime = (now - start - paused) seconds. An
audio element's currentTime takes priority when present — here that's any
object exposing `.current_time` / `.ended`.

The port's copy of `uvol_tpu/player/clock.py`, unchanged.
"""

from __future__ import annotations

import time
from typing import Optional


class PlaybackClock:
    def __init__(self, now=time.monotonic):
        self._now = now
        self._start: Optional[float] = None
        self._paused_at: Optional[float] = None
        self._total_paused = 0.0
        self.is_paused = True

    def start(self) -> None:
        self._start = self._now()
        self._total_paused = 0.0
        self._paused_at = None
        self.is_paused = False

    def pause(self) -> None:
        if not self.is_paused:
            self._paused_at = self._now()
            self.is_paused = True

    def play(self) -> None:
        if self.is_paused and self._paused_at is not None:
            self._total_paused += self._now() - self._paused_at
            self._paused_at = None
        self.is_paused = self._start is None
        if self._start is None:
            self.start()

    @property
    def current_time(self) -> float:
        if self._start is None:
            return 0.0
        ref = self._paused_at if self._paused_at is not None else self._now()
        return ref - self._start - self._total_paused


class VirtualClock:
    """Deterministic clock for scheduling tests (SURVEY.md §4 point 3)."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt
