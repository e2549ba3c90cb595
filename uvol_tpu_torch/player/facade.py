"""Facade Player: track-list management and V2 dispatch — the port of
`uvol_tpu/player/facade.py`.

Behavioral port of src/Player.ts: play-mode sequencing (:134-157), manifest
fetch + version dispatch with lazy instance construction (:159-204), and
the pause/play/update/dispose delegation (:206-264). Defaults mirror the
reference (:46-51).

Only V2 (`uvol.json`) tracks play: the V1 player (Corto `.drcs` geometry,
H.264/MP4 textures) is not ported yet, and a V1 manifest raises
NotImplementedError (ROADMAP.md §1 item 5). The V2 player is built on
`device` (default: the CUDA card; `"cpu"` names the CPU).
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional

from uvol_tpu_torch._device import DeviceLike, resolve_device
from uvol_tpu_torch.interfaces import PlayMode, V2Schema, parse_manifest
from uvol_tpu_torch.player.v2 import V2Player, default_fetcher


class Player:
    # reference defaults (src/Player.ts:46-51; the V1 ones are not ported)
    buffer_duration = 4
    interval_duration = 2

    def __init__(
        self,
        *,
        play_mode: PlayMode = PlayMode.loop,
        paths: Optional[List[str]] = None,
        fetcher: Callable[[str], bytes] = default_fetcher,
        on_mesh_buffering=None,
        on_frame_show=None,
        on_track_end=None,
        v2_args: Optional[dict] = None,
        v2_player_kwargs: Optional[dict] = None,
        rng: Optional[random.Random] = None,
        device: DeviceLike = None,
    ) -> None:
        self.play_mode = play_mode
        self.paths = paths or []
        if play_mode != PlayMode.unmanaged and not self.paths:
            raise ValueError("managed play modes require track paths")
        if play_mode == PlayMode.unmanaged and on_track_end is None:
            raise ValueError("unmanaged play mode requires on_track_end")
        self.fetcher = fetcher
        self.on_mesh_buffering = on_mesh_buffering
        self.on_frame_show = on_frame_show
        self._user_on_track_end = on_track_end
        self._rng = rng or random.Random()

        for k, v in (v2_args or {}).items():
            setattr(self, k, v)
        self._v2_player_kwargs = v2_player_kwargs or {}
        self.device = resolve_device(device)

        self.paused = True
        self.stopped = True
        self.manifest = None
        self.current_track: Optional[int] = None
        self.current_manifest_path = ""
        self.v2_instance: Optional[V2Player] = None

    # -- track sequencing (src/Player.ts:134-157) ----------------------------
    def _next_track(self) -> int:
        current = -1 if self.current_track is None else self.current_track
        n = len(self.paths)
        if self.play_mode == PlayMode.random:
            return self._rng.randrange(n)
        if self.play_mode == PlayMode.single:
            return (current + 1) % n
        if self.play_mode == PlayMode.singleloop:
            return max(current, 0)
        return (current + 1) % n  # loop

    def _on_track_end(self) -> None:
        if self._user_on_track_end is not None:
            self.paused = True
            self.stopped = True
            self.manifest = None
            self._user_on_track_end()
        else:
            self.set_track_path()

    @property
    def is_v2(self) -> bool:
        return isinstance(self.manifest, V2Schema)

    def set_track_path(self, next_path: Optional[str] = None) -> None:
        self.manifest = None
        if next_path is None:
            self.current_track = self._next_track()
            next_path = self.paths[self.current_track]
        raw = self.fetcher(next_path)
        manifest = parse_manifest(raw)
        if not isinstance(manifest, V2Schema):
            raise NotImplementedError(
                f"{next_path}: a V1 manifest; the V1 player (Corto, H.264/MP4) is not "
                "ported (ROADMAP.md §1 item 5)")
        self.manifest = manifest
        self.current_manifest_path = next_path
        if self.v2_instance is None:
            kwargs = dict(self._v2_player_kwargs)
            kwargs.setdefault("device", self.device)
            self.v2_instance = V2Player(
                fetcher=self.fetcher,
                on_mesh_buffering=self.on_mesh_buffering,
                on_frame_show=self.on_frame_show,
                on_track_end=self._on_track_end,
                **kwargs,
            )
        self.play_track()

    def play_track(self) -> None:
        self.v2_instance.play_track(
            self.manifest,
            self.current_manifest_path,
            self.buffer_duration,
            self.interval_duration,
        )
        self.paused = False
        self.stopped = False

    def pause(self) -> None:
        if self.manifest is None:
            return
        self.v2_instance.pause()
        self.paused = True
        self.stopped = False

    def play(self) -> None:
        if self.manifest is None:
            return
        self.v2_instance.play()
        self.paused = False
        self.stopped = False

    def update(self):
        if self.manifest is None:
            return None
        return self.v2_instance.update()

    def dispose(self) -> None:
        if self.v2_instance:
            self.v2_instance.dispose()
