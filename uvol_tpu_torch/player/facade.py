"""Facade Player: track-list management and V1/V2 dispatch — the port of
`uvol_tpu/player/facade.py`.

Behavioral port of src/Player.ts: play-mode sequencing (:134-157), manifest
fetch + version dispatch with lazy instance construction (:159-204), and
the pause/play/update/dispose delegation (:206-264). Defaults mirror the
reference (:46-51).

A V2 (`uvol.json`) track plays through `V2Player`, built on `device`
(default: the CUDA card; `"cpu"` names the CPU). A V1 (`.manifest`) track
plays through `V1Player` as in the reference: its Corto frames come from
one whole-blob fetch of the `.drcs`, sliced per range, and its texture is
the `.mp4` beside the manifest (`io/video.Mp4VideoTexture`). A V1 track
has no device stage. As in the reference, a texture that fails to load
leaves the track playing on the clock, untextured.
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional

from uvol_tpu_torch._device import DeviceLike, resolve_device
from uvol_tpu_torch.interfaces import PlayMode, V2Schema, parse_manifest
from uvol_tpu_torch.player.v1 import V1Player
from uvol_tpu_torch.player.v2 import V2Player, default_fetcher


class Player:
    # reference defaults (src/Player.ts:46-51)
    encoder_window_size = 8
    encoder_byte_length = 16
    video_size = 1024
    target_frames_to_request = 90
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
        v1_args: Optional[dict] = None,
        v2_args: Optional[dict] = None,
        v1_player_kwargs: Optional[dict] = None,
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

        for k, v in (v1_args or {}).items():
            setattr(self, k, v)
        for k, v in (v2_args or {}).items():
            setattr(self, k, v)
        self._v1_player_kwargs = v1_player_kwargs or {}
        self._v2_player_kwargs = v2_player_kwargs or {}
        self.device = resolve_device(device)

        self.paused = True
        self.stopped = True
        self.manifest = None
        self.current_track: Optional[int] = None
        self.current_manifest_path = ""
        self.v1_instance: Optional[V1Player] = None
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
        self.manifest = parse_manifest(raw)
        self.current_manifest_path = next_path
        if self.is_v2:
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
        else:
            if self.v1_instance is None:
                blob_cache: dict = {}

                def range_fetcher(url: str, start: int, end: int) -> bytes:
                    # one whole-blob fetch per .drcs, sliced per range (the
                    # reference's HTTP Range requests; re-downloading the
                    # full blob per range would multiply transfer)
                    if url not in blob_cache:
                        blob_cache.clear()
                        blob_cache[url] = self.fetcher(url)
                    return blob_cache[url][start:end]

                def corto_decoder(data: bytes):
                    from uvol_tpu_torch.codecs.corto.decoder import decode_crt

                    return decode_crt(data)

                v1_kwargs = dict(
                    range_fetcher=range_fetcher,
                    geometry_decoder=corto_decoder,
                    on_mesh_buffering=self.on_mesh_buffering,
                    on_frame_show=self.on_frame_show,
                    on_track_end=self._on_track_end,
                    target_frames_to_request=self.target_frames_to_request,
                    encoder_window_size=self.encoder_window_size,
                    encoder_byte_length=self.encoder_byte_length,
                    video_size=self.video_size,
                )
                v1_kwargs.update(self._v1_player_kwargs)
                self.v1_instance = V1Player(**v1_kwargs)
            # video texture: .mp4 URL derived from the manifest path like
            # the reference (src/V1/player.ts:192); track stays playable
            # without one (clock-synced), matching headless use. Always
            # rebuilt on track change — reusing the previous track's video
            # left `ended` permanently True on replay/looping.
            try:
                mp4_bytes = self.fetcher(
                    next_path.replace(".manifest", ".mp4")
                )
                from uvol_tpu_torch.io.video import Mp4VideoTexture

                self.v1_instance.video = Mp4VideoTexture(
                    mp4_bytes, clock=self.v1_instance.clock
                )
            except Exception:
                self.v1_instance.video = None
        self.play_track()

    def play_track(self) -> None:
        if self.is_v2:
            self.v2_instance.play_track(
                self.manifest,
                self.current_manifest_path,
                self.buffer_duration,
                self.interval_duration,
            )
        else:
            self.v1_instance.play_track(
                self.manifest, self.target_frames_to_request,
                self.current_manifest_path,
            )
        self.paused = False
        self.stopped = False

    def pause(self) -> None:
        if self.manifest is None:
            return
        if self.is_v2:
            self.v2_instance.pause()
        elif getattr(self.v1_instance, "video", None) is not None:
            self.v1_instance.video.pause()
        else:
            self.v1_instance.clock.pause()  # clock-synced V1 track
        self.paused = True
        self.stopped = False

    def play(self) -> None:
        if self.manifest is None:
            return
        if self.is_v2:
            self.v2_instance.play()
        elif getattr(self.v1_instance, "video", None) is not None:
            self.v1_instance.video.play()
        else:
            self.v1_instance.clock.play()
        self.paused = False
        self.stopped = False

    def update(self, **kwargs):
        if self.manifest is None:
            return None
        if self.is_v2:
            return self.v2_instance.update()
        # baked-counter read-back happens inside V1Player.update so it
        # samples the video AFTER buffer_loop may have (re)started the
        # clock — reading here returned the previous epoch's last frame
        # on replay and mis-evicted the fresh buffer
        return self.v1_instance.update(**kwargs)

    def dispose(self) -> None:
        if self.v1_instance:
            self.v1_instance.dispose()
        if self.v2_instance:
            self.v2_instance.dispose()
