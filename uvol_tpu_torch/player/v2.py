"""Headless UVOL 2.0 streaming player — the port of `uvol_tpu/player/v2.py`.

Behavioral port of the reference V2 player (src/V2/player.ts): manifest-
driven leaky-bucket prefetch of geometry frames + `.ktx2` segments, audio-
or wall-clock sync, geometry/texture frame-rate reconciliation,
array-texture layer indexing (`offset = frame % sequenceSize`, :446),
buffer eviction and fail-material degradation (:435-444). Rendering is
replaced by a `FrameResult` value the host app (or test) consumes.

`V2Player`'s logic is the reference's, copied as it is. Its default
decoders are the port's, on `device` (default: the CUDA card; `"cpu"`
names the CPU):

  - `.uvtg` geometry: `models.sequence.GeometrySequenceCodec` on the device;
  - `.drc` geometry: `codecs.draco.decoder.decode_drc`, the C decoder on
    the host, as the reference decodes it;
  - BasisLZ/ETC1S textures: the transcoder's target for
    `DEVICE_TEXTURE_CAPABILITIES` (`etc1` words, or `etc2-eac` for alpha,
    by default), palette lookups on the host;
  - raw-ETC KTX2 textures: `TextureSequenceCodec.decode_segment` (the
    ETC1 decode kernel on the card);
  - UASTC textures: `uastc.transcode_uastc` to the target the format
    table picks; on an ETC device its decode-and-refit, whose ETC1 fit is
    the ETC1 encode kernel on `device`.

Each decoder returns host arrays after its device work has finished, so
the prefetch threads (`async_prefetch=True`) may run them concurrently.
Decode wall times go into `utils.stats.STATS` (`v2.geometry_decode_s`,
`v2.texture_decode_s`).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, Optional

from uvol_tpu_torch._device import DeviceLike, resolve_device
from uvol_tpu_torch.interfaces import (
    FORMATS_TO_EXT,
    TEXTURE_FORMAT_PRIORITY,
    V2Schema,
)
from uvol_tpu_torch.player.clock import PlaybackClock
from uvol_tpu_torch.player.scheduler import (
    PrefetchState,
    eviction_thresholds,
    get_current_frame,
    plan_prefetch,
)
from uvol_tpu_torch.utils.paths import expand_template, get_absolute_url
from uvol_tpu_torch.utils.stats import STATS


def default_fetcher(url: str) -> bytes:
    if url.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(url) as r:  # noqa: S310 - explicit user-provided URL
            return r.read()
    with open(url, "rb") as f:
        return f.read()


#: the sequence codecs the default decoders build, one per (kind, device)
_CODEC_CACHE: Dict[Any, Any] = {}
_CODEC_LOCK = threading.Lock()


def _codec(kind: str, device):
    key = (kind, str(device))
    with _CODEC_LOCK:
        if key not in _CODEC_CACHE:
            from uvol_tpu_torch.models.sequence import (
                GeometrySequenceCodec,
                TextureSequenceCodec,
            )

            cls = GeometrySequenceCodec if kind == "uvtg" else TextureSequenceCodec
            _CODEC_CACHE[key] = cls(device=device)
        return _CODEC_CACHE[key]


def default_geometry_decoder(data: bytes, *, device: DeviceLike = None):
    """`.uvtg` through the port's geometry codec on `device`; anything else
    as a Draco frame, on the host."""
    from uvol_tpu_torch.codecs.draco.decoder import decode_drc
    from uvol_tpu_torch.models.sequence import UVTG_MAGIC

    with STATS.timer("v2.geometry_decode_s"):
        if data[:4] == UVTG_MAGIC:
            return _codec("uvtg", resolve_device(device)).decode([data])
        return decode_drc(data)


#: the headless "device" is ETC-capable: the format-selection table then
#: picks the compressed ETC1 passthrough (palette lookups only, no pixel
#: math) exactly like the reference's KTX2Loader on an ETC2 GPU
#: (src/lib/KTX2Loader.js:591-697). Set to () to force full RGBA decode.
DEVICE_TEXTURE_CAPABILITIES = ("etc2", "etc1")


@dataclasses.dataclass
class DecodedTexture:
    """Tagged texture-decode result: `format` names the payload layout
    instead of making consumers sniff it per segment. `format` is the
    transcode target actually produced:

      - ``"rgba"``: `data` is [F, H, W, 3|4] uint8 pixels,
      - ``"etc1"``: [F, nblocks, 2] uint32 block words
      - ``"etc2-eac"``: [F, nblocks, 4] uint32 (EAC alpha + color words)
      - ``"pvrtc1"``: [F, nblocks, 2] uint32 Morton-order PVRTC1 blocks
        (compressed passthrough, upload-ready),
      - ``"bc1-bc3"``: [F, nblocks, 2|4] uint32 BC1 (BC4 alpha + BC1) words,
      - ``"astc-4x4"`` / ``"bc7"``: [F, nblocks, 16] uint8 blocks (UASTC).

    Array-protocol passthroughs keep ndarray-style consumers working.
    """

    format: str
    data: Any

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def __array__(self, dtype=None, copy=None):
        import numpy as _np

        a = _np.asarray(self.data)
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, key):
        return self.data[key]

    def astype(self, dtype):
        return self.data.astype(dtype)


def default_texture_decoder(data: bytes, *, device: DeviceLike = None) -> DecodedTexture:
    from uvol_tpu_torch.containers.ktx2 import (
        KHR_DF_MODEL_UASTC,
        SUPERCOMPRESSION_BASISLZ,
        read_ktx2,
    )

    with STATS.timer("v2.texture_decode_s"):
        f = read_ktx2(data)
        if f.header.supercompression_scheme == SUPERCOMPRESSION_BASISLZ:
            from uvol_tpu_torch.codecs.basis.transcoder import (
                select_transcode_target,
                transcode_ktx2_etc1s,
            )

            target = select_transcode_target(
                DEVICE_TEXTURE_CAPABILITIES,
                width=f.header.pixel_width,
                height=f.header.pixel_height,
            )
            if f.basis_lz is not None and any(
                d.alpha_slice_byte_length for d in f.basis_lz.image_descs
            ):
                # alpha files upgrade to the paired-alpha-block formats where
                # the device supports them (BC3, ETC2+EAC); otherwise full
                # decode, like the reference's fallback column
                if target == "bc1-bc3":
                    pass
                elif (
                    target == "etc1"
                    and "etc2" in DEVICE_TEXTURE_CAPABILITIES
                ):
                    target = "etc2-eac"
                else:
                    target = "rgba"
            return DecodedTexture(target, transcode_ktx2_etc1s(f, target=target))
        if f.dfd_color_model() == KHR_DF_MODEL_UASTC:
            return _uastc_texture(f, device)
        codec = _codec("etc", resolve_device(device))
        return DecodedTexture("rgba", codec.decode_segment(f))


def _uastc_texture(f, device) -> DecodedTexture:
    """UASTC path (reference: KTX2Loader UASTC column of FORMAT_OPTIONS)
    — astc-4x4 devices get REAL ASTC blocks and bptc devices real BC7
    (structural transcodes); ETC/DXT/PVRTC-class devices get
    decode-and-refit block words, matching basisu's transcoder."""
    from uvol_tpu_torch.codecs.basis.transcoder import select_transcode_target
    from uvol_tpu_torch.codecs.basis.uastc import transcode_uastc

    target = select_transcode_target(
        DEVICE_TEXTURE_CAPABILITIES,
        is_uastc=True,
        width=f.header.pixel_width,
        height=f.header.pixel_height,
    )
    if target == "astc-4x4":
        return DecodedTexture("astc-4x4", transcode_uastc(f, target="astc", device=device))
    if target == "bc7":
        return DecodedTexture("bc7", transcode_uastc(f, target="bc7", device=device))
    if target == "etc1" and "etc2" in DEVICE_TEXTURE_CAPABILITIES:
        # ETC2-capable devices take the EAC-paired form so alpha content
        # survives; plain etc1 devices get the color words
        return DecodedTexture("etc2-eac", transcode_uastc(f, target="etc2-eac", device=device))
    if target in ("etc1", "bc1-bc3", "pvrtc1"):
        try:
            return DecodedTexture(target, transcode_uastc(f, target=target, device=device))
        except NotImplementedError:
            # alpha content on the pvrtc1 target: full decode, like the
            # reference's unsupported-combination column (a format rule;
            # a kernel or build failure raises something else)
            pass
    return DecodedTexture("rgba", transcode_uastc(f, target="rgba", device=device))


@dataclasses.dataclass
class FrameResult:
    """What `update()` would render this tick."""

    status: str  # 'buffering' | 'ended' | 'skipped' | 'fail-material' | 'ok'
    geometry_frame: Optional[int] = None
    texture_segment: Optional[int] = None
    texture_layer: Optional[int] = None  # offset into the array texture
    geometry: Any = None
    texture: Any = None
    buffering_progress: Optional[float] = None


class V2Player:
    def __init__(
        self,
        *,
        fetcher: Callable[[str], bytes] = default_fetcher,
        geometry_decoder: Optional[Callable[[bytes], Any]] = None,
        texture_decoder: Optional[Callable[[bytes], Any]] = None,
        on_mesh_buffering=None,
        on_frame_show=None,
        on_track_end=None,
        audio: Any = None,  # object with .current_time/.ended/.play()
        clock: Optional[PlaybackClock] = None,
        supported_texture_formats=("ktx2", "etc2", "mp4"),
        async_prefetch: bool = False,
        prefetch_workers: int = 4,
        device: DeviceLike = None,
    ) -> None:
        # the default decoders run on `device`: the card unless the caller
        # names the CPU; no card raises here
        self.device = resolve_device(device)
        if geometry_decoder is None:
            geometry_decoder = functools.partial(default_geometry_decoder, device=self.device)
        if texture_decoder is None:
            texture_decoder = functools.partial(default_texture_decoder, device=self.device)
        self.buffer_duration = 4.0  # reference defaults (src/V2/player.ts:50-51)
        self.interval_duration = 2.0
        self.fetcher = fetcher
        self.geometry_decoder = geometry_decoder
        self.texture_decoder = texture_decoder
        self.on_mesh_buffering = on_mesh_buffering
        self.on_frame_show = on_frame_show
        self.on_track_end = on_track_end
        self.audio = audio
        self.clock = clock or PlaybackClock()
        self.supported_texture_formats = supported_texture_formats

        self.manifest: Optional[V2Schema] = None
        self.manifest_path = ""
        self.mesh_map: Dict[int, Any] = {}
        self.texture_map: Dict[int, Any] = {}
        self._prefetch = PrefetchState()
        self._ended = False
        self.geometry_target = ""
        self.texture_target = ""
        self.texture_type = "baseColor"
        self.texture_tag = "default"
        self._last_fetch_time: Optional[float] = None
        # L5 async decode services (reference worker pools → host threads)
        self._async = async_prefetch
        self._prefetch_workers = prefetch_workers
        self._geo_pool = self._tex_pool = None
        if async_prefetch:
            self._make_pools()

    def _make_pools(self) -> None:
        from uvol_tpu_torch.runtime.prefetch import PrefetchPool

        # DRACOLoader pool: ≤4 workers (src/lib/DRACOLoader.js:24)
        self._geo_pool = PrefetchPool(
            lambda url: self.geometry_decoder(self.fetcher(url)),
            workers=self._prefetch_workers,
        )
        self._tex_pool = PrefetchPool(
            lambda url: self.texture_decoder(self.fetcher(url)),
            workers=self._prefetch_workers,
        )

    # -- target selection (src/V2/player.ts:207-222) -------------------------
    def _select_targets(self) -> None:
        m = self.manifest
        self.geometry_target = next(iter(m.geometry.targets))
        self.texture_target = next(iter(m.texture.targets))
        names = sorted(
            m.texture.targets,
            key=lambda t: TEXTURE_FORMAT_PRIORITY.get(
                m.texture.targets[t].format, -1
            ),
            reverse=True,
        )
        for name in names:
            if m.texture.targets[name].format in self.supported_texture_formats:
                self.texture_target = name
                break

    # -- URLs (src/V2/player.ts:141-174) -------------------------------------
    def geometry_url(self, frame: int) -> str:
        m = self.manifest
        t = m.geometry.targets[self.geometry_target]
        path = expand_template(
            m.geometry.path,
            index=frame,
            target=self.geometry_target,
            ext=FORMATS_TO_EXT[t.format],
        )
        return get_absolute_url(self.manifest_path, path)

    def texture_url(self, segment: int) -> str:
        m = self.manifest
        t = m.texture.targets[self.texture_target]
        ttype = t.type if isinstance(t.type, str) else t.type[0]
        path = expand_template(
            m.texture.path,
            index=segment,
            target=self.texture_target,
            type=ttype,
            tag=t.tag or "default",
        )
        path = path.replace("[ext]", FORMATS_TO_EXT[t.format])
        return get_absolute_url(self.manifest_path, path)

    # -- lifecycle -----------------------------------------------------------
    def play_track(
        self,
        manifest: V2Schema,
        manifest_path: str,
        buffer_duration: Optional[float] = None,
        interval_duration: Optional[float] = None,
    ) -> None:
        self.manifest = manifest
        self.manifest_path = manifest_path
        self._select_targets()
        if buffer_duration:
            self.buffer_duration = buffer_duration
        if interval_duration:
            self.interval_duration = interval_duration
        self._prefetch = PrefetchState()
        self._ended = False
        self.mesh_map.clear()
        self.texture_map.clear()
        # generation-scope async pool keys: a track switch must not hit the
        # previous track's dedup entries, and its late decodes must not
        # land in the new track's maps
        self._track_gen = getattr(self, "_track_gen", 0) + 1
        if self._async and (self._geo_pool is None or self._geo_pool._closed):
            self._make_pools()
        self.fetch_buffers()
        self._last_fetch_time = self.current_time
        self.start_video()

    def start_video(self) -> None:
        if self.audio is not None:
            self.audio.play()
        else:
            self.clock.start()

    def pause(self) -> None:
        if self.audio is not None:
            self.audio.pause()
        else:
            self.clock.pause()

    def play(self) -> None:
        if self.audio is not None:
            self.audio.play()
        else:
            self.clock.play()

    @property
    def paused(self) -> bool:
        if self.audio is not None:
            return self.audio.paused
        return self.clock.is_paused

    @property
    def current_time(self) -> float:
        if self.audio is not None:
            return self.audio.current_time
        return self.clock.current_time

    # -- prefetch + decode (src/V2/player.ts:272-366) ------------------------
    def fetch_buffers(self) -> None:
        STATS.count("v2.fetch_buffers")
        m = self.manifest
        g = m.geometry.targets[self.geometry_target]
        t = m.texture.targets[self.texture_target]
        plan = plan_prefetch(
            self._prefetch,
            current_time=self.current_time,
            geometry_frame_rate=g.frameRate,
            geometry_frame_count=g.frameCount,
            texture_frame_rate=t.frameRate,
            texture_sequence_size=t.sequenceSize,
            texture_sequence_count=t.sequenceCount,
            buffer_duration=self.buffer_duration,
        )
        if self._async:
            gen = self._track_gen
            for frame in plan.geometry_frames:
                self._geo_pool.request((gen, frame), self.geometry_url(frame))
            for segment in plan.texture_segments:
                self._tex_pool.request(
                    (gen, segment), self.texture_url(segment)
                )
            self._drain_pools()
            return
        for frame in plan.geometry_frames:
            self.mesh_map[frame] = self.geometry_decoder(
                self.fetcher(self.geometry_url(frame))
            )
        for segment in plan.texture_segments:
            self.texture_map[segment] = self.texture_decoder(
                self.fetcher(self.texture_url(segment))
            )

    def _drain_pools(self) -> None:
        """Move completed async decodes into the playback maps; decode
        failures degrade to a missing entry (skip / fail-material path)."""
        gen = self._track_gen
        for (g_, frame), (result, err) in self._geo_pool.poll().items():
            if g_ == gen and err is None:
                self.mesh_map[frame] = result
        for (g_, segment), (result, err) in self._tex_pool.poll().items():
            if g_ == gen and err is None:
                self.texture_map[segment] = result

    # -- per-tick processing (src/V2/player.ts:388-531) ----------------------
    def process_frame(self) -> FrameResult:
        if self.manifest is None:
            return FrameResult("buffering", buffering_progress=0.0)
        m = self.manifest
        g = m.geometry.targets[self.geometry_target]
        t = m.texture.targets[self.texture_target]

        if self.audio is not None and getattr(self.audio, "ended", False):
            self._ended = True
            if self.on_track_end:
                self.on_track_end()
            return FrameResult("ended")

        if self.paused:
            progress = len(self.mesh_map) / (g.frameRate * self.buffer_duration)
            if self.on_mesh_buffering:
                self.on_mesh_buffering(progress)
            return FrameResult("buffering", buffering_progress=progress)

        now = self.current_time
        geometry_frame = get_current_frame(g.frameRate, now)
        texture_frame = get_current_frame(t.frameRate, now)
        texture_segment = texture_frame // t.sequenceSize

        if geometry_frame >= g.frameCount:
            self._ended = True
            self.dispose()
            if self.on_track_end:
                self.on_track_end()
            return FrameResult("ended")

        # geometry prioritized over texture (reference comment :429-433)
        if geometry_frame not in self.mesh_map:
            STATS.count("v2.frames_skipped")
            return FrameResult("skipped", geometry_frame=geometry_frame)

        if texture_segment not in self.texture_map:
            STATS.count("v2.fail_material")
            if self.on_frame_show:
                self.on_frame_show(geometry_frame)
            return FrameResult(
                "fail-material",
                geometry_frame=geometry_frame,
                geometry=self.mesh_map[geometry_frame],
            )

        offset = texture_frame % t.sequenceSize
        STATS.count("v2.frames_ok")
        if self.on_frame_show:
            self.on_frame_show(geometry_frame)
        return FrameResult(
            "ok",
            geometry_frame=geometry_frame,
            texture_segment=texture_segment,
            texture_layer=offset,
            geometry=self.mesh_map[geometry_frame],
            texture=self.texture_map[texture_segment],
        )

    def update(self) -> FrameResult:
        # interval-driven refetch: the reference re-runs fetchBuffers every
        # intervalDuration seconds (src/V2/player.ts:253-255); driving it
        # from update() keeps the headless player virtual-clock friendly
        if self.manifest is not None and not self._ended:
            now = self.current_time
            if (
                self._last_fetch_time is None
                or now - self._last_fetch_time >= self.interval_duration
            ):
                self.fetch_buffers()
                self._last_fetch_time = now
            elif self._async:
                self._drain_pools()  # completions land every tick
        result = self.process_frame()
        if self.manifest is None or self._ended:
            return result
        m = self.manifest
        g = m.geometry.targets[self.geometry_target]
        t = m.texture.targets[self.texture_target]
        geo_min, tex_min = eviction_thresholds(
            current_time=self.current_time,
            geometry_frame_rate=g.frameRate,
            texture_frame_rate=t.frameRate,
            texture_sequence_size=t.sequenceSize,
        )
        self.remove_played_buffers(geo_min, tex_min)
        return result

    def remove_played_buffers(self, frame_no: int, segment_no: int) -> None:
        for k in [k for k in self.mesh_map if k < frame_no]:
            del self.mesh_map[k]
        for k in [k for k in self.texture_map if k < segment_no]:
            del self.texture_map[k]

    def dispose(self) -> None:
        self.mesh_map.clear()
        self.texture_map.clear()
        if self._geo_pool is not None:
            self._geo_pool.close()
        if self._tex_pool is not None:
            self._tex_pool.close()
