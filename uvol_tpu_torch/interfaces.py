"""Manifest schemas, play modes, and format tables.

TPU-native re-design of the reference's manifest/type surface
(upstream `src/Interfaces.ts:1-169`). The JSON wire formats are
preserved exactly (they are the public API boundary); the in-memory
representation is Python dataclasses with strict validation, because the
rebuild's encoder and player are driven from these.

Notable fix carried over knowingly (SURVEY.md §2.1): the reference's
`scripts/Encoder.py:313-327` writes `texture.targets` as a *list* while the
player consumes a *Record keyed by target name* (`src/V2/player.ts:207-208`).
We emit and consume the Record form only.

The port's copy of `uvol_tpu/interfaces.py`, unchanged: the manifests
it reads and writes are the reference's, byte for byte. `V1Schema` is
parsed so the facade player can name a V1 manifest it does not play.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union


class PlayMode(str, enum.Enum):
    """Track sequencing behavior (reference: src/Interfaces.ts:148-154)."""

    single = "single"
    random = "random"
    loop = "loop"
    singleloop = "singleloop"
    unmanaged = "unmanaged"


#: File extension per encoding format (reference: src/Interfaces.ts:156-161).
FORMATS_TO_EXT: Dict[str, str] = {
    "mp3": ".mp3",
    "draco": ".drc",
    "ktx2": ".ktx2",
    "etc2": ".etc2",
    # rebuild additions (UVOL1 assets addressed through the same table)
    "mp4": ".mp4",
    "obj": ".obj",
    "crt": ".crt",
    "drcs": ".drcs",
    # this framework's own batched geometry format — declared honestly, not
    # mislabeled as draco (round-1 ADVICE item 2)
    "uvtg": ".uvtg",
}

#: Larger value == higher priority (reference: src/Interfaces.ts:165-169).
TEXTURE_FORMAT_PRIORITY: Dict[str, int] = {
    "ktx2": 0,
    "etc2": 1,
    "etc1": 2,
}

AUDIO_FORMATS = ("mp3",)
GEOMETRY_FORMATS = ("obj", "draco", "uvtg")
TEXTURE_FORMATS = ("mp4", "ktx2", "etc2")
TEXTURE_TYPES = ("baseColor", "normal", "metallicRoughness", "emissive", "occlusion")


# ---------------------------------------------------------------------------
# V1 (UVOL 1.0) manifest — reference: src/Interfaces.ts:1-15
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class V1FrameData:
    """Per-frame index entry of the `.drcs` blob (src/Interfaces.ts:1-8)."""

    frameNumber: int
    keyframeNumber: int
    startBytePosition: int
    vertices: int
    faces: int
    meshLength: int

    def to_json(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "V1FrameData":
        return cls(
            frameNumber=int(d["frameNumber"]),
            keyframeNumber=int(d["keyframeNumber"]),
            startBytePosition=int(d["startBytePosition"]),
            vertices=int(d["vertices"]),
            faces=int(d["faces"]),
            meshLength=int(d["meshLength"]),
        )


@dataclasses.dataclass
class V1Schema:
    """UVOL 1.0 `.manifest` (src/Interfaces.ts:10-15)."""

    maxVertices: int
    maxTriangles: int
    frameData: List[V1FrameData]
    frameRate: float

    def to_json(self) -> Dict[str, Any]:
        return {
            "maxVertices": self.maxVertices,
            "maxTriangles": self.maxTriangles,
            "frameData": [f.to_json() for f in self.frameData],
            "frameRate": self.frameRate,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "V1Schema":
        return cls(
            maxVertices=int(d["maxVertices"]),
            maxTriangles=int(d["maxTriangles"]),
            frameData=[V1FrameData.from_json(f) for f in d["frameData"]],
            frameRate=float(d["frameRate"]),
        )


# ---------------------------------------------------------------------------
# V2 (UVOL 2.0) manifest — reference: src/Interfaces.ts:21-132
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GeometryTarget:
    """One geometry encoding target (src/Interfaces.ts:21-37)."""

    frameRate: float
    frameCount: int
    format: str = "draco"

    def __post_init__(self) -> None:
        if self.format not in GEOMETRY_FORMATS:
            raise ValueError(f"unknown geometry format {self.format!r}")

    def to_json(self) -> Dict[str, Any]:
        return {
            "frameRate": self.frameRate,
            "frameCount": self.frameCount,
            "format": self.format,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "GeometryTarget":
        return cls(
            frameRate=float(d["frameRate"]),
            frameCount=int(d["frameCount"]),
            format=str(d.get("format", "draco")),
        )


@dataclasses.dataclass
class TextureTarget:
    """Base texture target (src/Interfaces.ts:41-58)."""

    format: str
    resolution: Tuple[int, int]
    type: Union[str, List[str]] = "baseColor"
    tag: Optional[str] = "default"

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "format": self.format,
            "resolution": list(self.resolution),
            "type": self.type,
        }
        if self.tag is not None:
            d["tag"] = self.tag
        return d


@dataclasses.dataclass
class KTX2TextureTarget(TextureTarget):
    """KTX2 texture target with frame batching (src/Interfaces.ts:60-73).

    `sequenceSize` is the number of frames packed as layers of each `.ktx2`
    file (`KTX2_BATCH_SIZE` in the reference encoder, scripts/Encoder.py:279).
    """

    sequenceSize: int = 0
    sequenceCount: int = 0
    frameRate: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        d = super().to_json()
        d.update(
            {
                "sequenceSize": self.sequenceSize,
                "sequenceCount": self.sequenceCount,
                "frameRate": self.frameRate,
            }
        )
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "KTX2TextureTarget":
        return cls(
            format=str(d["format"]),
            resolution=tuple(d["resolution"]),  # type: ignore[arg-type]
            type=d.get("type", "baseColor"),
            tag=d.get("tag", "default"),
            sequenceSize=int(d.get("sequenceSize", 0)),
            sequenceCount=int(d.get("sequenceCount", 0)),
            frameRate=float(d.get("frameRate", 0.0)),
        )


@dataclasses.dataclass
class AudioSection:
    path: str
    format: Union[str, List[str]] = "mp3"

    def to_json(self) -> Dict[str, Any]:
        return {"path": self.path, "format": self.format}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "AudioSection":
        return cls(path=str(d["path"]), format=d.get("format", "mp3"))

    @property
    def primary_format(self) -> str:
        # reference: src/V2/player.ts:134-136 — first element wins
        return self.format[0] if isinstance(self.format, list) else self.format


@dataclasses.dataclass
class GeometrySection:
    targets: Dict[str, GeometryTarget]
    path: str

    def to_json(self) -> Dict[str, Any]:
        return {
            "targets": {k: v.to_json() for k, v in self.targets.items()},
            "path": self.path,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "GeometrySection":
        return cls(
            targets={k: GeometryTarget.from_json(v) for k, v in d["targets"].items()},
            path=str(d["path"]),
        )


@dataclasses.dataclass
class TextureSection:
    targets: Dict[str, KTX2TextureTarget]
    path: str

    def to_json(self) -> Dict[str, Any]:
        return {
            "targets": {k: v.to_json() for k, v in self.targets.items()},
            "path": self.path,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TextureSection":
        return cls(
            targets={
                k: KTX2TextureTarget.from_json(v) for k, v in d["targets"].items()
            },
            path=str(d["path"]),
        )


@dataclasses.dataclass
class V2Schema:
    """UVOL 2.0 `uvol.json` manifest (src/Interfaces.ts:75-132)."""

    geometry: GeometrySection
    texture: TextureSection
    audio: Optional[AudioSection] = None
    version: str = "v2"

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"version": self.version}
        if self.audio is not None:
            d["audio"] = self.audio.to_json()
        d["geometry"] = self.geometry.to_json()
        d["texture"] = self.texture.to_json()
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "V2Schema":
        audio = None
        if d.get("audio"):
            audio = AudioSection.from_json(d["audio"])
        return cls(
            version=str(d.get("version", "v2")),
            audio=audio,
            geometry=GeometrySection.from_json(d["geometry"]),
            texture=TextureSection.from_json(d["texture"]),
        )


UVOLManifestSchema = Union[V1Schema, V2Schema]


def is_v2_manifest(d: Dict[str, Any]) -> bool:
    """V1-vs-V2 dispatch predicate (reference: src/Player.ts:127-132)."""
    return d.get("version") == "v2"


def parse_manifest(text_or_dict: Union[str, bytes, Dict[str, Any]]) -> UVOLManifestSchema:
    d = (
        json.loads(text_or_dict)
        if isinstance(text_or_dict, (str, bytes))
        else text_or_dict
    )
    if is_v2_manifest(d):
        return V2Schema.from_json(d)
    return V1Schema.from_json(d)


# ---------------------------------------------------------------------------
# Callback protocol (reference: src/Interfaces.ts:136-146) — plain callables
# ---------------------------------------------------------------------------

OnMeshBufferingCallback = Any  # Callable[[float], None]
OnFrameShowCallback = Any  # Callable[[int], None]
OnTrackEndCallback = Any  # Callable[[], None]
