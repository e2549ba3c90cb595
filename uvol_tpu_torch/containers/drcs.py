"""UVOL 1.0 `.drcs` container: concatenated per-frame Corto `.crt` blobs.

The reference packs every frame's raw `.crt` bytes back-to-back and records
`{frameNumber, keyframeNumber, startBytePosition, vertices, faces,
meshLength}` per frame plus `{frameRate, maxVertices, maxTriangles}` in a
sibling JSON `.manifest` (writer: deprecated/encoder/src/Encoder30.js:113-178;
reader: src/V1/player.ts:179-204 + byte-range fetches in src/V1/worker.ts:37-41).

This module is the container layer only — frame payload encode/decode lives
in `uvol_tpu_torch.codecs.corto`.

The port's copy of `uvol_tpu/containers/drcs.py`.
"""

from __future__ import annotations

import io
import json
import os
from typing import BinaryIO, Iterable, List, Optional, Tuple, Union

from uvol_tpu_torch.interfaces import V1FrameData, V1Schema


class DrcsWriter:
    """Streamingly packs `.crt` frame blobs and builds the V1 manifest."""

    def __init__(self, frame_rate: float = 30.0) -> None:
        self.frame_rate = frame_rate
        self._buf = io.BytesIO()
        self._frames: List[V1FrameData] = []
        self._max_vertices = 0
        self._max_faces = 0
        self._last_keyframe = 0

    def add_frame(
        self,
        crt_bytes: bytes,
        *,
        vertices: int,
        faces: int,
        is_keyframe: bool = True,
    ) -> None:
        i = len(self._frames)
        if is_keyframe:
            self._last_keyframe = i
        self._frames.append(
            V1FrameData(
                frameNumber=i,
                keyframeNumber=self._last_keyframe,
                startBytePosition=self._buf.tell(),
                vertices=vertices,
                faces=faces,
                meshLength=len(crt_bytes),
            )
        )
        self._max_vertices = max(self._max_vertices, vertices)
        self._max_faces = max(self._max_faces, faces)
        self._buf.write(crt_bytes)

    @property
    def manifest(self) -> V1Schema:
        return V1Schema(
            maxVertices=self._max_vertices,
            maxTriangles=self._max_faces,
            frameData=list(self._frames),
            frameRate=self.frame_rate,
        )

    def getvalue(self) -> bytes:
        return self._buf.getvalue()

    def save(self, drcs_path: str, manifest_path: Optional[str] = None) -> None:
        """Write `.drcs` plus its `.manifest` (name derived like the
        reference: Encoder30.js:166 replaces 'drcs' with 'manifest')."""
        if manifest_path is None:
            root, ext = os.path.splitext(drcs_path)
            manifest_path = root + ".manifest"
        with open(drcs_path, "wb") as f:
            f.write(self.getvalue())
        with open(manifest_path, "w") as f:
            json.dump(self.manifest.to_json(), f)


class DrcsReader:
    """Random access into a `.drcs` blob via the V1 manifest.

    Mirrors the worker's byte-range fetch (src/V1/worker.ts:37-41): a frame
    range maps to one contiguous byte range
    [frameData[start].startBytePosition,
     frameData[end].startBytePosition + frameData[end].meshLength).
    """

    def __init__(self, manifest: V1Schema, source: Union[bytes, BinaryIO, str]):
        self.manifest = manifest
        if isinstance(source, str):
            self._fh: BinaryIO = open(source, "rb")
            self._owned = True
        elif isinstance(source, (bytes, bytearray, memoryview)):
            self._fh = io.BytesIO(bytes(source))
            self._owned = True
        else:
            self._fh = source
            self._owned = False

    @classmethod
    def open(cls, drcs_path: str, manifest_path: Optional[str] = None) -> "DrcsReader":
        if manifest_path is None:
            root, _ = os.path.splitext(drcs_path)
            manifest_path = root + ".manifest"
        with open(manifest_path) as f:
            manifest = V1Schema.from_json(json.load(f))
        return cls(manifest, drcs_path)

    def byte_range(self, frame_start: int, frame_end: int) -> Tuple[int, int]:
        """Inclusive frame range → [start_byte, end_byte) of the blob."""
        fd = self.manifest.frameData
        start = fd[frame_start].startBytePosition
        end = fd[frame_end].startBytePosition + fd[frame_end].meshLength
        return start, end

    def read_frame(self, frame: int) -> bytes:
        fd = self.manifest.frameData[frame]
        self._fh.seek(fd.startBytePosition)
        return self._fh.read(fd.meshLength)

    def read_frames(self, frame_start: int, frame_end: int) -> List[bytes]:
        """Inclusive range, single contiguous read (range-request shaped)."""
        start, end = self.byte_range(frame_start, frame_end)
        self._fh.seek(start)
        blob = self._fh.read(end - start)
        out = []
        for i in range(frame_start, frame_end + 1):
            fd = self.manifest.frameData[i]
            o = fd.startBytePosition - start
            out.append(blob[o : o + fd.meshLength])
        return out

    def close(self) -> None:
        if self._owned:
            self._fh.close()

    def __enter__(self) -> "DrcsReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
