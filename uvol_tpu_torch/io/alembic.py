"""Alembic-style `.abc` archives over spec Ogawa — the ABC ingest path.

Replaces the reference's Blender-based Alembic import
(scripts/Encoder.py:207-242: `bpy.ops.wm.alembic_import` + per-frame OBJ
export) with a direct reader: no subprocess, no DCC dependency, frames
stream straight into the sequence encoder.

SCOPE (honest): the Ogawa *container* layer (io/ogawa.py) is the real,
publicly documented format, so genuine `.abc` files parse at the
group/data level. The object/property schema stacked on it here is a
documented profile ("UVT-ABC") that mirrors AbcCoreOgawa's shape (root
slots → object tree → typed sampled properties) but is NOT bit-compatible
with Alembic's property-header packing, which is unverifiable in this
offline environment (zero egress, no fixtures, no reference library).
Files written by `write_abc_polymesh` declare themselves via the archive
info blob; `read_abc` refuses foreign archives with a clear error instead
of misparsing them.

Layout (all integers LE):

  root group — 4 slots (cf. AbcCoreOgawa's fixed root):
    0 data  archive info: magic ``UVT-ABC`` + u8 version + u32 api
    1 group top object
    2 data  archive metadata: utf-8 ``key=value`` lines
    3 data  time samplings: u32 count, then per sampling
            f64 start_time, f64 time_per_sample
  object group:
    0 data  header: u16-len name, u16-len schema, u16-len metadata
    1 group properties
    2..     child object groups
  property group:
    0 data  header: u16-len name, u8 pod, u8 extent,
            u32 time_sampling_index, u32 num_samples
    1..     one data blob per sample (raw LE array, [n, extent])

PolyMesh schema (``uvtAbcGeom_PolyMesh_v1``) properties: ``P`` (f32×3
positions), ``.faceIndices`` (i32×1), ``.faceCounts`` (i32×1), optional
``uv`` (f32×2, per-point). Polygons are fan-triangulated on read.

The port's copy of `uvol_tpu/io/alembic.py` (the archive's
`writer` metadata keeps the reference's value, so both write the same bytes).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from uvol_tpu_torch.io.ogawa import GroupSpec, OgawaGroup, OgawaReader, write_ogawa

ABC_MAGIC = b"UVT-ABC"
ABC_VERSION = 1
API_VERSION = 1
POLYMESH_SCHEMA = "uvtAbcGeom_PolyMesh_v1"

_POD_DTYPES = {
    0: np.dtype("<f4"),
    1: np.dtype("<f8"),
    2: np.dtype("<i4"),
    3: np.dtype("<u4"),
    4: np.dtype("<u1"),
}
_DTYPE_PODS = {v: k for k, v in _POD_DTYPES.items()}


def _pstr(s: str) -> bytes:
    data = s.encode()
    return struct.pack("<H", len(data)) + data


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        (v,) = struct.unpack_from("<H", self.data, self.pos)
        self.pos += 2
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.data, self.pos)
        self.pos += 8
        return v

    def string(self) -> str:
        n = self.u16()
        s = self.data[self.pos : self.pos + n].decode()
        self.pos += n
        return s


@dataclasses.dataclass
class AbcProperty:
    name: str
    pod: int
    extent: int
    time_sampling_index: int
    samples: List[np.ndarray]  # lazily-read [n, extent] arrays


@dataclasses.dataclass
class AbcObject:
    name: str
    schema: str
    metadata: str
    properties: Dict[str, AbcProperty]
    children: List["AbcObject"]

    def find_schema(self, schema: str) -> Optional["AbcObject"]:
        if self.schema == schema:
            return self
        for c in self.children:
            hit = c.find_schema(schema)
            if hit is not None:
                return hit
        return None


@dataclasses.dataclass
class AbcArchive:
    metadata: Dict[str, str]
    time_samplings: List[Tuple[float, float]]  # (start, per-sample dt)
    top: AbcObject

    @property
    def fps(self) -> float:
        """Frame rate implied by time sampling 0 (after the default)."""
        if len(self.time_samplings) > 1 and self.time_samplings[1][1] > 0:
            return 1.0 / self.time_samplings[1][1]
        return 30.0


def _read_property(g: OgawaGroup) -> AbcProperty:
    c = _Cursor(g.data(0).read())
    name = c.string()
    pod = c.u8()
    extent = c.u8()
    tsi = c.u32()
    nsamp = c.u32()
    if pod not in _POD_DTYPES:
        raise ValueError(f"abc: unknown pod {pod} in property {name!r}")
    if nsamp != len(g) - 1:
        raise ValueError(
            f"abc: property {name!r} declares {nsamp} samples, "
            f"group holds {len(g) - 1}"
        )
    dt = _POD_DTYPES[pod]
    samples = []
    for i in range(1, len(g)):
        raw = g.data(i).read()
        arr = np.frombuffer(raw, dt)
        if extent > 1:
            if len(arr) % extent:
                raise ValueError(f"abc: ragged sample in {name!r}")
            arr = arr.reshape(-1, extent)
        samples.append(arr)
    return AbcProperty(name, pod, extent, tsi, samples)


def _read_object(g: OgawaGroup) -> AbcObject:
    c = _Cursor(g.data(0).read())
    name, schema, metadata = c.string(), c.string(), c.string()
    props: Dict[str, AbcProperty] = {}
    pg = g.group(1)
    for i in range(len(pg)):
        p = _read_property(pg.group(i))
        props[p.name] = p
    children = [_read_object(g.group(i)) for i in range(2, len(g))]
    return AbcObject(name, schema, metadata, props, children)


def read_abc(src: Union[bytes, str]) -> AbcArchive:
    if isinstance(src, str):
        with open(src, "rb") as f:
            src = f.read()
    root = OgawaReader(src).root
    if len(root) < 4 or not root.is_data(0):
        raise ValueError("abc: not a UVT-ABC archive (bad root shape)")
    info = root.data(0).read()
    if not info.startswith(ABC_MAGIC):
        raise ValueError(
            "abc: foreign Alembic archive — the Ogawa container parsed, "
            "but this reader only understands the documented UVT-ABC "
            "profile (see io/alembic.py docstring); real AbcCoreOgawa "
            "archives need tooling unavailable offline"
        )
    meta: Dict[str, str] = {}
    for line in root.data(2).read().decode().splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            meta[k] = v
    c = _Cursor(root.data(3).read())
    ts = [(c.f64(), c.f64()) for _ in range(c.u32())]
    return AbcArchive(meta, ts, _read_object(root.group(1)))


# ---------------------------------------------------------------------------
# PolyMesh convenience layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PolyMeshSample:
    positions: np.ndarray  # [N, 3] float32
    faces: np.ndarray  # [M, 3] int32 (fan-triangulated)
    uvs: Optional[np.ndarray]  # [N, 2] float32 or None


def _triangulate(indices: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Fan-triangulate polygon soup (counts ≥ 3) into [M, 3] int32."""
    if (counts < 3).any():
        raise ValueError("abc: polygon with fewer than 3 vertices")
    if (counts == 3).all():
        return indices.reshape(-1, 3).astype(np.int32)
    tris = []
    pos = 0
    for n in counts:
        poly = indices[pos : pos + n]
        for k in range(1, n - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))
        pos += n
    return np.asarray(tris, np.int32)


class AbcPolyMesh:
    """Sampled polymesh view over an archive (first PolyMesh object)."""

    def __init__(self, archive: AbcArchive):
        obj = archive.top.find_schema(POLYMESH_SCHEMA)
        if obj is None:
            raise ValueError("abc: archive contains no PolyMesh object")
        self.archive = archive
        self.object = obj
        self._p = obj.properties["P"]
        self._fi = obj.properties[".faceIndices"]
        self._fc = obj.properties[".faceCounts"]
        self._uv = obj.properties.get("uv")
        self.num_samples = len(self._p.samples)
        for prop in (self._fi, self._fc, self._uv):
            if prop is not None and len(prop.samples) not in (
                1, self.num_samples
            ):
                raise ValueError(
                    f"abc: property {prop.name!r} holds "
                    f"{len(prop.samples)} samples, expected 1 (constant) "
                    f"or {self.num_samples} (matching P)"
                )

    def sample(self, i: int) -> PolyMeshSample:
        def pick(prop):  # constant properties hold one sample
            return prop.samples[i if len(prop.samples) > 1 else 0]

        faces = _triangulate(
            np.asarray(pick(self._fi)).reshape(-1),
            np.asarray(pick(self._fc)).reshape(-1),
        )
        uv = pick(self._uv).astype(np.float32) if self._uv else None
        return PolyMeshSample(
            positions=pick(self._p).astype(np.float32),
            faces=faces,
            uvs=uv,
        )


def _property_spec(
    name: str, arrays: Sequence[np.ndarray], extent: int, tsi: int = 1
) -> GroupSpec:
    dt = np.asarray(arrays[0]).dtype
    pod = _DTYPE_PODS[np.dtype(dt).newbyteorder("<")]
    header = (
        _pstr(name)
        + struct.pack("<BB", pod, extent)
        + struct.pack("<II", tsi, len(arrays))
    )
    g = GroupSpec([header])
    for a in arrays:
        g.add(np.ascontiguousarray(a, np.dtype(dt).newbyteorder("<")).tobytes())
    return g


def write_abc_polymesh(
    samples: Sequence[PolyMeshSample],
    *,
    fps: float = 30.0,
    name: str = "mesh",
    metadata: Optional[Dict[str, str]] = None,
) -> bytes:
    """Serialize a PolyMesh sample sequence as a UVT-ABC archive."""
    if not samples:
        raise ValueError("abc: need at least one sample")
    pos = [np.asarray(s.positions, "<f4") for s in samples]
    fi = [np.asarray(s.faces, "<i4").reshape(-1) for s in samples]
    fc = [
        np.full(len(np.asarray(s.faces).reshape(-1, 3)), 3, "<i4")
        for s in samples
    ]
    props = GroupSpec(
        [
            _property_spec("P", pos, 3),
            _property_spec(".faceIndices", fi, 1),
            _property_spec(".faceCounts", fc, 1),
        ]
    )
    if samples[0].uvs is not None:
        props.add(
            _property_spec(
                "uv", [np.asarray(s.uvs, "<f4") for s in samples], 2
            )
        )
    mesh_obj = GroupSpec(
        [_pstr(name) + _pstr(POLYMESH_SCHEMA) + _pstr(""), props]
    )
    top = GroupSpec([_pstr("ABC") + _pstr("") + _pstr(""), GroupSpec(), mesh_obj])
    meta = dict(metadata or {})
    meta.setdefault("writer", "uvol_tpu")
    meta_blob = "\n".join(f"{k}={v}" for k, v in sorted(meta.items())).encode()
    # sampling 0 = default static, 1 = the uniform per-frame sampling
    ts_blob = struct.pack("<I", 2) + struct.pack(
        "<dddd", 0.0, 1.0, 0.0, 1.0 / fps
    )
    info = ABC_MAGIC + struct.pack("<BI", ABC_VERSION, API_VERSION)
    return write_ogawa(GroupSpec([info, top, meta_blob, ts_blob]))
