"""Top-level Draco `.drc` mesh decoder — the port's copy of
`uvol_tpu/codecs/draco/decoder.py`, cut to its native fast path.

Decodes real Draco 2.2 edgebreaker files into point-indexed arrays shaped
like the reference player's BufferGeometry assembly: `faces` indexes
points, each attribute is an array with one value per point. The whole
frame is one call into the port's copy of the reference's C decoder
(`native.drc_decode_native`, `native/draco_frame.cpp`), as the
reference's `decode_drc` takes it first. The reference falls back to its
staged Python decoder for a stream outside that path (the standard edge
coder, tagged symbols, sequential or point-cloud encodings); the port
has no Python Draco decoder yet (ROADMAP.md §1 item 5) and raises
`NotImplementedError` for such a stream.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from uvol_tpu_torch.codecs.draco import constants as K


@dataclasses.dataclass
class DracoAttribute:
    attribute_type: int  # POSITION / NORMAL / COLOR / TEX_COORD / GENERIC
    data_type: int
    num_components: int
    normalized: bool
    unique_id: int
    values: Optional[np.ndarray] = None  # per attribute-vertex, final dtype
    corner_to_value: Optional[np.ndarray] = None  # corner -> value index


@dataclasses.dataclass
class DracoMesh:
    faces: np.ndarray  # [F, 3] point indices
    attributes: List[DracoAttribute]
    num_points: int

    def attribute_by_type(self, att_type: int) -> Optional[DracoAttribute]:
        for a in self.attributes:
            if a.attribute_type == att_type:
                return a
        return None

    def point_attribute(self, att_type: int) -> Optional[np.ndarray]:
        """Per-point array for an attribute (reference DRACOLoader's
        GetAttributeDataArrayForAllPoints shape)."""
        a = self.attribute_by_type(att_type)
        if a is None:
            return None
        return a.values[self._point_value_index(a)]

    def _point_value_index(self, a: DracoAttribute) -> np.ndarray:
        idx = np.zeros(self.num_points, np.int64)
        idx[self._point_of_corner] = a.corner_to_value
        return idx

    # filled by decoder:
    _point_of_corner: np.ndarray = dataclasses.field(default=None, repr=False)


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Per-component sRGB → linear, the three.js `SRGBToLinear` curve the
    reference applies to Draco vertex colors (src/lib/DRACOLoader.js:
    222-240 `_assignVertexColorSpace` → Color.convertSRGBToLinear).
    Input/output are normalized [0, 1] float."""
    c = np.asarray(c, np.float32)
    return np.where(
        c < 0.04045,
        c * np.float32(0.0773993808),
        (c * np.float32(0.9478672986) + np.float32(0.0521327014)) ** 2.4,
    ).astype(np.float32)


def convert_vertex_colors_srgb_to_linear(mesh: "DracoMesh") -> None:
    """In-place sRGB→linear on every COLOR attribute's RGB channels
    (alpha untouched, like the reference's setXYZ loop). Integer color
    attrs are normalized to [0,1] float32 first — the reference decodes
    every attribute as Float32Array anyway (DRACOLoader.js:36-39)."""
    for a in mesh.attributes:
        if a.attribute_type != K.ATT_COLOR or a.values is None:
            continue
        vals = a.values
        if np.issubdtype(vals.dtype, np.integer):
            scale = np.float32(np.iinfo(vals.dtype).max)
            vals = vals.astype(np.float32) / scale
        else:
            vals = vals.astype(np.float32)
        n = min(3, vals.shape[1])
        vals[:, :n] = srgb_to_linear(vals[:, :n])
        a.values = vals


def decode_drc(data: bytes, *, vertex_color_space: str = "linear") -> DracoMesh:
    """`vertex_color_space="srgb"` mirrors the reference's standalone
    `.load()`/`.parse()` behavior: .drc files don't declare a colorspace,
    official tooling writes sRGB, so vertex colors are converted to
    linear (DRACOLoader.js:222-231). Default "linear" leaves values
    untouched (the glTF-style path)."""
    from uvol_tpu_torch.utils.stats import STATS

    with STATS.timer("draco.decode_s"):
        mesh = _decode_drc_native(data)
        if mesh is None:
            raise NotImplementedError(
                "this .drc stream is outside the native decoder's path (or g++ could not "
                "build the Draco library); the port has no Python Draco decoder yet "
                "(ROADMAP.md §1 item 5)")
        if vertex_color_space == "srgb":
            convert_vertex_colors_srgb_to_linear(mesh)
        elif vertex_color_space != "linear":
            raise ValueError(f"unknown vertex_color_space {vertex_color_space!r}")
        return mesh


def _decode_drc_native(data: bytes) -> Optional[DracoMesh]:
    """Whole-frame native fast path (native/draco_frame.cpp): one C call
    runs container parse → connectivity → traversals → predictions →
    dequantize → point assembly. None for anything the fast path rejects."""
    from uvol_tpu_torch import native

    res = native.drc_decode_native(data)
    if res is None:
        return None
    num_faces, num_points, point_of_corner, raw_attrs = res
    attributes = []
    for att_type, data_type, ncomp, norm, uid, values, corner_map in raw_attrs:
        if values.dtype == np.int64:  # integer attrs: declared wire dtype
            values = values.astype(integer_dtype(data_type))
        attributes.append(
            DracoAttribute(
                att_type, data_type, ncomp, norm, uid,
                values=values, corner_to_value=corner_map,
            )
        )
    faces = point_of_corner.reshape(-1, 3).astype(np.int32, copy=False)
    mesh = DracoMesh(
        faces=faces, attributes=attributes, num_points=num_points
    )
    mesh._point_of_corner = point_of_corner
    return mesh


_INT_DTYPES = {
    K.DT_INT8: np.int8, K.DT_UINT8: np.uint8,
    K.DT_INT16: np.int16, K.DT_UINT16: np.uint16,
    K.DT_INT32: np.int32, K.DT_UINT32: np.uint32,
    K.DT_INT64: np.int64, K.DT_UINT64: np.uint64,
}


def integer_dtype(data_type: int):
    """numpy dtype for a Draco integer data_type (default int64)."""
    return _INT_DTYPES.get(data_type, np.int64)
