# Frozen copy of the program's `codecs/draco/decoder.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""Top-level Draco `.drc` mesh decoder: a frozen copy of the staged Python
decoder, with the native fast path and the sRGB colour helpers cut.

Decodes real Draco 2.2 edgebreaker files (the format consumed by the
reference player through draco_decoder.wasm — src/V2/player.ts:101) into
point-indexed arrays shaped like the reference's BufferGeometry assembly
(`src/lib/DRACOLoader.js:189-220`): `faces` indexes points, each attribute
is an array with one value per point.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from uvbench.ref.codecs.buffer import DecoderBuffer
from uvbench.ref.codecs.draco import constants as K
from uvbench.ref.codecs.draco.attributes import (
    GeometricNormalPredictor,
    TexCoordsPortablePredictor,
    WrapTransform,
    decode_constrained_multi_parallelogram,
    decode_difference,
    decode_parallelogram,
)
from uvbench.ref.codecs.draco.corner_table import (
    INVALID,
    MeshAttributeCornerTable,
)
from uvbench.ref.codecs.draco.edgebreaker import decode_edgebreaker_connectivity
from uvbench.ref.codecs.draco.traverser import (
    _TableView,
    traverse_depth_first,
    traverse_prediction_degree,
)
from uvbench.ref.codecs.symbol_coding import (
    convert_symbols_to_signed,
    decode_symbols,
)


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


def decode_drc(data: bytes) -> DracoMesh:
    """A `.drc` frame's mesh, by the staged Python pipeline."""
    return _decode_drc(data)


def _decode_drc(data: bytes) -> DracoMesh:
    buf = DecoderBuffer(data)
    if buf.raw(5) != K.MAGIC:
        raise ValueError("not a Draco file")
    major, minor = buf.u8(), buf.u8()
    if (major, minor) < (2, 2):
        raise NotImplementedError(f"bitstream {major}.{minor} < 2.2")
    encoder_type = buf.u8()
    method = buf.u8()
    flags = buf.u16()
    if flags & K.METADATA_FLAG_MASK:
        _skip_metadata(buf)
    if encoder_type == K.POINT_CLOUD:
        from uvbench.ref.codecs.draco.sequential import decode_drc_point_cloud

        return decode_drc_point_cloud(buf, method)
    if encoder_type != K.TRIANGULAR_MESH:
        raise NotImplementedError(f"encoder type {encoder_type}")
    if method == K.MESH_SEQUENTIAL_ENCODING:
        from uvbench.ref.codecs.draco.sequential import decode_drc_sequential

        return decode_drc_sequential(buf)
    if method != K.MESH_EDGEBREAKER_ENCODING:
        raise NotImplementedError(f"mesh encoding method {method}")

    conn = decode_edgebreaker_connectivity(buf)
    ct = conn.corner_table
    num_faces = len(ct.faces())

    # ---- attribute decoder headers ----------------------------------------
    num_decoders = buf.u8()
    headers = []
    for _ in range(num_decoders):
        att_data_id = _i8(buf.u8())
        decoder_type = buf.u8()
        traversal = buf.u8()
        if traversal not in (
            K.MESH_TRAVERSAL_DEPTH_FIRST,
            K.MESH_TRAVERSAL_PREDICTION_DEGREE,
        ):
            raise NotImplementedError(f"traversal method {traversal}")
        if (
            traversal == K.MESH_TRAVERSAL_PREDICTION_DEGREE
            and decoder_type != K.MESH_VERTEX_ATTRIBUTE
        ):
            # Draco only wires MaxPredictionDegreeTraverser for vertex
            # decoders; corner-mapped attributes are depth-first-only
            raise ValueError(
                "prediction-degree traversal is only valid for "
                "vertex-attribute decoders"
            )
        headers.append((int(att_data_id), decoder_type, traversal))
    decoders = []
    for att_data_id, decoder_type, traversal in headers:
        n_att = buf.varint()
        attrs = []
        for _ in range(n_att):
            att_type = buf.u8()
            dtype = buf.u8()
            comps = buf.u8()
            norm = buf.u8()
            uid = buf.varint()
            attrs.append(DracoAttribute(att_type, dtype, comps, bool(norm), uid))
        seq_types = [buf.u8() for _ in range(n_att)]
        decoders.append((att_data_id, decoder_type, traversal, attrs, seq_types))

    # ---- per-decoder attribute decode -------------------------------------
    pos_values: Optional[np.ndarray] = None  # portable ints, for predictors
    pos_vertex_to_data: Optional[np.ndarray] = None
    all_attributes: List[DracoAttribute] = []
    corner_maps: List[np.ndarray] = []  # per attribute: corner -> value index

    for att_data_id, decoder_type, traversal, attrs, seq_types in decoders:
        if decoder_type == K.MESH_CORNER_ATTRIBUTE:
            att_table = MeshAttributeCornerTable(
                ct, conn.attribute_seam_corners[att_data_id]
            )
            view = _TableView(att_table, num_faces)
            corner_vertex = att_table.corner_to_vertex
        else:
            view = _TableView(ct, num_faces)
            corner_vertex = ct.vertex
        traverse = (
            traverse_prediction_degree
            if traversal == K.MESH_TRAVERSAL_PREDICTION_DEGREE
            else traverse_depth_first
        )
        vertex_to_data, data_to_corner = traverse(
            att_table if decoder_type == K.MESH_CORNER_ATTRIBUTE else ct,
            num_faces,
            corner_order=conn.processed_corners,
        )
        num_values = len(data_to_corner)

        def pos_for_corner(c, _pv=None):
            return pos_values[pos_vertex_to_data[ct.vertex[c]]]

        # corner -> position-data index (the native predictors take arrays)
        pos_corner_map = (
            np.asarray(
                pos_vertex_to_data[ct.vertex[: 3 * num_faces]], np.int32
            )
            if pos_values is not None
            else None
        )

        for attr, seq_type in zip(attrs, seq_types):
            nc = attr.num_components
            if seq_type in (K.SEQ_INTEGER, K.SEQ_QUANTIZATION):
                method_b = _i8(buf.u8())
                transform = None
                if method_b != K.PREDICTION_NONE:
                    transform_type = _i8(buf.u8())
                    if transform_type != K.PREDICTION_TRANSFORM_WRAP:
                        raise NotImplementedError(
                            f"transform {transform_type} for integer attrs"
                        )
                compressed = buf.u8()
                if compressed:
                    symbols = decode_symbols(num_values * nc, nc, buf)
                else:
                    symbols = _read_raw_values(buf, num_values * nc)
                # correction sign convention is per scheme (validated on the
                # liam corpus histograms): parallelogram/difference use
                # zigzag-signed corrections, tex-coords-portable uses
                # positive modular corrections
                signed = convert_symbols_to_signed(symbols).astype(np.int64)
                if method_b == K.PREDICTION_NONE:
                    ints = signed.reshape(num_values, nc)
                elif method_b == K.PREDICTION_DIFFERENCE:
                    wrap = WrapTransform(buf)
                    ints = decode_difference(signed, nc, wrap)
                elif method_b == K.MESH_PREDICTION_PARALLELOGRAM:
                    wrap = WrapTransform(buf)
                    ints = decode_parallelogram(
                        signed, nc, wrap, view, vertex_to_data, data_to_corner
                    )
                elif (
                    method_b
                    == K.MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM
                ):
                    # prediction data (crease flags + wrap bounds) is read
                    # from `buf` inside — it follows the symbol block
                    ints = decode_constrained_multi_parallelogram(
                        signed, nc, buf, view, vertex_to_data, data_to_corner
                    )
                elif method_b == K.MESH_PREDICTION_TEX_COORDS_PORTABLE:
                    pred = TexCoordsPortablePredictor(
                        buf, view, vertex_to_data, pos_for_corner,
                        pos_values=pos_values,
                        pos_data_of_corner=pos_corner_map,
                    )
                    wrap = WrapTransform(buf)
                    ints = pred.decode(
                        symbols.astype(np.int64), wrap, data_to_corner
                    )
                else:
                    raise NotImplementedError(f"prediction method {method_b}")

                if seq_type == K.SEQ_QUANTIZATION:
                    mins = np.frombuffer(buf.raw(4 * nc), "<f4").astype(np.float64)
                    rng = float(np.frombuffer(buf.raw(4), "<f4")[0])
                    qbits = buf.u8()
                    delta = rng / ((1 << qbits) - 1)
                    attr.values = (mins + ints * delta).astype(np.float32)
                else:
                    # honor the declared wire data_type (DT_UINT8 generics
                    # round-trip as uint8, not int64)
                    attr.values = ints.astype(integer_dtype(attr.data_type))
                if attr.attribute_type == K.ATT_POSITION:
                    pos_values = ints
                    pos_vertex_to_data = vertex_to_data

            elif seq_type == K.SEQ_NORMALS:
                method_b = _i8(buf.u8())
                transform_type = _i8(buf.u8())
                if (
                    method_b != K.MESH_PREDICTION_GEOMETRIC_NORMAL
                    or transform_type
                    != K.PREDICTION_TRANSFORM_NORMAL_OCTAHEDRON_CANONICALIZED
                ):
                    raise NotImplementedError(
                        f"normals method {method_b} transform {transform_type}"
                    )
                compressed = buf.u8()
                if compressed:
                    symbols = decode_symbols(num_values * 2, 2, buf)
                else:
                    symbols = _read_raw_values(buf, num_values * 2)
                pred = GeometricNormalPredictor(
                    buf, view, pos_for_corner,
                    pos_values=pos_values,
                    pos_data_of_corner=pos_corner_map,
                )
                st = pred.decode(symbols, data_to_corner)
                qbits = buf.u8()  # DecodeDataNeededByPortableTransform
                tb = pred.transform.tool
                # vectorized octahedral -> unit vector (same math as
                # OctahedronToolBox.quantized_octahedral_coords_to_unit_vector)
                u = st[:, 0].astype(np.float64) / tb.max_value * 2.0 - 1.0
                v = st[:, 1].astype(np.float64) / tb.max_value * 2.0 - 1.0
                z = 1.0 - np.abs(u) - np.abs(v)
                neg = z < 0
                su = np.where(u >= 0, 1.0, -1.0)
                sv = np.where(v >= 0, 1.0, -1.0)
                u2 = np.where(neg, (1.0 - np.abs(v)) * su, u)
                v2 = np.where(neg, (1.0 - np.abs(u)) * sv, v)
                nrm = np.sqrt(u2 * u2 + v2 * v2 + z * z)
                out = np.stack(
                    [
                        np.where(nrm == 0, 0.0, u2 / np.maximum(nrm, 1e-30)),
                        np.where(nrm == 0, 0.0, v2 / np.maximum(nrm, 1e-30)),
                        np.where(nrm == 0, 1.0, z / np.maximum(nrm, 1e-30)),
                    ],
                    axis=1,
                ).astype(np.float32)
                attr.values = out
            else:
                raise NotImplementedError(f"sequential decoder type {seq_type}")

            attr.corner_to_value = vertex_to_data[corner_vertex[: 3 * num_faces]]
            all_attributes.append(attr)
            corner_maps.append(attr.corner_to_value)

    # ---- assemble points ---------------------------------------------------
    keys = np.stack(corner_maps, axis=1)  # [num_corners, num_attributes]
    from uvbench.ref import native as uvt_native

    assembled = uvt_native.point_assembly_native(
        keys, [len(a.values) for a in all_attributes]
    )
    if assembled is not None:
        point_of_corner, num_points = assembled
    else:
        # pack each column into bit fields of one int64 when they fit — 1-D
        # unique is ~10x faster than the lexsort behind unique(axis=0)
        widths = [
            max(max(int(keys[:, i].max()), 0).bit_length(), 1)
            for i in range(keys.shape[1])
        ]
        # negative entries (INVALID on malformed streams) would smear sign
        # bits across the packed columns — the unique(axis=0) path handles
        # them correctly
        if sum(widths) <= 63 and int(keys.min()) >= 0:
            packed = np.zeros(len(keys), np.int64)
            shift = 0
            for i in range(keys.shape[1] - 1, -1, -1):
                packed |= keys[:, i].astype(np.int64) << shift
                shift += widths[i]
            uniq_keys, point_of_corner = np.unique(packed, return_inverse=True)
            uniq = np.empty((len(uniq_keys), keys.shape[1]), np.int64)  # unused
        else:
            uniq, point_of_corner = np.unique(keys, axis=0, return_inverse=True)
        # renumber points by first appearance (corner order), like Draco
        first_seen = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
        np.minimum.at(
            first_seen, point_of_corner, np.arange(len(point_of_corner))
        )
        order = np.argsort(first_seen, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        point_of_corner = rank[point_of_corner]
        num_points = len(uniq)

    faces = point_of_corner.reshape(-1, 3).astype(np.int32, copy=False)
    mesh = DracoMesh(faces=faces, attributes=all_attributes, num_points=num_points)
    mesh._point_of_corner = point_of_corner
    if buf.remaining() != 0:
        raise ValueError(f"{buf.remaining()} undecoded bytes at end of stream")
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


def _i8(v: int) -> int:
    return v - 256 if v >= 128 else v


def _read_raw_values(buf: DecoderBuffer, num_values: int) -> np.ndarray:
    """compressed=0 storage: u8 byte-width, then each value as that many
    little-endian bytes (4 ⇒ one contiguous int32 block). The values are
    the same zigzag/positive symbols the compressed path carries."""
    nb = buf.u8()
    if nb == 4:
        return np.frombuffer(buf.raw(4 * num_values), "<u4").astype(np.uint32)
    if nb not in (1, 2, 3):
        raise ValueError(f"invalid raw integer byte width {nb}")
    raw = (
        np.frombuffer(buf.raw(nb * num_values), np.uint8)
        .reshape(num_values, nb)
        .astype(np.uint32)
    )
    shifts = np.arange(nb, dtype=np.uint32) * 8
    return (raw << shifts[None, :]).sum(axis=1, dtype=np.uint32)


def _skip_metadata(buf: DecoderBuffer) -> None:
    """Metadata section (flags bit 15). Attribute + file metadata entries."""
    num_att_metadata = buf.varint()
    for _ in range(num_att_metadata):
        buf.varint()  # attribute id
        _skip_single_metadata(buf)
    _skip_single_metadata(buf)


def _skip_single_metadata(buf: DecoderBuffer) -> None:
    num_entries = buf.varint()
    for _ in range(num_entries):
        for _ in range(2):  # key, value
            n = buf.u8()
            buf.raw(n)
    num_sub = buf.varint()
    for _ in range(num_sub):
        n = buf.u8()
        buf.raw(n)
        _skip_single_metadata(buf)
