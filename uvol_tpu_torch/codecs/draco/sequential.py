"""Draco sequential mesh + point-cloud coding (encode and decode).

The port's copy of `uvol_tpu/codecs/draco/sequential.py`, unchanged in what it emits; it
calls the port's own native library (`uvol_tpu_torch.native`).

The second connectivity method of the Draco format (the reference player's
draco_decoder.wasm accepts both, src/lib/DRACOLoader.js:483): no
Edgebreaker — faces are stored as delta-coded index symbols and attribute
values in linear point order. draco_encoder selects it for low compression
levels and degenerate meshes; point clouds (encoder_type 0) use the same
sequential attribute coding (the KD-tree method is not implemented —
`NotImplementedError` with a clear message).

No sequential fixtures exist in the reference corpus, so (unlike the
edgebreaker path, which is golden-validated on liam) this module's parity
evidence is self-consistency plus layout fidelity to the documented
format: header, varint counts, connectivity method byte, zigzag
delta-coded indices, and the same sequential attribute decoders used by
the edgebreaker path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from uvol_tpu_torch.codecs.buffer import DecoderBuffer, EncoderBuffer
from uvol_tpu_torch.codecs.draco import constants as K
from uvol_tpu_torch.codecs.symbol_coding import (
    convert_signed_to_symbols,
    convert_symbols_to_signed,
    decode_symbols,
    encode_symbols,
)

SEQUENTIAL_COMPRESSED_INDICES = 0
SEQUENTIAL_UNCOMPRESSED_INDICES = 1


# ---------------------------------------------------------------------------
# Attribute payloads (linear point order; difference prediction)
# ---------------------------------------------------------------------------


def _write_attribute(out: EncoderBuffer, att, num_values: int) -> None:
    from uvol_tpu_torch.codecs.draco.encoder import (
        WrapEncoder,
        _encode_difference,
        quantize_attribute,
    )

    values = att.values[: num_values]
    if att.integer:
        ints = np.asarray(values, np.int64).reshape(num_values, -1)
        q = None
    else:
        q = quantize_attribute(values, att.quantization_bits)
        ints = q.ints
    out.u8(K.PREDICTION_DIFFERENCE & 0xFF)
    out.u8(K.PREDICTION_TRANSFORM_WRAP)
    out.u8(1)  # compressed
    corr, wrap = _encode_difference(ints)
    encode_symbols(convert_signed_to_symbols(corr.reshape(-1)), ints.shape[1], out)
    wrap.write(out)
    if q is not None:
        out.raw(np.asarray(q.mins, "<f4").tobytes())
        out.raw(np.asarray([q.range_value], "<f4").tobytes())
        out.u8(q.bits)


def _read_attribute(buf: DecoderBuffer, attr, num_values: int) -> np.ndarray:
    from uvol_tpu_torch.codecs.draco.attributes import WrapTransform, decode_difference

    nc = attr.num_components
    method = buf.u8()
    method = method - 256 if method >= 128 else method
    if method != K.PREDICTION_NONE:
        transform = buf.u8()
        if transform != K.PREDICTION_TRANSFORM_WRAP:
            raise NotImplementedError(f"transform {transform}")
    if not buf.u8():
        raise NotImplementedError("uncompressed sequential attributes")
    symbols = decode_symbols(num_values * nc, nc, buf)
    signed = convert_symbols_to_signed(symbols).astype(np.int64)
    if method == K.PREDICTION_DIFFERENCE:
        wrap = WrapTransform(buf)
        ints = decode_difference(signed, nc, wrap)
    elif method == K.PREDICTION_NONE:
        ints = signed.reshape(num_values, nc)
    else:
        raise NotImplementedError(f"sequential prediction {method}")
    if attr.data_type == K.DT_FLOAT32:
        mins = np.frombuffer(buf.raw(4 * nc), "<f4").astype(np.float64)
        rng = float(np.frombuffer(buf.raw(4), "<f4")[0])
        qbits = buf.u8()
        delta = rng / ((1 << qbits) - 1)
        return (mins + ints * delta).astype(np.float32)
    from uvol_tpu_torch.codecs.draco.decoder import integer_dtype

    return ints.astype(integer_dtype(attr.data_type))


def _write_attribute_headers(out: EncoderBuffer, attributes) -> None:
    out.u8(len(attributes))
    for i, att in enumerate(attributes):
        out.u8(0xFF)  # att_data_id -1 (no attribute connectivity)
        out.u8(K.MESH_VERTEX_ATTRIBUTE)
        out.u8(K.MESH_TRAVERSAL_DEPTH_FIRST)
    for i, att in enumerate(attributes):
        out.varint(1)
        out.u8(att.attribute_type)
        out.u8(
            K.DT_UINT8
            if att.integer and att.values.dtype == np.uint8
            else (K.DT_INT32 if att.integer else K.DT_FLOAT32)
        )
        out.u8(att.values.shape[1])
        out.u8(0)
        out.varint(i)
        out.u8(K.SEQ_INTEGER if att.integer else K.SEQ_QUANTIZATION)


def _read_attribute_headers(buf: DecoderBuffer):
    from uvol_tpu_torch.codecs.draco.decoder import DracoAttribute

    num_decoders = buf.u8()
    for _ in range(num_decoders):
        buf.u8()  # att_data_id
        buf.u8()  # decoder type
        buf.u8()  # traversal
    attrs: List[DracoAttribute] = []
    seq_types: List[int] = []
    for _ in range(num_decoders):
        n_att = buf.varint()
        for _ in range(n_att):
            att_type = buf.u8()
            dtype = buf.u8()
            comps = buf.u8()
            norm = buf.u8()
            uid = buf.varint()
            attrs.append(DracoAttribute(att_type, dtype, comps, bool(norm), uid))
        for _ in range(n_att):
            seq_types.append(buf.u8())
    return attrs, seq_types


# ---------------------------------------------------------------------------
# Sequential mesh
# ---------------------------------------------------------------------------


def encode_drc_sequential(faces: np.ndarray, attributes: List) -> bytes:
    """Sequential-method `.drc`: delta-coded indices + linear attributes."""
    faces = np.asarray(faces, np.int64)
    num_points = len(attributes[0].values)
    out = EncoderBuffer()
    out.raw(K.MAGIC)
    out.u8(2)
    out.u8(2)
    out.u8(K.TRIANGULAR_MESH)
    out.u8(K.MESH_SEQUENTIAL_ENCODING)
    out.u16(0)
    out.varint(len(faces))
    out.varint(num_points)
    out.u8(SEQUENTIAL_COMPRESSED_INDICES)
    flat = faces.reshape(-1)
    deltas = np.diff(flat, prepend=0)
    encode_symbols(convert_signed_to_symbols(deltas), 1, out)
    _write_attribute_headers(out, attributes)
    for att in attributes:
        _write_attribute(out, att, num_points)
    return out.getvalue()


def decode_drc_sequential(buf: DecoderBuffer):
    """Decode after the 11-byte header; returns a DracoMesh."""
    from uvol_tpu_torch.codecs.draco.decoder import DracoMesh

    num_faces = buf.varint()
    num_points = buf.varint()
    method = buf.u8()
    if method == SEQUENTIAL_COMPRESSED_INDICES:
        syms = decode_symbols(num_faces * 3, 1, buf)
        deltas = convert_symbols_to_signed(syms).astype(np.int64)
        flat = np.cumsum(deltas)
    elif method == SEQUENTIAL_UNCOMPRESSED_INDICES:
        if num_points < 256:
            flat = np.frombuffer(buf.raw(3 * num_faces), np.uint8).astype(np.int64)
        elif num_points < (1 << 16):
            flat = np.frombuffer(buf.raw(6 * num_faces), "<u2").astype(np.int64)
        else:
            flat = np.frombuffer(buf.raw(12 * num_faces), "<u4").astype(np.int64)
    else:
        raise NotImplementedError(f"sequential index method {method}")
    faces = flat.reshape(num_faces, 3).astype(np.int32)

    attrs, seq_types = _read_attribute_headers(buf)
    for attr in attrs:
        attr.values = _read_attribute(buf, attr, num_points)
        attr.corner_to_value = faces.reshape(-1).astype(np.int64)
    mesh = DracoMesh(faces=faces, attributes=attrs, num_points=num_points)
    mesh._point_of_corner = faces.reshape(-1).astype(np.int64)
    return mesh


# ---------------------------------------------------------------------------
# Point clouds (sequential attribute coding)
# ---------------------------------------------------------------------------

POINT_CLOUD_SEQUENTIAL_ENCODING = 0
POINT_CLOUD_KD_TREE_ENCODING = 1
#: UVT KD profile (codecs/draco/kdtree.py) — outside Draco's id space
UVT_KD_TREE_METHOD = 16


def encode_drc_point_cloud(attributes: List) -> bytes:
    num_points = len(attributes[0].values)
    out = EncoderBuffer()
    out.raw(K.MAGIC)
    out.u8(2)
    out.u8(2)
    out.u8(K.POINT_CLOUD)
    out.u8(POINT_CLOUD_SEQUENTIAL_ENCODING)
    out.u16(0)
    out.varint(num_points)
    _write_attribute_headers(out, attributes)
    for att in attributes:
        _write_attribute(out, att, num_points)
    return out.getvalue()


def decode_drc_point_cloud(buf: DecoderBuffer, method: int):
    from uvol_tpu_torch.codecs.draco.decoder import DracoMesh

    if method == POINT_CLOUD_KD_TREE_ENCODING:
        raise NotImplementedError(
            "Draco's own KD-tree bitstream is not supported (no spec or "
            "fixtures offline; see codecs/draco/kdtree.py for the UVT "
            "KD profile that carries the same capability)"
        )
    if method == UVT_KD_TREE_METHOD:
        from uvol_tpu_torch.codecs.draco.kdtree import decode_drc_point_cloud_kdtree

        return decode_drc_point_cloud_kdtree(buf)
    if method != POINT_CLOUD_SEQUENTIAL_ENCODING:
        raise NotImplementedError(f"point cloud method {method}")
    num_points = buf.varint()
    attrs, seq_types = _read_attribute_headers(buf)
    ids = np.arange(num_points, dtype=np.int64)
    for attr in attrs:
        attr.values = _read_attribute(buf, attr, num_points)
        attr.corner_to_value = ids
    mesh = DracoMesh(
        faces=np.zeros((0, 3), np.int32), attributes=attrs, num_points=num_points
    )
    mesh._point_of_corner = ids
    return mesh
