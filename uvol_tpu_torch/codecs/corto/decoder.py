"""Corto `.crt` decoder — the UVOL 1.0 geometry frame codec.

Decodes the format produced by the reference's C++ encoder
(deprecated/encoder/dev/src/encoder.cpp) and consumed by its JS worker
decoder (src/lib/corto.ts): header + exif + attribute table, groups, the
CLER front-machine connectivity stream, and the per-attribute
values/array/diffs blocks with parallelogram delta decoding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from uvol_tpu_torch.codecs.corto.stream import CortoInStream

MAGIC = 0x787A6300

# codecs
GENERIC_CODEC = 1
NORMAL_CODEC = 2
COLOR_CODEC = 3

# strategies
PARALLEL = 0x1
CORRELATED = 0x2

# CLER symbols
VERTEX, LEFT, RIGHT, END, BOUNDARY, DELAY, SPLIT = range(7)

# formats
FMT_UINT32, FMT_INT32, FMT_UINT16, FMT_INT16, FMT_UINT8, FMT_INT8, FMT_FLOAT, FMT_DOUBLE = range(8)

# normal predictions
PRED_DIFF, PRED_ESTIMATED, PRED_BORDER = range(3)


@dataclasses.dataclass
class CortoAttribute:
    name: str
    codec: int
    q: float
    components: int
    format: int
    strategy: int
    values: Optional[np.ndarray] = None  # final decoded (nvert, N)
    prediction: int = PRED_DIFF  # normals only
    qc: Optional[List[int]] = None  # colors only


@dataclasses.dataclass
class CortoMesh:
    nvert: int
    nface: int
    faces: np.ndarray  # [nface, 3] int32 (new vertex order)
    attributes: Dict[str, np.ndarray]
    groups: List[dict]
    exif: Dict[str, str]


from uvol_tpu_torch.codecs.corto.stream import ilog2 as _ilog2  # shared helper


def decode_crt(data: bytes) -> CortoMesh:
    s = CortoInStream(data)
    if s.u32() != MAGIC:
        raise ValueError("not a .crt file")
    _version = s.u32()
    s.entropy = s.u8()

    exif = {}
    for _ in range(s.u32()):
        key = s.string()
        exif[key] = s.string()

    attrs: Dict[str, CortoAttribute] = {}
    for _ in range(s.u32()):
        name = s.string()
        codec = s.u32()
        q = s.f32()
        components = s.u8()
        fmt = s.u8()
        strategy = s.u8()
        attrs[name] = CortoAttribute(name, codec, q, components, fmt, strategy)

    nvert = s.u32()
    nface = s.u32()

    groups = _decode_groups(s)

    # whole-frame C decode (native/corto_frame.cpp): one call replaces the
    # staged per-stream glue below.  Bit-exact contract — the staged path
    # is the oracle (tests/test_corto.py) and the fallback for anything
    # the orchestrator rejects (rc<0).  UVT_CRT_STAGED=1 forces staged.
    import os

    if os.environ.get("UVT_CRT_STAGED") != "1":
        from uvol_tpu_torch import native

        res = native.crt_decode_frame_native(data)
        if res is not None:
            nat_faces, nat_attrs, _, _ = res
            return CortoMesh(nvert, nface, nat_faces, nat_attrs, groups, exif)

    if nface == 0:
        return _decode_point_cloud(s, nvert, attrs, groups, exif)

    # connectivity
    _max_front = s.u32()
    clers = s.decompress_block()
    bitstream = s.read_bitstream()
    splitbits = _ilog2(nvert) + 1

    from uvol_tpu_torch import native

    group_ends = [g["end"] for g in groups]
    if native.get_corto_lib() is not None:
        faces, prediction, _vc = native.corto_decode_faces(
            clers, bitstream.a, group_ends, splitbits, nvert, nface
        )
    else:
        faces = np.zeros(nface * 3, np.int64)
        prediction = np.zeros((nvert, 3), np.int64)
        vertex_count = 0
        cler_pos = 0
        start = 0
        for end in group_ends:
            vertex_count, cler_pos = _decode_faces(
                clers, bitstream, faces, prediction, start, end * 3,
                vertex_count, cler_pos, splitbits, nvert,
            )
            start = end * 3

    # attributes: decode -> deltaDecode -> postDelta -> dequantize
    for a in sorted(attrs.values(), key=lambda a: a.name):
        _attr_decode(a, s, nvert)
    for a in attrs.values():
        _attr_delta_decode(a, nvert, prediction)
    for a in attrs.values():
        _attr_post_delta(a, nvert, nface, attrs, faces)
    out = {}
    for a in attrs.values():
        out[a.name] = _attr_dequantize(a, nvert)

    return CortoMesh(
        nvert=nvert,
        nface=nface,
        faces=faces.reshape(-1, 3).astype(np.int32),
        attributes=out,
        groups=groups,
        exif=exif,
    )


def _decode_groups(s: CortoInStream) -> List[dict]:
    groups = []
    for _ in range(s.u32()):
        end = s.u32()
        props = {}
        for _ in range(s.u8()):
            key = s.string()
            props[key] = s.string()
        groups.append({"end": end, "properties": props})
    return groups


def _decode_point_cloud(s, nvert, attrs, groups, exif) -> CortoMesh:
    out = {}
    for a in sorted(attrs.values(), key=lambda a: a.name):
        _attr_decode(a, s, nvert)
    for a in attrs.values():
        _attr_delta_decode(a, nvert, None)
        out[a.name] = _attr_dequantize(a, nvert)
    return CortoMesh(nvert, 0, np.zeros((0, 3), np.int32), out, groups, exif)


# ---------------------------------------------------------------------------
# The CLER front machine (src/lib/corto.ts:142-297)
# ---------------------------------------------------------------------------


def _decode_faces(
    clers, bitstream, faces, prediction, start, end,
    vertex_count, cler, splitbits, nvert,
):
    front_v0: List[int] = []
    front_v1: List[int] = []
    front_v2: List[int] = []
    front_prev: List[int] = []
    front_next: List[int] = []

    def add_front(v0, v1, v2, prev, nxt):
        front_v0.append(v0)
        front_v1.append(v1)
        front_v2.append(v2)
        front_prev.append(prev)
        front_next.append(nxt)

    faceorder: List[int] = []
    order_front = 0
    delayed: List[int] = []
    new_edge = -1

    while start < end:
        if new_edge == -1 and order_front >= len(faceorder) and not delayed:
            # new connected component: initial face
            last_index = vertex_count - 1
            split = 0
            if clers[cler] == SPLIT:
                cler += 1
                split = bitstream.read(3)
            else:
                cler += 1
            vindex = [0, 0, 0]
            for k in range(3):
                if split & (1 << k):
                    v = bitstream.read(splitbits)
                else:
                    prediction[vertex_count] = (last_index, last_index, last_index)
                    v = vertex_count
                    last_index = v
                    vertex_count += 1
                vindex[k] = v
                faces[start] = v
                start += 1
            current_edge = len(front_v0)
            for kk in range(3):
                faceorder.append(len(front_v0))
                a, b, c = vindex[(kk + 1) % 3], vindex[(kk + 2) % 3], vindex[kk]
                add_front(
                    a, b, c,
                    current_edge + (kk + 2) % 3,
                    current_edge + (kk + 1) % 3,
                )
            continue

        if new_edge != -1:
            edge = new_edge
            new_edge = -1
        elif order_front < len(faceorder):
            edge = faceorder[order_front]
            order_front += 1
        else:
            edge = delayed.pop()

        if front_v0[edge] < 0:
            continue  # deleted

        c = clers[cler]
        cler += 1
        if c == BOUNDARY:
            continue

        v0 = front_v0[edge]
        v1 = front_v1[edge]
        v2 = front_v2[edge]
        prev = front_prev[edge]
        nxt = front_next[edge]
        new_edge = len(front_v0)
        opposite = -1

        if c == VERTEX or c == SPLIT:
            if c == SPLIT:
                opposite = bitstream.read(splitbits)
            else:
                prediction[vertex_count] = (v1, v0, v2)
                opposite = vertex_count
                vertex_count += 1
            front_next[prev] = new_edge
            front_prev[nxt] = new_edge + 1
            add_front(v0, opposite, v1, prev, new_edge + 1)
            faceorder.append(len(front_v0))
            add_front(opposite, v1, v0, new_edge, nxt)
        elif c == LEFT:
            front_next[front_prev[prev]] = new_edge
            front_prev[nxt] = new_edge
            opposite = front_v0[prev]
            add_front(opposite, v1, v0, front_prev[prev], nxt)
            front_v0[prev] = -1
        elif c == RIGHT:
            front_prev[front_next[nxt]] = new_edge
            front_next[prev] = new_edge
            opposite = front_v1[nxt]
            add_front(v0, opposite, v1, prev, front_next[nxt])
            front_v0[nxt] = -1
        elif c == DELAY:
            delayed.append(edge)
            new_edge = -1
            continue
        elif c == END:
            front_next[front_prev[prev]] = front_next[nxt]
            front_prev[front_next[nxt]] = front_prev[prev]
            opposite = front_v0[prev]
            front_v0[prev] = -1
            front_v0[nxt] = -1
            new_edge = -1
        else:
            raise ValueError(f"invalid CLER symbol {c}")

        if v1 >= nvert or v0 >= nvert or opposite >= nvert:
            raise ValueError("topological error")
        faces[start] = v1
        faces[start + 1] = v0
        faces[start + 2] = opposite
        start += 3

    return vertex_count, cler


# ---------------------------------------------------------------------------
# Attributes
# ---------------------------------------------------------------------------


def _attr_decode(a: CortoAttribute, s: CortoInStream, nvert: int) -> None:
    if a.codec == NORMAL_CODEC:
        a.prediction = s.u8()
        a.values = s.decode_array(2, nvert)
        return
    if a.codec == COLOR_CODEC:
        a.qc = [s.u8() for _ in range(4)]
    if a.strategy & CORRELATED:
        a.values = s.decode_array(a.components, nvert)
    else:
        a.values = s.decode_values(a.components, nvert)


def _attr_delta_decode(a: CortoAttribute, nvert: int, prediction) -> None:
    v = a.values
    if a.codec == NORMAL_CODEC and a.prediction != PRED_DIFF:
        return
    if prediction is None:
        mode = 2
    elif a.codec != NORMAL_CODEC and (a.strategy & PARALLEL):
        mode = 0
    else:
        mode = 1

    from uvol_tpu_torch import native

    if (
        v.dtype == np.int32
        and v.flags.c_contiguous
        and native.corto_delta_decode(v, prediction if mode != 2 else None, mode)
    ):
        return
    if mode == 0:
        for i in range(1, nvert):
            fa, fb, fc = prediction[i]
            v[i] += v[fa] + v[fb] - v[fc]
    elif mode == 1:
        for i in range(1, nvert):
            v[i] += v[prediction[i][0]]
    else:  # point cloud
        for i in range(1, nvert):
            v[i] += v[i - 1]


def _attr_post_delta(a, nvert, nface, attrs, faces) -> None:
    if a.codec != NORMAL_CODEC or a.prediction == PRED_DIFF:
        return
    coord = attrs.get("position")
    if coord is None:
        raise ValueError("normal estimation requires position attribute")
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    est = _estimate_normals(coord.values.astype(np.float64), f)
    if a.prediction == PRED_BORDER:
        # boundary marking via the reference's XOR trick (commutative, so
        # the per-face loop vectorizes to scatter-XOR)
        boundary = np.zeros(nvert, np.int64)
        np.bitwise_xor.at(boundary, f[:, 0], f[:, 1] ^ f[:, 2])
        np.bitwise_xor.at(boundary, f[:, 1], f[:, 2] ^ f[:, 0])
        np.bitwise_xor.at(boundary, f[:, 2], f[:, 0] ^ f[:, 1])
        mask = boundary != 0
    else:
        mask = np.ones(nvert, bool)
    out = np.zeros((nvert, 3), np.float64)
    m = int(mask.sum())
    if m:
        # corrections are stored in mask order (ESTIMATED: every vertex)
        o0, o1 = _to_octa_float_vec(est[mask])
        corr = np.asarray(a.values[:m], np.float64)
        # JS Int32Array truncates after the add (corto.ts toOcta)
        s_ = np.trunc(corr[:, 0] + o0 * a.q).astype(np.int64)
        t_ = np.trunc(corr[:, 1] + o1 * a.q).astype(np.int64)
        out[mask] = _to_sphere_vec(s_, t_, a.q)
    rest = ~mask
    if rest.any():
        n = est[rest]
        norm = np.linalg.norm(n, axis=1)
        out[rest] = np.where(
            norm[:, None] > 0,
            n / np.maximum(norm, 1e-300)[:, None],
            np.array([0.0, 0.0, 1.0]),
        )
    a.values = out
    a.prediction = -1  # mark as materialized


def _attr_dequantize(a: CortoAttribute, nvert: int) -> np.ndarray:
    if a.codec == NORMAL_CODEC:
        if a.prediction == -1:  # already float normals from postDelta
            return a.values.astype(np.float32)
        from uvol_tpu_torch import native

        out = native.corto_normals_dequant_native(a.values, a.q)
        if out is not None:
            return out
        return _to_sphere_vec(
            a.values[:, 0].astype(np.int64),
            a.values[:, 1].astype(np.int64),
            a.q,
        ).astype(np.float32)
    if a.codec == COLOR_CODEC:
        qc = a.qc
        v = a.values
        out = np.zeros((nvert, 4), np.uint8)
        e0, e1, e2, e3 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
        out[:, 0] = ((e2 + e0) * qc[0]) & 0xFF
        out[:, 1] = (e0 * qc[1]) & 0xFF
        out[:, 2] = ((e1 + e0) * qc[2]) & 0xFF
        out[:, 3] = (e3 * qc[3]) & 0xFF
        return out
    if a.format in (FMT_FLOAT, FMT_DOUBLE):
        return (a.values * a.q).astype(np.float32)
    return (a.values * a.q).astype(np.int64)


def _estimate_normals(coords: np.ndarray, faces: np.ndarray) -> np.ndarray:
    est = np.zeros((len(coords), 3), np.float64)
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    n = np.cross(coords[b] - coords[a], coords[c] - coords[a])
    np.add.at(est, a, n)
    np.add.at(est, b, n)
    np.add.at(est, c, n)
    return est


def _to_octa_float_vec(n: np.ndarray):
    """Vectorized `_to_octa_float` over [N, 3] float64 normals."""
    length = np.abs(n).sum(1)
    safe = np.maximum(length, 1e-300)
    p0 = n[:, 0] / safe
    p1 = n[:, 1] / safe
    ap0, ap1 = np.abs(p0), np.abs(p1)
    p0n = np.where(n[:, 0] >= 0, 1.0 - ap1, ap1 - 1.0)
    p1n = np.where(n[:, 1] >= 0, 1.0 - ap0, ap0 - 1.0)
    neg = n[:, 2] < 0
    p0 = np.where(neg, p0n, p0)
    p1 = np.where(neg, p1n, p1)
    zero = length == 0
    return np.where(zero, 0.0, p0), np.where(zero, 0.0, p1)


def _to_sphere_vec(s_: np.ndarray, t_: np.ndarray, unit: float) -> np.ndarray:
    """Vectorized `_to_sphere` over int arrays."""
    x = s_.astype(np.float64)
    y = t_.astype(np.float64)
    z = unit - np.abs(x) - np.abs(y)
    neg = z < 0
    xn = np.where(s_ > 0, unit - np.abs(y), np.abs(y) - unit)
    yn = np.where(t_ > 0, unit - np.abs(x), np.abs(x) - unit)
    v = np.stack([np.where(neg, xn, x), np.where(neg, yn, y), z], 1)
    norm = np.linalg.norm(v, axis=1)
    return np.where(
        norm[:, None] > 0,
        v / np.maximum(norm, 1e-300)[:, None],
        np.array([0.0, 0.0, 1.0]),
    )


