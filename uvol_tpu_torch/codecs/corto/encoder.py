"""Corto `.crt` encoder — produces streams the reference decoders accept.

Mirrors the reference encoder's pipeline (deprecated/encoder/dev/src/
encoder.cpp): degenerate-face removal, bucketed-edge topology build, the
CLER front machine with DELAY/SPLIT handling, traversal-order vertex
renumbering, attribute quantize → (parallelogram) delta → Tunstall-coded
log/bit streams. Self-roundtrips with `decode_crt`, which itself replicates
the JS/C++ decoder semantics.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from uvol_tpu_torch.codecs.corto.bitstream import BitWriter
from uvol_tpu_torch.codecs.corto.decoder import (
    COLOR_CODEC,
    CORRELATED,
    GENERIC_CODEC,
    MAGIC,
    NORMAL_CODEC,
    PARALLEL,
    FMT_FLOAT,
    FMT_INT32,
    PRED_DIFF,
    PRED_ESTIMATED,
    PRED_BORDER,
    BOUNDARY,
    DELAY,
    END,
    LEFT,
    RIGHT,
    SPLIT,
    VERTEX,
    _ilog2,
)
from uvol_tpu_torch.codecs.corto.stream import CortoOutStream
import dataclasses


@dataclasses.dataclass
class CrtCustomAttr:
    """A custom per-vertex attribute for `encode_crt` — the reference's
    `Encoder::addAttribute` surface (encoder.h:54-79; GenericAttr<T>
    vertex_attribute.h:72-120). The trajectory fork stores polynomial
    coefficients this way (xPos/yPos/zPos, main.cpp:189-202).

    values: [nvert, C] float or integer array.
    step:   quantization step (float inputs). None derives it from the
            per-component range and `bits`, like GenericAttr's
            bits-from-range heuristic. Integer inputs are stored exact
            (step 1, INT32 wire format) and decode back as ints.
    """

    values: np.ndarray
    step: Optional[float] = None
    bits: int = 12


def _build_topology(faces: np.ndarray) -> np.ndarray:
    """opposite[face, side] = (opp_face, opp_side) or (-1, -1).

    Side k is the edge opposite corner k: (f[k+1], f[k+2]).
    """
    nf = len(faces)
    opp = np.full((nf, 3, 2), -1, np.int64)
    edge_map: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for fi in range(nf):
        f = faces[fi]
        for k in range(3):
            a, b = int(f[(k + 1) % 3]), int(f[(k + 2) % 3])
            key = (min(a, b), max(a, b))
            if key in edge_map:
                of, ok = edge_map[key]
                if opp[fi, k, 0] == -1 and opp[of, ok, 0] == -1:
                    opp[fi, k] = (of, ok)
                    opp[of, ok] = (fi, k)
            else:
                edge_map[key] = (fi, k)
    return opp


def _grouped_topology(
    faces: np.ndarray, nvert: int, group_ends: List[int]
) -> np.ndarray:
    """Per-group adjacency (the reference builds topology on a local copy of
    each group's faces inside encodeFaces — encoder.cpp:458-467 — so edges
    never match across group boundaries). Opposite face ids are global."""
    from uvol_tpu_torch import native

    nface = len(faces)
    opp = np.full((nface, 3, 2), -1, np.int32)
    start = 0
    for g_end in group_ends:
        sub = faces[start:g_end]
        t = native.corto_build_topology(sub, nvert)
        if t is None:
            t = _build_topology(sub).astype(np.int32)
        face_col = t[:, :, 0]
        t[:, :, 0] = np.where(face_col >= 0, face_col + start, -1)
        opp[start:g_end] = t
        start = g_end
    return opp


class _FrontMachine:
    """Encoder-side CLER emission mirroring encoder.cpp:encodeFaces.

    `encode_group(start, end)` may be called once per group: the front
    restarts per group while vertex numbering, the CLER stream and the
    bitstream persist (reference encoder.cpp:280-282)."""

    def __init__(self, faces: np.ndarray, topology: np.ndarray, nvert: int,
                 splitbits: int):
        self.faces = faces
        self.topology = topology
        self.nvert = nvert
        self.splitbits = splitbits
        self.clers: List[int] = []
        self.bitstream = BitWriter()
        self.encoded = np.full(nvert, -1, np.int64)
        self.prediction: List[Tuple[int, int, int, int]] = []  # (t, a, b, c)
        self.current_vertex = 0
        self.last_index = 0
        self.max_front = 0
        self.visited = np.zeros(len(faces), bool)

    def encode_group(self, face_start: int, face_end: int) -> None:
        faces = self.faces
        topo = self.topology
        visited = self.visited
        nf = face_end
        totfaces = face_end - face_start
        current = face_start

        # front edge arrays: face, side, prev, next, deleted
        e_face: List[int] = []
        e_side: List[int] = []
        e_prev: List[int] = []
        e_next: List[int] = []
        e_del: List[bool] = []

        def emplace(face, side, prev, nxt):
            e_face.append(face)
            e_side.append(side)
            e_prev.append(prev)
            e_next.append(nxt)
            e_del.append(False)

        faceorder: List[int] = []
        order = 0
        delayed: List[int] = []
        new_edge = -1

        while totfaces > 0:
            if new_edge == -1 and order >= len(faceorder) and not delayed:
                while current != nf and visited[current]:
                    current += 1
                if current == nf:
                    break
                face = faces[current]
                current_edge = len(e_face)
                split = 0
                for k in range(3):
                    if self.encoded[face[k]] != -1:
                        split |= 1 << k
                if split:
                    self.clers.append(SPLIT)
                    self.bitstream.write(split, 3)
                else:
                    self.clers.append(VERTEX)
                for k in range(3):
                    vindex = int(face[k])
                    if self.encoded[vindex] != -1:
                        self.bitstream.write(int(self.encoded[vindex]), self.splitbits)
                    else:
                        self.prediction.append(
                            (vindex, self.last_index, self.last_index, self.last_index)
                        )
                        self.encoded[vindex] = self.current_vertex
                        self.current_vertex += 1
                        self.last_index = vindex
                faceorder.append(len(e_face))
                emplace(current, 0, current_edge + 2, current_edge + 1)
                faceorder.append(len(e_face))
                emplace(current, 1, current_edge + 0, current_edge + 2)
                faceorder.append(len(e_face))
                emplace(current, 2, current_edge + 1, current_edge + 0)
                visited[current] = True
                current += 1
                totfaces -= 1
                continue

            if new_edge != -1:
                c = new_edge
                new_edge = -1
            elif order < len(faceorder):
                c = faceorder[order]
                order += 1
            else:
                c = delayed.pop()

            if e_del[c]:
                continue

            opposite_face, opposite_side = topo[e_face[c], e_side[c]]
            if opposite_face == -1 or visited[opposite_face]:
                self.clers.append(BOUNDARY)
                continue

            face = faces[opposite_face]
            k2 = int(opposite_side)
            k0 = (k2 + 1) % 3
            k1 = (k0 + 1) % 3

            eprev = e_prev[c]
            enext = e_next[c]
            close_left = (
                topo[e_face[eprev], e_side[eprev]][0] == opposite_face
            )
            close_right = (
                topo[e_face[enext], e_side[enext]][0] == opposite_face
            )
            new_edge = len(e_face)

            if close_left and close_right:
                self.clers.append(END)
                e_del[eprev] = True
                e_del[enext] = True
                e_next[e_prev[eprev]] = e_next[enext]
                e_prev[e_next[enext]] = e_prev[eprev]
                new_edge = -1
            elif close_left:
                self.clers.append(LEFT)
                e_del[eprev] = True
                e_next[e_prev[eprev]] = new_edge
                e_prev[enext] = new_edge
                emplace(opposite_face, k1, e_prev[eprev], enext)
            elif close_right:
                self.clers.append(RIGHT)
                e_del[enext] = True
                e_prev[e_next[enext]] = new_edge
                e_next[eprev] = new_edge
                emplace(opposite_face, k0, eprev, e_next[enext])
            else:
                v0 = int(face[k0])
                v1 = int(face[k1])
                opposite = int(face[k2])
                if self.encoded[opposite] != -1 and order < len(faceorder):
                    delayed.append(c)
                    self.clers.append(DELAY)
                    new_edge = -1
                    continue
                if self.encoded[opposite] != -1:
                    self.clers.append(SPLIT)
                    self.bitstream.write(int(self.encoded[opposite]), self.splitbits)
                else:
                    self.clers.append(VERTEX)
                    v2 = int(faces[e_face[c], e_side[c]])
                    self.prediction.append((opposite, v0, v1, v2))
                    self.encoded[opposite] = self.current_vertex
                    self.current_vertex += 1
                    self.last_index = opposite
                e_next[eprev] = new_edge
                e_prev[enext] = new_edge + 1
                emplace(opposite_face, k0, eprev, new_edge + 1)
                faceorder.append(len(e_face))
                emplace(opposite_face, k1, new_edge, enext)

            visited[opposite_face] = True
            totfaces -= 1

        self.max_front = max(self.max_front, len(e_face))


def encode_crt(
    positions: np.ndarray,
    faces: np.ndarray,
    *,
    uvs: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    position_step: Optional[float] = None,
    uv_step: float = 1.0 / 1024,
    normal_bits: int = 10,
    color_bits: Tuple[int, int, int, int] = (6, 7, 6, 5),
    exif: Optional[Dict[str, str]] = None,
    groups: Optional[List[int]] = None,
    entropy: int = 1,
    normal_prediction: str = "diff",
    custom_attributes: Optional[Dict[str, "CrtCustomAttr"]] = None,
) -> bytes:
    """Encode a mesh into a `.crt` the reference JS/C++ decoders accept.

    `entropy` selects the stream entropy coder per the reference enum
    (cstream.h:39): 1=TUNSTALL (default, what the corto CLI emits),
    0=NONE, 3=ZLIB, 4=LZ4 (the reference's ENTROPY_TESTS modes).

    `normal_prediction` is the reference NormalAttr prediction mode
    (normal_attribute.h: DIFF/ESTIMATED/BORDER): "diff" codes traversal
    deltas; "estimated" codes octahedral corrections against the
    geometry-estimated normal for every vertex; "border" stores
    corrections for boundary vertices only (interior normals are fully
    re-estimated from the decoded geometry — the smallest streams, at
    the cost of interior normal fidelity)."""
    positions = np.asarray(positions, np.float32)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    nvert = len(positions)
    if normal_prediction not in ("diff", "estimated", "border"):
        raise ValueError(f"unknown normal_prediction {normal_prediction!r}")
    if normal_prediction != "diff" and len(faces) == 0:
        raise ValueError(
            "estimated/border normal prediction needs connectivity; "
            "point clouds code normals with DIFF"
        )

    if position_step is None:
        bbox = positions.max(0) - positions.min(0)
        diag = float(np.linalg.norm(bbox))
        position_step = (diag if diag > 0 else 1.0) / (1 << 12)

    # degenerate removal (encoder.cpp:252-273)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    removed_before = np.cumsum(~good)  # remap caller group ends like the
    faces = faces[good]                # reference (encoder.cpp adjusts ends)
    nface = len(faces)
    if groups:
        group_ends = [int(g - removed_before[g - 1]) if g > 0 else 0
                      for g in groups]
    else:
        group_ends = [nface]

    referenced = np.zeros(nvert, bool)
    referenced[faces.reshape(-1)] = True
    nreferenced = int(referenced.sum())
    splitbits = _ilog2(nreferenced) + 1

    if group_ends != sorted(group_ends) or (nface and group_ends[-1] != nface):
        raise ValueError("group ends must be ascending and cover all faces")

    from uvol_tpu_torch import native

    if nface and native.get_corto_lib() is not None:
        topo = _grouped_topology(
            np.ascontiguousarray(faces, np.int32), nvert, group_ends
        )
        nm = native.CortoEncoderNative(faces, topo, nvert, splitbits)
        start = 0
        for g_end in group_ends:
            nm.encode_group(start, g_end)
            start = g_end
        clers_arr, bs_words, _encoded, quads_arr, new_nvert, max_front = (
            nm.finish()
        )
        machine = None
        quads = quads_arr.astype(np.int64)  # [new_nvert, 4] (t, a, b, c)
    else:
        topo = _grouped_topology(faces, nvert, group_ends).astype(np.int64)
        machine = _FrontMachine(faces, topo, nvert, splitbits)
        start = 0
        for g_end in group_ends:
            machine.encode_group(start, g_end)
            start = g_end
        clers_arr = np.asarray(machine.clers, np.uint8)
        bs_words = None
        new_nvert = machine.current_vertex
        max_front = machine.max_front
        quads = np.asarray(machine.prediction, np.int64).reshape(-1, 4)

    # attribute encode: quantize originals, reorder+delta by quads.
    # quads reference original (pre-traversal) indices of already-encoded
    # vertices, so the delta is a pure gather — fully vectorized.
    q_t, q_a, q_b, q_c = quads.T

    def delta_generic(values_q: np.ndarray, strategy: int) -> np.ndarray:
        vq = np.asarray(values_q, np.int64)
        if vq.size and np.abs(vq).max() < (1 << 29):
            # int32 gathers halve the memory traffic of this hot pass;
            # |a+b-c| < 3*2^29 < 2^31 so the parallelogram stays exact,
            # and the int64 cast back preserves the wire values
            vq32 = vq.astype(np.int32)
            if strategy & PARALLEL:
                par = (q_a != q_b)[:, None]
                pred = np.where(
                    par, vq32[q_a] + vq32[q_b] - vq32[q_c], vq32[q_a]
                )
            else:
                pred = vq32[q_a]
            out = (vq32[q_t] - pred).astype(np.int64)
            out[0] = vq[q_t[0]]
            return out
        if strategy & PARALLEL:
            par = (q_a != q_b)[:, None]
            pred = np.where(par, vq[q_a] + vq[q_b] - vq[q_c], vq[q_a])
        else:
            pred = vq[q_a]
        out = vq[q_t] - pred
        out[0] = vq[q_t[0]]
        return out

    out = CortoOutStream(entropy=entropy)
    out.u32(MAGIC)
    out.u32(1)
    out.u8(out.entropy)
    exif = exif or {}
    out.u32(len(exif))
    for k, v in sorted(exif.items()):
        out.string(k)
        out.string(v)

    # attribute table (map order = sorted by name)
    attrs = []
    pos_q = np.trunc(positions / position_step).astype(np.int64)
    attrs.append(("position", GENERIC_CODEC, position_step, 3, FMT_FLOAT,
                  PARALLEL | CORRELATED, pos_q))
    if uvs is not None:
        uv_q = np.trunc(np.asarray(uvs, np.float32) / uv_step).astype(np.int64)
        attrs.append(("uv", GENERIC_CODEC, uv_step, 2, FMT_FLOAT,
                      PARALLEL | CORRELATED, uv_q))
    if normals is not None:
        unit = float((1 << normal_bits) - 1)
        from uvol_tpu_torch.codecs.corto.decoder import _to_octa_float_vec

        nn = np.asarray(normals, np.float64)
        p0, p1 = _to_octa_float_vec(nn)
        nq = np.stack(
            [np.trunc(p0 * unit), np.trunc(p1 * unit)], 1
        ).astype(np.int64)
        attrs.append(("normal", NORMAL_CODEC, unit, 3, FMT_FLOAT,
                      PARALLEL, nq))
    if colors is not None:
        cb = color_bits
        qc = [1 << (8 - b) for b in cb]
        col = np.asarray(colors, np.int64)
        if col.shape[1] == 3:
            col = np.concatenate([col, np.full((nvert, 1), 255, np.int64)], 1)
        e0 = col[:, 1] // qc[1]
        e2 = col[:, 0] // qc[0] - e0
        e1 = col[:, 2] // qc[2] - e0
        e3 = col[:, 3] // qc[3]
        col_q = np.stack([e0, e1, e2, e3], 1)
        attrs.append(("color", COLOR_CODEC, 1.0, 4, 4, CORRELATED, col_q))

    reserved = {"position", "uv", "normal", "color"}
    for name, ca in sorted((custom_attributes or {}).items()):
        if name in reserved:
            raise ValueError(
                f"custom attribute name {name!r} collides with a built-in"
            )
        vals = np.asarray(ca.values)
        if vals.ndim == 1:
            vals = vals[:, None]
        if len(vals) != nvert or vals.ndim != 2:
            raise ValueError(
                f"custom attribute {name!r}: expected [{nvert}, C] values"
            )
        if vals.shape[1] > 255:
            raise ValueError(f"custom attribute {name!r}: too many components")
        if np.issubdtype(vals.dtype, np.integer):
            # exact integer attribute: unit step, INT32 wire format
            attrs.append(
                (name, GENERIC_CODEC, 1.0, vals.shape[1], FMT_INT32,
                 PARALLEL | CORRELATED, vals.astype(np.int64))
            )
            continue
        step = ca.step
        if step is None:
            # GenericAttr<T>'s bits-from-range heuristic: step sized so
            # the largest per-component range spans 2^bits values
            rng = float(
                np.max(vals.max(0) - vals.min(0), initial=0.0)
            )
            step = (rng if rng > 0 else 1.0) / (1 << ca.bits)
        vq = np.trunc(np.asarray(vals, np.float64) / step).astype(np.int64)
        attrs.append(
            (name, GENERIC_CODEC, float(step), vals.shape[1], FMT_FLOAT,
             PARALLEL | CORRELATED, vq)
        )

    attrs.sort(key=lambda a: a[0])
    out.u32(len(attrs))
    for name, codec, q, ncomp, fmt, strategy, _vals in attrs:
        out.string(name)
        out.u32(codec)
        out.f32(q)
        out.u8(ncomp)
        out.u8(fmt)
        out.u8(strategy)

    out.u32(new_nvert if nface else nvert)
    out.u32(nface)

    # groups
    out.u32(len(group_ends))
    for g_end in group_ends:
        out.u32(g_end)
        out.u8(0)

    if nface == 0:
        # point-cloud path: sequential delta in the given (pre-sorted) order
        for name, codec, q, ncomp, fmt, strategy, vals in attrs:
            if codec == NORMAL_CODEC:
                out.u8(PRED_DIFF)
                d = np.diff(vals, axis=0, prepend=vals[:1] * 0)
                d[0] = vals[0]
                out.encode_array(d, 2)
                continue
            if codec == COLOR_CODEC:
                for b in color_bits:
                    out.u8(1 << (8 - b))
            d = np.diff(vals, axis=0, prepend=vals[:1] * 0)
            d[0] = vals[0]
            if strategy & CORRELATED:
                out.encode_array(d, ncomp)
            else:
                out.encode_values(d, ncomp)
        return out.getvalue()

    # index
    out.u32(max_front)
    out.compress_block(clers_arr)
    if bs_words is not None:
        out._write_words(bs_words)
    else:
        out.write_bitstream(machine.bitstream)

    # attributes (sorted order == decode order)
    for name, codec, q, ncomp, fmt, strategy, vals in attrs:
        if codec == NORMAL_CODEC:
            if normal_prediction != "diff":
                _encode_normals_estimated(
                    out, normal_prediction, np.asarray(vals, np.int64),
                    pos_q, q_t, float(q), clers_arr, bs_words, machine,
                    group_ends, new_nvert, nface,
                )
                continue
            out.u8(PRED_DIFF)
            vals64 = np.asarray(vals, np.int64)
            diffs = vals64[q_t] - vals64[q_a]
            diffs[0] = vals64[q_t[0]]
            out.encode_array(diffs, 2)
            continue
        if codec == COLOR_CODEC:
            for b in color_bits:
                out.u8(1 << (8 - b))
        diffs = delta_generic(vals, strategy)
        if strategy & CORRELATED:
            out.encode_array(diffs, ncomp)
        else:
            out.encode_values(diffs, ncomp)

    return out.getvalue()


def _fit_trunc(target: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Integer corr with trunc(corr + f) == target.

    The decoder reconstructs s = trunc(corr + octa_prediction) with
    float64 trunc-toward-zero (decoder.py:371, corto.ts toOcta Int32Array
    semantics). trunc(c + f) over consecutive integers c is monotone with
    unit steps (one flat spot at zero), so a couple of correction rounds
    always land exactly."""
    target = np.asarray(target, np.int64)
    corr = target - np.trunc(f).astype(np.int64)
    for _ in range(4):
        d = np.trunc(corr + f).astype(np.int64)
        if np.array_equal(d, target):
            break
        corr += target - d
    return corr


def _encode_normals_estimated(
    out, mode, nq, pos_q, q_t, unit, clers_arr, bs_words, machine,
    group_ends, new_nvert, nface,
):
    """ESTIMATED/BORDER normal coding (reference normal_attribute.cpp).

    Replays the just-encoded connectivity exactly as the decoder will, so
    the geometry-estimated prediction (and the BORDER boundary mask) are
    bit-identical to decode time; corrections then make the decoded
    octahedral ints match the encoder's quantized normals exactly for
    every coded vertex."""
    from uvol_tpu_torch.codecs.corto.decoder import (
        _decode_faces,
        _estimate_normals,
        _to_octa_float_vec,
    )
    from uvol_tpu_torch import native

    splitbits = _ilog2(new_nvert) + 1
    if bs_words is not None:
        words = np.asarray(bs_words, np.uint32)
    else:
        words = np.frombuffer(machine.bitstream.getvalue(), "<u4")
    if native.get_corto_lib() is not None:
        faces_new, _, _ = native.corto_decode_faces(
            clers_arr, words, group_ends, splitbits, new_nvert, nface
        )
        f = np.asarray(faces_new, np.int64).reshape(-1, 3)
    else:
        from uvol_tpu_torch.codecs.corto.bitstream import BitReader

        faces_flat = np.zeros(nface * 3, np.int64)
        pred = np.zeros((new_nvert, 3), np.int64)
        br = BitReader(words)
        vc = 0
        cp = 0
        start = 0
        for end in group_ends:
            vc, cp = _decode_faces(
                clers_arr, br, faces_flat, pred, start, end * 3,
                vc, cp, splitbits, new_nvert,
            )
            start = end * 3
        f = faces_flat.reshape(-1, 3)

    pos_new = np.asarray(pos_q, np.int64)[q_t].astype(np.float64)
    est = _estimate_normals(pos_new, f)
    if mode == "border":
        boundary = np.zeros(new_nvert, np.int64)
        np.bitwise_xor.at(boundary, f[:, 0], f[:, 1] ^ f[:, 2])
        np.bitwise_xor.at(boundary, f[:, 1], f[:, 2] ^ f[:, 0])
        np.bitwise_xor.at(boundary, f[:, 2], f[:, 0] ^ f[:, 1])
        mask = boundary != 0
    else:
        mask = np.ones(new_nvert, bool)
    o0, o1 = _to_octa_float_vec(est[mask])
    target = np.asarray(nq, np.int64)[q_t][mask]
    m = int(mask.sum())
    # corrections in mask order; the block is still nvert tuples (the
    # decoder always reads decode_array(2, nvert) — decoder.py:305)
    corr = np.zeros((new_nvert, 2), np.int64)
    corr[:m, 0] = _fit_trunc(target[:, 0], o0 * unit)
    corr[:m, 1] = _fit_trunc(target[:, 1], o1 * unit)
    out.u8(PRED_ESTIMATED if mode == "estimated" else PRED_BORDER)
    out.encode_array(corr, 2)
