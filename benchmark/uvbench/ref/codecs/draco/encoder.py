# Frozen copy of the program's `codecs/draco/encoder.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""Draco `.drc` triangular-mesh encoder (valence Edgebreaker, bitstream 2.2).

The port's copy of `uvol_tpu/codecs/draco/encoder.py`, unchanged in what it emits; it
calls the port's own native library (`uvbench.ref.native`).

Replaces the external `draco_encoder` binary the reference shells out to per
frame (the reference project's `scripts/Encoder.py:260-267`); output is consumed by
the same decode path as the reference player's draco_decoder.wasm
(`src/lib/DRACOLoader.js:483`) — here, `uvbench.ref.codecs.draco.decoder`,
which is golden-validated against real draco_encoder output (liam corpus).

Architecture: the connectivity encoder runs the Edgebreaker traversal over
an encoder-side corner table, then **replays its own symbol stream through
the decoder's spirale-reversi machine** (`run_connectivity_machine`) to
(a) assign valence contexts exactly as the decoder will consume them and
(b) obtain the decoder-side corner table + traversal order that attribute
encoding must follow. This replay-based construction makes decoder
compatibility structural rather than hoped-for.

Prediction schemes are the exact inverses of the decode paths in
`attributes.py`: parallelogram (positions/generic), portable tex-coords
(UVs, incl. orientation bits), canonicalized-octahedron geometric normals.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from uvbench.ref.codecs.buffer import EncoderBuffer
from uvbench.ref.codecs.draco import constants as K
from uvbench.ref.codecs.draco.attributes import (
    OctahedronToolBox,
    collect_ring_parallelograms,
    parallelogram_prediction,
    tdiv,
)
from uvbench.ref.codecs.draco.corner_table import (
    INVALID,
    MeshAttributeCornerTable,
    next_corner,
    previous_corner,
)
from uvbench.ref.codecs.draco.edgebreaker import (
    EdgebreakerConnectivity,
    TopologySplit,
    run_connectivity_machine,
)
from uvbench.ref.codecs.draco.traverser import (
    _TableView,
    traverse_depth_first,
    traverse_prediction_degree,
)
from uvbench.ref.codecs.rans import RansBitEncoder
from uvbench.ref.codecs.symbol_coding import (
    convert_signed_to_symbols,
    encode_symbols,
)

#: topology symbol -> valence-context symbol index (inverse of
#: constants.SYMBOL_TO_TOPOLOGY)
TOPOLOGY_TO_SYMBOL_IDX = {t: i for i, t in enumerate(K.SYMBOL_TO_TOPOLOGY)}


# ---------------------------------------------------------------------------
# Input description
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AttributeToEncode:
    attribute_type: int  # K.ATT_POSITION / ATT_TEX_COORD / ...
    values: np.ndarray  # [N, C] float32 (or ints for integer attributes)
    corner_to_value: np.ndarray  # [3F] value index per corner
    quantization_bits: int = 11
    integer: bool = False  # SEQ_INTEGER (no quantization header)


# ---------------------------------------------------------------------------
# Encoder-side corner table
# ---------------------------------------------------------------------------


class EncoderCornerTable:
    """Corner table over position-index faces; vertices are corner fans
    (non-manifold position vertices are split into one vertex per fan,
    matching what the decoder will reconstruct)."""

    def __init__(self, faces: np.ndarray):
        faces = np.asarray(faces, np.int64)
        if (faces[:, 0] == faces[:, 1]).any() or (
            faces[:, 1] == faces[:, 2]
        ).any() or (faces[:, 2] == faces[:, 0]).any():
            raise ValueError("degenerate faces must be removed before encoding")
        self.num_faces = len(faces)
        n = 3 * self.num_faces
        self.position_of_corner = faces.reshape(-1)  # input position ids

        from uvbench.ref import native as uvt_native

        native_res = None
        if uvt_native.get_draco_lib() is not None:
            num_positions = int(faces.max()) + 1 if len(faces) else 0
            native_res = uvt_native.encoder_corner_table_native(
                faces, num_positions
            )
        if native_res is not None:
            opposite, corner_vertex, vertex_corner = native_res
            self.opposite = opposite.astype(np.int64)
            self.vertex = corner_vertex.astype(np.int64)
            self.vertex_corner = vertex_corner.tolist()
            self.num_vertices = len(self.vertex_corner)
        else:
            self._build_python(n)

        # holes: chain boundary half-edges into loops
        self.vertex_hole_id = np.full(self.num_vertices, -1, np.int64)
        # boundary edge runs vertex(prev(c)) -> vertex(next(c))
        # (opposite to face winding)
        bnd = np.nonzero(self.opposite[:n] == INVALID)[0]
        prv = np.where(bnd % 3 == 0, bnd + 2, bnd - 1)
        out_edge: Dict[int, int] = {
            int(v): int(c) for v, c in zip(self.vertex[prv], bnd)
        }
        self.num_holes = 0
        for v0 in list(out_edge):
            if self.vertex_hole_id[v0] != -1:
                continue
            hid = self.num_holes
            self.num_holes += 1
            v = v0
            while self.vertex_hole_id[v] == -1:
                self.vertex_hole_id[v] = hid
                c = out_edge[v]
                v = int(self.vertex[next_corner(c)])

    def _build_python(self, n: int) -> None:
        """Reference half-edge build (fallback; the native path mirrors it)."""
        # half-edge matching: edge of corner c = (pos[next(c)], pos[prev(c)])
        self.opposite = np.full(n, INVALID, np.int64)
        edge_map: Dict[Tuple[int, int], List[int]] = {}
        pos = self.position_of_corner
        for c in range(n):
            a = int(pos[next_corner(c)])
            b = int(pos[previous_corner(c)])
            edge_map.setdefault((min(a, b), max(a, b)), []).append(c)
        for key, corners in edge_map.items():
            # pair corners of opposite direction; extras stay boundary
            fwd = [c for c in corners if int(pos[next_corner(c)]) == key[0]]
            bwd = [c for c in corners if int(pos[next_corner(c)]) == key[1]]
            for ca, cb in zip(fwd, bwd):
                self.opposite[ca] = cb
                self.opposite[cb] = ca

        # fan-based vertex ids
        self.vertex = np.full(n, INVALID, np.int64)
        self.vertex_corner = []  # leftmost corner per vertex
        for c in range(n):
            if self.vertex[c] != INVALID:
                continue
            # sweep left to the fan start (or detect a closed fan)
            start = c
            cur = c
            steps = 0
            while True:
                nxt = self.swing_left(cur)
                if nxt == INVALID or nxt == start:
                    break
                cur = nxt
                steps += 1
                if steps > n:
                    raise ValueError("non-manifold fan cycle")
            first = cur if self.swing_left(cur) == INVALID else start
            vid = len(self.vertex_corner)
            self.vertex_corner.append(first)
            cur = first
            while cur != INVALID and self.vertex[cur] == INVALID:
                self.vertex[cur] = vid
                cur = self.swing_right(cur)
        self.num_vertices = len(self.vertex_corner)

    def swing_left(self, c: int) -> int:
        o = self.opposite[next_corner(c)]
        return INVALID if o == INVALID else next_corner(int(o))

    def swing_right(self, c: int) -> int:
        o = self.opposite[previous_corner(c)]
        return INVALID if o == INVALID else previous_corner(int(o))

    def hole_vertices(self, hole_id: int) -> List[int]:
        return [
            int(v) for v in np.nonzero(self.vertex_hole_id == hole_id)[0]
        ]


# ---------------------------------------------------------------------------
# Edgebreaker traversal (encoder)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Traversal:
    symbols: List[int]
    symbol_corners: List[int]
    start_face_bits: List[int]  # one per component, encoder order
    splits: List[TopologySplit]
    init_face_corners_enc: List[int]  # next(start_corner) per interior comp
    interior_start_corners: List[int]  # start corner per interior comp
    num_split_symbols: int


def _edgebreaker_traverse(ct: EncoderCornerTable) -> _Traversal:
    # native C++ DFS (draco_native.cpp uvt_eb_traverse, 1:1 port of the
    # loop below; parity-tested through the liam re-encode goldens)
    from uvbench.ref import native as uvt_native

    res = None
    if uvt_native.get_draco_lib() is not None:
        res = uvt_native.eb_traverse_native(
            ct.vertex, ct.opposite, ct.vertex_hole_id,
            ct.num_faces, ct.num_vertices, ct.num_holes,
        )
    if res is not None:
        symbols_a, corners_a, sf_a, (s_src, s_id, s_edge), initc, starts, nss = res
        return _Traversal(
            # ndarrays, not lists: .tolist() + re-asarray cost ~5 ms per
            # liam frame; every consumer is ndarray-compatible
            symbols=symbols_a,
            symbol_corners=corners_a,
            start_face_bits=sf_a,
            splits=[
                TopologySplit(int(a), int(b), int(e))
                for a, b, e in zip(s_src, s_id, s_edge)
            ],
            init_face_corners_enc=initc,
            interior_start_corners=starts,
            num_split_symbols=nss,
        )
    num_faces = ct.num_faces
    visited_faces = np.zeros(num_faces, bool)
    visited_verts = np.zeros(ct.num_vertices, bool)
    visited_holes = [False] * ct.num_holes
    vert = ct.vertex
    opp = ct.opposite
    hole_of = ct.vertex_hole_id

    symbols: List[int] = []
    symbol_corners: List[int] = []
    start_face_bits: List[int] = []
    splits: List[TopologySplit] = []
    face_to_split: Dict[int, int] = {}
    init_face_corners_enc: List[int] = []
    interior_start_corners: List[int] = []
    num_split_symbols = 0

    def encode_hole(start_corner: int, encode_first_vertex: bool) -> None:
        """Mark every vertex of the hole at vertex(start_corner) visited."""
        v = int(vert[start_corner])
        hid = int(hole_of[v])
        visited_holes[hid] = True
        for hv in ct.hole_vertices(hid):
            visited_verts[hv] = True
        if encode_first_vertex:
            visited_verts[v] = True

    def check_split(src_symbol_id: int, src_edge: int, neighbor_face: int):
        sid = face_to_split.pop(neighbor_face, None)
        if sid is not None:
            splits.append(TopologySplit(src_symbol_id, sid, src_edge))

    def right_corner(c: int) -> int:
        return int(opp[next_corner(c)])

    def left_corner(c: int) -> int:
        return int(opp[previous_corner(c)])

    def encode_from_corner(corner_id: int) -> None:
        nonlocal num_split_symbols
        stack = [corner_id]
        while stack:
            corner_id = stack[-1]
            if corner_id == INVALID or visited_faces[corner_id // 3]:
                stack.pop()
                continue
            while True:
                face_id = corner_id // 3
                visited_faces[face_id] = True
                symbol_id = len(symbols)
                symbol_corners.append(corner_id)
                vert_id = int(vert[corner_id])
                if not visited_verts[vert_id]:
                    visited_verts[vert_id] = True
                    if hole_of[vert_id] == -1:
                        symbols.append(K.TOPOLOGY_C)
                        corner_id = right_corner(corner_id)
                        if corner_id == INVALID or visited_faces[corner_id // 3]:
                            raise ValueError("C into visited/invalid face")
                        continue
                rc = right_corner(corner_id)
                lc = left_corner(corner_id)
                rf = INVALID if rc == INVALID else rc // 3
                lf = INVALID if lc == INVALID else lc // 3
                right_visited = rf == INVALID or visited_faces[rf]
                left_visited = lf == INVALID or visited_faces[lf]
                if right_visited:
                    if rf != INVALID:
                        check_split(symbol_id, K.RIGHT_FACE_EDGE, rf)
                    if left_visited:
                        if lf != INVALID:
                            check_split(symbol_id, K.LEFT_FACE_EDGE, lf)
                        symbols.append(K.TOPOLOGY_E)
                        stack.pop()
                        break
                    symbols.append(K.TOPOLOGY_R)
                    corner_id = lc
                else:
                    if left_visited:
                        if lf != INVALID:
                            check_split(symbol_id, K.LEFT_FACE_EDGE, lf)
                        symbols.append(K.TOPOLOGY_L)
                        corner_id = rc
                    else:
                        # split: unvisited on both sides
                        hid = hole_of[vert_id]
                        if hid != -1 and not visited_holes[hid]:
                            encode_hole(corner_id, False)
                        face_to_split[face_id] = symbol_id
                        symbols.append(K.TOPOLOGY_S)
                        num_split_symbols += 1
                        stack[-1] = lc
                        stack.append(rc)
                        break

    def find_init_face_configuration(face: int) -> Tuple[bool, int]:
        corner = 3 * face
        for _ in range(3):
            if opp[corner] == INVALID:
                return False, corner
            if hole_of[vert[corner]] != -1:
                # swing right to the boundary; previous corner faces the
                # boundary edge
                right = corner
                while right != INVALID:
                    corner = right
                    right = ct.swing_right(right)
                return False, previous_corner(corner)
            corner = next_corner(corner)
        return True, corner

    for c_id in range(3 * num_faces):
        face_id = c_id // 3
        if visited_faces[face_id]:
            continue
        interior, start_corner = find_init_face_configuration(face_id)
        start_face_bits.append(1 if interior else 0)
        if interior:
            interior_start_corners.append(start_corner)
            for c in (
                start_corner,
                next_corner(start_corner),
                previous_corner(start_corner),
            ):
                visited_verts[vert[c]] = True
            visited_faces[face_id] = True
            init_face_corners_enc.append(next_corner(start_corner))
            opp_id = int(opp[next_corner(start_corner)])
            if opp_id != INVALID and not visited_faces[opp_id // 3]:
                encode_from_corner(opp_id)
        else:
            encode_hole(next_corner(start_corner), True)
            encode_from_corner(start_corner)

    if len(symbol_corners) != len(symbols):
        raise AssertionError("symbol bookkeeping out of sync")
    return _Traversal(
        symbols=symbols,
        symbol_corners=symbol_corners,
        start_face_bits=start_face_bits,
        splits=splits,
        init_face_corners_enc=init_face_corners_enc,
        interior_start_corners=interior_start_corners,
        num_split_symbols=num_split_symbols,
    )


# ---------------------------------------------------------------------------
# Decoder replay (context assignment + decoder-side connectivity)
# ---------------------------------------------------------------------------


class _ScriptedBitDecoder:
    def __init__(self, bits: Sequence[int]):
        self._bits = list(bits)
        self._i = 0

    def decode_bit(self) -> int:
        b = self._bits[self._i]
        self._i += 1
        return b


class _ReplayValenceTraversal:
    """Feeds the known (reversed) symbol stream to the decoder machine and
    records which valence context each symbol is read from."""

    def __init__(self, symbols_decode_order: List[int], start_face_bits_fifo):
        self._symbols = symbols_decode_order
        self._i = 0
        self.contexts: List[int] = []  # context per decode step (-1 implicit)
        self.active_context = -1
        self.last_symbol = -1
        self.start_face_decoder = _ScriptedBitDecoder(start_face_bits_fifo)
        self.seam_decoders: List = []  # seams computed separately

    def decode_symbol(self) -> int:
        sym = self._symbols[self._i]
        self._i += 1
        if self.active_context == -1 and sym != K.TOPOLOGY_E:
            raise ValueError("first decoded symbol of stream must be E")
        self.contexts.append(self.active_context)
        self.last_symbol = sym
        return sym


# ---------------------------------------------------------------------------
# Prediction encode (inverses of attributes.py decode paths)
# ---------------------------------------------------------------------------


class WrapEncoder:
    """Inverse of attributes.WrapTransform."""

    def __init__(self, values: np.ndarray):
        self.min_value = int(values.min()) if values.size else 0
        self.max_value = int(values.max()) if values.size else 0
        self.max_dif = 1 + self.max_value - self.min_value
        self.max_corr = self.max_dif // 2
        self.min_corr = -self.max_corr
        if self.max_dif % 2 == 0:
            self.max_corr -= 1

    def clamp_pred(self, pred: np.ndarray) -> np.ndarray:
        return np.clip(pred, self.min_value, self.max_value)

    def correction(self, orig: np.ndarray, pred: np.ndarray) -> np.ndarray:
        """Signed correction that compute_original maps back to orig."""
        corr = orig - self.clamp_pred(pred)
        corr = np.where(corr < self.min_corr, corr + self.max_dif, corr)
        corr = np.where(corr > self.max_corr, corr - self.max_dif, corr)
        return corr

    def correction_positive(self, orig: np.ndarray, pred: np.ndarray) -> np.ndarray:
        """Positive modular correction (tex-coords-portable convention)."""
        return (orig - self.clamp_pred(pred)) % self.max_dif

    def write(self, out: EncoderBuffer) -> None:
        out.raw(np.asarray([self.min_value, self.max_value], "<i4").tobytes())


def _encode_parallelogram(
    values: np.ndarray, view, vertex_to_data, data_to_corner
) -> Tuple[np.ndarray, WrapEncoder]:
    n, nc = values.shape
    wrap = WrapEncoder(values)

    from uvbench.ref import native as uvt_native

    if n > 0 and uvt_native.get_draco_lib() is not None:
        res = uvt_native.parallelogram_encode_native(
            np.asarray(values, np.int64), nc, wrap.min_value, wrap.max_value,
            np.asarray(view.opposite, np.int32),
            np.asarray(view.vertex, np.int32),
            view._seam, vertex_to_data, data_to_corner,
        )
        if res is not None:
            return res, wrap

    corr = np.zeros_like(values)
    if n == 0:
        return corr, wrap
    corr[0] = wrap.correction(values[0], np.zeros(nc, np.int64))
    for p in range(1, n):
        ci = int(data_to_corner[p])
        oci = view.opp(ci)
        pred = (
            parallelogram_prediction(values, p, oci, view, vertex_to_data)
            if oci != INVALID
            else None
        )
        if pred is None:
            pred = values[p - 1]
        corr[p] = wrap.correction(values[p], pred)
    return corr, wrap


def _encode_constrained_multi(
    values: np.ndarray, view, vertex_to_data, data_to_corner
):
    """Encoder counterpart of
    attributes.decode_constrained_multi_parallelogram: same corner-ring
    walk, every available parallelogram used (all crease flags 0 — any
    flag assignment is valid wire; Draco's encoder optimizes the choice
    for rate, which affects compression only, never correctness).
    Returns (corr, wrap, crease_flag_streams[4])."""
    n, nc = values.shape
    wrap = WrapEncoder(values)
    corr = np.zeros_like(values)
    creases: List[List[int]] = [[] for _ in range(4)]
    if n == 0:
        return corr, wrap, creases
    corr[0] = wrap.correction(values[0], np.zeros(nc, np.int64))
    for p in range(1, n):
        preds = collect_ring_parallelograms(
            values, p, int(data_to_corner[p]), view, vertex_to_data
        )
        if preds:
            creases[len(preds) - 1].extend([0] * len(preds))
            total = np.sum(preds, axis=0)
            pred = np.asarray(
                [tdiv(int(total[c]), len(preds)) for c in range(nc)],
                np.int64,
            )
        else:
            pred = values[p - 1]
        corr[p] = wrap.correction(values[p], pred)
    return corr, wrap, creases


def _write_symbol_block(
    symbols: np.ndarray, nc: int, out: EncoderBuffer, compress: bool = True
) -> None:
    """The `compressed` flag + symbol payload: rANS-coded symbols, or the
    raw storage form (u8 byte-width + little-endian values) a foreign
    encoder emits with attribute compression disabled."""
    if compress:
        out.u8(1)
        encode_symbols(symbols, nc, out)
        return
    out.u8(0)
    symbols = np.asarray(symbols, np.uint32)
    masked = int(np.bitwise_or.reduce(symbols)) if len(symbols) else 0
    nb = 1 + (masked.bit_length() - 1) // 8 if masked else 1
    out.u8(nb)
    le = symbols.astype("<u4").view(np.uint8).reshape(-1, 4)[:, :nb]
    out.raw(np.ascontiguousarray(le).tobytes())


def _encode_difference(values: np.ndarray) -> Tuple[np.ndarray, WrapEncoder]:
    n, nc = values.shape
    wrap = WrapEncoder(values)
    corr = np.zeros_like(values)
    prev = np.zeros(nc, np.int64)
    for i in range(n):
        corr[i] = wrap.correction(values[i], prev)
        prev = values[i]
    return corr, wrap


class _TexCoordsPortableEncoder:
    """Mirror of attributes.TexCoordsPortablePredictor, producing positive
    modular corrections + orientation bits."""

    def __init__(
        self, view, vertex_to_data, pos_for_corner,
        *, pos_values=None, pos_data_of_corner=None,
    ):
        self.view = view
        self.vertex_to_data = vertex_to_data
        self.pos_for_corner = pos_for_corner
        self._pos_values = pos_values
        self._pos_data_of_corner = pos_data_of_corner
        self.orientations: List[bool] = []  # in prediction order

    def encode(
        self, values: np.ndarray, data_to_corner: np.ndarray
    ) -> Tuple[np.ndarray, WrapEncoder]:
        n = len(values)
        wrap = WrapEncoder(values)

        from uvbench.ref import native as uvt_native

        if (
            n > 0
            and self._pos_values is not None
            and uvt_native.get_draco_lib() is not None
        ):
            res = uvt_native.texcoords_encode_native(
                np.asarray(values, np.int64), wrap.min_value, wrap.max_value,
                np.asarray(self.view.vertex, np.int32),
                self.vertex_to_data, data_to_corner,
                np.asarray(self._pos_values, np.int64),
                np.asarray(self._pos_data_of_corner, np.int32),
            )
            if res is not None:
                corr, orients = res
                # keep the ndarray: per-element list conversion was ~4 ms
                # per liam frame on the 1-core bench host
                self.orientations = orients.astype(bool)
                return corr, wrap

        corr = np.zeros_like(values)
        vertex = self.view.vertex
        v2d = self.vertex_to_data
        self._wrap = wrap  # orientation choice needs the modular-cost view
        out = values  # predictions read already-"decoded" (== true) values
        for p in range(n):
            ci = int(data_to_corner[p])
            nc_, pc_ = next_corner(ci), previous_corner(ci)
            next_id = int(v2d[vertex[nc_]])
            prev_id = int(v2d[vertex[pc_]])
            pred = self._predict(p, ci, nc_, pc_, next_id, prev_id, out)
            corr[p] = wrap.correction_positive(out[p], pred)
        return corr, wrap

    def _predict(self, p, ci, nc, pc, next_id, prev_id, out):
        if 0 <= prev_id < p and 0 <= next_id < p:
            n_uv = out[next_id]
            p_uv = out[prev_id]
            if p_uv[0] == n_uv[0] and p_uv[1] == n_uv[1]:
                return p_uv.copy()
            tip_pos = self.pos_for_corner(ci)
            next_pos = self.pos_for_corner(nc)
            prev_pos = self.pos_for_corner(pc)
            pn = [int(prev_pos[k]) - int(next_pos[k]) for k in range(3)]
            pn_norm2 = pn[0] * pn[0] + pn[1] * pn[1] + pn[2] * pn[2]
            if pn_norm2 != 0:
                import math

                cn = [int(tip_pos[k]) - int(next_pos[k]) for k in range(3)]
                cn_dot_pn = sum(pn[k] * cn[k] for k in range(3))
                pn_uv = [int(p_uv[0]) - int(n_uv[0]), int(p_uv[1]) - int(n_uv[1])]
                x_uv = [
                    int(n_uv[0]) * pn_norm2 + cn_dot_pn * pn_uv[0],
                    int(n_uv[1]) * pn_norm2 + cn_dot_pn * pn_uv[1],
                ]
                x_pos = [
                    int(next_pos[k]) + tdiv(cn_dot_pn * pn[k], pn_norm2)
                    for k in range(3)
                ]
                cx = [int(tip_pos[k]) - x_pos[k] for k in range(3)]
                cx_norm2 = cx[0] * cx[0] + cx[1] * cx[1] + cx[2] * cx[2]
                pn_uv_perp = [pn_uv[1], -pn_uv[0]]
                norm_sq = math.isqrt(cx_norm2 * pn_norm2)
                # candidate predictions for both orientations
                pu_t = tdiv(x_uv[0] + pn_uv_perp[0] * norm_sq, pn_norm2)
                pv_t = tdiv(x_uv[1] + pn_uv_perp[1] * norm_sq, pn_norm2)
                pu_f = tdiv(x_uv[0] - pn_uv_perp[0] * norm_sq, pn_norm2)
                pv_f = tdiv(x_uv[1] - pn_uv_perp[1] * norm_sq, pn_norm2)
                true_uv = out[p]
                # corrections are coded as POSITIVE MODULAR symbols: compare
                # the bit cost of the modular symbols, not |error| (a small
                # negative error is an expensive near-`dif` symbol)
                w = self._wrap
                dif = w.max_dif

                def _cost(pu, pv):
                    su = (int(true_uv[0]) - min(max(pu, w.min_value), w.max_value)) % dif
                    sv = (int(true_uv[1]) - min(max(pv, w.min_value), w.max_value)) % dif
                    return su.bit_length() + sv.bit_length()

                err_t = _cost(pu_t, pv_t)
                err_f = _cost(pu_f, pv_f)
                # ties to the minus branch (see draco_native.cpp note)
                orientation = err_t < err_f
                self.orientations.append(orientation)
                if orientation:
                    return np.array([pu_t, pv_t], np.int64)
                return np.array([pu_f, pv_f], np.int64)
        if 0 <= prev_id < p:
            return out[prev_id].copy()
        if 0 <= next_id < p:
            return out[next_id].copy()
        return out[p - 1].copy() if p > 0 else np.zeros(2, np.int64)

    def write_orientations(self, out: EncoderBuffer) -> None:
        # the decoder defaults to orientation=true once the stored list is
        # exhausted (consumed from the end), so a trailing run of trues in
        # prediction order need not be stored at all — draco's own streams
        # store zero orientations on consistently-wound meshes
        orients = np.asarray(self.orientations, bool)
        false_idx = np.nonzero(~orients)[0]
        orients = orients[: false_idx[-1] + 1] if len(false_idx) else orients[:0]
        self.orientations = orients
        out.raw(np.asarray([len(self.orientations)], "<i4").tobytes())
        enc = RansBitEncoder()
        # decoder consumes by pop() from the end, delta-coded from last=True
        rev = np.asarray(self.orientations, bool)[::-1]
        prev = np.concatenate([[True], rev[:-1]])
        enc.encode_bits(rev == prev)
        enc.flush(out)


class _GeometricNormalEncoder:
    """Mirror of attributes.GeometricNormalPredictor (encode direction)."""

    def __init__(
        self, view_full_ct, pos_for_corner, quantization_bits: int,
        *, pos_values=None, pos_data_of_corner=None,
    ):
        self.ct = view_full_ct
        self.pos_for_corner = pos_for_corner
        self.tool = OctahedronToolBox(quantization_bits)
        self.flip_bits: List[int] = []
        self._pos_values = pos_values
        self._pos_data_of_corner = pos_data_of_corner

    def _face_normal(self, corner: int):
        c = self.pos_for_corner(corner)
        nn = self.pos_for_corner(next_corner(corner))
        pp = self.pos_for_corner(previous_corner(corner))
        d1 = [int(nn[k]) - int(c[k]) for k in range(3)]
        d2 = [int(pp[k]) - int(c[k]) for k in range(3)]
        return [
            d1[1] * d2[2] - d1[2] * d2[1],
            d1[2] * d2[0] - d1[0] * d2[2],
            d1[0] * d2[1] - d1[1] * d2[0],
        ]

    def predict(self, corner: int):
        ct = self.ct
        normal = [0, 0, 0]
        start = corner
        c = corner
        while c != INVALID:
            fn = self._face_normal(c)
            normal = [normal[k] + fn[k] for k in range(3)]
            c = ct.swing_right(c)
            if c == start:
                return normal
        c = ct.swing_left(start)
        while c != INVALID and c != start:
            fn = self._face_normal(c)
            normal = [normal[k] + fn[k] for k in range(3)]
            c = ct.swing_left(c)
        return normal

    def encode(
        self, oct_coords: np.ndarray, data_to_corner: np.ndarray
    ) -> np.ndarray:
        """oct_coords [N,2] target quantized octahedral ints → corrections
        (positive, modulo max_quantized_value — the decoder folds them back
        with mod_max, see OctahedronCanonicalizedTransform.compute_original).
        """
        tb = self.tool

        from uvbench.ref import native as uvt_native

        n = len(oct_coords)
        if (
            n > 0
            and self._pos_values is not None
            and uvt_native.get_draco_lib() is not None
        ):
            view = self.ct
            res = uvt_native.normals_encode_native(
                np.asarray(oct_coords, np.int64),
                tb.max_quantized_value,
                np.asarray(view.opposite, np.int32),
                np.asarray(view.vertex, np.int32),
                getattr(view, "_seam", None),
                data_to_corner,
                np.asarray(self._pos_values, np.int64),
                np.asarray(self._pos_data_of_corner, np.int32),
            )
            if res is not None:
                corr, flips = res
                self.flip_bits = np.asarray(flips, np.uint8)  # ndarray, not list
                return corr

        corr = np.zeros((n, 2), np.int64)
        for p in range(n):
            ci = int(data_to_corner[p])
            normal = self.predict(ci)
            normal = tb.canonicalize_integer_vector(normal)
            # candidate predictions: as-is and flipped (decode applies the
            # flip bit by negating the canonicalized vector pre-quantization)
            ps, pt = tb.integer_vector_to_quantized_octahedral_coords(normal)
            fs_, ft_ = tb.integer_vector_to_quantized_octahedral_coords(
                [-x for x in normal]
            )
            os_, ot_ = int(oct_coords[p, 0]), int(oct_coords[p, 1])
            c0, c1 = self._correction(ps, pt, os_, ot_)
            f0, f1 = self._correction(fs_, ft_, os_, ot_)
            if abs(f0) + abs(f1) < abs(c0) + abs(c1):
                self.flip_bits.append(1)
                c0, c1 = f0, f1
            else:
                self.flip_bits.append(0)
            # store positive modular representatives
            m = tb.max_quantized_value
            corr[p] = (c0 % m, c1 % m)
        return corr

    def _correction(self, ps: int, pt: int, os_: int, ot_: int) -> Tuple[int, int]:
        """Inverse of OctahedronCanonicalizedTransform.compute_original."""
        tb = self.tool
        c = tb.center_value
        s, t = ps - c, pt - c
        in_diamond = tb.is_in_diamond(s, t)
        if not in_diamond:
            s, t = tb.invert_diamond(s, t)
        in_bl = tb.is_in_bottom_left(s, t)
        rot = tb.get_rotation_count(s, t)
        if not in_bl:
            s, t = tb.rotate_point(s, t, rot)
        o_s, o_t = os_ - c, ot_ - c
        if not in_diamond:
            o_s, o_t = tb.invert_diamond(o_s, o_t)
        if not in_bl:
            o_s, o_t = tb.rotate_point(o_s, o_t, rot)
        return tb.mod_max(o_s - s), tb.mod_max(o_t - t)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Quantized:
    ints: np.ndarray  # [N, C] int64
    mins: np.ndarray  # [C] float32
    range_value: float
    bits: int


def quantize_attribute(values: np.ndarray, bits: int) -> Quantized:
    """Draco-style: per-component min, shared range = max extent."""
    v = np.asarray(values, np.float64)
    mins = v.min(axis=0)
    extent = v.max(axis=0) - mins
    rng = float(extent.max())
    if rng <= 0:
        rng = 1.0
    delta = rng / ((1 << bits) - 1)
    ints = np.floor((v - mins) / delta + 0.5).astype(np.int64)
    return Quantized(ints, mins.astype(np.float32), np.float32(rng), bits)


def quantize_normals(values: np.ndarray, bits: int) -> np.ndarray:
    """float unit normals [N,3] → quantized octahedral ints [N,2]."""
    from uvbench.ref import native as uvt_native

    if uvt_native.get_draco_lib() is not None:
        res = uvt_native.quantize_normals_native(
            np.asarray(values, np.float64), bits
        )
        if res is not None:
            return res
    tb = OctahedronToolBox(bits)
    out = np.zeros((len(values), 2), np.int64)
    scale = 1 << 29
    for i, nv in enumerate(np.asarray(values, np.float64)):
        iv = [int(round(nv[0] * scale)), int(round(nv[1] * scale)),
              int(round(nv[2] * scale))]
        iv = tb.canonicalize_integer_vector(iv)
        s, t = tb.integer_vector_to_quantized_octahedral_coords(iv)
        out[i] = (s, t)
    return out


# ---------------------------------------------------------------------------
# Top-level encode
# ---------------------------------------------------------------------------


def encode_drc(
    faces: np.ndarray,
    attributes: List[AttributeToEncode],
    *,
    traversal_encoding: str = "valence",
    attribute_traversal: str = "depth_first",
    position_prediction: str = "parallelogram",
    integer_compression: bool = True,
) -> bytes:
    """Encode a triangular mesh to a Draco 2.2 bitstream.

    `faces` are position-index triangles; attributes[0] must be POSITION.
    Per-corner attribute indexing (`corner_to_value`) expresses seams.
    `traversal_encoding`: "valence" (context-modeled rANS symbols, what
    draco_encoder emits by default) or "standard" (bit-coded CLER stream).
    `attribute_traversal`: "depth_first" or "prediction_degree" (vertex
    decoders only — draco's selection at low encoding speeds).
    `position_prediction`: "parallelogram" or "constrained_multi"
    (MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM, the scheme foreign
    draco encoders pair with prediction-degree traversal).
    `integer_compression=False` stores integer corrections raw
    (compressed=0 wire) instead of rANS symbol coding.
    These three exist to generate foreign-settings fixtures — default
    values reproduce draco_encoder's output at the reference's settings
    (the reference project's `scripts/Encoder.py:260-267`).
    """
    if attribute_traversal not in ("depth_first", "prediction_degree"):
        raise ValueError(f"unknown attribute_traversal {attribute_traversal!r}")
    if position_prediction not in ("parallelogram", "constrained_multi"):
        raise ValueError(f"unknown position_prediction {position_prediction!r}")
    if attributes[0].attribute_type != K.ATT_POSITION:
        raise ValueError("attributes[0] must be POSITION")
    faces = np.asarray(faces, np.int64)
    if (faces[:, 0] == faces[:, 1]).any() or (
        faces[:, 1] == faces[:, 2]
    ).any() or (faces[:, 2] == faces[:, 0]).any():
        raise ValueError("degenerate faces must be removed before encoding")

    # whole-frame native fast path (native/draco_frame_enc.cpp): one C
    # call runs corner table → traversal → replay → maps → per-attribute
    # DFS/quantize/predict/entropy → container bytes. Byte-identical to
    # the staged pipeline below, which stays as oracle and fallback
    # (parity locked in tests/test_native_draco.py).
    from uvbench.ref import native as _native_mod

    _default_wire = (
        attribute_traversal == "depth_first"
        and position_prediction == "parallelogram"
        and integer_compression
    )
    _fast = (
        _native_mod.drc_encode_native(
            faces, attributes, traversal_encoding == "standard"
        )
        if _default_wire
        else None
    )
    if _fast is not None:
        return _fast

    ct = EncoderCornerTable(faces)

    # ---- connectivity traversal -------------------------------------------
    trav = _edgebreaker_traverse(ct)
    num_symbols = len(trav.symbols)

    # ---- replay through the decoder machine --------------------------------
    from uvbench.ref import native as uvt_native
    from uvbench.ref.codecs.draco.corner_table import CornerTable

    symbols_decode_u8 = np.ascontiguousarray(
        np.asarray(trav.symbols, np.uint8)[::-1]
    )
    replay_contexts = None
    conn = None
    if uvt_native.get_draco_lib() is not None:
        max_nv = (
            ct.num_vertices + trav.num_split_symbols + 3 * ct.num_faces // 2 + 3
        )
        res = uvt_native.eb_replay_machine_native(
            symbols_decode_u8, ct.num_faces, max_nv, trav.splits,
            np.asarray(trav.start_face_bits, np.uint8),
        )
        if res is not None:
            opp_d, vert_d, vcorner_d, processed_d, contexts_d, counts_d = res
            ct_d = CornerTable(ct.num_faces, max_nv)
            ct_d.opposite = opp_d
            ct_d.vertex = vert_d
            ct_d.vertex_corner = vcorner_d
            ct_d.num_vertices = int(counts_d[2])
            conn = EdgebreakerConnectivity(
                corner_table=ct_d,
                vertex_remap=np.zeros(0, np.int32),
                num_vertices=int(counts_d[2]),
                attribute_seam_corners=[],
                num_attribute_data=0,
                processed_corners=processed_d[
                    : int(counts_d[0]) + int(counts_d[1])
                ],
            )
            replay_contexts = contexts_d
    if conn is None:
        replay = _ReplayValenceTraversal(
            list(reversed(trav.symbols)), trav.start_face_bits
        )
        conn = run_connectivity_machine(
            replay,
            True,
            num_faces=ct.num_faces,
            num_encoded_symbols=num_symbols,
            num_encoded_split_symbols=trav.num_split_symbols,
            num_encoded_vertices=ct.num_vertices,
            num_attribute_data=0,  # seams handled separately below
            splits=trav.splits,
        )
        replay_contexts = np.asarray(replay.contexts, np.int32)
    ct_d = conn.corner_table
    num_faces = ct.num_faces

    # ---- dec ↔ enc corner/vertex maps + attribute seams ----------------------
    # native single-pass version (uvt_eb_encode_maps) with the vectorized
    # numpy region as fallback/oracle; identical outputs incl. the
    # consistency assertions
    non_pos = attributes[1:]
    num_attribute_data = len(non_pos)
    sc_rev = np.asarray(trav.symbol_corners, np.int64)[::-1]
    dvert = ct_d.vertex
    maps_res = None
    if uvt_native.get_draco_lib() is not None:
        maps_res = uvt_native.eb_encode_maps_native(
            num_faces, num_symbols, sc_rev, dvert, ct.vertex, ct.opposite,
            ct_d.opposite[: 3 * num_faces],
            np.asarray(trav.interior_start_corners, np.int64),
            [np.asarray(a.corner_to_value, np.int64) for a in non_pos],
            ct_d.vertex_corner.shape[0],
        )
    if maps_res is not None:
        dec2enc_corner, _cs, seam_bit_lists, seam_corner_lists, boundary = (
            maps_res
        )
        final_seams = [
            np.concatenate([np.asarray(s, np.int64), boundary])
            for s in seam_corner_lists
        ]
    else:
        dec2enc_corner = np.full(3 * num_faces, INVALID, np.int64)
        enc_vert_of_dec = np.full(
            ct_d.vertex_corner.shape[0], INVALID, np.int64
        )
        j3 = 3 * np.arange(num_symbols, dtype=np.int64)
        nxt_sc = np.where(sc_rev % 3 == 2, sc_rev - 2, sc_rev + 1)
        prv_sc = np.where(sc_rev % 3 == 0, sc_rev + 2, sc_rev - 1)
        dec2enc_corner[j3] = sc_rev
        dec2enc_corner[j3 + 1] = nxt_sc
        dec2enc_corner[j3 + 2] = prv_sc
        dv_all = np.asarray(dvert[: 3 * num_symbols], np.int64)
        ev_all = np.asarray(ct.vertex, np.int64)[
            dec2enc_corner[: 3 * num_symbols]
        ]
        enc_vert_of_dec[dv_all] = ev_all  # last-writer; verified below
        if not np.array_equal(enc_vert_of_dec[dv_all], ev_all):
            raise AssertionError("inconsistent vertex correspondence")
        # init faces: match by (already mapped) vertices
        init_faces_dec = range(num_symbols, num_faces)
        for i, df in enumerate(init_faces_dec):
            sc = trav.interior_start_corners[i]
            enc_corners = [sc, next_corner(sc), previous_corner(sc)]
            enc_verts = [int(ct.vertex[c]) for c in enc_corners]
            for dc in (3 * df, 3 * df + 1, 3 * df + 2):
                ev = int(enc_vert_of_dec[dvert[dc]])
                if ev == INVALID:
                    raise AssertionError("init face vertex unmapped")
                k = enc_verts.index(ev)
                dec2enc_corner[dc] = enc_corners[k]
        if (dec2enc_corner == INVALID).any():
            raise AssertionError("incomplete corner correspondence")

        # attribute seams: for each face-order interior edge with opposite
        # face index greater than the current face (exactly the decoder's
        # seam-pass order, ascending corner index), a seam bit per
        # attribute — an edge is a seam when the attribute's value index
        # differs across it at either endpoint
        opp_d = np.asarray(ct_d.opposite[: 3 * num_faces], np.int64)
        corner_ids = np.arange(3 * num_faces, dtype=np.int64)
        edge_sel = (opp_d != INVALID) & (opp_d // 3 > corner_ids // 3)
        cs = corner_ids[edge_sel]  # ascending corner order == pass order
        ce = dec2enc_corner[cs]
        o_enc = np.asarray(ct.opposite, np.int64)[ce]
        o_safe = np.where(o_enc == INVALID, 0, o_enc)

        def _nxt(a):
            return np.where(a % 3 == 2, a - 2, a + 1)

        def _prv(a):
            return np.where(a % 3 == 0, a + 2, a - 1)

        seam_bit_lists = []
        seam_corner_lists = []
        nxt_ce, prv_ce = _nxt(ce), _prv(ce)
        nxt_o, prv_o = _nxt(o_safe), _prv(o_safe)
        for att in non_pos:
            c2v = np.asarray(att.corner_to_value, np.int64)
            bits = (
                (o_enc == INVALID)
                | (c2v[nxt_ce] != c2v[prv_o])
                | (c2v[prv_ce] != c2v[nxt_o])
            )
            seam_bit_lists.append(bits.astype(np.uint8))
            pairs = np.column_stack([cs[bits], opp_d[cs[bits]]]).reshape(-1)
            seam_corner_lists.append(pairs)
        boundary = np.nonzero(opp_d == INVALID)[0]
        final_seams = [
            np.concatenate([np.asarray(s, np.int64), boundary])
            for s in seam_corner_lists
        ]

    # ---- serialize header + connectivity ------------------------------------
    out = EncoderBuffer()
    out.raw(K.MAGIC)
    out.u8(2)
    out.u8(2)
    out.u8(K.TRIANGULAR_MESH)
    out.u8(K.MESH_EDGEBREAKER_ENCODING)
    out.u16(0)  # flags

    standard = traversal_encoding == "standard"
    out.u8(
        K.MESH_EDGEBREAKER_STANDARD_ENCODING
        if standard
        else K.MESH_EDGEBREAKER_VALENCE_ENCODING
    )
    out.varint(ct.num_vertices)
    out.varint(num_faces)
    out.u8(num_attribute_data)
    out.varint(num_symbols)
    out.varint(trav.num_split_symbols)

    # topology splits (sorted by source id; delta-coded)
    splits_sorted = sorted(
        trav.splits, key=lambda s: (s.source_symbol_id, s.split_symbol_id)
    )
    out.varint(len(splits_sorted))
    last_source = 0
    for s in splits_sorted:
        out.varint(s.source_symbol_id - last_source)
        out.varint(s.source_symbol_id - s.split_symbol_id)
        last_source = s.source_symbol_id
    if splits_sorted:
        out.start_bit_encoding()
        for s in splits_sorted:
            out.put_bits(s.source_edge, 1)
        out.end_bit_encoding(encode_size=False)

    def write_start_face_and_seams() -> None:
        # start-face bits (component order = decoder pop order)
        sf = RansBitEncoder()
        sf.encode_bits(trav.start_face_bits)
        sf.flush(out)
        # seam bits (decoder's face-order pass)
        for bits in seam_bit_lists:
            enc = RansBitEncoder()
            enc.encode_bits(bits)
            enc.flush(out)

    if standard:
        # bit-coded CLER symbols in decode order: C = '0', others
        # '1' + 2-bit suffix with symbol = (suffix << 1) | 1
        out.start_bit_encoding()
        # python ints: numpy uint8 symbols would poison put_bits' int state
        for sym in reversed(np.asarray(trav.symbols).tolist()):
            if sym == K.TOPOLOGY_C:
                out.put_bits(0, 1)
            else:
                out.put_bits(1, 1)
                out.put_bits(sym >> 1, 2)
        out.end_bit_encoding(encode_size=True)
        write_start_face_and_seams()
    else:
        write_start_face_and_seams()
        # valence contexts: bucket symbols by the replay-recorded context;
        # the decoder consumes each bucket back-to-front, so store reverse
        # decode order (== encode order within the bucket) — vectorized
        # (the per-symbol append loop was ~10 ms/frame on liam)
        top2idx = np.zeros(8, np.uint32)
        for t, i in TOPOLOGY_TO_SYMBOL_IDX.items():
            top2idx[t] = i
        ctx_arr = np.asarray(replay_contexts, np.int64)
        sym_idx = top2idx[symbols_decode_u8]
        for k in range(K.NUM_VALENCE_CONTEXTS):
            bucket = sym_idx[ctx_arr == k][::-1]
            out.varint(len(bucket))
            if len(bucket):
                encode_symbols(np.ascontiguousarray(bucket), 1, out)

    # ---- attribute encoding --------------------------------------------------
    # decoder layout mirrored from draco_encoder output (liam):
    #   position → vertex decoder (att_data_id -1); each non-position
    #   attribute → its own decoder with att_data_id 0..n-1; UV/normals are
    #   corner-mapped, integer attrs vertex-mapped
    decoder_plan = [(-1, K.MESH_VERTEX_ATTRIBUTE, attributes[0])]
    for i, att in enumerate(non_pos):
        dec_type = (
            K.MESH_VERTEX_ATTRIBUTE if att.integer else K.MESH_CORNER_ATTRIBUTE
        )
        decoder_plan.append((i, dec_type, att))

    out.u8(len(decoder_plan))
    pred_degree = attribute_traversal == "prediction_degree"
    for att_data_id, dec_type, att in decoder_plan:
        out.u8(att_data_id & 0xFF)
        out.u8(dec_type)
        # prediction-degree only applies to vertex decoders (corner
        # decoders are depth-first-only per the format)
        out.u8(
            K.MESH_TRAVERSAL_PREDICTION_DEGREE
            if pred_degree and dec_type == K.MESH_VERTEX_ATTRIBUTE
            else K.MESH_TRAVERSAL_DEPTH_FIRST
        )
    uid = 0
    for att_data_id, dec_type, att in decoder_plan:
        out.varint(1)
        if att.integer:
            dtype = K.DT_UINT8 if att.values.dtype == np.uint8 else K.DT_INT32
            seq_type = K.SEQ_INTEGER
        elif att.attribute_type == K.ATT_NORMAL:
            dtype = K.DT_FLOAT32
            seq_type = K.SEQ_NORMALS
        else:
            dtype = K.DT_FLOAT32
            seq_type = K.SEQ_QUANTIZATION
        out.u8(att.attribute_type)
        out.u8(dtype)
        out.u8(att.values.shape[1])
        out.u8(0)  # normalized
        out.varint(uid)
        uid += 1
        out.u8(seq_type)
        att._seq_type = seq_type  # stash for the payload pass

    # payload pass — mirrors decoder.py's per-decoder loop
    pos_values: Optional[np.ndarray] = None
    pos_vertex_to_data: Optional[np.ndarray] = None

    vertex_traversal_cache = None  # pos + integer attrs traverse identically
    for att_data_id, dec_type, att in decoder_plan:
        if dec_type == K.MESH_CORNER_ATTRIBUTE:
            att_table = MeshAttributeCornerTable(
                ct_d, final_seams[att_data_id]
            )
            view = _TableView(att_table, num_faces)
            corner_vertex = att_table.corner_to_vertex
            table_for_traversal = att_table
            vertex_to_data, data_to_corner = traverse_depth_first(
                table_for_traversal, num_faces,
                corner_order=conn.processed_corners,
            )
        else:
            view = _TableView(ct_d, num_faces)
            corner_vertex = ct_d.vertex
            table_for_traversal = ct_d
            # seamless vertex attributes (POSITION + every integer attr)
            # share one DFS over ct_d — identical inputs, identical result
            if vertex_traversal_cache is None:
                _tfn = (
                    traverse_prediction_degree
                    if pred_degree
                    else traverse_depth_first
                )
                vertex_traversal_cache = _tfn(
                    table_for_traversal, num_faces,
                    corner_order=conn.processed_corners,
                )
            vertex_to_data, data_to_corner = vertex_traversal_cache
        num_values = len(data_to_corner)

        # values in decoder data order: decoder corner → encoder corner →
        # input value index
        c2v = att.corner_to_value
        value_idx = np.asarray(c2v, np.int64)[
            dec2enc_corner[np.asarray(data_to_corner, np.int64)]
        ]
        # every corner of an attribute vertex must agree on the value index
        raw = att.values[value_idx]

        def pos_for_corner(c):
            return pos_values[pos_vertex_to_data[ct_d.vertex[c]]]

        seq_type = att._seq_type
        if seq_type in (K.SEQ_INTEGER, K.SEQ_QUANTIZATION):
            if seq_type == K.SEQ_QUANTIZATION:
                q = quantize_attribute(raw, att.quantization_bits)
                ints = q.ints
            else:
                ints = np.asarray(raw, np.int64)
                q = None
            if att.attribute_type == K.ATT_TEX_COORD:
                method = K.MESH_PREDICTION_TEX_COORDS_PORTABLE
            elif position_prediction == "constrained_multi":
                method = K.MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM
            else:
                method = K.MESH_PREDICTION_PARALLELOGRAM
            out.u8(method & 0xFF)
            out.u8(K.PREDICTION_TRANSFORM_WRAP)
            if method == K.MESH_PREDICTION_PARALLELOGRAM:
                corr, wrap = _encode_parallelogram(
                    ints, view, vertex_to_data, data_to_corner
                )
                symbols = convert_signed_to_symbols(corr.reshape(-1))
                _write_symbol_block(
                    symbols, ints.shape[1], out, integer_compression
                )
                wrap.write(out)
            elif method == K.MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM:
                corr, wrap, creases = _encode_constrained_multi(
                    ints, view, vertex_to_data, data_to_corner
                )
                symbols = convert_signed_to_symbols(corr.reshape(-1))
                _write_symbol_block(
                    symbols, ints.shape[1], out, integer_compression
                )
                # prediction data: 4 crease-flag streams, then wrap bounds
                for ctx_flags in creases:
                    out.varint(len(ctx_flags))
                    if ctx_flags:
                        enc = RansBitEncoder()
                        enc.encode_bits(ctx_flags)
                        enc.flush(out)
                wrap.write(out)
            else:
                pos_corner_map = (
                    np.asarray(
                        pos_vertex_to_data[ct_d.vertex[: 3 * num_faces]],
                        np.int32,
                    )
                    if pos_values is not None
                    else None
                )
                tex = _TexCoordsPortableEncoder(
                    view, vertex_to_data, pos_for_corner,
                    pos_values=pos_values,
                    pos_data_of_corner=pos_corner_map,
                )
                corr, wrap = tex.encode(ints, data_to_corner)
                symbols = corr.reshape(-1).astype(np.uint32)
                _write_symbol_block(symbols, 2, out, integer_compression)
                tex.write_orientations(out)
                wrap.write(out)
            if seq_type == K.SEQ_QUANTIZATION:
                out.raw(np.asarray(q.mins, "<f4").tobytes())
                out.raw(np.asarray([q.range_value], "<f4").tobytes())
                out.u8(q.bits)
            if att.attribute_type == K.ATT_POSITION:
                pos_values = ints
                pos_vertex_to_data = vertex_to_data
        elif seq_type == K.SEQ_NORMALS:
            out.u8(K.MESH_PREDICTION_GEOMETRIC_NORMAL & 0xFF)
            out.u8(K.PREDICTION_TRANSFORM_NORMAL_OCTAHEDRON_CANONICALIZED & 0xFF)
            bits = att.quantization_bits
            oct_coords = quantize_normals(raw, bits)
            # the decoder's predictor swings over the SEAM-CUT attribute view
            # (decoder.py passes `view` for corner-mapped normals) — must
            # mirror that here or seam-adjacent predictions diverge
            pos_corner_map = (
                np.asarray(
                    pos_vertex_to_data[ct_d.vertex[: 3 * num_faces]], np.int32
                )
                if pos_values is not None
                else None
            )
            genc = _GeometricNormalEncoder(
                view, pos_for_corner, bits,
                pos_values=pos_values,
                pos_data_of_corner=pos_corner_map,
            )
            corr = genc.encode(oct_coords, data_to_corner)
            # corrections are already positive modular representatives —
            # the decoder consumes them raw (no zigzag) and mod_max-folds
            symbols = corr.reshape(-1).astype(np.uint32)
            _write_symbol_block(symbols, 2, out, integer_compression)
            # transform header (max_quantized_value, center_value)
            tb = genc.tool
            out.raw(
                np.asarray(
                    [tb.max_quantized_value, tb.center_value], "<i4"
                ).tobytes()
            )
            flip = RansBitEncoder()
            flip.encode_bits(genc.flip_bits)
            flip.flush(out)
            out.u8(bits)
        else:
            raise NotImplementedError(f"seq type {seq_type}")

    return out.getvalue()
