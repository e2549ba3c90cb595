# Frozen copy of the program's `codecs/draco/edgebreaker.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""Draco Edgebreaker connectivity decoder (standard + valence coders).

The port's copy of `uvol_tpu/codecs/draco/edgebreaker.py`, unchanged in what it emits; it
calls the port's own native library (`uvbench.ref.native`).

Replays the CLER symbol stream in reverse encoding order ("spirale
reversi"), rebuilding the corner table face by face. Validated against the
liam corpus: context counters must reach exactly zero, the active-corner
stack must end with one entry per component, and every rANS section must be
consumed exactly.

Reference consumption path this replaces: draco_decoder.wasm invoked by
src/lib/DRACOLoader.js:483.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from uvbench.ref.codecs.buffer import DecoderBuffer
from uvbench.ref.codecs.draco.constants import (
    INVALID,
    LEFT_FACE_EDGE,
    MESH_EDGEBREAKER_STANDARD_ENCODING,
    MESH_EDGEBREAKER_VALENCE_ENCODING,
    MIN_VALENCE,
    MAX_VALENCE,
    NUM_VALENCE_CONTEXTS,
    RIGHT_FACE_EDGE,
    SYMBOL_TO_TOPOLOGY,
    TOPOLOGY_C,
    TOPOLOGY_E,
    TOPOLOGY_L,
    TOPOLOGY_R,
    TOPOLOGY_S,
)
from uvbench.ref.codecs.draco.corner_table import (
    CornerTable,
    next_corner,
    previous_corner,
)
from uvbench.ref.codecs.rans import RansBitDecoder
from uvbench.ref.codecs.symbol_coding import decode_symbols


@dataclasses.dataclass
class TopologySplit:
    source_symbol_id: int  # encoder-order ids as stored in the stream
    split_symbol_id: int
    source_edge: int = RIGHT_FACE_EDGE


@dataclasses.dataclass
class EdgebreakerConnectivity:
    corner_table: CornerTable
    vertex_remap: np.ndarray  # decode-time vertex id -> final compact id
    num_vertices: int
    attribute_seam_corners: List[np.ndarray]  # per attribute-data
    num_attribute_data: int
    #: tip corners of faces in reverse decode order (encoder traversal
    #: order); attribute traversals must seed from these, in order
    processed_corners: List[int] = dataclasses.field(default_factory=list)


class _ValenceTraversal:
    """Valence-context symbol source + seam/start-face bit decoders."""

    def __init__(self, buf: DecoderBuffer, num_attribute_data: int):
        self.start_face_decoder = RansBitDecoder(buf)
        self.seam_decoders = [RansBitDecoder(buf) for _ in range(num_attribute_data)]
        self.context_symbols: List[Optional[np.ndarray]] = []
        self.context_counters: List[int] = []
        for _ in range(NUM_VALENCE_CONTEXTS):
            n = buf.varint()
            if n > 0:
                self.context_symbols.append(decode_symbols(n, 1, buf))
            else:
                self.context_symbols.append(None)
            self.context_counters.append(n)
        self.active_context = -1
        self.last_symbol = -1

    def decode_symbol(self) -> int:
        if self.active_context != -1:
            ctx = self.active_context
            self.context_counters[ctx] -= 1
            counter = self.context_counters[ctx]
            if counter < 0:
                raise ValueError(f"valence context {ctx} underflow")
            self.last_symbol = SYMBOL_TO_TOPOLOGY[
                int(self.context_symbols[ctx][counter])
            ]
        else:
            self.last_symbol = TOPOLOGY_E
        return self.last_symbol


class _StandardTraversal:
    """Bit-coded CLER symbols (C='0', others '1'+2 bits)."""

    def __init__(self, buf: DecoderBuffer, num_attribute_data: int):
        # symbol bit section: varint64 size + LSB-first bits
        buf.start_bit_decoding(True)
        self._bit_buf = buf
        self._symbols_done = False
        # NOTE: start faces + seams follow after EndBitDecoding; handled by
        # the caller via `finish_symbols`.
        self.start_face_decoder: Optional[RansBitDecoder] = None
        self.seam_decoders: List[RansBitDecoder] = []
        self._num_attribute_data = num_attribute_data
        self.last_symbol = -1

    def finish_symbols(self, buf: DecoderBuffer) -> None:
        buf.end_bit_decoding()
        self.start_face_decoder = RansBitDecoder(buf)
        self.seam_decoders = [
            RansBitDecoder(buf) for _ in range(self._num_attribute_data)
        ]

    def decode_symbol(self) -> int:
        bit = self._bit_buf.get_bits(1)
        if bit == 0:
            self.last_symbol = TOPOLOGY_C
        else:
            suffix = self._bit_buf.get_bits(2)
            self.last_symbol = (suffix << 1) | 1
        return self.last_symbol


def decode_topology_splits(buf: DecoderBuffer) -> List[TopologySplit]:
    n = buf.varint()
    splits: List[TopologySplit] = []
    last_source = 0
    for _ in range(n):
        delta = buf.varint()
        source = last_source + delta
        delta2 = buf.varint()
        splits.append(TopologySplit(source, source - delta2))
        last_source = source
    if n:
        buf.start_bit_decoding(False)
        for s in splits:
            s.source_edge = buf.get_bits(1)
        buf.end_bit_decoding()
    return splits


def decode_edgebreaker_connectivity(
    buf: DecoderBuffer, *, trace: bool = False
) -> EdgebreakerConnectivity:
    traversal_type = buf.u8()
    num_encoded_vertices = buf.varint()
    num_faces = buf.varint()
    num_attribute_data = buf.u8()
    num_encoded_symbols = buf.varint()
    num_encoded_split_symbols = buf.varint()

    splits = decode_topology_splits(buf)

    if traversal_type == MESH_EDGEBREAKER_VALENCE_ENCODING:
        traversal = _ValenceTraversal(buf, num_attribute_data)
        valence_mode = True
    elif traversal_type == MESH_EDGEBREAKER_STANDARD_ENCODING:
        traversal = _StandardTraversal(buf, num_attribute_data)
        valence_mode = False
    else:
        raise NotImplementedError(f"traversal type {traversal_type}")

    return run_connectivity_machine(
        traversal,
        valence_mode,
        num_faces=num_faces,
        num_encoded_symbols=num_encoded_symbols,
        num_encoded_split_symbols=num_encoded_split_symbols,
        num_encoded_vertices=num_encoded_vertices,
        num_attribute_data=num_attribute_data,
        splits=splits,
        buf=buf,
    )


def run_connectivity_machine(
    traversal,
    valence_mode: bool,
    *,
    num_faces: int,
    num_encoded_symbols: int,
    num_encoded_split_symbols: int,
    num_encoded_vertices: int,
    num_attribute_data: int,
    splits: List[TopologySplit],
    buf: Optional[DecoderBuffer] = None,
) -> EdgebreakerConnectivity:
    """The spirale-reversi replay, driven by any symbol/bit source.

    `traversal` supplies decode_symbol / start_face_decoder / seam_decoders;
    the encoder drives this with a scripted traversal to (a) compute the
    valence contexts exactly as the decoder will, and (b) obtain the
    decoder-side corner table its attribute encoding must traverse.
    """
    # native C++ fast path for the real valence decoder (1:1 port; the
    # Python loop below is the reference + fallback)
    if valence_mode and isinstance(traversal, _ValenceTraversal):
        from uvbench.ref import native as uvt_native

        if uvt_native.get_draco_lib() is not None:
            return _run_machine_native(
                traversal,
                num_faces=num_faces,
                num_encoded_symbols=num_encoded_symbols,
                num_encoded_split_symbols=num_encoded_split_symbols,
                num_encoded_vertices=num_encoded_vertices,
                num_attribute_data=num_attribute_data,
                splits=splits,
            )

    # encoder-order source id -> list of splits (consumed as faces appear)
    splits_by_source: Dict[int, List[TopologySplit]] = {}
    for s in splits:
        splits_by_source.setdefault(s.source_symbol_id, []).append(s)

    max_num_vertices = num_encoded_vertices + num_encoded_split_symbols
    # allow extra room: isolated-face counting slack
    ct = CornerTable(num_faces, max_num_vertices + 3 * num_faces // 2 + 3)

    vertex_valences = np.zeros(ct.vertex_corner.shape[0], np.int64)
    is_vert_hole = np.ones(ct.vertex_corner.shape[0], bool)
    # union-find style remap for S merges
    vertex_alias = np.arange(ct.vertex_corner.shape[0], dtype=np.int32)

    active_corner_stack: List[int] = []
    topology_split_active_corners: Dict[int, int] = {}
    # seam decode log: (corner ids in decode order per attribute)
    seam_corners: List[List[int]] = [[] for _ in range(num_attribute_data)]

    opp = ct.opposite
    vert = ct.vertex


    processed_corners: List[int] = []
    init_face_corners: List[int] = []
    num_symbols = num_encoded_symbols
    for symbol_id in range(num_symbols):
        symbol = traversal.decode_symbol()
        corner = 3 * symbol_id  # one face per symbol
        processed_corners.append(corner)
        check_topology_split = False

        if symbol == TOPOLOGY_C:
            if not active_corner_stack:
                raise ValueError(f"C with empty stack at symbol {symbol_id}")
            corner_a = active_corner_stack[-1]
            vertex_x = int(vert[next_corner(corner_a)])
            corner_b = next_corner(ct.left_most_corner(vertex_x))
            if corner_a == corner_b:
                raise ValueError(f"non-manifold C at symbol {symbol_id}")
            vert_b_next = int(vert[next_corner(corner_b)])
            vert_a_prev = int(vert[previous_corner(corner_a)])
            ct.set_opposite(corner_a, corner + 1)
            ct.set_opposite(corner_b, corner + 2)
            ct.map_corner_to_vertex(corner, vertex_x)
            ct.map_corner_to_vertex(corner + 1, vert_b_next)
            ct.map_corner_to_vertex(corner + 2, vert_a_prev)
            ct.set_left_most_corner(vert_a_prev, corner + 2)
            is_vert_hole[vertex_x] = False
            active_corner_stack[-1] = corner

        elif symbol == TOPOLOGY_R or symbol == TOPOLOGY_L:
            if not active_corner_stack:
                raise ValueError(f"R/L with empty stack at symbol {symbol_id}")
            corner_a = active_corner_stack[-1]
            if symbol == TOPOLOGY_R:
                opp_corner, corner_l, corner_r = corner + 2, corner + 1, corner
            else:
                opp_corner, corner_l, corner_r = corner + 1, corner, corner + 2
            ct.set_opposite(corner_a, opp_corner)
            new_vert = ct.new_vertex()
            ct.map_corner_to_vertex(opp_corner, new_vert)
            ct.set_left_most_corner(new_vert, opp_corner)
            vertex_r = int(vert[previous_corner(corner_a)])
            ct.map_corner_to_vertex(corner_r, vertex_r)
            ct.set_left_most_corner(vertex_r, corner_r)
            ct.map_corner_to_vertex(corner_l, int(vert[next_corner(corner_a)]))
            active_corner_stack[-1] = corner
            check_topology_split = True

        elif symbol == TOPOLOGY_E:
            v0, v1, v2 = ct.new_vertex(), ct.new_vertex(), ct.new_vertex()
            ct.map_corner_to_vertex(corner, v0)
            ct.map_corner_to_vertex(corner + 1, v1)
            ct.map_corner_to_vertex(corner + 2, v2)
            ct.set_left_most_corner(v0, corner)
            ct.set_left_most_corner(v1, corner + 1)
            ct.set_left_most_corner(v2, corner + 2)
            active_corner_stack.append(corner)
            check_topology_split = True

        elif symbol == TOPOLOGY_S:
            if not active_corner_stack:
                raise ValueError(f"S with empty stack at symbol {symbol_id}")
            corner_b = active_corner_stack.pop()
            saved = topology_split_active_corners.pop(symbol_id, None)
            if saved is not None:
                active_corner_stack.append(saved)
            if not active_corner_stack:
                raise ValueError(f"S with empty stack at symbol {symbol_id}")
            corner_a = active_corner_stack[-1]
            if opp[corner_a] != INVALID or opp[corner_b] != INVALID:
                raise ValueError(f"S corners already attached at {symbol_id}")
            vertex_p = int(vert[previous_corner(corner_a)])
            vertex_q = int(vert[next_corner(corner_b)])
            if vertex_p == vertex_q:
                raise ValueError(f"degenerate S merge at {symbol_id}")
            # remap all corners of q to p: sweep right from q's left-most
            first_q_corner = ct.left_most_corner(vertex_q)
            c = first_q_corner
            steps = 0
            while c != INVALID:
                vert[c] = vertex_p
                c = ct.swing_right(c)
                steps += 1
                if steps > 3 * num_faces:  # hostile: closed-fan S ref
                    raise ValueError(f"S sweep cycle at symbol {symbol_id}")
            ct.set_opposite(corner_a, corner + 2)
            ct.set_opposite(corner_b, corner + 1)
            ct.map_corner_to_vertex(corner, vertex_p)
            ct.map_corner_to_vertex(corner + 1, int(vert[next_corner(corner_a)]))
            ct.map_corner_to_vertex(corner + 2, int(vert[previous_corner(corner_b)]))
            # merged fan's left end comes from q's old fan
            ct.set_left_most_corner(vertex_p, first_q_corner)
            ct.make_vertex_isolated(vertex_q)
            vertex_alias[vertex_q] = vertex_p
            vertex_valences[vertex_p] += vertex_valences[vertex_q]
            is_vert_hole[vertex_q] = False
            active_corner_stack[-1] = corner

        else:
            raise ValueError(f"bad symbol {symbol} at {symbol_id}")

        # register topology-split corners exposed by this face
        if check_topology_split:
            encoder_symbol_id = num_symbols - symbol_id - 1
            for s in splits_by_source.get(encoder_symbol_id, ()):  # sorted ok
                decoder_split_id = num_symbols - s.split_symbol_id - 1
                if s.source_edge == RIGHT_FACE_EDGE:
                    topology_split_active_corners[decoder_split_id] = next_corner(
                        corner
                    )
                else:
                    topology_split_active_corners[decoder_split_id] = (
                        previous_corner(corner)
                    )

        # valence tracking (context selection for the next symbol)
        if valence_mode:
            nxt, prv = next_corner(corner), previous_corner(corner)
            if symbol == TOPOLOGY_C or symbol == TOPOLOGY_S:
                vertex_valences[vert[nxt]] += 1
                vertex_valences[vert[prv]] += 1
            elif symbol == TOPOLOGY_R:
                vertex_valences[vert[corner]] += 1
                vertex_valences[vert[nxt]] += 1
                vertex_valences[vert[prv]] += 2
            elif symbol == TOPOLOGY_L:
                vertex_valences[vert[corner]] += 1
                vertex_valences[vert[nxt]] += 2
                vertex_valences[vert[prv]] += 1
            elif symbol == TOPOLOGY_E:
                vertex_valences[vert[corner]] += 2
                vertex_valences[vert[nxt]] += 2
                vertex_valences[vert[prv]] += 2
            active_valence = int(vertex_valences[vert[nxt]])
            clamped = min(max(active_valence, MIN_VALENCE), MAX_VALENCE)
            traversal.active_context = clamped - MIN_VALENCE


    if not valence_mode:
        # standard coder: the start-face and seam rANS sections follow the
        # symbol bit section; the shared machine below then consumes them
        # exactly like the valence path (same decoder-side pass order)
        traversal.finish_symbols(buf)

    # ---- end of symbols: init faces / holes --------------------------------
    num_decoded_faces = num_symbols
    while active_corner_stack:
        corner = active_corner_stack.pop()
        interior = traversal.start_face_decoder.decode_bit()
        if interior:
            # the remaining 3-edge boundary loop is the encoder's start face
            corner_a = corner
            corner_b = previous_corner(corner_a)
            while opp[corner_b] != INVALID:
                corner_b = previous_corner(opp[corner_b])
            corner_c = next_corner(corner_a)
            while opp[corner_c] != INVALID:
                corner_c = next_corner(opp[corner_c])
            face_corner = 3 * num_decoded_faces
            num_decoded_faces += 1
            init_face_corners.append(face_corner)
            if face_corner + 2 >= ct.num_corners:
                raise ValueError("face overflow at init face")
            # new corners x_a ↔ corner_a, x_b ↔ corner_c, x_c ↔ corner_b
            # orientation: vertex(next(x)) == vertex(previous(opp(x)))
            vert_n_b = int(vert[next_corner(corner_b)])
            vert_n_c = int(vert[next_corner(corner_c)])
            vert_n_a = int(vert[next_corner(corner_a)])
            ct.set_opposite(face_corner, corner_a)
            ct.set_opposite(face_corner + 1, corner_b)
            ct.set_opposite(face_corner + 2, corner_c)
            ct.map_corner_to_vertex(face_corner, vert_n_b)
            ct.map_corner_to_vertex(face_corner + 1, vert_n_c)
            ct.map_corner_to_vertex(face_corner + 2, vert_n_a)
            # orientation sanity: vertex(next(x)) == vertex(previous(opp(x)))
            for x in (face_corner, face_corner + 1, face_corner + 2):
                o = opp[x]
                if (
                    vert[next_corner(x)] != vert[previous_corner(o)]
                    or vert[previous_corner(x)] != vert[next_corner(o)]
                ):
                    raise ValueError("init face orientation mismatch")
            for v in (vert_n_b, vert_n_c, vert_n_a):
                is_vert_hole[v] = False
        # hole config: boundary stays open, nothing to add

    if num_decoded_faces != num_faces:
        raise ValueError(f"decoded {num_decoded_faces} faces, expected {num_faces}")
    for i, n in enumerate(getattr(traversal, "context_counters", [])):
        if n != 0:
            raise ValueError(f"context {i} has {n} unconsumed symbols")

    # Attribute seam decode: a separate pass over faces in index order.
    # An edge's seam bits are consumed at the lower-indexed face of its two
    # faces (the opposite face is "not yet visited" by this pass), one bit
    # per attribute-data, corners in (c, next, prev) order.
    for f in range(num_faces):
        for c in (3 * f, 3 * f + 1, 3 * f + 2):
            o = opp[c]
            if o != INVALID and o // 3 > f:
                for i, dec in enumerate(traversal.seam_decoders):
                    if dec.decode_bit():
                        seam_corners[i].append(c)
                        seam_corners[i].append(int(o))

    # final boundary edges are seams for every attribute
    final_seams = [np.asarray(s, np.int64) for s in seam_corners]
    boundary = np.nonzero(ct.opposite[: 3 * num_faces] == INVALID)[0]
    for i in range(num_attribute_data):
        final_seams[i] = np.concatenate([final_seams[i], boundary])

    # compact vertex ids (drop merged slots)
    used = np.unique(vert[: 3 * num_faces])
    remap = np.full(ct.vertex_corner.shape[0], INVALID, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)

    # Attribute-traversal seed order: the format's corner order is DECODE
    # order (the encoder reverses its own traversal list to decode order
    # before seeding attribute traversals), with init-face corners appended
    # after the regular corners, in component order (= stack pop order).
    processed_corners.extend(init_face_corners)
    return EdgebreakerConnectivity(
        corner_table=ct,
        vertex_remap=remap,
        num_vertices=len(used),
        attribute_seam_corners=final_seams,
        num_attribute_data=num_attribute_data,
        processed_corners=processed_corners,
    )


def _run_machine_native(
    traversal: "_ValenceTraversal",
    *,
    num_faces: int,
    num_encoded_symbols: int,
    num_encoded_split_symbols: int,
    num_encoded_vertices: int,
    num_attribute_data: int,
    splits: List[TopologySplit],
) -> EdgebreakerConnectivity:
    """C++ machine + seam pass (native/draco_native.cpp), identical outputs
    to the Python loop above (parity-tested on the liam corpus)."""
    from uvbench.ref import native as uvt_native

    max_num_vertices = (
        num_encoded_vertices + num_encoded_split_symbols + 3 * num_faces // 2 + 3
    )
    sf = traversal.start_face_decoder
    opposite, vertex, vertex_corner, processed, counts = (
        uvt_native.eb_valence_machine_native(
            traversal.context_symbols,
            num_encoded_symbols,
            num_faces,
            max_num_vertices,
            splits,
            sf.prob_zero,
            sf._buf,
        )
    )
    n_processed, n_init, num_vertices_raw, _n_components = (
        int(counts[0]), int(counts[1]), int(counts[2]), int(counts[3]),
    )
    # mark contexts consumed (the caller-side bookkeeping)
    traversal.context_counters = [0] * len(traversal.context_counters)

    ct = CornerTable(num_faces, max_num_vertices)
    ct.opposite = opposite
    ct.vertex = vertex
    ct.vertex_corner = vertex_corner
    ct.num_vertices = num_vertices_raw

    seam_lists = uvt_native.seam_pass_native(
        opposite,
        num_faces,
        [(d.prob_zero, d._buf) for d in traversal.seam_decoders],
    )
    boundary = np.nonzero(opposite[: 3 * num_faces] == INVALID)[0]
    final_seams = [
        np.concatenate([np.asarray(s, np.int64), boundary]) for s in seam_lists
    ]
    while len(final_seams) < num_attribute_data:
        final_seams.append(boundary.copy())

    used = np.unique(vertex[: 3 * num_faces])
    remap = np.full(max_num_vertices, INVALID, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)

    return EdgebreakerConnectivity(
        corner_table=ct,
        vertex_remap=remap,
        num_vertices=len(used),
        attribute_seam_corners=final_seams,
        num_attribute_data=num_attribute_data,
        processed_corners=processed[: n_processed + n_init],
    )
