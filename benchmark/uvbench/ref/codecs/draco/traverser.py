# Frozen copy of the program's `codecs/draco/traverser.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""Depth-first mesh traversal producing the attribute encoding order.

The port's copy of `uvol_tpu/codecs/draco/traverser.py`, unchanged in what it emits; it
calls the port's own native library (`uvbench.ref.native`).

The value stream of each attribute is ordered by the first visit of each
(attribute-)vertex during a deterministic depth-first traversal of the
corner table — identical on encoder and decoder. This reimplements the
depth-first traverser semantics of the Draco format (validated against the
liam corpus by full-stream consumption).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from uvbench.ref.codecs.draco.corner_table import (
    INVALID,
    CornerTable,
    MeshAttributeCornerTable,
    next_corner,
    previous_corner,
)


class _TableView:
    """Uniform view over CornerTable / MeshAttributeCornerTable."""

    def __init__(self, table, num_faces: int):
        self.num_faces = num_faces
        if isinstance(table, MeshAttributeCornerTable):
            self._att = table
            self._ct = table.ct
            self.vertex = table.corner_to_vertex
            self.num_vertices = table.num_vertices
            self._seam = table.is_edge_on_seam
        else:
            self._att = None
            self._ct = table
            self.vertex = table.vertex
            self.num_vertices = table.num_vertices
            self._seam = None
        self.opposite = self._ct.opposite

    def opp(self, c: int) -> int:
        if c == INVALID:
            return INVALID
        if self._seam is not None and self._seam[c]:
            return INVALID
        return int(self.opposite[c])

    def right_corner(self, c: int) -> int:
        return self.opp(next_corner(c))

    def left_corner(self, c: int) -> int:
        return self.opp(previous_corner(c))

    def swing_left(self, c: int) -> int:
        o = self.opp(next_corner(c))
        return INVALID if o == INVALID else next_corner(o)

    def swing_right(self, c: int) -> int:
        o = self.opp(previous_corner(c))
        return INVALID if o == INVALID else previous_corner(o)

    def is_on_boundary(self, vert: int, corner_hint: int) -> bool:
        """True when the vertex fan is open (has a boundary/seam edge)."""
        c = corner_hint
        start = c
        while True:
            n = self.swing_left(c)
            if n == INVALID:
                return True
            if n == start:
                return False
            c = n


def traverse_depth_first(
    table, num_faces: int, corner_order=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (vertex_to_data, data_to_corner):
    vertex_to_data[v] = encoding-order index of (attribute) vertex v;
    data_to_corner[i] = corner at which value i was first visited.

    `corner_order`: seed corners in encoder-traversal order (the decoder's
    processed connectivity corners, reversed). Falls back to face order.
    """
    view = _TableView(table, num_faces)

    # native C++ fast path (draco_native.cpp, parity-tested)
    from uvbench.ref import native as uvt_native

    if uvt_native.get_draco_lib() is not None:
        order = np.asarray(
            corner_order
            if corner_order is not None
            else [3 * f for f in range(num_faces)],
            np.int32,
        )
        res = uvt_native.traverse_native(
            view.opposite[: 3 * num_faces],
            np.asarray(view.vertex[: 3 * num_faces], np.int32),
            None if view._seam is None else view._seam[: 3 * num_faces],
            num_faces,
            view.num_vertices,
            order,
        )
        if res is not None:
            v2d, d2c = res
            return v2d, d2c.astype(np.int64)
    nv = view.num_vertices
    vertex_to_data = np.full(nv, INVALID, np.int32)
    data_to_corner: List[int] = []
    is_face_visited = np.zeros(num_faces, bool)
    is_vertex_visited = np.zeros(nv, bool)

    def visit_vertex(v: int, corner: int) -> None:
        is_vertex_visited[v] = True
        vertex_to_data[v] = len(data_to_corner)
        data_to_corner.append(corner)

    def face_visited(face: int) -> bool:
        return face == INVALID or bool(is_face_visited[face])

    vertex = view.vertex
    seeds = corner_order if corner_order is not None else [
        3 * f for f in range(num_faces)
    ]
    for corner_id in seeds:
        if is_face_visited[corner_id // 3]:
            continue
        stack = [corner_id]
        nxt, prv = next_corner(corner_id), previous_corner(corner_id)
        nv_id, pv_id = int(vertex[nxt]), int(vertex[prv])
        if not is_vertex_visited[nv_id]:
            visit_vertex(nv_id, nxt)
        if not is_vertex_visited[pv_id]:
            visit_vertex(pv_id, prv)

        while stack:
            corner_id = stack[-1]
            face_id = INVALID if corner_id == INVALID else corner_id // 3
            if face_visited(face_id):
                stack.pop()
                continue
            while True:
                is_face_visited[face_id] = True
                vert_id = int(vertex[corner_id])
                if not is_vertex_visited[vert_id]:
                    on_boundary = view.is_on_boundary(vert_id, corner_id)
                    visit_vertex(vert_id, corner_id)
                    if not on_boundary:
                        corner_id = view.right_corner(corner_id)
                        face_id = INVALID if corner_id == INVALID else corner_id // 3
                        continue
                right_corner = view.right_corner(corner_id)
                left_corner = view.left_corner(corner_id)
                right_face = INVALID if right_corner == INVALID else right_corner // 3
                left_face = INVALID if left_corner == INVALID else left_corner // 3
                if face_visited(right_face):
                    if face_visited(left_face):
                        stack.pop()
                        break
                    corner_id = left_corner
                    face_id = left_face
                else:
                    if face_visited(left_face):
                        corner_id = right_corner
                        face_id = right_face
                    else:
                        stack[-1] = left_corner
                        stack.append(right_corner)
                        break

    return vertex_to_data, np.asarray(data_to_corner, np.int64)


_MAX_PRIORITY = 3  # Draco MaxPredictionDegreeTraverser::kMaxPriority


def traverse_prediction_degree(
    table, num_faces: int, corner_order=None
) -> Tuple[np.ndarray, np.ndarray]:
    """MESH_TRAVERSAL_PREDICTION_DEGREE order (Draco
    MaxPredictionDegreeTraverser semantics): corners are expanded from
    priority buckets 0..2 where traversing toward an already-visited
    vertex has priority 0, toward a vertex whose running prediction
    degree exceeds 1 has priority 1, and toward a fresh vertex priority 2
    — so vertices reachable by full parallelograms decode first. Only
    valid for vertex-attribute decoders (the reference WASM decoder
    rejects it for corner-mapped attributes; so do we).

    Returns the same (vertex_to_data, data_to_corner) contract as
    `traverse_depth_first`.
    """
    view = _TableView(table, num_faces)
    nv = view.num_vertices
    vertex = view.vertex
    vertex_to_data = np.full(nv, INVALID, np.int32)
    data_to_corner: List[int] = []
    is_face_visited = np.zeros(num_faces, bool)
    is_vertex_visited = np.zeros(nv, bool)
    prediction_degree = np.zeros(nv, np.int32)

    def visit_vertex(v: int, corner: int) -> None:
        is_vertex_visited[v] = True
        vertex_to_data[v] = len(data_to_corner)
        data_to_corner.append(corner)

    def face_visited(corner: int) -> bool:
        return corner == INVALID or bool(is_face_visited[corner // 3])

    stacks: List[List[int]] = [[] for _ in range(_MAX_PRIORITY)]

    def compute_priority(corner_id: int) -> int:
        v_tip = int(vertex[corner_id])
        priority = 0
        if not is_vertex_visited[v_tip]:
            prediction_degree[v_tip] += 1
            priority = 1 if prediction_degree[v_tip] > 1 else 2
        return min(priority, _MAX_PRIORITY - 1)

    seeds = corner_order if corner_order is not None else [
        3 * f for f in range(num_faces)
    ]
    for seed in seeds:
        if is_face_visited[seed // 3]:
            continue
        stacks[0].append(int(seed))
        best_priority = 0
        nxt, prv = next_corner(int(seed)), previous_corner(int(seed))
        for c in (nxt, prv):
            v = int(vertex[c])
            if not is_vertex_visited[v]:
                visit_vertex(v, c)

        while True:
            # pop the next corner from the best-priority bucket (LIFO)
            corner_id = INVALID
            for i in range(best_priority, _MAX_PRIORITY):
                if stacks[i]:
                    corner_id = stacks[i].pop()
                    best_priority = i
                    break
            if corner_id == INVALID:
                break
            if face_visited(corner_id):
                continue
            while True:
                is_face_visited[corner_id // 3] = True
                vert_id = int(vertex[corner_id])
                if not is_vertex_visited[vert_id]:
                    visit_vertex(vert_id, corner_id)
                right_corner = view.right_corner(corner_id)
                left_corner = view.left_corner(corner_id)
                right_visited = face_visited(right_corner)
                left_visited = face_visited(left_corner)
                if not left_visited:
                    priority = compute_priority(left_corner)
                    if right_visited and priority <= best_priority:
                        # the left face is guaranteed next — skip the stack
                        corner_id = left_corner
                        continue
                    stacks[priority].append(left_corner)
                    if priority < best_priority:
                        best_priority = priority
                if not right_visited:
                    priority = compute_priority(right_corner)
                    if priority <= best_priority:
                        corner_id = right_corner
                        continue
                    stacks[priority].append(right_corner)
                    if priority < best_priority:
                        best_priority = priority
                break

    return vertex_to_data, np.asarray(data_to_corner, np.int64)
