# Frozen copy of the program's `codecs/draco/corner_table.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""Corner table — the mesh connectivity structure behind Edgebreaker coding.

The port's copy of `uvol_tpu/codecs/draco/corner_table.py`, unchanged in what it emits; it
calls the port's own native library (`uvbench.ref.native`).

Corners are integers; corner c belongs to face c // 3. `next`/`previous`
cycle within a face; `opposite` links the two corners facing a shared edge.
Orientation invariant used throughout the Draco-format codecs:

    vertex(next(c)) == vertex(previous(opposite(c)))
    vertex(previous(c)) == vertex(next(opposite(c)))

Also provides the seam-cut variant (`MeshAttributeCornerTable`) used by
corner-mapped attributes (UVs/normals with seams), mirroring the role of
Draco's MeshAttributeCornerTable for the reference's UV/normal channels.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

INVALID = -1


def next_corner(c: int) -> int:
    return c - 2 if c % 3 == 2 else c + 1


def previous_corner(c: int) -> int:
    return c + 2 if c % 3 == 0 else c - 1


class CornerTable:
    """Growable corner table used during Edgebreaker decode."""

    def __init__(self, num_faces: int, max_num_vertices: int):
        n = num_faces * 3
        self.opposite = np.full(n, INVALID, np.int32)
        self.vertex = np.full(n, INVALID, np.int32)
        # one representative corner per vertex (any corner mapped to it)
        self.vertex_corner = np.full(max_num_vertices, INVALID, np.int32)
        self.num_vertices = 0

    # -- topology ------------------------------------------------------------
    def set_opposite(self, a: int, b: int) -> None:
        self.opposite[a] = b
        self.opposite[b] = a

    def map_corner_to_vertex(self, corner: int, vert: int) -> None:
        self.vertex[corner] = vert

    def set_left_most_corner(self, vert: int, corner: int) -> None:
        """Explicitly maintained during Edgebreaker decode; the resting
        value (not a lazy walk) is load-bearing for attribute-vertex
        splitting (see MeshAttributeCornerTable.recompute_vertices)."""
        self.vertex_corner[vert] = corner

    def make_vertex_isolated(self, vert: int) -> None:
        self.vertex_corner[vert] = INVALID

    def new_vertex(self) -> int:
        v = self.num_vertices
        self.num_vertices += 1
        return v

    def swing_left(self, c: int) -> int:
        """CCW to the next corner around vertex(c); INVALID at a boundary."""
        o = self.opposite[next_corner(c)]
        return INVALID if o == INVALID else next_corner(o)

    def swing_right(self, c: int) -> int:
        o = self.opposite[previous_corner(c)]
        return INVALID if o == INVALID else previous_corner(o)

    def left_most_corner(self, vert: int) -> int:
        return int(self.vertex_corner[vert])

    def corners_around_vertex(self, vert: int, start: Optional[int] = None) -> List[int]:
        """All corners currently mapped to `vert` (walk both directions)."""
        start = int(self.vertex_corner[vert]) if start is None else start
        out = [start]
        c = start
        while True:
            c = self.swing_left(c)
            if c == INVALID or c == start:
                break
            out.append(c)
        if c != start:  # open fan: also walk right
            c = start
            while True:
                c = self.swing_right(c)
                if c == INVALID:
                    break
                out.append(c)
        return out

    @property
    def num_corners(self) -> int:
        return len(self.vertex)

    def faces(self) -> np.ndarray:
        return self.vertex.reshape(-1, 3)


class MeshAttributeCornerTable:
    """Attribute connectivity: the corner fan around each vertex is cut at
    seam edges, splitting one position-vertex into several attribute
    vertices (e.g. UV seams). Assigns an attribute-vertex id to each corner.
    """

    def __init__(self, ct: CornerTable, seam_corners: np.ndarray):
        """`seam_corners`: corners whose *opposite edge* is a seam."""
        self.ct = ct
        n = ct.num_corners
        self.is_edge_on_seam = np.zeros(n, bool)
        seam = np.asarray(seam_corners, np.int64)
        self.is_edge_on_seam[seam] = True
        opp = ct.opposite[seam]
        self.is_edge_on_seam[opp[opp != INVALID]] = True
        self.corner_to_vertex = np.full(n, INVALID, np.int32)
        self.vertex_to_corner: List[int] = []  # attribute vertex -> one corner
        self.vertex_parent: List[int] = []  # attribute vertex -> position vertex
        # vertices touching any seam edge (seam edge opposite corner c has
        # endpoints vertex(next(c)) and vertex(previous(c)))
        self.is_vertex_on_seam = np.zeros(ct.vertex_corner.shape[0], bool)
        seam_idx = np.nonzero(self.is_edge_on_seam)[0]
        nxt = np.where(seam_idx % 3 == 2, seam_idx - 2, seam_idx + 1)
        prv = np.where(seam_idx % 3 == 0, seam_idx + 2, seam_idx - 1)
        self.is_vertex_on_seam[ct.vertex[nxt]] = True
        self.is_vertex_on_seam[ct.vertex[prv]] = True

        from uvbench.ref import native as uvt_native

        res = None
        if uvt_native.get_draco_lib() is not None:
            res = uvt_native.attr_corner_table_native(
                ct.opposite[:n],
                ct.vertex[:n],
                ct.vertex_corner,
                ct.num_vertices,
                n,
                self.is_edge_on_seam,
                self.is_vertex_on_seam,
            )
        if res is not None:
            self.corner_to_vertex, v2c = res
            self.vertex_to_corner = v2c
            self.vertex_parent = ct.vertex[v2c]
        else:
            self._recompute()

    # seam-aware swings: cannot cross a seam edge
    def swing_left(self, c: int) -> int:
        nc = next_corner(c)
        if self.is_edge_on_seam[nc]:
            return INVALID
        o = self.ct.opposite[nc]
        return INVALID if o == INVALID else next_corner(o)

    def swing_right(self, c: int) -> int:
        pc = previous_corner(c)
        if self.is_edge_on_seam[pc]:
            return INVALID
        o = self.ct.opposite[pc]
        return INVALID if o == INVALID else previous_corner(o)

    def _recompute(self) -> None:
        """Assign attribute vertices by sweeping each position-vertex's fan.

        Matches the Draco decoder's RecomputeVertices semantics exactly:
        start at the *maintained* left-most corner from the Edgebreaker
        decode, swing right through the full fan (crossing seams), and open
        a new attribute vertex at every seam crossing. Note this
        deliberately reproduces Draco's behavior of not re-merging the
        first and last segments of a closed seamed fan — the split
        structure (and therefore the value count) must match the encoder.
        """
        ct = self.ct
        for vert in range(ct.num_vertices):
            first_c = int(ct.vertex_corner[vert])
            if first_c == INVALID:
                continue
            if self.is_vertex_on_seam[vert]:
                # find the fan start: swing left (seam-aware) to the seam
                act_c = self.swing_left(first_c)
                while act_c != INVALID:
                    first_c = act_c
                    act_c = self.swing_left(act_c)
            fan_vertex = len(self.vertex_to_corner)
            self.vertex_to_corner.append(first_c)
            self.vertex_parent.append(vert)
            self.corner_to_vertex[first_c] = fan_vertex
            c = ct.swing_right(first_c)
            while c != INVALID and c != first_c:
                if self.is_edge_on_seam[next_corner(c)]:
                    # crossed a seam: new attribute vertex
                    fan_vertex = len(self.vertex_to_corner)
                    self.vertex_to_corner.append(c)
                    self.vertex_parent.append(vert)
                self.corner_to_vertex[c] = fan_vertex
                c = ct.swing_right(c)

    @property
    def num_vertices(self) -> int:
        return len(self.vertex_to_corner)
