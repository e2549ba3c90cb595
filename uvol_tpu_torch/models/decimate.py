"""Progressive-mesh decimation (edge collapse) — pyprogmesh equivalent.

The reference's experimental encoder decimates each frame group with a
progressive-mesh edge-collapse pass before corto encoding
(its `deprecated/encoder/dev/encoder.py:182-366` driving
`pyprogmesh.py`, 780 LoC Melax-style collapse). This is the same
capability re-built around quadric error metrics: each collapse picks the
cheapest half-edge u→v by QEM cost, producing

  - a vertex permutation in collapse order (progressive transmission:
    keeping the first k permuted vertices + `collapse_map` yields a valid
    LOD for every k), and
  - the decimated mesh at the requested target.

Vectorized numpy where it counts (quadric accumulation, face updates);
the greedy loop is host-side by nature (data-dependent heap order).

The port's copy of `uvol_tpu/models/decimate.py`.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


@dataclasses.dataclass
class DecimatedMesh:
    positions: np.ndarray  # [M, 3] remaining vertices (original coords)
    faces: np.ndarray  # [F2, 3] indices into `positions`
    kept_original_ids: np.ndarray  # [M] original vertex id per output vertex
    collapse_map: np.ndarray  # [N] original id -> original id it merged into
    collapse_order: np.ndarray  # original ids, first-collapsed first


def _vertex_quadrics(positions: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Accumulate the fundamental error quadric of each face plane onto its
    vertices (Garland–Heckbert), fully vectorized."""
    v0, v1, v2 = (positions[faces[:, k]] for k in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    d = -np.einsum("ij,ij->i", n, v0)
    p = np.concatenate([n, d[:, None]], axis=1)  # [F, 4]
    kp = p[:, :, None] * p[:, None, :]  # [F, 4, 4]
    q = np.zeros((len(positions), 4, 4))
    for k in range(3):
        np.add.at(q, faces[:, k], kp)
    return q


def decimate_mesh(
    positions: np.ndarray,
    faces: np.ndarray,
    target_vertices: Optional[int] = None,
    target_ratio: float = 0.5,
) -> DecimatedMesh:
    positions = np.asarray(positions, np.float64)
    faces = np.asarray(faces, np.int64)
    n = len(positions)
    if target_vertices is None:
        target_vertices = max(3, int(n * target_ratio))

    quadrics = _vertex_quadrics(positions, faces)
    neighbors: List[Set[int]] = [set() for _ in range(n)]
    vertex_faces: List[Set[int]] = [set() for _ in range(n)]
    for fi, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            neighbors[u].add(int(v))
            neighbors[v].add(int(u))
        for u in (a, b, c):
            vertex_faces[int(u)].add(fi)

    def cost(u: int, v: int) -> float:
        """QEM cost of collapsing u into v (v keeps its position)."""
        q = quadrics[u] + quadrics[v]
        h = np.append(positions[v], 1.0)
        return float(h @ q @ h)

    heap: List[Tuple[float, int, int]] = []
    version = np.zeros(n, np.int64)

    def push_edges(u: int) -> None:
        for v in neighbors[u]:
            heapq.heappush(heap, (cost(u, v), u, v))

    for u in range(n):
        push_edges(u)

    alive = np.ones(n, bool)
    face_alive = np.ones(len(faces), bool)
    work_faces = faces.copy()
    collapse_map = np.arange(n, dtype=np.int64)
    collapse_order: List[int] = []
    remaining = n

    def is_stale(c: float, u: int, v: int) -> bool:
        return (
            not alive[u]
            or not alive[v]
            or v not in neighbors[u]
            or abs(cost(u, v) - c) > 1e-12
        )

    while remaining > target_vertices and heap:
        c, u, v = heapq.heappop(heap)
        if is_stale(c, u, v):
            continue
        # reject collapses that would flip triangle orientation
        flip = False
        for fi in vertex_faces[u]:
            if not face_alive[fi]:
                continue
            tri = work_faces[fi]
            if v in tri:
                continue  # face will degenerate (removed), fine
            old = tri.copy()
            new = np.where(old == u, v, old)
            n_old = np.cross(
                positions[old[1]] - positions[old[0]],
                positions[old[2]] - positions[old[0]],
            )
            n_new = np.cross(
                positions[new[1]] - positions[new[0]],
                positions[new[2]] - positions[new[0]],
            )
            if np.dot(n_old, n_new) < 0:
                flip = True
                break
        if flip:
            continue

        # collapse u -> v
        alive[u] = False
        remaining -= 1
        collapse_map[u] = v
        collapse_order.append(u)
        quadrics[v] = quadrics[v] + quadrics[u]
        for fi in list(vertex_faces[u]):
            if not face_alive[fi]:
                continue
            tri = work_faces[fi]
            if v in tri:
                face_alive[fi] = False  # degenerate after merge
                for w in tri:
                    vertex_faces[int(w)].discard(fi)
            else:
                work_faces[fi] = np.where(tri == u, v, tri)
                vertex_faces[v].add(fi)
        for w in list(neighbors[u]):
            neighbors[w].discard(u)
            if w != v and alive[w]:
                neighbors[w].add(v)
                neighbors[v].add(w)
        neighbors[u].clear()
        push_edges(v)

    kept = np.nonzero(alive)[0]
    remap = np.full(n, -1, np.int64)
    remap[kept] = np.arange(len(kept))
    out_faces = work_faces[face_alive]
    out_faces = remap[out_faces]
    # resolve chains in collapse_map (u -> ... -> live vertex)
    final = collapse_map.copy()
    for _ in range(32):
        nxt = final[final]
        if np.array_equal(nxt, final):
            break
        final = nxt
    return DecimatedMesh(
        positions=positions[kept].astype(np.float32),
        faces=out_faces.astype(np.int32),
        kept_original_ids=kept,
        collapse_map=final,
        collapse_order=np.asarray(collapse_order, np.int64),
    )
