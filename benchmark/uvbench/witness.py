"""Decode-side witnesses: what a frame decodes to, held against the
inputs the benchmark made, by rules that take nothing from the encoders.

Geometry: every decoded position and UV lies within half a quantization
step of its input (the step: the attribute's largest extent over the
input's vertices, over 2^bits - 1, as the Draco format states it), and
the decoded faces are the input's faces. A `.drc` frame reorders vertices
and faces, so each decoded point is matched to its nearest input vertex
first (the grid's vertices lie many steps apart).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def step(source: np.ndarray, bits: int) -> float:
    """The quantization step of [N, C] `source` at `bits`."""
    src = np.asarray(source, np.float64)
    extent = float((src.max(axis=0) - src.min(axis=0)).max())
    return (extent if extent > 0 else 1.0) / ((1 << bits) - 1)


def error_steps(decoded: np.ndarray, source: np.ndarray, bits: int) -> float:
    """The largest |decoded - source| over every value, in steps."""
    d = np.abs(np.asarray(decoded, np.float64) - np.asarray(source, np.float64))
    return float(d.max() / step(source, bits)) if d.size else 0.0


def _canonical(faces: np.ndarray) -> np.ndarray:
    """[M, 3] faces, each rotated to start at its smallest index (orientation
    kept), rows sorted."""
    f = np.asarray(faces, np.int64)
    r = np.argmin(f, axis=1)
    rows = np.arange(len(f))[:, None]
    f = f[rows, (r[:, None] + np.arange(3)[None, :]) % 3]
    return f[np.lexsort(f.T[::-1])]


def same_faces(got: np.ndarray, want: np.ndarray) -> bool:
    """Whether two face lists hold the same oriented triangles."""
    return got.shape == want.shape and np.array_equal(_canonical(got), _canonical(want))


def drc_frame(dpos: np.ndarray, duv: np.ndarray, dfaces: np.ndarray, pos: np.ndarray,
              uv: np.ndarray, faces: np.ndarray, pbits: int, ubits: int) -> Tuple[float, bool]:
    """(the larger of the positions' and the UVs' error in steps, whether the
    faces are the input's) of a decoded `.drc` frame: points matched to their
    nearest input vertex by position; a match that is not one to one reads
    infinite."""
    from scipy.spatial import cKDTree

    if dpos is None or duv is None or len(dpos) != len(pos):
        return float("inf"), False
    _dist, idx = cKDTree(np.asarray(pos, np.float64)).query(np.asarray(dpos, np.float64))
    if len(np.unique(idx)) != len(pos):
        return float("inf"), False
    # one to one: pos[idx] is the input reordered, with the input's steps
    err = max(error_steps(dpos, pos[idx], pbits), error_steps(duv, uv[idx], ubits))
    return err, same_faces(idx[np.asarray(dfaces, np.int64)], faces)
