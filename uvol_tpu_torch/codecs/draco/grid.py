"""Synthetic `.drc` frames: a displaced grid mesh with positions,
texcoords and normals, encoded by the port's Draco encoder.

The inputs of the `.drc` decode's smoke run and tests (the reference's
liam corpus is not in the repository). A frame of `ny x nx` vertices has
`2 (ny - 1)(nx - 1)` triangles; 83 x 315 is the liam batch's 26,145
vertices. Each seed displaces the grid differently. The default bits are
Draco's `draco_encoder` defaults (`-qp 11 -qt 10 -qn 8`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from uvol_tpu_torch.codecs.draco import constants as K
from uvol_tpu_torch.codecs.draco.encoder import AttributeToEncode, encode_drc


def grid_mesh(ny: int, nx: int, seed: int) -> Tuple[np.ndarray, ...]:
    """(positions [N, 3], texcoords [N, 2], unit normals [N, 3]) float32
    and faces [M, 3] int32 of a grid displaced by the seed."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    fx, fy, phase = r.uniform(0.05, 0.4), r.uniform(0.05, 0.4), r.uniform(0, 2 * np.pi)
    z = 0.08 * np.sin(fx * xx + phase) * np.cos(fy * yy) + 0.002 * r.normal(size=xx.shape)
    sx, sy = 1.0 / max(nx - 1, 1), 1.0 / max(ny - 1, 1)
    pos = np.stack([xx * sx, yy * sy, z], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([xx * sx, 1.0 - yy * sy], -1).reshape(-1, 2).astype(np.float32)
    gy, gx = np.gradient(z, sy, sx)
    nrm = np.stack([-gx, -gy, np.ones_like(z)], -1).reshape(-1, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    i = np.arange(ny * nx).reshape(ny, nx)
    a, b, c, d = i[:-1, :-1], i[:-1, 1:], i[1:, 1:], i[1:, :-1]
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)]).astype(np.int32)
    return pos, uv, nrm, faces


def grid_attributes(ny: int, nx: int, seed: int, bits: Tuple[int, int, int] = (11, 10, 8)):
    """(faces, [AttributeToEncode] of positions, texcoords and normals at
    `bits`) for `encoder.encode_drc`."""
    pos, uv, nrm, faces = grid_mesh(ny, nx, seed)
    c2v = faces.reshape(-1)
    return faces, [AttributeToEncode(K.ATT_POSITION, pos, c2v, bits[0]),
                   AttributeToEncode(K.ATT_TEX_COORD, uv, c2v, bits[1]),
                   AttributeToEncode(K.ATT_NORMAL, nrm, c2v, bits[2])]


def grid_drc(ny: int, nx: int, seed: int, bits: Tuple[int, int, int] = (11, 10, 8)) -> bytes:
    """One grid frame as `.drc` bytes, by `encoder.encode_drc` (the native
    whole-frame encoder, else the staged Python encoder: the same bytes)."""
    return encode_drc(*grid_attributes(ny, nx, seed, bits))
