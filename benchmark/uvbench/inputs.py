"""The benchmark's inputs, made from the seed: mesh frames and texture layers.

Geometry: a displaced grid of `ny x nx` vertices a frame (83 x 315 is
26,145 vertices and 51,496 faces, the vertex count of the liam sample's
frames), with UVs and unit normals, and a motion of its own from frame to
frame: the surface's waves travel and the grid sways. The grid and its
faces are those of `uvol_tpu_torch/codecs/draco/grid.py`, copied.

Textures: `[L, H, W, 3]` uint8 layers meant to look like captured video
rather than a gradient: smooth shading at two scales, regions with hard
edges between two colours (clothing, hair, background), fine grain that
changes every frame, and motion (the picture pans by a few pixels a
frame). The amplitudes below are chosen, not measured from captured
frames: no captured texture is in the repository to calibrate them on. They are made on the device in a few large calls from a
`torch.Generator` seeded with the run's seed, then copied to the host,
where the program takes them as a decoded PNG sequence would be.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: how far the picture pans a frame, in pixels (x, y)
PAN_PX = (3.0, 1.5)
#: amplitudes of the picture's parts, in levels: shading at 16 px, the second
#: region's texture at 8 px, detail at 2 px, and the grain of each frame
MID, TEXTURE, DETAIL, GRAIN = 10.0, 5.0, 2.0, 1.0
#: layers made on the device at a time
CHUNK = 25


def grid_faces(ny: int, nx: int) -> np.ndarray:
    """[2 (ny - 1)(nx - 1), 3] int32 faces of the grid, in the order of
    `codecs/draco/grid.py`."""
    i = np.arange(ny * nx).reshape(ny, nx)
    a, b, c, d = i[:-1, :-1], i[:-1, 1:], i[1:, 1:], i[1:, :-1]
    return np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([a, c, d], -1).reshape(-1, 3)]).astype(np.int32)


def grid_frames(seed: int, frames: int, ny: int, nx: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(positions [F, N, 3], uvs [F, N, 2], unit normals [F, N, 3]) float32
    and faces [M, 3] int32 of `frames` frames of a moving grid."""
    r = np.random.default_rng([seed, 1])
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    sx, sy = 1.0 / max(nx - 1, 1), 1.0 / max(ny - 1, 1)
    # the waves' sizes and speeds are fixed, so every seed gives the codecs the
    # same amount of work; the seed sets where they start and the noise
    fx, fy, omega, nu = 0.2, 0.15, 0.12, 0.06
    phase = r.uniform(0, 2 * np.pi)
    t = np.arange(frames, dtype=np.float64)[:, None, None]
    z = (0.08 * np.sin(fx * xx + phase + omega * t) * np.cos(fy * yy + phase + nu * t)
         + 0.002 * r.normal(size=(frames, ny, nx)))
    sway = 0.01 * np.sin(0.07 * t + yy * sy)
    px = xx * sx + sway
    py = np.broadcast_to(yy * sy, z.shape)
    pos = np.stack([px, py, z], -1).reshape(frames, -1, 3).astype(np.float32)
    uv = np.stack([xx * sx, 1.0 - yy * sy], -1).reshape(1, -1, 2).astype(np.float32)
    uvs = np.ascontiguousarray(np.broadcast_to(uv, (frames, ny * nx, 2)))
    gy, gx = np.gradient(z, sy, sx, axis=(1, 2))
    nrm = np.stack([-gx, -gy, np.ones_like(z)], -1).reshape(frames, -1, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    return pos, uvs, nrm, grid_faces(ny, nx)


def _smooth(gen: torch.Generator, device, c: int, h: int, w: int, cell: int) -> torch.Tensor:
    """[c, h, w] float32 noise smoothed over about `cell` pixels (bicubic
    upsampling of a coarse random grid), unit variance at the grid."""
    gh, gw = h // cell + 3, w // cell + 3
    coarse = torch.randn((1, c, gh, gw), generator=gen, device=device)
    up = F.interpolate(coarse, size=(gh * cell, gw * cell), mode="bicubic", align_corners=False)
    return up[0, :, cell:cell + h, cell:cell + w]


def textures(seed: int, layers: int, h: int, w: int, device) -> np.ndarray:
    """[layers, h, w, 3] uint8 host layers of a panning, grainy picture
    made on `device` from `seed`; the same seed and device give the same
    layers."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63) * 2 + 1)
    pad_x = int(np.ceil(PAN_PX[0] * layers)) + 8
    pad_y = int(np.ceil(PAN_PX[1] * layers)) + 8
    ch, cw = h + pad_y, w + pad_x
    base = 128 + 45 * _smooth(gen, device, 3, ch, cw, 128) + MID * _smooth(gen, device, 3, ch, cw, 16)
    # a third of the picture is a second region with hard edges; its colour
    # differs from the shading by the same amount whatever the seed
    field = _smooth(gen, device, 1, ch, cw, 48)[0]
    regions = field > torch.quantile(field[::8, ::8].flatten(), 2 / 3)
    perm = torch.randperm(3, generator=gen, device=device)
    offset = torch.tensor([50.0, -40.0, 30.0], device=device)[perm].reshape(3, 1, 1)
    second = (base + offset + TEXTURE * _smooth(gen, device, 3, ch, cw, 8)).clamp(0, 255)
    canvas = torch.where(regions[None], second, base)
    canvas = (canvas + DETAIL * _smooth(gen, device, 1, ch, cw, 2)).clamp(0, 255)
    # the pan: full speed, in one of four directions
    dirs = np.sign(torch.rand(2, generator=gen, device=device).cpu().numpy() - 0.5)
    out = np.empty((layers, h, w, 3), np.uint8)
    for l0 in range(0, layers, CHUNK):
        n = min(CHUNK, layers - l0)
        crops = []
        for l in range(l0, l0 + n):
            ox = int(round(pad_x / 2 + dirs[0] * PAN_PX[0] * (l - layers / 2)))
            oy = int(round(pad_y / 2 + dirs[1] * PAN_PX[1] * (l - layers / 2)))
            crops.append(canvas[:, oy:oy + h, ox:ox + w])
        batch = torch.stack(crops)
        noise = GRAIN * torch.randn(batch.shape, generator=gen, device=device)
        pix = (batch + noise).round().clamp(0, 255).to(torch.uint8)
        out[l0:l0 + n] = pix.permute(0, 2, 3, 1).cpu().numpy()
    return out
