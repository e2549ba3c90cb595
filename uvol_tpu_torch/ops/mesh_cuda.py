"""The mesh and point-cloud ops' kernels on the card (U3, U4, U5) and their
plain PyTorch twins. The reference leaves each function to XLA; the
kernels in `csrc/mesh_ops.cu` compute it with the reference's arithmetic
and order:

  - `estimate_normals(positions, faces)` (U3, `uvol_tpu/ops/normals.py:66-84`):
    area-weighted vertex normals, each vertex's face normals added in the
    reference's (corner, face) order from 0.0;
  - `morton_keys(x, mn, inv, bits)` (U4, the device stage of
    `uvol_tpu/models/pointcloud.py:31-35`): the quantize of the port's
    `ops.quantize.quantize` with the frame's minimum and 1 / delta given,
    then the int64 Morton key of `ops.morton.morton_key`;
  - `parallelogram_decode(residuals, pred_indices)` (U5,
    `uvol_tpu/ops/prediction.py:56-90`): the scan over vertices.

The device of the tensor decides the route: a CUDA tensor launches the
kernels (built by `_build` at first use; a build or launch failure raises,
nothing falls back), a CPU tensor takes the twin (`*_plain`), which the
card's path never calls. Each kernel launch adds one to `LAUNCHES` under
its wrapper's name (U3 launches three kernels a call, U5 one, or two where
D is above 4 and not a multiple of 4); twin calls are not counted.

U3 builds its CSR on the card: a count of each vertex's corners and its
scan (a cluster of 8 CTAs a range of `NORMALS_RANGE_VERTICES` vertices),
a fill that stores each corner's key `k << 30 | face` in its row in any
order, then the normals kernel, which sorts each row's keys before it adds them, so
the sums keep the reference's (corner, face) order (a row of more than 512
keys by a radix sort through a second 3 M words of the scratch). `normals_csr` is the
twin's CSR and stays PyTorch's stable sort.

U3's float rules (what XLA compiles the reference into on the CPU, held
bit for bit in the tests): the differences `p1 - p0`, `p2 - p0` rounded,
each cross component one FMA `fma(a_i, b_j, -(a_j * b_i))`, the product
by the row's validity (0.0 or 1.0: a `-1` row adds +-0.0, or NaN where
its product is infinite, onto vertex 0), the sums from 0.0 in order, the
norm as `_device.xla_norm3`, IEEE divisions. A face index >= N is
clamped for the gathers and its corner dropped from the sums (XLA's
gather clamps, its scatter drops).
"""

from __future__ import annotations

from typing import Tuple

import torch

from uvol_tpu_torch import _build
from uvol_tpu_torch._device import fma_f32, true_div, xla_norm3
from uvol_tpu_torch.ops.morton import morton_key

Tensor = torch.Tensor

#: kernel launches since the last reset
LAUNCHES = {"estimate_normals": 0, "morton_keys": 0, "parallelogram_decode": 0}

#: frames of one U4 launch (its gridDim.y); a call of more launches once per
#: slice of so many frames
MORTON_LAUNCH_FRAMES = 65535
#: U3's count cluster owns so many vertices (each CTA's int32 counts of them in
#: its shared memory);
#: the fill's CTAs scan at most NORMALS_MAX_RANGES ranges' totals, and the
#: keys and slots stay below 2^31 up to NORMALS_MAX_FACES faces
#: (kRangeVertices, kMaxRanges, kMaxFaces in csrc/mesh_ops.cu)
NORMALS_RANGE_VERTICES = 51200
NORMALS_MAX_RANGES = 4096
NORMALS_MAX_FACES = 1 << 29
#: U5 steps the components of a frame in lanes of one warp, at most this many
#: a CTA (kChainGroup); a launch takes at most 2^30 CTAs (kChainsPerLaunch)
PARALLELOGRAM_GROUP = 4
PARALLELOGRAM_CHAINS_PER_LAUNCH = 1 << 30
#: the Morton key's coordinate bits (morton63: 21 bits a coordinate)
MORTON_MAX_BITS = 21
#: dependent adds in each chain of the probe (kProbeAdds)
PROBE_ADDS = 4096


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _route(t: Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (twin)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _launch(name: str, fn: str, device: torch.device, *args, kernels: int = 1) -> None:
    _build.launch(fn, device, *args)
    LAUNCHES[name] += kernels


def _same_device(*ts: Tensor) -> None:
    if any(t.device != ts[0].device for t in ts[1:]):
        raise ValueError(f"tensors on several devices: {[str(t.device) for t in ts]}")


# ---- U3: estimate_normals ----------------------------------------------------


def _check_mesh(positions: Tensor, faces: Tensor) -> Tuple[int, int]:
    if positions.dtype != torch.float32 or positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError(f"expected [N, 3] float32 positions, got "
                         f"{tuple(positions.shape)} {positions.dtype}")
    if faces.dtype != torch.int32 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"expected [M, 3] int32 faces, got {tuple(faces.shape)} {faces.dtype}")
    _same_device(positions, faces)
    return positions.shape[0], faces.shape[0]


def normals_csr(faces: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """Each vertex's faces in the reference's sum order: the corner list
    `max(faces, 0)` taken corner-major (entry k * M + face), sorted stably
    by vertex. Returns (row [n + 1] int32 offsets, face_of [row[n]] int32);
    corners naming a vertex >= n lie past row[n] and are dropped."""
    m = faces.shape[0]
    corners = faces.clamp(min=0).t().reshape(-1)
    vertex, order = torch.sort(corners, stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int32, device=faces.device)
    row = torch.searchsorted(vertex, bounds, out_int32=True)
    return row, (order % max(m, 1)).to(torch.int32)


def face_normals_plain(positions: Tensor, faces: Tensor) -> Tensor:
    """[M, 3] float32: each face's cross(p1 - p0, p2 - p0) times its
    validity (first index >= 0), in U3's float rules."""
    n = positions.shape[0]
    valid = (faces[:, 0] >= 0).to(torch.float32)[:, None]
    f = faces.clamp(0, n - 1).to(torch.int64)
    p0, p1, p2 = positions[f[:, 0]], positions[f[:, 1]], positions[f[:, 2]]
    a, b = p1 - p0, p2 - p0
    cross = torch.stack([fma_f32(a[:, i], b[:, j], -(a[:, j] * b[:, i]))
                         for i, j in ((1, 2), (2, 0), (0, 1))], dim=-1)
    return cross * valid


def estimate_normals_plain(positions: Tensor, faces: Tensor) -> Tensor:
    """Plain twin of U3 on any device: the face normals added onto each
    vertex from 0.0 in (corner, face) order, one rank of every vertex's row
    at a time, then normalised."""
    n, m = _check_mesh(positions, faces)
    out = torch.zeros_like(positions)
    if n == 0:
        return out
    row, face_of = normals_csr(faces, n)
    fn = face_normals_plain(positions, faces)
    count = row[1:] - row[:-1]
    vertex = torch.repeat_interleave(torch.arange(n, device=positions.device), count)
    rank = torch.arange(vertex.numel(), device=positions.device) - row[:-1].to(torch.int64)[vertex]
    vals = fn[face_of[: vertex.numel()].to(torch.int64)]
    for r in range(int(count.max()) if m else 0):
        sel = rank == r
        v = vertex[sel]
        out[v] = out[v] + vals[sel]
    norm = xla_norm3(out)[:, None]
    return true_div(out, torch.where(norm > 0, norm, torch.ones_like(norm)))


def estimate_normals(positions: Tensor, faces: Tensor) -> Tensor:
    """U3: positions [N, 3] float32, faces [M, 3] int32 (rows of -1 are
    padding) → [N, 3] float32 unit vertex normals (a vertex without a face
    gives 0). On the card: three launches (count, fill, normals) into one
    int32 scratch of N + 2 * ranges + 6 * M words; no other device work."""
    n, m = _check_mesh(positions, faces)
    if not _route(positions):
        return estimate_normals_plain(positions, faces)
    out = torch.empty_like(positions)
    if n == 0:
        return out
    ranges = -(-n // NORMALS_RANGE_VERTICES)
    if ranges > NORMALS_MAX_RANGES or m > NORMALS_MAX_FACES:
        raise ValueError(f"estimate_normals takes at most "
                         f"{NORMALS_MAX_RANGES * NORMALS_RANGE_VERTICES} vertices and "
                         f"{NORMALS_MAX_FACES} faces on the card, got {n} and {m}")
    positions, faces = positions.contiguous(), faces.contiguous()
    work = torch.empty(n + 2 * ranges + 6 * m, dtype=torch.int32, device=positions.device)
    _launch("estimate_normals", "uvt_estimate_normals", positions.device,
            positions.data_ptr(), faces.data_ptr(), work.data_ptr(), out.data_ptr(), n, m,
            kernels=3)
    return out


# ---- U4: morton_keys -----------------------------------------------------------


def _check_keys(x: Tensor, mn: Tensor, inv: Tensor, bits: int) -> Tuple[int, int]:
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"expected [F, N, 3] float32 points, got {tuple(x.shape)} {x.dtype}")
    f, n = x.shape[:2]
    if mn.dtype != torch.float32 or tuple(mn.shape) != (f, 3):
        raise ValueError(f"expected [{f}, 3] float32 minima, got {tuple(mn.shape)} {mn.dtype}")
    if inv.dtype != torch.float32 or tuple(inv.shape) != (f,):
        raise ValueError(f"expected [{f}] float32 inv, got {tuple(inv.shape)} {inv.dtype}")
    if not 1 <= bits <= MORTON_MAX_BITS:
        raise ValueError(f"the Morton key takes 1 to {MORTON_MAX_BITS} bits, got {bits}")
    _same_device(x, mn, inv)
    return f, n


def morton_keys_plain(x: Tensor, mn: Tensor, inv: Tensor, bits: int) -> Tensor:
    """Plain twin of U4 on any device: q = clip(floor((x - mn) * inv +
    0.5), 0, 2^bits - 1), each step rounded (the port's `quantize`), then
    `morton_key(q)` → [F, N] int64."""
    _check_keys(x, mn, inv, bits)
    q = torch.floor((x - mn[:, None, :]) * inv[:, None, None] + 0.5)
    q = torch.clamp(q, 0, (1 << bits) - 1).to(torch.int32)
    return morton_key(q)


def morton_keys(x: Tensor, mn: Tensor, inv: Tensor, bits: int) -> Tensor:
    """U4: points x [F, N, 3] float32, each frame's minimum mn [F, 3] and
    inv [F] = 1 / delta → [F, N] int64 Morton keys of the quantized
    points, as `morton_keys_plain`; one launch per `MORTON_LAUNCH_FRAMES`
    frames."""
    f, n = _check_keys(x, mn, inv, bits)
    if not _route(x):
        return morton_keys_plain(x, mn, inv, bits)
    key = torch.empty((f, n), dtype=torch.int64, device=x.device)
    if key.numel() == 0:
        return key
    x, mn, inv = x.contiguous(), mn.contiguous(), inv.contiguous()
    _launch("morton_keys", "uvt_morton_keys", x.device, x.data_ptr(), mn.data_ptr(),
            inv.data_ptr(), bits, key.data_ptr(), f, n)
    return key


# ---- U5: parallelogram_decode --------------------------------------------------


def _check_chain(res: Tensor, pidx: Tensor) -> None:
    if res.dtype != torch.int32 or res.ndim < 2:
        raise ValueError(f"expected [..., N, D] int32 residuals, got {tuple(res.shape)} {res.dtype}")
    if (pidx.dtype != torch.int32 or pidx.ndim != res.ndim or pidx.shape[-1] != 3
            or pidx.shape[:-1] != res.shape[:-1]):
        raise ValueError(f"expected {tuple(res.shape[:-1]) + (3,)} int32 indices, got "
                         f"{tuple(pidx.shape)} {pidx.dtype}")
    _same_device(res, pidx)


def _wrap32(v: Tensor) -> Tensor:
    """int64 → the int32 that two's-complement wrapping gives."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def parallelogram_decode_plain(residuals: Tensor, pred_indices: Tensor) -> Tensor:
    """Plain twin of U5 on any device: the scan written out, one step over
    every (frame, component) at a time, sums wrapped to int32."""
    _check_chain(residuals, pred_indices)
    *batch, n, d = residuals.shape
    res = residuals.reshape(-1, n, d).to(torch.int64)
    pidx = pred_indices.reshape(-1, n, 3).to(torch.int64)
    f = res.shape[0]
    out = torch.zeros((f, n, d), dtype=torch.int64, device=res.device)
    if n == 0 or f == 0:
        return out.to(torch.int32).reshape(residuals.shape)
    a = pidx[..., 0]
    ia, ib, ic = a.clamp(0, n - 1), pidx[..., 1].clamp(0, n - 1), pidx[..., 2].clamp(0, n - 1)
    frames = torch.arange(f, device=res.device)
    prev = torch.zeros((f, d), dtype=torch.int64, device=res.device)
    for i in range(n):
        par = out[frames, ia[:, i]] + out[frames, ib[:, i]] - out[frames, ic[:, i]]
        pred = torch.where((a[:, i] >= 0)[:, None], par, prev)
        prev = _wrap32(res[:, i] + pred)
        out[:, i] = prev
    return out.to(torch.int32).reshape(residuals.shape)


def _chain_launches(f: int, d: int) -> int:
    """Kernel launches of one U5 call (`uvt_parallelogram_decode`): the
    CTAs of whole groups of PARALLELOGRAM_GROUP components, then those of
    the rest, each in launches of at most PARALLELOGRAM_CHAINS_PER_LAUNCH."""
    g = PARALLELOGRAM_GROUP
    kinds = [f] if d <= g else [f * (d // g)] + ([f] if d % g else [])
    return sum(-(-c // PARALLELOGRAM_CHAINS_PER_LAUNCH) for c in kinds)


def parallelogram_decode(residuals: Tensor, pred_indices: Tensor) -> Tensor:
    """U5: residuals [..., N, D] int32, pred_indices [..., N, 3] int32 →
    the decoded values [..., N, D] int32, as `parallelogram_decode_plain`;
    a CTA per frame and group of up to PARALLELOGRAM_GROUP components, one
    launch (two where D > 4 is not a multiple of 4)."""
    _check_chain(residuals, pred_indices)
    if not _route(residuals):
        return parallelogram_decode_plain(residuals, pred_indices)
    *batch, n, d = residuals.shape
    out = torch.empty(residuals.shape, dtype=torch.int32, device=residuals.device)
    if out.numel() == 0:
        return out
    f = out.numel() // (n * d)
    res, pidx = residuals.contiguous(), pred_indices.contiguous()
    _launch("parallelogram_decode", "uvt_parallelogram_decode", res.device,
            res.data_ptr(), pidx.data_ptr(), out.data_ptr(), f, n, d,
            kernels=_chain_launches(f, d))
    return out


def dependent_add_cycles(device: torch.device) -> Tuple[float, float]:
    """The card's clock cycles per dependent integer add and per dependent
    integer multiply-add (U5's step), from one thread's chains of 4,096 of
    each timed with clock64 (`dependent_add_probe_kernel`). Not counted in
    LAUNCHES: no op runs it."""
    if torch.device(device).type != "cuda":
        raise ValueError("the probe runs on a CUDA card")
    seed = torch.tensor([12345, 7, 1], dtype=torch.int32).to(device)
    out = torch.zeros(4, dtype=torch.int64, device=device)
    _build.launch("uvt_dependent_add_cycles", out.device, seed.data_ptr(), out.data_ptr())
    cycles = out.cpu()
    return float(cycles[0]) / PROBE_ADDS, float(cycles[1]) / PROBE_ADDS
