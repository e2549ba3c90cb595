"""Point-cloud sequence codec (Morton-ordered), counterpart of
`uvol_tpu/models/pointcloud.py`.

Corto's point-cloud path: the points of each frame are quantized, sorted
by their Morton code so that neighbours follow each other, and written
as a `.crt` point cloud by the Corto encoder (`codecs/corto/`, the port's
copy of the reference's). The device stage takes the whole batch at
once: the frame's minimum and range as the port's `ops.quantize.quantize`
computes them, the quantize and the 63-bit Morton key in one kernel
(U4, `ops/mesh_cuda.morton_keys`; its twin on the CPU), a stable
`torch.sort` of the [F, N] int64 keys (XLA's sort keeps ties in index
order, and so does this one), and a gather of the sorted points.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from uvol_tpu_torch._device import DeviceLike, resolve_device, true_div
from uvol_tpu_torch.codecs.corto import decode_crt, encode_crt
from uvol_tpu_torch.ops.mesh_cuda import morton_keys
from uvol_tpu_torch.ops.quantize import compute_quantization_transform

Tensor = torch.Tensor


class PointCloudSequenceCodec:
    """Batch: quantize + Morton sort on the device; serialize per frame on
    the host. `device` is the card by default; the CPU runs only where the
    caller names it."""

    def __init__(self, position_bits: int = 11, *, device: DeviceLike = None):
        self.position_bits = position_bits
        self.device = resolve_device(device)

    def device_stage(self, pos: Tensor) -> Tuple[Tensor, Tensor]:
        """pos [F, N, 3] float32 on the codec's device → (the points in
        Morton order [F, N, 3], the permutation [F, N] int32)."""
        mn, rng = compute_quantization_transform(pos)
        delta = true_div(rng, (1 << self.position_bits) - 1)
        inv = true_div(1.0, delta)
        perm = torch.sort(morton_keys(pos, mn, inv, self.position_bits), dim=-1,
                          stable=True).indices
        return torch.take_along_dim(pos, perm[..., None], dim=-2), perm.to(torch.int32)

    def encode(self, positions: np.ndarray, **attrs) -> List[bytes]:
        """positions [F, N, 3] float32 → per-frame `.crt` point clouds; each
        attribute array [F, N, ...] is reordered with its frame's points."""
        pos = torch.from_numpy(np.ascontiguousarray(positions, np.float32)).to(self.device)
        sorted_pos, perm = self.device_stage(pos)
        sorted_pos = sorted_pos.cpu().numpy()
        perm = perm.cpu().numpy()
        blobs = []
        for i in range(len(sorted_pos)):
            kwargs = {name: np.asarray(arr[i])[perm[i]] for name, arr in attrs.items()}
            blobs.append(encode_crt(sorted_pos[i], np.zeros((0, 3), np.int64), **kwargs))
        return blobs

    def decode(self, blobs: List[bytes]) -> List[np.ndarray]:
        return [decode_crt(b).attributes["position"] for b in blobs]
