"""Polynomial-trajectory compression for fixed-topology frame groups
(PyTorch), counterpart of `uvol_tpu/models/trajectory.py`.

Each vertex's (x, y, z) trajectory over a group of frames is fitted with
one polynomial (degree 4 by default): the group is stored once plus
degree + 1 coefficients a vertex and component. The fit is one batched
least-squares solve: the device computes the one large product V^T y
(`_vty`, U6: [D+1, F] x [F, N * 3], a plain float32 `torch.matmul` under
`_device.require_full_f32()`, as the reference leaves it to XLA at
`Precision.HIGHEST`), and the host solves the (D+1) x (D+1) normal
equations in float64, copied from the reference as it is.

The Vandermonde matrix on the device is the reference's bit for bit:
`jnp.linspace(0.0, 1.0, f)` in float32 is `i * f32(1 / (f - 1))` with the
last sample 1.0 (XLA folds the division by the constant), not
`torch.linspace`'s values, and `t**k` is `lax.integer_pow`'s products
(t * t, then (t * t) * (t * t) for k = 4), not `torch.pow`'s. The
product's sums are taken in another order than XLA's, so `_vty` agrees
with the reference within float32 summation error, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uvol_tpu_torch._device import DeviceLike, require_full_f32, resolve_device, true_div

Tensor = torch.Tensor


@dataclasses.dataclass
class TrajectoryGroup:
    coefficients: np.ndarray  # [degree+1, N, 3]
    frame_count: int
    degree: int

    def sample(self, frame_index) -> np.ndarray:
        """Reconstruct positions at (possibly fractional) frame indices."""
        t = np.asarray(frame_index, np.float32) / max(self.frame_count - 1, 1)
        powers = np.stack([t**k for k in range(self.degree + 1)])
        return np.einsum("k,knc->nc", powers, self.coefficients)


def sample_times(f: int, device: torch.device) -> Tensor:
    """`jnp.linspace(0.0, 1.0, f)` in float32: i * (1 / (f - 1)), the
    reciprocal rounded to float32 once, and 1.0 last."""
    if f <= 1:
        return torch.zeros(f, dtype=torch.float32, device=device)
    recip = true_div(torch.ones((), dtype=torch.float32, device=device), float(f - 1))
    t = torch.arange(f - 1, dtype=torch.float32, device=device) * recip
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


def integer_pow(t: Tensor, k: int) -> Tensor:
    """`lax.integer_pow(t, k)` for k >= 0: binary exponentiation with each
    product rounded, as XLA multiplies."""
    if k == 0:
        return torch.ones_like(t)
    acc = None
    while k > 0:
        if k & 1:
            acc = t if acc is None else acc * t
        k >>= 1
        if k > 0:
            t = t * t
    return acc


def vandermonde(f: int, degree: int, device: torch.device) -> Tensor:
    """[F, D+1] float32: column k is t**k over the group's sample times."""
    t = sample_times(f, device)
    return torch.stack([integer_pow(t, k) for k in range(degree + 1)], dim=1)


def _vty(positions: Tensor, degree: int) -> Tensor:
    """The only large product of the fit: V^T y, [D+1, F] x [F, N * 3] in
    full float32."""
    require_full_f32()
    f, n, c = positions.shape
    vand = vandermonde(f, degree, positions.device)
    return torch.matmul(vand.t(), positions.reshape(f, n * c))


def fit_trajectories(positions, degree: int = 4, *,
                     device: DeviceLike = None) -> TrajectoryGroup:
    """positions [F, N, 3] (fixed topology; numpy or a tensor) → per-vertex
    polynomial fit. V^T y runs on `device` (the card by default; the CPU
    only where named); the (D+1) x (D+1) solve runs on the host in float64
    (V^T V is ill-conditioned at degree 4)."""
    dev = resolve_device(device)
    f, n, c = positions.shape
    if f <= degree:
        degree = max(f - 1, 0)
    pos = torch.as_tensor(positions, dtype=torch.float32).to(dev)
    vty = _vty(pos, degree).cpu().numpy().astype(np.float64)
    t = np.linspace(0.0, 1.0, f)
    vand = np.stack([t**k for k in range(degree + 1)], axis=1)
    vtv = vand.T @ vand  # tiny, float64
    coef = np.linalg.solve(vtv, vty).astype(np.float32)
    return TrajectoryGroup(
        coefficients=coef.reshape(degree + 1, n, c), frame_count=f, degree=degree
    )


def group_fixed_topology(frame_counts: np.ndarray) -> list:
    """Split a sequence into runs of equal vertex count: [(start, end)]."""
    groups = []
    start = 0
    for i in range(1, len(frame_counts) + 1):
        if i == len(frame_counts) or frame_counts[i] != frame_counts[start]:
            groups.append((start, i))
            start = i
    return groups


def reconstruction_error(positions: np.ndarray, group: TrajectoryGroup) -> float:
    recon = np.stack([group.sample(k) for k in range(group.frame_count)])
    return float(np.abs(recon - positions).max())
