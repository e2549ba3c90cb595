"""The geometry encode's device stage on the card — counterpart of
`uvol_tpu/ops/pallas_kernels.py` (K3, `fused_quantize_delta_zigzag`) and of
the XLA code around it in the reference codec's `_syms`.

`fused_quantize_delta_zigzag(xm, inv_step)` turns a min-subtracted planar
batch into entropy-ready symbols in one pass:

    q[f, c, n] = floor(xm[f, c, n] * inv_step[f] + 0.5)      (int32)
    d[f, c, n] = q[f, c, n] - q[f, c, n - 1]                 (q[f, c, -1] = 0)
    sym        = (d >> 31) ^ (d << 1)                        (uint32 bits in int32)

`geometry_quantize_stage(xt, mask, bits)` is the whole stage, from the
planar batch and its validity mask, in two halves that are two launches on
the card:

  - `geometry_minmax(xt, mask)`: the masked minimum and maximum of each
    (frame, component) row (`geometry_minmax_kernel`; the reference leaves
    this reduction to XLA);
  - `quantize_from_bounds(xt, mask, mn, mx, bits)`: the frame's range and
    `inv_step = (2^bits - 1) / range`, `xm = xt - min` on valid vertices
    and 0 on padded ones, then the three lines above (K3 taking the
    offsets in).

The device of the tensor decides the route:

  - a CUDA tensor launches the hand-written kernels of `csrc/geometry.cu`,
    built by `_build` at first use; a build or launch failure raises,
    nothing falls back;
  - a CPU tensor goes through the plain twin (`*_plain`).

Each kernel launch adds one to `LAUNCHES` under its name; twin calls are
not counted.

The rounding step is one fused multiply-add, `fma(xm, inv, 0.5)` rounded
once to float32, then floor: that is what XLA compiles the reference's
`jnp.floor(xm * inv + 0.5)` into on the CPU in the Pallas kernel, and
in the codec's `_syms` except, for some batch shapes, in one of the two
evaluations of each q there (ROADMAP.md §3). It differs from a rounded
multiply followed by a rounded add on rare inputs. The twin takes the
product and the sum in float64, which is exact wherever the floor can
change: xm >= 0 and inv > 0, so a sum near an integer m >= 1 comes from
a product >= 0.5, whose 48 significant bits fit float64's 53.
"""

from __future__ import annotations

from typing import Tuple

import torch

from uvol_tpu_torch import _build
from uvol_tpu_torch._device import true_div
from uvol_tpu_torch.ops.prediction import delta_encode
from uvol_tpu_torch.ops.quantize import masked_min_max, quantization_range, zigzag_encode

Tensor = torch.Tensor

#: kernel launches since the last reset
LAUNCHES = {"geometry_minmax": 0, "quantize_delta_zigzag": 0}

#: most frames of one batch and most vertices of one row on the card (the
#: kernels' grid: gridDim.z frames; gridDim.y tiles of 1,024 vertices)
MAX_FRAMES = 65535
MAX_VERTICES = 65535 * 1024 - 3


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    _build.launch(fn, device, *args)
    LAUNCHES[name] += 1


def _check_planar(x: Tensor, what: str) -> Tuple[int, int, int]:
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"expected [F, C, N] float32 {what}, got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return tuple(x.shape)


def _check_grid(f: int, n: int) -> None:
    if f > MAX_FRAMES or n > MAX_VERTICES:
        raise ValueError(f"the card takes at most {MAX_FRAMES} frames of {MAX_VERTICES} "
                         f"vertices per call, got {f} of {n}")


def fused_quantize_delta_zigzag_plain(xm: Tensor, inv_step: Tensor) -> Tensor:
    """Plain twin of K3 on any device: xm [F, C, N] f32, inv_step [F] f32
    → [F, C, N] int32 zigzag symbols."""
    t = xm.double() * inv_step.double()[:, None, None] + 0.5
    q = torch.floor(t.float()).to(torch.int32)
    return zigzag_encode(delta_encode(q, dim=-1))


def fused_quantize_delta_zigzag(xm: Tensor, inv_step: Tensor) -> Tensor:
    """K3: xm [F, C, N] float32 (min-subtracted, >= 0), inv_step [F]
    float32 (> 0) → [F, C, N] int32 zigzag symbols; row n = 0 carries the
    absolute quantized value."""
    f, c, n = _check_planar(xm, "offsets")
    if (inv_step.dtype != torch.float32 or tuple(inv_step.shape) != (f,)
            or inv_step.device != xm.device):
        raise ValueError(
            f"expected [{f}] float32 inv_step on {xm.device}, got "
            f"{tuple(inv_step.shape)} {inv_step.dtype} on {inv_step.device}"
        )
    if xm.device.type == "cpu":
        return fused_quantize_delta_zigzag_plain(xm, inv_step)
    _check_grid(f, n)
    xm, inv_step = xm.contiguous(), inv_step.contiguous()
    out = torch.empty((f, c, n), dtype=torch.int32, device=xm.device)
    if out.numel() == 0:
        return out
    _launch("quantize_delta_zigzag", "uvt_quantize_delta_zigzag", xm.device,
            xm.data_ptr(), None, None, None, inv_step.data_ptr(), 0,
            out.data_ptr(), None, f, c, n)
    return out


def _check_stage(xt: Tensor, mask: Tensor) -> Tuple[int, int, int]:
    f, c, n = _check_planar(xt, "attributes")
    if mask.dtype != torch.bool or tuple(mask.shape) != (f, n) or mask.device != xt.device:
        raise ValueError(f"expected [{f}, {n}] bool mask on {xt.device}, got "
                         f"{tuple(mask.shape)} {mask.dtype} on {mask.device}")
    return f, c, n


def geometry_minmax_plain(xt: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain twin of `geometry_minmax` on any device."""
    return masked_min_max(xt.transpose(1, 2), mask)


def geometry_minmax(xt: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """xt [F, C, N] float32 planar attributes, mask [F, N] bool (True =
    valid vertex) → (min [F, C], max [F, C]) over each row's valid
    vertices; a row without one gives +-float32 max. Of a row's zeros the
    minimum is -0.0 and the maximum +0.0 if the row holds one. NaN
    positions are outside the contract (the routes may then differ)."""
    f, c, n = _check_stage(xt, mask)
    if xt.device.type == "cpu" or xt.numel() == 0:  # an empty batch launches nothing
        return geometry_minmax_plain(xt, mask)
    _check_grid(f, n)
    return _minmax_launch(xt.contiguous(), mask.contiguous())


def _minmax_launch(xt: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """One launch of the minimum/maximum kernel on checked, contiguous
    CUDA tensors."""
    f, c, n = xt.shape
    bounds = torch.empty((2, f, c), dtype=torch.float32, device=xt.device)
    mn = bounds.data_ptr()
    _launch("geometry_minmax", "uvt_geometry_minmax", xt.device,
            xt.data_ptr(), mask.data_ptr(), mn, mn + 4 * f * c, f, c, n)
    return bounds.unbind(0)


def _offsets(xt: Tensor, mask: Tensor, mn: Tensor, rng: Tensor, bits: int
             ) -> Tuple[Tensor, Tensor]:
    """(xm, inv): xm = x - min on valid rows and 0 on padded ones, inv =
    (2^bits - 1) / range, an IEEE quotient."""
    inv = true_div(float((1 << bits) - 1), rng)
    xm = torch.where(mask[:, None, :], xt - mn[..., None], 0.0)
    return xm, inv


def quantize_offsets(xt: Tensor, bits: int, mask: Tensor):
    """What K3 takes with its offsets given, from a planar [F, C, N] batch
    and its [F, N] mask: (xm [F, C, N], inv [F], min [F, C], range [F])."""
    mn, mx = geometry_minmax_plain(xt, mask)
    rng = quantization_range(mn, mx)
    xm, inv = _offsets(xt, mask, mn, rng, bits)
    return xm, inv, mn, rng


def quantize_from_bounds_plain(xt: Tensor, mask: Tensor, mn: Tensor, mx: Tensor, bits: int
                               ) -> Tuple[Tensor, Tensor]:
    """Plain twin of `quantize_from_bounds` on any device."""
    rng = quantization_range(mn, mx)
    return fused_quantize_delta_zigzag_plain(*_offsets(xt, mask, mn, rng, bits)), rng


def quantize_from_bounds(xt: Tensor, mask: Tensor, mn: Tensor, mx: Tensor, bits: int
                         ) -> Tuple[Tensor, Tensor]:
    """K3 taking the offsets in: xt [F, C, N] float32, mask [F, N] bool,
    mn and mx [F, C] float32 (`geometry_minmax`), 1 <= bits <= 30 → (syms
    [F, C, N] int32 zigzag bit patterns, range [F]). range is the frame's
    largest mx - mn, 1 where that is <= 0. A padded vertex quantizes to 0,
    so the symbol at n = count is zigzag(-q[count - 1])."""
    f, c, n = _check_stage(xt, mask)
    for name, t in (("mn", mn), ("mx", mx)):
        if t.dtype != torch.float32 or tuple(t.shape) != (f, c) or t.device != xt.device:
            raise ValueError(f"expected [{f}, {c}] float32 {name} on {xt.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not 1 <= bits <= 30:
        raise ValueError(f"expected 1 <= bits <= 30, got {bits}")
    if xt.device.type == "cpu" or xt.numel() == 0:  # an empty batch launches nothing
        return quantize_from_bounds_plain(xt, mask, mn, mx, bits)
    _check_grid(f, n)
    return _from_bounds_launch(xt.contiguous(), mask.contiguous(), mn.contiguous(),
                               mx.contiguous(), bits)


def _from_bounds_launch(xt: Tensor, mask: Tensor, mn: Tensor, mx: Tensor, bits: int
                        ) -> Tuple[Tensor, Tensor]:
    """One launch of K3 in its offsets-taking form on checked, contiguous
    CUDA tensors."""
    f, c, n = xt.shape
    rng = torch.empty(f, dtype=torch.float32, device=xt.device)
    syms = torch.empty((f, c, n), dtype=torch.int32, device=xt.device)
    _launch("quantize_delta_zigzag", "uvt_quantize_delta_zigzag", xt.device,
            xt.data_ptr(), mask.data_ptr(), mn.data_ptr(), mx.data_ptr(), None, bits,
            syms.data_ptr(), rng.data_ptr(), f, c, n)
    return syms, rng


def geometry_quantize_stage_plain(xt: Tensor, mask: Tensor, bits: int
                                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain twin of the stage on any device: `quantize_offsets`, then
    K3's twin."""
    xm, inv, mn, rng = quantize_offsets(xt, bits, mask)
    return fused_quantize_delta_zigzag_plain(xm, inv), mn, rng


def geometry_quantize_stage(xt: Tensor, mask: Tensor, bits: int
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """The geometry encode's device stage: xt [F, C, N] float32 planar
    attributes, mask [F, N] bool (True = valid vertex), 1 <= bits <= 30 →
    (syms [F, C, N] int32 zigzag bit patterns, min [F, C], range [F]):
    `geometry_minmax`, then `quantize_from_bounds`; two launches on the
    card, the twin on the CPU."""
    f, _, n = _check_stage(xt, mask)
    if not 1 <= bits <= 30:
        raise ValueError(f"expected 1 <= bits <= 30, got {bits}")
    if xt.device.type == "cpu" or xt.numel() == 0:  # an empty batch launches nothing
        return geometry_quantize_stage_plain(xt, mask, bits)
    _check_grid(f, n)
    xt, mask = xt.contiguous(), mask.contiguous()
    mn, mx = _minmax_launch(xt, mask)
    syms, rng = _from_bounds_launch(xt, mask, mn, mx, bits)
    return syms, mn, rng
