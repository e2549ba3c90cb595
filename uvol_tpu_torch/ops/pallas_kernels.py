"""Fused quantize + delta + zigzag on the card — counterpart of
`uvol_tpu/ops/pallas_kernels.py` (K3, `fused_quantize_delta_zigzag`).

`fused_quantize_delta_zigzag(xm, inv_step)` turns the geometry encode's
min-subtracted planar batch into entropy-ready symbols in one pass:

    q[f, c, n] = floor(xm[f, c, n] * inv_step[f] + 0.5)      (int32)
    d[f, c, n] = q[f, c, n] - q[f, c, n - 1]                 (q[f, c, -1] = 0)
    sym        = (d >> 31) ^ (d << 1)                        (uint32 bits in int32)

The device of the tensor decides the route:

  - a CUDA tensor launches the hand-written kernel of `csrc/geometry.cu`,
    built by `_build` at first use; a build or launch failure raises,
    nothing falls back;
  - a CPU tensor goes through the plain twin,
    `fused_quantize_delta_zigzag_plain`.

Each kernel launch adds one to `LAUNCHES["quantize_delta_zigzag"]`; twin
calls are not counted.

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

import torch

from uvol_tpu_torch import _build
from uvol_tpu_torch.ops.prediction import delta_encode
from uvol_tpu_torch.ops.quantize import zigzag_encode

Tensor = torch.Tensor

#: kernel launches since the last reset
LAUNCHES = {"quantize_delta_zigzag": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    if xm.dtype != torch.float32 or xm.ndim != 3:
        raise ValueError(f"expected [F, C, N] float32, got {tuple(xm.shape)} {xm.dtype}")
    f, c, n = xm.shape
    if (inv_step.dtype != torch.float32 or tuple(inv_step.shape) != (f,)
            or inv_step.device != xm.device):
        raise ValueError(
            f"expected [{f}] float32 inv_step on {xm.device}, got "
            f"{tuple(inv_step.shape)} {inv_step.dtype} on {inv_step.device}"
        )
    if xm.device.type == "cpu":
        return fused_quantize_delta_zigzag_plain(xm, inv_step)
    if xm.device.type != "cuda":
        raise ValueError(f"unsupported device {xm.device}")
    xm, inv_step = xm.contiguous(), inv_step.contiguous()
    out = torch.empty((f, c, n), dtype=torch.int32, device=xm.device)
    if out.numel() == 0:
        return out
    lib = _build.get_lib()
    with torch.cuda.device(xm.device):
        stream = torch.cuda.current_stream(xm.device).cuda_stream
        err = lib.uvt_quantize_delta_zigzag(
            xm.data_ptr(), inv_step.data_ptr(), out.data_ptr(), f, c, n, stream)
    if err != 0:
        msg = lib.uvt_cuda_error_string(err).decode()
        raise RuntimeError(f"quantize_delta_zigzag kernel launch failed: {msg} ({err})")
    LAUNCHES["quantize_delta_zigzag"] += 1
    return out
