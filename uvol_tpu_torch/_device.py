"""Device selection and the float rules the port runs under.

Counterpart of `uvol_tpu.models.sequence._pallas_available`: the JAX
package picks its Pallas kernels by backend; here the device of the
tensors decides. A CUDA tensor goes through the hand-written kernels in
`csrc/`, a CPU tensor through their plain PyTorch twins. The entry
points run on the card unless the caller names the CPU.

Importing this module pins float32 matmuls and convolutions to full
precision: the reference runs its matmuls at `Precision.HIGHEST`, and on
Hopper both TF32 paths would keep only ~3 decimal digits. A caller can
switch them back on afterwards, so code that relies on exact float32
products calls `require_full_f32()` first.

Divisions with a Python-number operand go through `true_div`: PyTorch
computes `scalar / tensor` as `reciprocal(tensor) * scalar`, and on CUDA
`tensor / python_scalar` as a multiply by the scalar's reciprocal.
Either can be one ulp off the IEEE quotient the reference takes, which
moves a floor/round boundary and changes the bytes.

A multiply that feeds an add is one fused multiply-add in what XLA
compiles the reference into on the CPU (and `__fmaf_rn` in the kernels):
`fma_f32` rounds `a * b + c` once, as both do, and `xla_norm3` is the
three-component norm in XLA's own order of those operations.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

DeviceLike = Union[str, torch.device, None]
Tensor = torch.Tensor


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` is the current CUDA card. Asking for a card (by `None` or
    by name) on a machine without one raises instead of running on the
    CPU; the CPU runs only where the caller names it (`"cpu"`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False (name device='cpu' to run on the CPU)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def require_full_f32() -> None:
    """Raise unless float32 matmuls and convolutions still run in full
    float32 (the three switches this module sets at import). Host reads
    only: nothing is synchronised."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True: the port's float32 "
                           "products must be exact (set it to False)")
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("torch.backends.cudnn.allow_tf32 is True: the port runs float32 "
                           "in full precision (set it to False)")
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise RuntimeError(f"torch.get_float32_matmul_precision() is {precision!r}: the port's "
                           "float32 products must be exact "
                           "(torch.set_float32_matmul_precision('highest'))")


def true_div(a, b) -> Tensor:
    """IEEE `a / b` elementwise, on CPU and CUDA alike: a Python-number
    operand is first made a tensor of its own on the other's device, so
    PyTorch takes neither reciprocal shortcut."""
    if not isinstance(a, Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, Tensor):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued work on `device` (no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def f32(x: float) -> float:
    """The Python number x rounded to float32: what the reference's jitted
    functions receive for a Python-float argument."""
    return torch.tensor(float(x), dtype=torch.float32).item()


def fma_f32(a, b, c) -> Tensor:
    """`a * b + c` rounded once to float32. Operands are float32 tensors or
    Python numbers (taken as float32 first, `f32`); at least one is a
    tensor. The product of two float32 is exact in float64; the sum is
    rounded to odd there (TwoSum gives its error exactly, and an inexact
    sum with an even last bit moves one ulp toward the exact one), so the
    rounding to float32 that follows is the one correct rounding."""
    a, b, c = (x.double() if isinstance(x, Tensor) else f32(x) for x in (a, b, c))
    p = a * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    inf = torch.full_like(s, math.inf)
    odd = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    return torch.where((err != 0) & (s.view(torch.int64) % 2 == 0), odd, s).float()


def xla_norm3(v: Tensor) -> Tensor:
    """The Euclidean norm over the last axis of a float32 [..., 3] tensor as
    XLA compiles `jnp.linalg.norm(v, axis=-1)` on the CPU: the squares
    summed as x * x, then fma(y, y, .), then fma(z, z, .), and a correctly
    rounded square root (taken in float64: PyTorch's CPU float32 `sqrt` is
    not correctly rounded)."""
    x, y, z = v.unbind(-1)
    s = fma_f32(z, z, fma_f32(y, y, x * x))
    return torch.sqrt(s.double()).float()
