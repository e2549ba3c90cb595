"""Device selection and the float rules the port runs under.

Counterpart of `uvol_tpu.models.sequence._pallas_available`: the JAX
package picks its Pallas kernels by backend; here the device of the
tensors decides. A CUDA tensor goes through the hand-written kernels in
`csrc/`, a CPU tensor through their plain PyTorch twins.

Importing this module pins float32 matmuls and convolutions to full
precision: the reference runs its matmuls at `Precision.HIGHEST`, and on
Hopper both TF32 paths would keep only ~3 decimal digits.

Divisions with a Python-number operand go through `true_div`: PyTorch
computes `scalar / tensor` as `reciprocal(tensor) * scalar`, and on CUDA
`tensor / python_scalar` as a multiply by the scalar's reciprocal.
Either can be one ulp off the IEEE quotient the reference takes, which
moves a floor/round boundary and changes the bytes.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

DeviceLike = Union[str, torch.device, None]
Tensor = torch.Tensor


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` picks the first CUDA card when there is one, else the CPU
    (the JAX package's default-backend rule). Asking for `"cuda"` on a
    machine without a card raises instead of running on the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


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
