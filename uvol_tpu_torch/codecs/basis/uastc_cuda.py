"""The UASTC device fit (U1) on the card — counterpart of the reference's
`_device_fit_fn` (`uvol_tpu/codecs/basis/uastc.py`), an XLA program.

`device_fit(px, modes)` fits, quantizes and scores every candidate mode
of every block and picks each block's winner. The device of the tensor
decides the route:

  - a CUDA tensor launches `uastc_device_fit_kernel` of `csrc/uastc.cu`,
    built by `_build` at first use; a build or launch failure raises,
    nothing falls back;
  - a CPU tensor goes through `device_fit_select_plain`: the plain twin
    `uastc.device_fit_plain` and the first minimum of the error in mode
    order (`errs.argmin(0)`, as the reference's host does).

Each kernel launch adds one to `LAUNCHES["uastc_device_fit"]`.

`weight_index(w64, levels)` exports the kernel's nearest weight entry
(a closed form: every table is round(k * 64 / (levels - 1))) on its own,
so that it can be held against the twin's scan (`weight_index_plain`)
for every float32 in [0, 64]; its launches count under
`LAUNCHES["uastc_weight_index"]`.

Both return `(winner, q0, q1, wmain, walpha, err)` for the winning mode
of each block: its index in `modes` [B] uint8, its quantized endpoints
[B, 4] uint8 (channel 3 is 0 for an RGB mode), its weight indices [B, 16]
uint8 for the main plane and the alpha plane (0 without a second plane),
and its error [B] float32.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from uvol_tpu_torch import _build
from uvol_tpu_torch.codecs.basis.uastc import (
    DEVICE_FIT_MODES,
    MODES,
    WEIGHT_TABLES,
    device_fit_plain,
)

Tensor = torch.Tensor

#: kernel launches since the last reset (plain-twin calls are not counted)
LAUNCHES = {"uastc_device_fit": 0, "uastc_weight_index": 0}

#: blocks per chunk of the plain twin: its [B, 16, levels] float32 tiles
#: stay at 256 MiB
PLAIN_CHUNK = 1 << 18

#: the kernel's mode rows, one tensor per (modes, device)
_TABLES: Dict[Tuple[Tuple[int, ...], str], Tensor] = {}
#: one weight table per (levels, device), for `weight_index`
_WEIGHTS: Dict[Tuple[int, str], Tensor] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(px: Tensor, modes: Sequence[int]) -> None:
    if px.dtype != torch.uint8 or px.ndim != 3 or tuple(px.shape[1:]) != (16, 4):
        raise ValueError(f"expected [B, 16, 4] uint8, got {tuple(px.shape)} {px.dtype}")
    bad = [m for m in modes if m not in DEVICE_FIT_MODES]
    if not modes or bad:
        raise ValueError(f"the device fit takes modes {DEVICE_FIT_MODES}, got {list(modes)}")


def mode_rows(modes: Sequence[int]) -> np.ndarray:
    """The kernel's table: per mode [nc, dual plane, endpoint bits, weight
    levels, f32(scale / 255) bits, f32(1 / (16 nc)) bits, 0, 0, weight
    table (16, zero-padded)] int32."""
    rows = np.zeros((len(modes), 24), np.int32)
    for i, mid in enumerate(modes):
        m = MODES[mid]
        nc = 4 if m.cem == 12 else 3
        scale = (1 << m.ep_bits) - 1
        rows[i, :4] = (nc, int(m.dual_plane), m.ep_bits, m.weight_levels)
        rows[i, 4:6] = np.array([scale / 255.0, 1.0 / (16 * nc)], np.float32).view(np.int32)
        rows[i, 8:8 + m.weight_levels] = WEIGHT_TABLES[m.weight_levels]
    return rows


def device_fit_select_plain(px: Tensor, modes: Sequence[int], chunk: int = PLAIN_CHUNK):
    """Plain twin of the kernel on any device: `device_fit_plain` chunk by
    chunk, then each block's first minimum of the error over `modes`."""
    _check(px, modes)
    b = px.shape[0]
    dev = px.device
    winner = torch.empty(b, dtype=torch.uint8, device=dev)
    q0 = torch.zeros((b, 4), dtype=torch.uint8, device=dev)
    q1 = torch.zeros((b, 4), dtype=torch.uint8, device=dev)
    wmain = torch.empty((b, 16), dtype=torch.uint8, device=dev)
    walpha = torch.empty((b, 16), dtype=torch.uint8, device=dev)
    err = torch.empty(b, dtype=torch.float32, device=dev)
    for s in range(0, b, chunk):
        fits = device_fit_plain(px[s:s + chunk], modes)
        errs = torch.stack([f[4] for f in fits])  # [M, n]
        win = errs.argmin(0)  # the first minimum, as numpy's argmin
        winner[s:s + chunk] = win.to(torch.uint8)
        err[s:s + chunk] = errs.gather(0, win[None])[0]
        for field, out in ((0, q0), (1, q1), (2, wmain), (3, walpha)):
            for mi, f in enumerate(fits):
                sel = win == mi
                v = f[field].to(torch.uint8)
                out[s:s + chunk, :v.shape[1]][sel] = v[sel]
    return winner, q0, q1, wmain, walpha, err


def device_fit(px: Tensor, modes: Sequence[int]):
    """[B, 16, 4] uint8 blocks -> each block's winning mode and its fields
    (module docstring), on the tensor's device."""
    _check(px, modes)
    if px.device.type == "cpu":
        return device_fit_select_plain(px, modes)
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    px = px.contiguous()
    if px.data_ptr() % 16:  # the kernel reads a block as four 16-byte loads
        px = px.clone()
    key = (tuple(modes), str(px.device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(mode_rows(modes)).to(px.device)
    b = px.shape[0]
    dev = px.device
    winner = torch.empty(b, dtype=torch.uint8, device=dev)
    q0 = torch.empty((b, 4), dtype=torch.uint8, device=dev)
    q1 = torch.empty((b, 4), dtype=torch.uint8, device=dev)
    wmain = torch.empty((b, 16), dtype=torch.uint8, device=dev)
    walpha = torch.empty((b, 16), dtype=torch.uint8, device=dev)
    err = torch.empty(b, dtype=torch.float32, device=dev)
    _build.launch("uvt_uastc_device_fit", dev, px.data_ptr(), _TABLES[key].data_ptr(),
                  len(modes), b, winner.data_ptr(), q0.data_ptr(), q1.data_ptr(),
                  wmain.data_ptr(), walpha.data_ptr(), err.data_ptr())
    LAUNCHES["uastc_device_fit"] += 1
    return winner, q0, q1, wmain, walpha, err


def weight_index_plain(w64: Tensor, levels: int) -> Tensor:
    """The twin's nearest weight entry (`uastc._fit_plane`): the first
    minimum of |w64 - table[k]| over the table of `levels` entries, for
    w64 [N] float32 -> [N] int32, on the tensor's device."""
    table_f = torch.tensor(WEIGHT_TABLES[levels], dtype=torch.float32, device=w64.device)
    return (w64[..., None] - table_f).abs().argmin(-1).to(torch.int32)


def weight_index(w64: Tensor, levels: int) -> Tensor:
    """U1's nearest weight entry for each w64 [N] float32 in [0, 64]
    (levels one of `WEIGHT_TABLES`) -> [N] int32: on a CUDA tensor the
    kernel's own device function (`weight_index_kernel`), on a CPU tensor
    `weight_index_plain`."""
    if w64.dtype != torch.float32 or w64.ndim != 1 or levels not in WEIGHT_TABLES:
        raise ValueError(f"expected [N] float32 and levels in {sorted(WEIGHT_TABLES)}, "
                         f"got {tuple(w64.shape)} {w64.dtype}, {levels}")
    if w64.device.type == "cpu":
        return weight_index_plain(w64, levels)
    if w64.device.type != "cuda":
        raise ValueError(f"unsupported device {w64.device}")
    w64 = w64.contiguous()
    key = (levels, str(w64.device))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = torch.tensor(WEIGHT_TABLES[levels], dtype=torch.int32, device=w64.device)
    out = torch.empty(w64.shape[0], dtype=torch.int32, device=w64.device)
    _build.launch("uvt_uastc_weight_index", w64.device, w64.data_ptr(), w64.shape[0], levels,
                  _WEIGHTS[key].data_ptr(), out.data_ptr())
    LAUNCHES["uastc_weight_index"] += 1
    return out
