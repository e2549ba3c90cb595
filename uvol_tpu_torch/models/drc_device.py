"""Real `.drc` decode on the card — counterpart of
`uvol_tpu/models/drc_device.py`.

The split of labour is the reference's. The wire stages (rANS,
Edgebreaker connectivity, prediction integration) are sequential
recurrences and run in C on the host (`native.drc_decode_native(...,
portable=True)`, one thread per frame, GIL-free). What follows them is
per-value math: quantized ints to floats (`mins + ints * scale`) and
octahedral ints to unit normals. A window of frames is packed on the
host into one uint8 buffer: every float attribute at 8, 10, 12, 16 or 32
bits per value (`_MODE_GROUP`), padded to `nmax` vertices (a multiple of
`_NMAX_BUCKET`), with the float32 metadata (per-frame mins and scales, or
the normals' `maxv`) on its tail, 4-aligned. On the card that buffer is
one copy from pinned host memory and one launch of K8
(`csrc/drc.cu`, `drc_fused_batch_kernel`): unpack, dequantize and
normals for every attribute of the window, into one allocation viewed as
one `[F, nmax, C]` float32 tensor per attribute, each starting on a
16-byte boundary (K8 stores 16 bytes at a time).

`fused_batch(packed, specs, meta_off, meta_len)` is the device stage,
the counterpart of the reference's `_fused_batch_fn(key)(packed)`: a CUDA
`packed` launches K8 (a failure raises; nothing falls back), a CPU one
runs the plain twin `fused_batch_plain`. Each K8 launch adds one to
`LAUNCHES["drc_fused_batch"]`; twin calls are not counted. The windows of
a stream repeat a few spec keys, so the checks of a key and K8's spec
table are built once and kept (`_plan`, at most `PLANS_MAX` keys); the
window itself is checked on every call.

The arithmetic, in K8 and in the twin alike:

  - dequantize is one fused multiply-add, `fma(float(q), scale, min)`
    rounded once, for every component (`_device.fma_f32` in the twin).
    XLA's CPU code for the reference contracts some components and not
    others, depending on the shape (at [4, 4096, 3]: components 0 and 1
    fused, 2 not); the port follows one rule, so it matches the reference
    exactly where XLA fuses and within 1 ulp of the product `q * scale`
    elsewhere. The host C path, which accumulates in float64, is nearest
    to the FMA;
  - normals: `u = q / maxv * 2 - 1` with an IEEE division, the fold,
    `sqrt((u2 * u2 + v2 * v2) + z * z)` with every product and sum
    rounded and the square root correctly rounded (PyTorch's CPU float32
    `sqrt` is not: the twin takes it in float64), `max(nrm, 1e-30)`
    propagating NaN, three IEEE divisions and (0, 0, 1) where `nrm == 0`:
    within 2 ulps of the reference (XLA's CPU `sqrt` and contractions). A degenerate `maxv` (0, or -1 from a zero
    `oct_max_quantized`) is mirrored, NaNs included, not fixed.

The entry points (`decode_drc_batch`, `decode_drc_stream`) run on the
card unless the caller names the CPU (`device="cpu"`). On the card a
window's buffer is packed straight into a pinned host buffer from a small
pool (`_PinnedPool`), copied with `non_blocking=True` on a side stream of
the device, and K8 runs on that stream; the batch's `token` is a
`torch.cuda.Event` recorded after K8. Before a batch reaches the caller,
the caller's current stream waits on that event and every output tensor
is recorded on it (`record_stream`), so the outputs are safe to use and
to free there.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from uvol_tpu_torch import _build, native
from uvol_tpu_torch._device import DeviceLike, fma_f32, resolve_device, true_div

Tensor = torch.Tensor

#: kernel launches since the last reset
LAUNCHES = {"drc_fused_batch": 0}

#: most float attributes one window (one K8 launch) carries: K8's spec table
MAX_SPECS = 4

#: most values an attribute of a K8 launch holds (`kMaxValues` of csrc/drc.cu:
#: its indices are 32-bit)
K8_MAX_VALUES = 0xFFFFF000

#: vertex-count bucket of the padded window shapes. The port has no
#: compile to save, but the padded [F, nmax, C] shape and the padding rows
#: are part of the output, held equal to the reference's
_NMAX_BUCKET = 4096

#: packing mode (bits) -> (values, bytes) per group: 11-, 10- and 8-bit
#: quantized values ride at 1.5, 1.25 and 1.0 bytes instead of 2
_MODE_GROUP = native.PACK_GROUPS

#: pinned window buffers kept: the stream's default lookahead (4) + 2
PINNED_POOL_SIZE = 6


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass
class DeviceFrameBatch:
    """Batched tensors of F decoded `.drc` frames (padded)."""

    counts: Dict[int, np.ndarray]  # att_type -> [F] valid value counts
    values: Dict[int, Any]  # att_type -> [F, nmax, C] float32 (int attributes: host lists)
    faces: List[np.ndarray]  # per-frame [M, 3] int32 (host)
    num_points: List[int]
    # on the card: a torch.cuda.Event recorded after the window's K8 launch
    token: Any = None


# ---- host half: packing (numpy) -------------------------------------------------


def _pick_mode(max_bits: int, has_neg: bool) -> int:
    if has_neg:
        return 16 if max_bits <= 15 else 32
    for m in (8, 10, 12):
        if max_bits <= m:
            return m
    # mode 16 is an int16 pack (unpacking sign-extends), so a non-negative
    # value must fit 15 bits; values >= 2**15 ride the int32 wire
    return 16 if max_bits <= 15 else 32


def _packed_nbytes(n: int, mode: int) -> int:
    gv, gb = _MODE_GROUP[mode]
    return ((n + gv - 1) // gv) * gb


def _pack_host(vals: np.ndarray, mode: int) -> np.ndarray:
    """Flat int array -> uint8 wire for the chosen mode (int32 input: one C
    pass where the native library is built)."""
    if vals.dtype == np.int32:
        out = native.pack_bits_native(vals, mode, _packed_nbytes(len(vals), mode))
        if out is not None:
            return out
    v = vals.astype(np.int64)
    if mode == 8:
        return v.astype(np.uint8)
    if mode == 16:
        return np.ascontiguousarray(v.astype(np.int16)).view(np.uint8)
    if mode == 32:
        return np.ascontiguousarray(v.astype(np.int32)).view(np.uint8)
    gv, gb = _MODE_GROUP[mode]
    pad = (-len(v)) % gv
    if pad:
        v = np.concatenate([v, np.zeros(pad, np.int64)])
    g = v.reshape(-1, gv)
    out = np.empty((len(g), gb), np.uint8)
    if mode == 12:  # 2 values -> 3 bytes
        out[:, 0] = g[:, 0] & 0xFF
        out[:, 1] = ((g[:, 0] >> 8) & 0xF) | ((g[:, 1] & 0xF) << 4)
        out[:, 2] = (g[:, 1] >> 4) & 0xFF
    else:  # mode == 10: 4 values -> 5 bytes
        out[:, 0] = g[:, 0] & 0xFF
        out[:, 1] = ((g[:, 0] >> 8) & 0x3) | ((g[:, 1] & 0x3F) << 2)
        out[:, 2] = ((g[:, 1] >> 6) & 0xF) | ((g[:, 2] & 0xF) << 4)
        out[:, 3] = ((g[:, 2] >> 4) & 0x3F) | ((g[:, 3] & 0x3) << 6)
        out[:, 4] = (g[:, 3] >> 2) & 0xFF
    return out.reshape(-1)


# ---- device half: the plain twin -------------------------------------------------


def unpack_plain(by: Tensor, mode: int, n: int) -> Tensor:
    """The first n values of a packed uint8 run, as int32."""
    b = by.to(torch.int32)
    if mode == 8:
        return b[:n]
    if mode == 16:
        g = b.reshape(-1, 2)
        v = g[:, 0] | (g[:, 1] << 8)
        return (v - ((v & 0x8000) << 1))[:n]  # sign-extend
    if mode == 32:  # in int64: an int32 << 24 of a byte >= 128 overflows
        g = by.to(torch.int64).reshape(-1, 4)
        v = g[:, 0] | (g[:, 1] << 8) | (g[:, 2] << 16) | (g[:, 3] << 24)
        return (v - ((v & 0x80000000) << 1)).to(torch.int32)[:n]
    if mode == 12:
        g = b.reshape(-1, 3)
        v0 = g[:, 0] | ((g[:, 1] & 0xF) << 8)
        v1 = (g[:, 1] >> 4) | (g[:, 2] << 4)
        return torch.stack([v0, v1], -1).reshape(-1)[:n]
    g = b.reshape(-1, 5)  # mode == 10
    v0 = g[:, 0] | ((g[:, 1] & 0x3) << 8)
    v1 = (g[:, 1] >> 2) | ((g[:, 2] & 0xF) << 6)
    v2 = (g[:, 2] >> 4) | ((g[:, 3] & 0x3F) << 4)
    v3 = (g[:, 3] >> 6) | (g[:, 4] << 2)
    return torch.stack([v0, v1, v2, v3], -1).reshape(-1)[:n]


def dequantize(ints: Tensor, mins: Tensor, scale: Tensor) -> Tensor:
    """[F, N, C] ints, [F, C] mins, [F] scale -> mins + ints * scale, one
    fused multiply-add rounded once."""
    return fma_f32(ints.to(torch.float32), scale[:, None, None], mins[:, None, :])


def oct_to_unit(st: Tensor, max_value: Tensor) -> Tensor:
    """[F, N, 2] octahedral ints, [F] maxv -> [F, N, 3] unit normals."""
    one = torch.ones((), dtype=torch.float32, device=st.device)
    u = true_div(st[..., 0].to(torch.float32), max_value[:, None]) * 2.0 - 1.0
    v = true_div(st[..., 1].to(torch.float32), max_value[:, None]) * 2.0 - 1.0
    z = (1.0 - u.abs()) - v.abs()
    neg = z < 0
    su = torch.where(u >= 0, one, -one)  # -0.0 maps to +1
    sv = torch.where(v >= 0, one, -one)
    u2 = torch.where(neg, (1.0 - v.abs()) * su, u)
    v2 = torch.where(neg, (1.0 - u.abs()) * sv, v)
    # correctly rounded on every device: PyTorch's CPU float32 sqrt (the
    # AVX512 path) is not; a float64 sqrt rounded once to float32 is
    nrm = torch.sqrt(((u2 * u2 + v2 * v2) + z * z).double()).float()
    dn = torch.maximum(nrm, torch.full_like(nrm, 1e-30))  # NaN stays NaN
    out = torch.stack([true_div(u2, dn), true_div(v2, dn), true_div(z, dn)], -1)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=st.device)
    return torch.where((nrm == 0)[..., None], up, out)


def _meta(packed: Tensor, meta_off: int, meta_len: int) -> Tensor:
    """The window's float32 metadata (little-endian bytes on its tail)."""
    b = packed[meta_off:meta_off + 4 * meta_len].to(torch.int64).reshape(-1, 4)
    bits = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return (bits - ((bits & 0x80000000) << 1)).to(torch.int32).view(torch.float32)


def fused_batch_plain(packed: Tensor, specs: Sequence[tuple], meta_off: int,
                      meta_len: int) -> Tuple[Tensor, ...]:
    """Plain twin of K8 on any device: one [F, nmax, C] float32 tensor per
    spec (att_type, kind, mode, f, nmax, nc, off, mlen, moff); kind 1
    dequantizes (C = nc), kind 2 decodes normals (nc = 2, C = 3)."""
    meta = _meta(packed, meta_off, meta_len)
    outs = []
    for _t, kind, mode, f, nmax, nc, off, _ml, moff in specs:
        n = f * nmax * nc
        ints = unpack_plain(packed[off:off + _packed_nbytes(n, mode)], mode, n)
        ints = ints.reshape(f, nmax, nc)
        if kind == 1:
            mins = meta[moff:moff + f * nc].reshape(f, nc)
            scale = meta[moff + f * nc:moff + f * nc + f]
            outs.append(dequantize(ints, mins, scale))
        else:
            outs.append(oct_to_unit(ints, meta[moff:moff + f]))
    return tuple(outs)


# ---- device half: K8 ----------------------------------------------------------------


class _Spec(ctypes.Structure):
    """One row of K8's spec table (`DrcSpec` of csrc/drc.cu)."""

    _fields_ = [("kind", ctypes.c_int32), ("mode", ctypes.c_int32), ("f", ctypes.c_int32),
                ("nmax", ctypes.c_int32), ("nc", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("off", ctypes.c_int64), ("moff", ctypes.c_int64), ("out_off", ctypes.c_int64)]


@dataclasses.dataclass(frozen=True)
class _Plan:
    """A spec key's checked layout: what `fused_batch` needs of a window,
    K8's spec table, and where each output lies in the one allocation
    (every attribute at a multiple of 4 floats, so K8's float4 stores are
    16-byte aligned)."""

    meta_end: int  # bytes the metadata needs: meta_off + 4 * meta_len
    spec_ends: Tuple[int, ...]  # bytes each attribute needs
    data_end: int  # the most of them
    table: Optional[ctypes.Array]  # K8's spec table; None past its limits
    total: int  # floats of the output allocation, every attribute padded to 4
    views: Tuple[Tuple[Tuple[int, int, int], Tuple[int, int, int], int], ...]  # shape, stride, at


#: spec keys whose plans `fused_batch` keeps: a corpus's bucketed shapes are
#: few, a hostile caller's are not
PLANS_MAX = 64
_PLANS: "collections.OrderedDict[tuple, _Plan]" = collections.OrderedDict()
_plans_lock = threading.Lock()


def _make_plan(specs: Tuple[tuple, ...], meta_off: int, meta_len: int) -> _Plan:
    if meta_off < 0 or meta_len < 0:
        raise ValueError(f"metadata [{meta_off}, +{4 * meta_len}) is not a byte range")
    ends, views = [], []
    fits = len(specs) <= MAX_SPECS and all(f * nmax * nc <= K8_MAX_VALUES
                                            for _t, _k, _m, f, nmax, nc, *_r in specs)
    table = (_Spec * MAX_SPECS)() if fits else None
    at = 0
    for i, spec in enumerate(specs):
        _t, kind, mode, f, nmax, nc, off, _ml, moff = spec
        need = {1: moff + f * nc + f, 2: moff + f}.get(kind)
        if need is None or mode not in _MODE_GROUP or (kind == 2 and nc != 2):
            raise ValueError(f"unsupported spec {spec}")
        if min(f, nmax, nc, off, moff) < 0 or need > meta_len:
            raise ValueError(f"spec {spec} outside its metadata of {meta_len} floats")
        ends.append(off + _packed_nbytes(f * nmax * nc, mode))
        w = nc if kind == 1 else 3
        if table is not None:
            row = table[i]
            row.kind, row.mode, row.f, row.nmax, row.nc = kind, mode, f, nmax, nc
            row.off, row.moff, row.out_off = off, moff, at
        views.append(((f, nmax, w), (nmax * w, w, 1), at))
        at += -(-f * nmax * w // 4) * 4
    return _Plan(meta_off + 4 * meta_len, tuple(ends), max(ends, default=0), table, at,
                 tuple(views))


def _plan(specs: Sequence[tuple], meta_off: int, meta_len: int) -> _Plan:
    """The checked plan of a spec key, from a bounded cache (least recently
    used out); raises ValueError on a key K8 cannot take."""
    key = (tuple(map(tuple, specs)), meta_off, meta_len)
    with _plans_lock:
        plan = _PLANS.get(key)
        if plan is not None:
            _PLANS.move_to_end(key)
            return plan
    plan = _make_plan(*key)
    with _plans_lock:
        _PLANS[key] = plan
        while len(_PLANS) > PLANS_MAX:
            _PLANS.popitem(last=False)
    return plan


@functools.cache
def _k8():
    return _build.entry("uvt_drc_fused_batch")


def fused_batch(packed: Tensor, specs: Sequence[tuple], meta_off: int,
                meta_len: int) -> Tuple[Tensor, ...]:
    """K8: the window's device stage. packed: the 1-D uint8 window;
    specs: up to `MAX_SPECS` tuples (att_type, kind, mode, f, nmax, nc,
    off, mlen, moff), `off` the attribute's byte offset in the window and
    `moff` its first float of the metadata at byte `meta_off` (a multiple
    of 4; `meta_len` floats). Returns one [f, nmax, C] float32 tensor per
    spec, contiguous views of one allocation on the card, each 16-byte
    aligned. The checks of a spec key are cached; the window's own (type,
    size, alignment) are made on every call."""
    if packed.dtype != torch.uint8 or packed.ndim != 1:
        raise ValueError(f"expected a 1-D uint8 window, got {tuple(packed.shape)} {packed.dtype}")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")
    plan = _plan(specs, meta_off, meta_len)
    size = packed.numel()
    if plan.meta_end > size:
        raise ValueError(f"metadata [{meta_off}, +{4 * meta_len}) outside a window of {size} bytes")
    if plan.data_end > size:
        spec = next(s for s, end in zip(specs, plan.spec_ends) if end > size)
        raise ValueError(f"spec {spec} outside a window of {size} bytes")
    if packed.device.type == "cpu":
        return fused_batch_plain(packed, specs, meta_off, meta_len)
    if plan.table is None:
        raise ValueError(f"K8 takes at most {MAX_SPECS} float attributes of at most "
                         f"{K8_MAX_VALUES} values each, got {len(specs)}")
    packed = packed.contiguous()
    ptr = packed.data_ptr()
    if (ptr + meta_off) % 4:
        raise ValueError("the window's metadata is not 4-byte aligned on the card")
    out = torch.empty(plan.total, dtype=torch.float32, device=packed.device)
    if plan.total:
        _build.launch(_k8(), packed.device, ptr, size, ctypes.addressof(plan.table), len(specs),
                      meta_off, out.data_ptr())
        LAUNCHES["drc_fused_batch"] += 1
    return tuple(out.as_strided(shape, stride, at) for shape, stride, at in plan.views)


# ---- uploads on the card ----------------------------------------------------------------


class _PinnedPool:
    """Pinned host buffers for the window uploads. A buffer goes back to
    the pool with the event of the copy that reads it, and is handed out
    again only once that event has completed: a buffer overwritten while
    its copy is in flight would be a silent wrong answer."""

    def __init__(self, size: int):
        self.size = size
        self._lock = threading.Lock()
        self._free: List[Tuple[Tensor, Optional[torch.cuda.Event]]] = []
        self._made = 0

    def acquire(self, nbytes: int) -> Tensor:
        with self._lock:
            for i, (buf, ev) in enumerate(self._free):
                if buf.numel() >= nbytes and ev.query():
                    del self._free[i]
                    return buf
            if self._made >= self.size and self._free:
                buf, ev = self._free.pop(0)  # the oldest: wait for its copy below
            else:
                self._made += 1
                buf, ev = None, None
        if ev is not None:
            ev.synchronize()
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return buf

    def release(self, buf: Tensor, event: torch.cuda.Event) -> None:
        with self._lock:
            self._free.append((buf, event))


_POOL = _PinnedPool(PINNED_POOL_SIZE)
_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}
_streams_lock = threading.Lock()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    with _streams_lock:
        if device.index not in _SIDE_STREAMS:
            _SIDE_STREAMS[device.index] = torch.cuda.Stream(device)
        return _SIDE_STREAMS[device.index]


def _upload_and_run(buf: Tensor, nbytes: int, specs, meta_off: int, meta_len: int,
                    device: torch.device, as_numpy: bool):
    """The window's copy and K8 on the device's side stream; returns the
    outputs (host arrays with `as_numpy`) and the event after K8."""
    stream = _side_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        packed = torch.empty(nbytes, dtype=torch.uint8, device=device)
        packed.copy_(buf[:nbytes], non_blocking=True)
        outs = fused_batch(packed, specs, meta_off, meta_len)
        token = torch.cuda.Event()
        token.record(stream)
        _POOL.release(buf, token)
        if as_numpy:
            outs = tuple(o.cpu().numpy() for o in outs)  # blocking, after K8 on this stream
    return outs, token


def _hand_over(batch: DeviceFrameBatch) -> DeviceFrameBatch:
    """Make the calling thread's current stream wait for the batch's K8 and
    record its outputs on that stream."""
    token = batch.token
    if isinstance(token, torch.cuda.Event):
        tensors = [v for v in batch.values.values() if isinstance(v, Tensor)]
        if tensors:
            stream = torch.cuda.current_stream(tensors[0].device)
            stream.wait_event(token)
            for v in tensors:
                v.record_stream(stream)
    return batch


def _bucket(n: int) -> int:
    return -(-max(n, 1) // _NMAX_BUCKET) * _NMAX_BUCKET


def _build_batch(frames, *, device: torch.device, as_numpy: bool = False,
                 sync: bool = True) -> DeviceFrameBatch:
    """Native-decoded frame tuples -> one padded batch: every float
    attribute rides one packed window, one copy and one K8 launch on the
    card (the plain twin on the CPU). `sync=False` leaves the card's work
    in flight (the stream pipelines windows)."""
    f = len(frames)
    by_type: Dict[int, List] = {}
    faces = []
    num_points = []
    for _num_faces, npts, poc, attrs in frames:
        faces.append(np.asarray(poc, np.int32).reshape(-1, 3))
        num_points.append(int(npts))
        for a in attrs:
            by_type.setdefault(a[0], []).append(a)

    counts: Dict[int, np.ndarray] = {}
    values: Dict[int, Any] = {}
    specs = []  # (att_type, kind, mode, f, nmax, nc, off, mlen, moff)
    jobs = []  # (vals_list, mode, stride, off), parallel to specs
    metas: List[np.ndarray] = []
    off = moff = 0
    for att_type, entries in sorted(by_type.items()):
        if len(entries) != f:
            raise ValueError(
                f"attribute type {att_type} appears in {len(entries)} of {f} frames; "
                "decode_drc_batch needs a uniform attribute set")
        kind = entries[0][7][0]
        decl_bits = 0
        if kind == 1:  # quantized: dequantize on the device
            nc = entries[0][5].shape[1]
            decl_bits = max(int(e[7][1]) for e in entries)
            mins = np.zeros((f, nc), np.float32)
            scale = np.zeros(f, np.float32)
            for i, e in enumerate(entries):
                _k, bits, _mq, rng, mn = e[7]
                mins[i] = mn[:nc]
                scale[i] = rng / ((1 << bits) - 1)
            meta = np.concatenate([mins.reshape(-1), scale]).astype(np.float32)
        elif kind == 2:  # octahedral normals
            nc = 2
            maxv = np.zeros(f, np.float32)
            for i, e in enumerate(entries):
                mq = e[7][2]
                q = 0
                while (1 << q) <= mq:
                    q += 1
                maxv[i] = float((1 << q) - 2)
                decl_bits = max(decl_bits, q)
            meta = maxv
        else:  # integer attributes are final: host ints
            counts[att_type] = np.asarray([len(e[5]) for e in entries], np.int64)
            values[att_type] = [e[5] for e in entries]
            continue
        vals_list = [np.ascontiguousarray(e[5], np.int32) for e in entries]
        nmax = _bucket(max(v.shape[0] for v in vals_list))
        # the declared bits pick the mode; the data range only where values
        # escape it (hostile or foreign streams)
        mode = _pick_mode(max(decl_bits, 1), False)
        vmax = max(int(v.max(initial=0)) for v in vals_list)
        vmin = min(int(v.min(initial=0)) for v in vals_list)
        if vmin < 0 or vmax >= (1 << max(decl_bits, 1)):
            mode = _pick_mode(max(vmax, 1).bit_length(), vmin < 0)
            if vmin < -(2**15) or vmax >= 2**15:
                mode = 32
        counts[att_type] = np.asarray([v.shape[0] for v in vals_list], np.int64)
        specs.append((att_type, kind, mode, f, nmax, nc, off, len(meta), moff))
        jobs.append((vals_list, mode, nmax * nc, off))
        metas.append(meta)
        off += _packed_nbytes(f * nmax * nc, mode)
        moff += len(meta)

    token = None
    if specs:
        meta_all = np.concatenate(metas)
        pad = (-off) % 4  # the metadata floats ride the tail, 4-aligned
        nbytes = off + pad + 4 * len(meta_all)
        if device.type == "cuda":
            buf = _POOL.acquire(nbytes)
            packed = buf.numpy()[:nbytes]
        else:
            packed = np.empty(nbytes, np.uint8)
        for spec, (vals_list, mode, stride, j_off) in zip(specs, jobs):
            # C fill + pack straight into the window (pinned on the card)
            if not native.pack_frames_native(vals_list, mode, stride, packed, j_off):
                nmax, nc = spec[4], spec[5]
                ints = np.zeros((f, nmax, nc), np.int32)
                for i, v in enumerate(vals_list):
                    ints[i, :v.shape[0]] = v.reshape(v.shape[0], nc)
                chunk = _pack_host(ints.reshape(-1), mode)
                packed[j_off:j_off + len(chunk)] = chunk
        packed[off:off + pad] = 0
        packed[off + pad:] = meta_all.view(np.uint8)
        if device.type == "cuda":
            outs, token = _upload_and_run(buf, nbytes, specs, off + pad, len(meta_all),
                                          device, as_numpy)
            if sync and not as_numpy:
                token.synchronize()
        else:
            outs = fused_batch(torch.from_numpy(packed), specs, off + pad, len(meta_all))
            if as_numpy:
                outs = tuple(o.numpy() for o in outs)
        for (att_type, *_rest), out in zip(specs, outs):
            values[att_type] = out
    return DeviceFrameBatch(counts=counts, values=values, faces=faces,
                            num_points=num_points, token=token)


# ---- entry points ---------------------------------------------------------------------------


def _resolve(device: DeviceLike) -> torch.device:
    """resolve_device, with the card's index made explicit (the uploader
    thread enters it; a thread's current device is its own)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _host_one(blob: bytes):
    res = native.drc_decode_native(blob, portable=True)
    if res is None:
        raise NotImplementedError("stream outside the native fast path; use decode_drc")
    return res


def decode_drc_batch(blobs: Sequence[bytes], *, workers: int = 8, as_numpy: bool = False,
                     device: DeviceLike = None) -> DeviceFrameBatch:
    """Real `.drc` frames -> one batch of padded float tensors on `device`
    (None: the current card). Host phase: the portable native decode of
    each frame on a thread pool; device phase: one packed upload and one
    K8 launch for every float attribute. `as_numpy=True` returns host
    arrays."""
    dev = _resolve(device)
    if len(blobs) > 1:
        with ThreadPoolExecutor(min(workers, len(blobs))) as pool:
            frames = list(pool.map(_host_one, blobs))
    else:
        frames = [_host_one(b) for b in blobs]
    return _hand_over(_build_batch(frames, device=dev, as_numpy=as_numpy))


def decode_drc_stream(blobs: Sequence[bytes], *, window: int = 8, workers: Optional[int] = None,
                      as_numpy: bool = False, lookahead: int = 4, device: DeviceLike = None):
    """Pipelined wire -> device decode; yields (start_index, batch) in order.

    `workers` threads (default min(8, cores)) run the C wire decode of up
    to `lookahead` windows ahead; one uploader thread packs each finished
    window into a pinned buffer and issues its copy and K8 on the device's
    side stream, in window order, without waiting for the card. Each batch
    is handed to the caller's current stream before it is yielded. Each
    window equals `decode_drc_batch` on the same slice."""
    dev = _resolve(device)
    if workers is None:
        workers = max(1, min(8, os.cpu_count() or 1))
    starts = list(range(0, len(blobs), window))

    def build(idx):
        frames = [fut.result() for fut in decode_futs.pop(idx)]
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            return _build_batch(frames, device=dev, as_numpy=as_numpy, sync=False)

    with ThreadPoolExecutor(max(1, workers)) as pool, ThreadPoolExecutor(1) as uploader:
        decode_futs: dict = {}
        batch_futs: dict = {}
        next_submit = 0
        for i, start in enumerate(starts):
            while next_submit < len(starts) and next_submit <= i + lookahead:
                s = starts[next_submit]
                decode_futs[next_submit] = [pool.submit(_host_one, b)
                                            for b in blobs[s:s + window]]
                # the uploader runs windows in order: copies stay ordered
                batch_futs[next_submit] = uploader.submit(build, next_submit)
                next_submit += 1
            yield start, _hand_over(batch_futs.pop(i).result())
