"""Host -> device streaming: ring-buffered uploads overlapping device
compute — counterpart of `uvol_tpu/runtime/device_stream.py`.

`DeviceRingBuffer.put` uploads a window (a tree of numpy arrays or
tensors: tuples, lists and dicts of them) to its device and keeps a
bounded number of windows resident. On the card each array is staged in
pinned host memory and copied with `non_blocking=True` on the ring's own
side stream, so the copy overlaps the kernels queued on the caller's
stream; the caller's current stream is then made to wait for the copy (a
wait on the card: the host goes on) and each uploaded tensor is recorded
on that stream. `stream_frames` keeps one window's upload in flight ahead
of the window being computed.

`device=None` is the current card; the CPU runs only where named
(`device="cpu"`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from uvol_tpu_torch._device import DeviceLike, resolve_device


class DeviceRingBuffer:
    """Fixed number of device-resident slots keyed by an increasing window
    index; windows older than the ring's capacity are evicted as new ones
    land."""

    def __init__(self, num_slots: int = 2, device: DeviceLike = None):
        self.num_slots = num_slots
        self.device = resolve_device(device)
        self._slots: Dict[int, Any] = {}
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)

    def _upload(self, tree: Any) -> Any:
        if isinstance(tree, (tuple, list)):
            return type(tree)(self._upload(t) for t in tree)
        if isinstance(tree, dict):
            return {k: self._upload(v) for k, v in tree.items()}
        t = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(np.asarray(tree))
        if self._stream is None:
            return t.to(self.device)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def put(self, index: int, host_tree: Any) -> Any:
        """Start the upload of a window; returns its device tree."""
        if self._stream is None:
            dev = self._upload(host_tree)
        else:
            current = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._stream):
                dev = self._upload(host_tree)
                done = torch.cuda.Event()
                done.record(self._stream)
            current.wait_event(done)
            for t in _leaves(dev):
                t.record_stream(current)
        self._slots[index] = dev
        for k in sorted(self._slots):
            if k <= index - self.num_slots:
                del self._slots[k]
        return dev

    def get(self, index: int) -> Optional[Any]:
        return self._slots.get(index)

    def __len__(self) -> int:
        return len(self._slots)


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    else:
        yield tree


def stream_frames(frames: Iterable[Any], step_fn: Callable[[Any], Any], *,
                  num_slots: int = 2, device: DeviceLike = None) -> Iterator[Tuple[int, Any]]:
    """Double-buffered pipeline: while the device computes `step_fn` on
    window i, window i+1's upload is already in flight. Yields (index,
    result) in order."""
    ring = DeviceRingBuffer(num_slots=num_slots, device=device)
    pending = []  # [(index, device_tree)]
    for idx, host in enumerate(frames):
        pending.append((idx, ring.put(idx, host)))
        if len(pending) >= 2:
            i0, dev0 = pending.pop(0)
            yield i0, step_fn(dev0)  # the upload of pending[0] overlaps this
    for i0, dev0 in pending:
        yield i0, step_fn(dev0)
