"""The port's ring-buffered host -> device streaming
(`runtime/device_stream.py`) on the CPU: ports of
tests/test_device_stream.py, whose `stream_frames` and ring the port
mirrors, with `device="cpu"` where the reference takes its default
device."""

import numpy as np
import pytest
import torch

import uvol_tpu_torch.runtime.device_stream as ds
from uvol_tpu_torch.runtime.device_stream import DeviceRingBuffer, stream_frames


def test_ring_buffer_eviction():
    ring = DeviceRingBuffer(num_slots=2, device="cpu")
    for i in range(5):
        ring.put(i, np.full((4,), i, np.float32))
    assert len(ring) == 2
    assert ring.get(2) is None  # evicted
    assert ring.get(3) is not None and ring.get(4) is not None
    np.testing.assert_array_equal(np.asarray(ring.get(4)), np.full(4, 4.0))


def test_stream_frames_matches_sequential():
    frames = [np.full((8, 8), i, np.float32) for i in range(7)]
    out = list(stream_frames(frames, lambda x: (x * 2.0).sum(), num_slots=2, device="cpu"))
    assert [i for i, _ in out] == list(range(7))
    for i, r in out:
        assert float(r) == float(np.sum(frames[i] * 2.0))


def test_stream_frames_stays_one_window_ahead(monkeypatch):
    """`stream_frames` finds the ring through its module when called, so
    a replaced ring is the one it fills."""
    uploads = []
    computed = []

    class Ring(ds.DeviceRingBuffer):
        def __init__(self, **kw):
            self.num_slots = kw.get("num_slots", 2)
            self._slots = {}

        def put(self, index, host):
            uploads.append(index)
            self._slots[index] = host
            for k in sorted(self._slots):
                if k <= index - self.num_slots:
                    del self._slots[k]
            return host

    monkeypatch.setattr(ds, "DeviceRingBuffer", Ring)

    def step(x):
        computed.append(int(x[0]))
        # the NEXT window's upload must already have been issued
        assert len(uploads) >= min(len(computed) + 1, 5)
        return x

    frames = [np.full(2, i) for i in range(5)]
    list(ds.stream_frames(frames, step))
    assert computed == list(range(5))


def test_ring_uploads_trees_of_arrays_and_tensors():
    """A window is any tree of tuples, lists and dicts of arrays or
    tensors; each leaf lands as a tensor on the ring's device, with its
    values and dtype."""
    ring = DeviceRingBuffer(device="cpu")
    tree = (np.arange(6, dtype=np.int32).reshape(2, 3),
            {"mask": np.ones(4, bool), "x": [torch.full((2,), 1.5)]})
    dev = ring.put(0, tree)
    assert isinstance(dev, tuple) and isinstance(dev[1]["x"], list)
    np.testing.assert_array_equal(dev[0].numpy(), tree[0])
    assert dev[1]["mask"].dtype == torch.bool and dev[1]["x"][0].tolist() == [1.5, 1.5]


def test_stream_frames_through_the_geometry_encode():
    """bench.py's windowed variant on a small batch: the device encode
    over windows of (positions, uvs, mask) equals the unwindowed call."""
    from uvol_tpu_torch.models.sequence import encode_device

    r = np.random.default_rng(0)
    windows = [(r.normal(size=(2, 3, 50)).astype(np.float32),
                r.uniform(size=(2, 2, 50)).astype(np.float32), np.ones((2, 50), bool))
               for _ in range(3)]
    got = list(stream_frames(windows, lambda w: encode_device(*w, 11, 10), device="cpu"))
    for i, out in got:
        want = encode_device(*(torch.from_numpy(a) for a in windows[i]), 11, 10)
        for k, v in want.items():
            assert torch.equal(out[k], v), k


def test_ring_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceRingBuffer()
    with pytest.raises(RuntimeError, match="cuda"):
        list(stream_frames([np.zeros(2)], lambda x: x))
