"""Faults planted in the program underneath a run, which the cell's
comparison has to find: `benchmark/tests/test_bench_cells.py` runs each at a
tiny size on the CPU, `benchmark/control.py --mode fault:<name>` at the
cell's own size on the card.

A fault is a list of (dotted attribute of the program, wrapper): the
wrapper takes the attribute and returns what stands in its place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np


def _flip_last_byte(blob: bytes) -> bytes:
    return blob[:-1] + bytes([blob[-1] ^ 1])


def _flip_middle_byte(blob: bytes) -> bytes:
    """One byte of a segment's slice data altered (the level data is the
    file's second half)."""
    i = len(blob) * 3 // 4
    return blob[:i] + bytes([blob[i] ^ 0x5A]) + blob[i + 1:]


def _hard_selectors(encode):
    """An ETC1S segment whose high-contrast blocks (each layer's half with
    the widest range of levels) get a selector drawn at random from the
    palette before emission: a stream that decodes, wrong where the
    content is hard."""
    def wrapped(frames, *a, **k):
        from uvol_tpu_torch.codecs.basis import etc1s_encode as m

        emit = m._emit_segment

        def scrambled(pal, f, h, w, *rest):
            px = np.asarray(frames)[..., :3].astype(np.int16)
            blocks = px.reshape(f, h // 4, 4, w // 4, 4, 3)
            contrast = (blocks.max(axis=(2, 4)) - blocks.min(axis=(2, 4))).max(-1).reshape(f, -1)
            hard = contrast > np.median(contrast, axis=1, keepdims=True)
            sel = pal.block_selector.copy()
            sel[:f][hard] = np.random.default_rng(0).integers(0, len(pal.selectors),
                                                              int(hard.sum()))
            return emit(dataclasses.replace(pal, block_selector=sel), f, h, w, *rest)

        m._emit_segment = scrambled
        try:
            return encode(frames, *a, **k)
        finally:
            m._emit_segment = emit
    return wrapped


Fault = List[Tuple[str, Callable]]

FAULTS: Dict[Tuple[str, str], Fault] = {
    # an answer altered where it is produced
    ("v2-etc1s-1k.encode", "altered"): [
        ("uvol_tpu_torch.codecs.draco.encoder.encode_drc",
         lambda f: lambda *a, **k: _flip_last_byte(f(*a, **k)))],
    ("v2-etc1s-1k.encode", "altered-texture"): [
        ("uvol_tpu_torch.codecs.basis.etc1s_encode.encode_ktx2_etc1s",
         lambda f: lambda *a, **k: _flip_middle_byte(f(*a, **k)))],
    # half of the batch left out: the segment's later layers repeat its first
    ("v2-etc1s-1k.encode", "half-batch"): [
        ("uvol_tpu_torch.codecs.basis.etc1s_encode.encode_ktx2_etc1s",
         lambda f: lambda frames, *a, **k: f(
             np.concatenate([frames[: (len(frames) + 1) // 2]] * 2)[: len(frames)], *a, **k))],
    # wrong selectors where the content is hard
    ("v2-etc1s-1k.encode", "hard-selectors"): [
        ("uvol_tpu_torch.codecs.basis.etc1s_encode.encode_ktx2_etc1s", _hard_selectors)],
}


def _owner(dotted: str):
    """(the object holding the attribute, its name)."""
    mod_name, attr = dotted.rsplit(".", 1)
    try:
        return importlib.import_module(mod_name), attr
    except ModuleNotFoundError:
        mod_name, cls = mod_name.rsplit(".", 1)
        return getattr(importlib.import_module(mod_name), cls), attr


@contextlib.contextmanager
def planted(cell: str, name: str, setattr_=None) -> Iterator[None]:
    """The fault `name` of `cell` in place for the block (`setattr_`: a
    test's monkeypatch.setattr, which restores by itself)."""
    saved = []
    for dotted, wrap in FAULTS[(cell, name)]:
        owner, attr = _owner(dotted)
        old = getattr(owner, attr)
        (setattr_ or setattr)(owner, attr, wrap(old))
        saved.append((owner, attr, old))
    try:
        yield
    finally:
        if setattr_ is None:
            for owner, attr, old in reversed(saved):
                setattr(owner, attr, old)
