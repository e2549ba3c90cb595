# Frozen copy of the program's `codecs/varint.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""LEB128 varints + little-endian helpers (Draco wire primitives).

The port's copy of the reference's `codecs/varint.py`, unchanged."""

from __future__ import annotations

from typing import Tuple


def encode_varint(value: int) -> bytes:
    if value < 0:
        raise ValueError("varint must be unsigned")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")
