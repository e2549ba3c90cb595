# Frozen copy of the program's `codecs/buffer.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""Sequential decoder/encoder buffers with Draco wire conventions.

The port's copy of the reference's `codecs/buffer.py`, unchanged.

Host-side serialization primitives (SURVEY.md §7: "final bit-exact stream
pack/unpack ... because variable-length bitstream emit is serialization, not
math"). These model the byte/varint/bit-sequence accessors of a Draco-style
bitstream: little-endian scalars, LEB128 varints, and an LSB-first bit
sequence section.
"""

from __future__ import annotations

import struct
from typing import Optional

from uvbench.ref.codecs.varint import decode_varint, encode_varint


class DecoderBuffer:
    __slots__ = ("data", "pos", "end", "_bit_pos", "_bit_end")

    def __init__(self, data: bytes, pos: int = 0, end: Optional[int] = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end
        self._bit_pos = 0  # absolute bit cursor while in bit-decoding mode
        self._bit_end = 0

    # -- bytes ---------------------------------------------------------------
    def remaining(self) -> int:
        return self.end - self.pos

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        v = struct.unpack_from("<H", self.data, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def f32(self) -> float:
        v = struct.unpack_from("<f", self.data, self.pos)[0]
        self.pos += 4
        return v

    def raw(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n]
        if len(v) != n:
            raise ValueError("buffer underrun")
        self.pos += n
        return v

    def varint(self) -> int:
        v, self.pos = decode_varint(self.data, self.pos)
        return v

    def sub_buffer(self, n: int) -> "DecoderBuffer":
        b = DecoderBuffer(self.data, self.pos, self.pos + n)
        self.pos += n
        return b

    # -- bit sequence (LSB-first within each byte) ---------------------------
    def start_bit_decoding(self, decode_size: bool) -> int:
        size = self.varint() if decode_size else 0
        self._bit_pos = self.pos * 8
        self._bit_end = self.end * 8
        return size

    def get_bits(self, nbits: int) -> int:
        v = 0
        for i in range(nbits):
            if self._bit_pos >= self._bit_end:
                raise ValueError("bit buffer underrun")
            byte = self.data[self._bit_pos >> 3]
            v |= ((byte >> (self._bit_pos & 7)) & 1) << i
            self._bit_pos += 1
        return v

    def end_bit_decoding(self) -> None:
        self.pos = (self._bit_pos + 7) >> 3


class EncoderBuffer:
    __slots__ = ("_chunks", "_bits", "_bit_count")

    def __init__(self) -> None:
        self._chunks: list = []
        self._bits = 0
        self._bit_count = -1  # -1 = not in bit-encoding mode

    def u8(self, v: int) -> None:
        self._chunks.append(struct.pack("<B", v))

    def u16(self, v: int) -> None:
        self._chunks.append(struct.pack("<H", v))

    def u32(self, v: int) -> None:
        self._chunks.append(struct.pack("<I", v))

    def u64(self, v: int) -> None:
        self._chunks.append(struct.pack("<Q", v))

    def f32(self, v: float) -> None:
        self._chunks.append(struct.pack("<f", v))

    def raw(self, b: bytes) -> None:
        self._chunks.append(bytes(b))

    def varint(self, v: int) -> None:
        self._chunks.append(encode_varint(v))

    def start_bit_encoding(self) -> None:
        self._bits = 0
        self._bit_count = 0

    def put_bits(self, value: int, nbits: int) -> None:
        self._bits |= (value & ((1 << nbits) - 1)) << self._bit_count
        self._bit_count += nbits

    def end_bit_encoding(self, *, encode_size: bool = True) -> None:
        nbytes = (self._bit_count + 7) >> 3
        payload = self._bits.to_bytes(nbytes, "little")
        if encode_size:
            self._chunks.append(encode_varint(nbytes))
        self._chunks.append(payload)
        self._bit_count = -1

    def getvalue(self) -> bytes:
        return b"".join(self._chunks)

    def __len__(self) -> int:
        return sum(len(c) for c in self._chunks)
