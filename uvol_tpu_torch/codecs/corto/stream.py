"""Corto stream layer: typed reads/writes + entropy blocks + bit sections.

Wire format per the reference `cstream.h/.cpp`:
  - little-endian scalars; strings as uint16 length (incl. NUL) + bytes + NUL
  - Tunstall block: u8 nsymbols, nsymbols×(symbol,prob) byte pairs,
    i32 uncompressed size, i32 compressed size, payload
  - embedded BitStream: i32 word count, pad stream to 4-byte alignment,
    then words (uint32 LE, MSB-first bit packing)
  - encodeValues / encodeArray / encodeDiffs / encodeIndices exactly as the
    reference templates (log-length side channel + magnitude bits)
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from uvol_tpu_torch.codecs.corto.bitstream import BitReader, BitWriter
from uvol_tpu_torch.codecs.corto import tunstall

#: reference enum (cstream.h:39): NONE=0 TUNSTALL=1 HUFFMAN=2 ZLIB=3 LZ4=4.
#: HUFFMAN has no implementation in the reference either (its dispatch
#: throws "Unknown entropy" — cstream.cpp:41-58); ZLIB/LZ4 wrap raw
#: zlib / LZ4-block payloads in an `i32 size, i32 csize, payload` frame
#: (cstream.cpp:124-168, behind ENTROPY_TESTS).
ENTROPY_NONE = 0
ENTROPY_TUNSTALL = 1
ENTROPY_HUFFMAN = 2
ENTROPY_ZLIB = 3
ENTROPY_LZ4 = 4


def ilog2(p: int) -> int:
    k = 0
    while p > 1:
        p >>= 1
        k += 1
    return k


def needed_bits(a: int) -> int:
    """Bits to store a signed diff (reference cstream.h `needed`)."""
    if a == 0:
        return 0
    if a == -1:
        return 1
    if a < 0:
        a = -a - 1
    n = 2
    while a > 1:
        a >>= 1
        n += 1
    return n


class CortoOutStream:
    def __init__(self, entropy: int = ENTROPY_TUNSTALL):
        self.entropy = entropy
        self._b = bytearray()

    # -- scalars -------------------------------------------------------------
    def u8(self, v): self._b += struct.pack("<B", v)
    def u16(self, v): self._b += struct.pack("<H", v)
    def u32(self, v): self._b += struct.pack("<I", v)
    def i32(self, v): self._b += struct.pack("<i", v)
    def f32(self, v): self._b += struct.pack("<f", v)
    def raw(self, b): self._b += b

    def string(self, s: str) -> None:
        data = s.encode() + b"\x00"
        self.u16(len(data))
        self.raw(data)

    def write_bitstream(self, bw: BitWriter) -> None:
        data = bw.getvalue()
        self.i32(len(data) // 4)
        pad = len(self._b) & 3
        if pad:
            self._b += b"\x00" * (4 - pad)
        self.raw(data)

    # -- entropy block -------------------------------------------------------
    def compress_block(self, data: np.ndarray) -> None:
        data = np.asarray(data, np.uint8)
        if self.entropy == ENTROPY_NONE:
            self.u32(len(data))
            self.raw(data.tobytes())
            return
        if self.entropy == ENTROPY_ZLIB:
            import zlib

            payload = zlib.compress(data.tobytes(), 9)  # cstream.cpp:126 level 9
            self.i32(len(data))
            self.i32(len(payload))
            self.raw(payload)
            return
        if self.entropy == ENTROPY_LZ4:
            from uvol_tpu_torch.codecs.corto import lz4

            payload = lz4.compress(data.tobytes())
            self.i32(len(data))
            self.i32(len(payload))
            self.raw(payload)
            return
        if self.entropy != ENTROPY_TUNSTALL:
            # parity with the reference: HUFFMAN & unknown values throw
            # (cstream.cpp:55-57 "Unknown entropy")
            raise ValueError(f"unknown corto entropy {self.entropy}")
        probabilities = tunstall.get_probabilities(data) if len(data) else []
        payload = tunstall.compress(data, probabilities)
        self.u8(len(probabilities))
        for s, p in probabilities:
            self.u8(s)
            self.u8(p)
        self.i32(len(data))
        self.i32(len(payload))
        self.raw(payload)

    def _write_words(self, words: np.ndarray) -> None:
        """Embed pre-packed bitstream words (native pack fast path)."""
        words = np.asarray(words, "<u4")
        self.i32(len(words))
        pad = len(self._b) & 3
        if pad:
            self._b += b"\x00" * (4 - pad)
        self.raw(words.tobytes())

    # -- value coders (reference cstream.h:118-205) --------------------------
    def encode_values(self, values: np.ndarray, n: int) -> None:
        """Per-component logs (uncorrelated components)."""
        values = np.asarray(values, np.int64).reshape(-1, n)
        size = len(values)
        from uvol_tpu_torch import native

        packed = native.corto_pack_values(values, size, n)
        if packed is not None:
            logs, words = packed
            self._write_words(words)
            for c in range(n):
                self.compress_block(logs[c])
            return
        bw = BitWriter()
        clogs = []
        for c in range(n):
            logs = np.zeros(size, np.uint8)
            col = values[:, c]
            for i in range(size):
                val = int(col[i])
                if val == 0:
                    continue
                ret = ilog2(abs(val)) + 1
                logs[i] = ret
                middle = (1 << ret) >> 1
                if val < 0:
                    val = -val - middle
                bw.write(val, ret)
            clogs.append(logs)
        self.write_bitstream(bw)
        for logs in clogs:
            self.compress_block(logs)

    def encode_array(self, values: np.ndarray, n: int) -> None:
        """Shared log per tuple (correlated components)."""
        values = np.asarray(values, np.int64).reshape(-1, n)
        size = len(values)
        from uvol_tpu_torch import native

        packed = native.corto_pack_tuples(values, size, n)
        if packed is not None:
            logs, words = packed
            self._write_words(words)
            self.compress_block(logs)
            return
        bw = BitWriter()
        logs = np.zeros(size, np.uint8)
        for i in range(size):
            p = values[i]
            diff = max(needed_bits(int(x)) for x in p)
            logs[i] = diff
            if diff == 0:
                continue
            mx = 1 << (diff - 1)
            for c in range(n):
                bw.write(int(p[c]) + mx, diff)
        self.write_bitstream(bw)
        self.compress_block(logs)

    def encode_diffs(self, values: np.ndarray) -> None:
        values = np.asarray(values, np.int64)
        from uvol_tpu_torch import native

        packed = native.corto_pack_values(values, len(values), 1)
        if packed is not None:
            logs, words = packed
            self._write_words(words)
            self.compress_block(logs[0])
            return
        bw = BitWriter()
        logs = np.zeros(len(values), np.uint8)
        for i, val in enumerate(values):
            val = int(val)
            if val == 0:
                continue
            ret = ilog2(abs(val)) + 1
            logs[i] = ret
            middle = (1 << ret) >> 1
            if val < 0:
                val = -val - middle
            bw.write(val, ret)
        self.write_bitstream(bw)
        self.compress_block(logs)

    def encode_indices(self, values: np.ndarray) -> None:
        values = np.asarray(values, np.int64)
        from uvol_tpu_torch import native

        packed = native.corto_pack_indices(values, len(values))
        if packed is not None:
            logs, words = packed
            self._write_words(words)
            self.compress_block(logs)
            return
        bw = BitWriter()
        logs = np.zeros(len(values), np.uint8)
        for i, v in enumerate(values):
            val = int(v) + 1
            if val == 1:
                continue
            ret = ilog2(val)
            logs[i] = ret
            bw.write(val - (1 << ret), ret)
        self.write_bitstream(bw)
        self.compress_block(logs)

    def getvalue(self) -> bytes:
        return bytes(self._b)


class CortoInStream:
    def __init__(self, data: bytes, entropy: int = ENTROPY_TUNSTALL):
        self.data = data
        self.pos = 0
        self.entropy = entropy

    def u8(self):
        v = self.data[self.pos]; self.pos += 1; return v
    def u16(self):
        v = struct.unpack_from("<H", self.data, self.pos)[0]; self.pos += 2; return v
    def u32(self):
        v = struct.unpack_from("<I", self.data, self.pos)[0]; self.pos += 4; return v
    def i32(self):
        v = struct.unpack_from("<i", self.data, self.pos)[0]; self.pos += 4; return v
    def f32(self):
        v = struct.unpack_from("<f", self.data, self.pos)[0]; self.pos += 4; return v

    def string(self) -> str:
        n = self.u16()
        s = self.data[self.pos : self.pos + n - 1].decode()
        self.pos += n
        return s

    def read_bitstream(self) -> BitReader:
        n = self.i32()
        pad = self.pos & 3
        if pad:
            self.pos += 4 - pad
        words = np.frombuffer(self.data, "<u4", count=n, offset=self.pos)
        self.pos += n * 4
        return BitReader(words)

    def decompress_block(self) -> np.ndarray:
        if self.entropy == ENTROPY_NONE:
            size = self.u32()
            out = np.frombuffer(self.data, np.uint8, count=size, offset=self.pos).copy()
            self.pos += size
            return out
        if self.entropy in (ENTROPY_ZLIB, ENTROPY_LZ4):
            size = self.u32()
            csize = self.u32()
            payload = self.data[self.pos : self.pos + csize]
            if len(payload) != csize:
                raise ValueError("corto stream: truncated entropy payload")
            self.pos += csize
            if not size:
                return np.zeros(0, np.uint8)
            if self.entropy == ENTROPY_ZLIB:
                import zlib

                raw = zlib.decompress(payload, bufsize=size)
            else:
                from uvol_tpu_torch.codecs.corto import lz4

                raw = lz4.decompress(payload, size)
            if len(raw) != size:
                raise ValueError("corto stream: entropy size mismatch")
            return np.frombuffer(raw, np.uint8).copy()
        if self.entropy != ENTROPY_TUNSTALL:
            raise ValueError(f"unknown corto entropy {self.entropy}")
        nsymbols = self.u8()
        probabilities = []
        for _ in range(nsymbols):
            s = self.u8()
            p = self.u8()
            probabilities.append((s, p))
        size = self.u32()
        compressed_size = self.u32()
        payload = self.data[self.pos : self.pos + compressed_size]
        self.pos += compressed_size
        return tunstall.decompress(payload, probabilities, size)

    # -- value decoders (corto.ts:828-927) -----------------------------------
    def decode_values(self, n: int, size: int) -> np.ndarray:
        bs = self.read_bitstream()
        from uvol_tpu_torch import native

        if native.get_corto_lib() is not None:
            logs = np.concatenate(
                [self.decompress_block() for _ in range(n)]
            ) if n > 1 else self.decompress_block()
            return native.corto_unpack_values(bs.a, logs, size, n)
        out = np.zeros((size, n), np.int32)
        for c in range(n):
            logs = self.decompress_block()
            for i in range(size):
                diff = int(logs[i])
                if diff == 0:
                    continue
                val = bs.read(diff)
                middle = (1 << diff) >> 1
                if val < middle:
                    val = -val - middle
                out[i, c] = val
        return out

    def decode_array(self, n: int, size: int) -> np.ndarray:
        bs = self.read_bitstream()
        logs = self.decompress_block()
        from uvol_tpu_torch import native

        if native.get_corto_lib() is not None:
            return native.corto_unpack_tuples(bs.a, logs, size, n)
        out = np.zeros((size, n), np.int32)
        for i in range(size):
            diff = int(logs[i])
            if diff == 0:
                continue
            mx = (1 << diff) >> 1
            for c in range(n):
                out[i, c] = bs.read(diff) - mx
        return out

    def decode_diffs(self, size: int) -> np.ndarray:
        """Inverse of `encode_diffs`. (Note: the reference's JS decodeDiffs
        at corto.ts:884-905 uses a read−max convention that does NOT invert
        the C++ encodeDiffs sign scheme; it's a legacy point-cloud path.
        We pair with the encoder's actual scheme, same as decodeValues.)"""
        bs = self.read_bitstream()
        logs = self.decompress_block()
        from uvol_tpu_torch import native

        if native.get_corto_lib() is not None:
            return (
                native.corto_unpack_values(bs.a, logs, size, 1)
                .reshape(-1)
                .astype(np.int64)
            )
        out = np.zeros(size, np.int64)
        for i in range(size):
            diff = int(logs[i])
            if diff == 0:
                continue
            val = bs.read(diff)
            middle = (1 << diff) >> 1
            if val < middle:
                val = -val - middle
            out[i] = val
        return out

    def decode_indices(self, size: int) -> np.ndarray:
        bs = self.read_bitstream()
        logs = self.decompress_block()
        from uvol_tpu_torch import native

        if native.get_corto_lib() is not None:
            return native.corto_unpack_indices(bs.a, logs, size).astype(
                np.int64
            )
        out = np.zeros(size, np.int64)
        for i in range(size):
            ret = int(logs[i])
            if ret:
                out[i] = (1 << ret) + bs.read(ret) - 1
        return out
