"""Corto 32-bit-word bitstream (MSB-first within little-endian uint32 words).

Format per the reference's `bitstream.h/.cpp` and the JS reader
(`src/lib/corto.ts:738-771`): values are packed into the high bits of each
32-bit word; the final partial word is left-aligned on flush.
"""

from __future__ import annotations

from typing import List

import numpy as np


class BitWriter:
    def __init__(self) -> None:
        self.words: List[int] = []
        self._buff = 0
        self._bits = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        value &= (1 << n) - 1
        space = 32 - self._bits
        if n < space:
            self._buff = (self._buff << n) | value
            self._bits += n
        else:
            hi_bits = n - space
            self._buff = ((self._buff << space) | (value >> hi_bits)) & 0xFFFFFFFF
            self.words.append(self._buff)
            self._bits = hi_bits
            self._buff = value & ((1 << hi_bits) - 1) if hi_bits else 0

    def flush(self) -> None:
        if self._bits:
            self.words.append((self._buff << (32 - self._bits)) & 0xFFFFFFFF)
            self._buff = 0
            self._bits = 0

    def getvalue(self) -> bytes:
        self.flush()
        return np.asarray(self.words, "<u4").tobytes()

    @property
    def num_words(self) -> int:
        return len(self.words) + (1 if self._bits else 0)


class BitReader:
    def __init__(self, words: np.ndarray):
        self.a = np.asarray(words, np.uint32)
        self.position = 0
        self.current = int(self.a[0]) if len(self.a) else 0
        self.pending = 32

    def read(self, bits: int) -> int:
        if bits == 0:
            return 0
        if bits > self.pending:
            over = bits - self.pending
            result = (self.current << over) & 0xFFFFFFFF
            self.pending = 32 - over
            self.position += 1
            self.current = int(self.a[self.position])
            result |= self.current >> self.pending
            self.current &= (1 << self.pending) - 1
            return result
        self.pending -= bits
        result = self.current >> self.pending
        self.current &= (1 << self.pending) - 1
        return result
