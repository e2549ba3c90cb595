# Frozen copy of the program's `codecs/rans.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""rANS entropy codec with Draco wire layout (host serialization layer).

The port's copy of `uvol_tpu/codecs/rans.py`, unchanged in what it emits; it
calls the port's own native library (`uvbench.ref.native`).

Implements the asymmetric-numeral-system coder family used by the Draco
bitstream (the reference consumes it through `draco_decoder.wasm`,
`src/lib/DRACOLoader.js:483`; our build replaces that WASM with a native
decode path and must therefore speak the same wire format):

  - `RansSymbolDecoder` / `RansSymbolEncoder` — multi-symbol rANS with an
    explicit probability table, precision bits clamp(3·L/2, 12, 20)
  - `RansBitDecoder` / `RansBitEncoder` — binary rABS coder with 8-bit
    probability, L_BASE 4096
  - buffer conventions: renormalization bytes stream forward, the final
    state is appended with a 2-bit length marker, and the decoder walks the
    byte stream backwards from that marker

Python reference implementation — bit-exact oracle for tests and for the
C++ hot path (`uvol_tpu_torch/native`). Throughput-critical decode is batched
per frame across CPU workers / moved to native; TPU work stays in ops/.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from uvbench.ref.codecs.buffer import DecoderBuffer, EncoderBuffer

IO_BASE = 256
L_BASE_BITS = 4096  # rABS (binary) coder base
P8_PRECISION = 256


def rans_precision_bits(symbols_bit_length: int) -> int:
    """clamp((3·L)/2, 12, 20) — Draco's precision-from-bit-length rule."""
    return max(12, min(20, (3 * symbols_bit_length) // 2))


# ---------------------------------------------------------------------------
# Final-state marker: encoder appends state with a 2-bit size tag; decoder
# reads it from the end of the buffer.
# ---------------------------------------------------------------------------


def _write_final_state(state: int, l_base: int) -> bytes:
    state -= l_base
    if state < (1 << 6):
        return bytes([(0 << 6) | state])
    if state < (1 << 14):
        v = (1 << 14) | state
        return bytes([v & 0xFF, v >> 8])
    if state < (1 << 22):
        v = (2 << 22) | state
        return bytes([v & 0xFF, (v >> 8) & 0xFF, v >> 16])
    if state < (1 << 30):
        v = (3 << 30) | state
        return bytes([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF, v >> 24])
    raise ValueError("rANS state overflow at flush")


def _read_final_state(buf: bytes, l_base: int) -> Tuple[int, int]:
    """Returns (state, buf_offset) where buf_offset is the number of
    renormalization bytes preceding the marker."""
    n = len(buf)
    x = buf[n - 1] >> 6
    if x == 0:
        return (buf[n - 1] & 0x3F) + l_base, n - 1
    if x == 1:
        v = buf[n - 2] | (buf[n - 1] << 8)
        return (v & 0x3FFF) + l_base, n - 2
    if x == 2:
        v = buf[n - 3] | (buf[n - 2] << 8) | (buf[n - 1] << 16)
        return (v & 0x3FFFFF) + l_base, n - 3
    v = buf[n - 4] | (buf[n - 3] << 8) | (buf[n - 2] << 16) | (buf[n - 1] << 24)
    return (v & 0x3FFFFFFF) + l_base, n - 4


# ---------------------------------------------------------------------------
# Probability tables
# ---------------------------------------------------------------------------


def normalize_probabilities(counts: Sequence[int], precision: int) -> List[int]:
    """Scale counts so they sum to `precision`; nonzero counts stay ≥ 1."""
    counts = list(counts)
    total = sum(counts)
    if total == 0:
        raise ValueError("no symbols")
    nonzero = sum(1 for c in counts if c)
    if nonzero > precision:
        # every nonzero symbol needs >= 1 slot; the redistribution loop
        # below cannot converge (it used to spin forever)
        raise ValueError(
            f"{nonzero} symbols cannot fit precision {precision}"
        )
    probs = [0] * len(counts)
    used = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        p = (c * precision) // total
        probs[i] = max(p, 1)
        used += probs[i]
    # distribute the rounding error onto the most probable symbol(s)
    err = precision - used
    order = sorted(range(len(counts)), key=lambda i: -probs[i])
    k = 0
    while err != 0:
        i = order[k % len(order)]
        step = err
        if probs[i] + step < 1:  # never drop a nonzero symbol to zero
            step = 1 - probs[i]
        probs[i] += step
        err -= step
        k += 1
    return probs


def encode_probability_table(probs: Sequence[int], out: EncoderBuffer) -> None:
    """Token-coded table: low 2 bits = extra-byte count, or 3 = zero run."""
    out.varint(len(probs))
    i = 0
    n = len(probs)
    while i < n:
        p = probs[i]
        if p == 0:
            run = 1
            while i + run < n and run < 64 and probs[i + run] == 0:
                run += 1
            out.u8(((run - 1) << 2) | 3)
            i += run
            continue
        extra = 0
        if p >= (1 << 6):
            extra += 1
        if p >= (1 << 14):
            extra += 1
        out.u8(((p << 2) | extra) & 0xFF)
        for b in range(1, extra + 1):
            out.u8((p >> (8 * b - 2)) & 0xFF)
        i += 1


def decode_probability_table(buf: DecoderBuffer) -> List[int]:
    num_symbols = buf.varint()
    probs = [0] * num_symbols
    i = 0
    while i < num_symbols:
        d = buf.u8()
        token = d & 3
        if token == 3:
            i += (d >> 2) + 1
            continue
        p = d >> 2
        for b in range(1, token + 1):
            p |= buf.u8() << (8 * b - 2)
        probs[i] = p
        i += 1
    return probs


# ---------------------------------------------------------------------------
# Multi-symbol rANS
# ---------------------------------------------------------------------------


class RansSymbolDecoder:
    """Decodes a symbol stream laid out as: varint num_symbols, probability
    table, varint64 buffer size, rANS bytes (+marker)."""

    def __init__(self, buf: DecoderBuffer, precision_bits: int):
        self.precision = 1 << precision_bits
        self.l_base = self.precision * 4
        self.probs = decode_probability_table(buf)
        if sum(self.probs) != self.precision:
            raise ValueError(
                f"probability table sums to {sum(self.probs)}, "
                f"expected {self.precision}"
            )
        # slot → (symbol, prob, cum_prob)
        self._lut_sym = np.zeros(self.precision, np.uint32)
        self._cum = np.zeros(len(self.probs) + 1, np.uint64)
        c = 0
        for s, p in enumerate(self.probs):
            self._lut_sym[c : c + p] = s
            self._cum[s] = c
            c += p
        self._cum[len(self.probs)] = c
        self.num_symbols = len(self.probs)
        # rANS buffer
        size = buf.varint()
        self._buf = buf.raw(size)
        self.state, self.offset = _read_final_state(self._buf, self.l_base)
        self._initial_state = self.state
        self._consumed = False
        self._marker_len = len(self._buf) - self.offset

    def decode_symbol(self) -> int:
        if self._consumed:
            raise ValueError("rANS decoder already fully consumed")
        state = self.state
        while state < self.l_base and self.offset > 0:
            self.offset -= 1
            state = state * IO_BASE + self._buf[self.offset]
        rem = state % self.precision
        sym = int(self._lut_sym[rem])
        p = self.probs[sym]
        self.state = (state // self.precision) * p + rem - int(self._cum[sym])
        return sym

    def decode_all(self, n: int) -> np.ndarray:
        """Decode n symbols (native C++ hot loop when available)."""
        if self._consumed:
            raise ValueError(
                "rANS decoder already fully consumed by a single-shot "
                "decode_all (per-stream decoders are one-shot)"
            )
        from uvbench.ref import native

        if (
            self.offset == len(self._buf) - self._marker_len
            and self.state == self._initial_state
        ):
            out = native.rans_decode_native(
                np.asarray(self.probs, np.uint32),
                (self.precision - 1).bit_length(),
                self._buf,
                n,
            )
            if out is not None:
                # the native single-shot call does not return the final
                # state; mark the decoder consumed so a later call errors
                # instead of silently decoding garbage
                self._consumed = True
                return out
        out = np.empty(n, np.uint32)
        state = self.state
        offset = self.offset
        buf = self._buf
        precision = self.precision
        l_base = self.l_base
        lut = self._lut_sym
        probs = self.probs
        cum = self._cum
        for i in range(n):
            while state < l_base and offset > 0:
                offset -= 1
                state = state * IO_BASE + buf[offset]
            rem = state % precision
            sym = int(lut[rem])
            state = (state // precision) * probs[sym] + rem - int(cum[sym])
            out[i] = sym
        self.state, self.offset = state, offset
        return out


class RansSymbolEncoder:
    """Inverse of `RansSymbolDecoder`: same wire layout."""

    def __init__(self, counts: Sequence[int], precision_bits: int):
        self.precision = 1 << precision_bits
        self.l_base = self.precision * 4
        self.probs = normalize_probabilities(counts, self.precision)
        self._cum = [0] * (len(self.probs) + 1)
        for i, p in enumerate(self.probs):
            self._cum[i + 1] = self._cum[i] + p

    def encode_all(self, symbols: Sequence[int], out: EncoderBuffer) -> None:
        encode_probability_table(self.probs, out)
        from uvbench.ref import native

        payload_native = native.rans_encode_native(
            np.asarray(self.probs, np.uint32),
            (self.precision - 1).bit_length(),
            np.asarray(symbols, np.uint32),
        )
        if payload_native is not None:
            out.varint(len(payload_native))
            out.raw(payload_native)
            return
        state = self.l_base
        renorm = bytearray()
        precision = self.precision
        upper_factor = IO_BASE * (self.l_base // precision)  # = 1024
        for s in reversed(symbols):
            p = self.probs[s]
            bound = upper_factor * p
            while state >= bound:
                renorm.append(state % IO_BASE)
                state //= IO_BASE
            state = (state // p) * precision + state % p + self._cum[s]
        payload = bytes(renorm) + _write_final_state(state, self.l_base)
        out.varint(len(payload))
        out.raw(payload)


# ---------------------------------------------------------------------------
# Binary rABS coder (probability-of-zero in 1/256 units)
# ---------------------------------------------------------------------------


class RansBitDecoder:
    """Wire layout: u8 prob_zero, varint size, rABS bytes (+marker)."""

    def __init__(self, buf: DecoderBuffer):
        self.prob_zero = buf.u8()
        size = buf.varint()
        self._buf = buf.raw(size)
        self.state, self.offset = _read_final_state(self._buf, L_BASE_BITS)

    def decode_bit(self) -> int:
        p0 = self.prob_zero
        p = P8_PRECISION - p0
        state = self.state
        while state < L_BASE_BITS and self.offset > 0:
            self.offset -= 1
            state = state * IO_BASE + self._buf[self.offset]
        quot, rem = divmod(state, P8_PRECISION)
        xn = quot * p
        if rem < p:
            self.state = xn + rem
            return 1
        self.state = state - xn - p
        return 0


class RansBitEncoder:
    """Accumulates bits; flush computes prob_zero and emits the stream.

    Bits are stored as numpy chunks (single-bit appends are batched) so
    bulk seam/flip streams never cross per-element Python calls."""

    def __init__(self) -> None:
        self._chunks: List[np.ndarray] = []
        self._singles: List[int] = []

    def encode_bit(self, bit: int) -> None:
        self._singles.append(1 if bit else 0)

    def encode_bits(self, bits) -> None:
        """Bulk append (numpy array or iterable of 0/1)."""
        if self._singles:
            self._chunks.append(np.asarray(self._singles, np.uint8))
            self._singles = []
        self._chunks.append(
            (np.asarray(bits).ravel() != 0).astype(np.uint8)
        )

    def _all_bits(self) -> np.ndarray:
        if self._singles:
            self._chunks.append(np.asarray(self._singles, np.uint8))
            self._singles = []
        if not self._chunks:
            return np.zeros(0, np.uint8)
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks)]
        return self._chunks[0]

    def flush(self, out: EncoderBuffer) -> None:
        bits = self._all_bits()
        total = len(bits)
        zeros = total - int(bits.sum())
        if total == 0:
            prob_zero = 128
        else:
            prob_zero = min(255, max(1, (zeros * 256 + total // 2) // total))
        out.u8(prob_zero)
        if total > 256:  # native C++ emit (identical wire bytes)
            from uvbench.ref import native

            payload_native = native.rabs_encode_bits_native(bits, prob_zero)
            if payload_native is not None:
                out.varint(len(payload_native))
                out.raw(payload_native)
                self._chunks = []
                return
        p = P8_PRECISION - prob_zero
        state = L_BASE_BITS
        renorm = bytearray()
        for bit in reversed(bits.tolist()):
            l_s = p if bit else prob_zero
            bound = (L_BASE_BITS // P8_PRECISION) * IO_BASE * l_s
            while state >= bound:
                renorm.append(state % IO_BASE)
                state //= IO_BASE
            quot, rem = divmod(state, l_s)
            state = quot * P8_PRECISION + rem + (0 if bit else p)
        payload = bytes(renorm) + _write_final_state(state, L_BASE_BITS)
        out.varint(len(payload))
        out.raw(payload)
        self._chunks = []
