# Frozen copy of the program's `codecs/symbol_coding.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""Draco-layout symbol encoding/decoding (tagged & raw rANS schemes).

The port's copy of `uvol_tpu/codecs/symbol_coding.py`, unchanged in what it emits; it
calls the port's own native library (`uvbench.ref.native`).

Wire format:
  u8 scheme — 0 = TAGGED, 1 = RAW
  TAGGED: rANS over per-value bit lengths (precision from L=5), then an
          LSB-first bit section with the raw value bits, num_components
          values per tag.
  RAW:    u8 max_bit_length, then one rANS symbol per value with
          precision bits clamp(3·L/2, 12, 20).

The signed↔symbol mapping is the zigzag used across the reference's codecs
(Draco ConvertSignedIntsToSymbols; Corto encodeDiff — see
`uvbench.ref.ops.quantize.zigzag_encode`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from uvbench.ref.codecs.buffer import DecoderBuffer, EncoderBuffer
from uvbench.ref.codecs.rans import (
    RansSymbolDecoder,
    RansSymbolEncoder,
    rans_precision_bits,
)

TAGGED = 0
RAW = 1

MAX_TAG_SYMBOL_BIT_LENGTH = 32
MAX_RAW_ENCODING_BIT_LENGTH = 18


def decode_symbols(
    num_values: int, num_components: int, buf: DecoderBuffer
) -> np.ndarray:
    """Decode `num_values` uint32 symbols (total, across components)."""
    if num_values == 0:
        return np.zeros(0, np.uint32)
    scheme = buf.u8()
    if scheme == TAGGED:
        return _decode_tagged(num_values, num_components, buf)
    if scheme == RAW:
        return _decode_raw(num_values, buf)
    raise ValueError(f"unknown symbol coding scheme {scheme}")


def _decode_tagged(num_values: int, num_components: int, buf: DecoderBuffer) -> np.ndarray:
    tag_decoder = RansSymbolDecoder(buf, rans_precision_bits(5))
    out = np.zeros(num_values, np.uint32)
    buf.start_bit_decoding(False)
    i = 0
    while i < num_values:
        bit_length = tag_decoder.decode_symbol()
        for _ in range(num_components):
            out[i] = buf.get_bits(bit_length)
            i += 1
    buf.end_bit_decoding()
    return out


def _decode_raw(num_values: int, buf: DecoderBuffer) -> np.ndarray:
    max_bit_length = buf.u8()
    pb = rans_precision_bits(max_bit_length)
    from uvbench.ref import native

    res = native.rans_stream_decode(buf.data, buf.end, buf.pos, pb, num_values)
    if res is not None:
        out, buf.pos = res
        return out
    decoder = RansSymbolDecoder(buf, pb)
    return decoder.decode_all(num_values)


def encode_symbols(
    symbols: np.ndarray,
    num_components: int,
    out: EncoderBuffer,
    *,
    scheme: Optional[int] = None,
) -> None:
    """Encode uint32 symbols; picks RAW unless the caller forces a scheme.

    RAW is what matters for our streams (Draco also chooses adaptively by
    estimated cost); TAGGED is implemented for format completeness.
    """
    symbols = np.asarray(symbols, np.uint32)
    if symbols.size == 0:
        return  # Draco EncodeSymbols: nothing written for zero values
    if scheme is None:
        scheme = RAW
        max_value = int(symbols.max()) if symbols.size else 0
        if max_value.bit_length() > MAX_RAW_ENCODING_BIT_LENGTH:
            scheme = TAGGED
    out.u8(scheme)
    if scheme == RAW:
        _encode_raw(symbols, out)
    else:
        _encode_tagged(symbols, num_components, out)


def _encode_raw(symbols: np.ndarray, out: EncoderBuffer) -> None:
    max_value = int(symbols.max()) if symbols.size else 0
    max_bit_length = max(1, max_value.bit_length())
    out.u8(max_bit_length)
    from uvbench.ref import native

    # one-call native tail (bincount/normalize/table/rANS — byte-exact
    # with the Python chain below, which stays as oracle + fallback)
    blob = native.rans_symbol_encode_native(
        symbols, max_value + 1, rans_precision_bits(max_bit_length)
    )
    if blob is not None:
        out.raw(blob)
        return
    counts = np.bincount(symbols, minlength=max_value + 1)
    encoder = RansSymbolEncoder(counts, rans_precision_bits(max_bit_length))
    encoder.encode_all(symbols, out)


def _encode_tagged(symbols: np.ndarray, num_components: int, out: EncoderBuffer) -> None:
    n = len(symbols)
    values = symbols.reshape(n // num_components, num_components)
    # tag per value-group: max bit length over its components
    bit_lengths = np.zeros(len(values), np.uint32)
    for i, row in enumerate(values):
        bit_lengths[i] = max(1, int(row.max()).bit_length()) if row.max() else 0
    counts = np.bincount(bit_lengths, minlength=MAX_TAG_SYMBOL_BIT_LENGTH + 1)
    tag_encoder = RansSymbolEncoder(counts, rans_precision_bits(5))
    tag_encoder.encode_all(bit_lengths, out)
    out.start_bit_encoding()
    for i, row in enumerate(values):
        bl = int(bit_lengths[i])
        for v in row:
            out.put_bits(int(v), bl)
    out.end_bit_encoding(encode_size=False)


def convert_symbols_to_signed(symbols: np.ndarray) -> np.ndarray:
    """zigzag⁻¹: 0,1,2,3,4 → 0,-1,1,-2,2 (Draco ConvertSymbolToSignedInt)."""
    symbols = symbols.astype(np.uint32)
    mag = (symbols >> 1).astype(np.int32)
    return np.where((symbols & 1) == 0, mag, -mag - 1)


def convert_signed_to_symbols(values: np.ndarray) -> np.ndarray:
    values = values.astype(np.int64)
    return np.where(values >= 0, values << 1, (-values << 1) - 1).astype(np.uint32)
