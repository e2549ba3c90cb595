"""LZ4 block-format codec (pure Python) for the Corto LZ4 entropy mode.

The reference dispatches entropy {NONE, TUNSTALL, HUFFMAN, ZLIB, LZ4}
(deprecated/encoder/dev/src/cstream.h:39); ZLIB/LZ4 live behind
`ENTROPY_TESTS` (cstream.cpp:124-168) and wrap raw zlib / LZ4 block
streams in an `i32 size, i32 compressed_size, payload` frame. This module
implements the LZ4 *block* format (the part LZ4_compress_HC /
LZ4_decompress_safe speak): token byte = (literal_len << 4) | (match_len
- 4) with 255-extension bytes, little-endian 16-bit match offsets, and
the end-of-block rules (last sequence is literals-only; matches must not
cover the final 5 bytes).

The decoder accepts any conformant stream (so reference-produced LZ4
`.crt` streams decode); the encoder is a greedy hash-table matcher — not
HC-optimal, but every output is a valid LZ4 block the reference's
LZ4_decompress_safe accepts.
"""

from __future__ import annotations

MIN_MATCH = 4
#: spec: a match must end ≥5 bytes before the block end, and the last
#: sequence is literals only
END_LITERALS = 5
MF_LIMIT = 12


def compress(data: bytes) -> bytes:
    """Greedy LZ4 block compress (valid per spec; not bit-equal to HC)."""
    n = len(data)
    out = bytearray()
    if n == 0:
        return b""
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    limit = n - MF_LIMIT  # last match may not start beyond here

    def emit(lit_len: int, lit_start: int, match_len: int = -1, offset: int = 0):
        tok_lit = 15 if lit_len >= 15 else lit_len
        tok_match = 0 if match_len < 0 else (15 if match_len - 4 >= 15 else match_len - 4)
        out.append((tok_lit << 4) | tok_match)
        rem = lit_len - 15
        while rem >= 0:
            out.append(min(rem, 255))
            if rem < 255:
                break
            rem -= 255
        out.extend(data[lit_start : lit_start + lit_len])
        if match_len >= 0:
            out.append(offset & 0xFF)
            out.append((offset >> 8) & 0xFF)
            rem = match_len - 4 - 15
            while rem >= 0:
                out.append(min(rem, 255))
                if rem < 255:
                    break
                rem -= 255

    while i < limit:
        key = data[i : i + MIN_MATCH]
        j = table.get(key)
        table[key] = i
        if j is None or i - j > 0xFFFF:
            i += 1
            continue
        # extend the match, clamped so ≥5 trailing bytes stay literal
        end = n - END_LITERALS
        m = i + MIN_MATCH
        k = j + MIN_MATCH
        while m < end and data[m] == data[k]:
            m += 1
            k += 1
        emit(i - anchor, anchor, m - i, i - j)
        i = m
        anchor = m
    emit(n - anchor, anchor)  # final literals-only sequence
    return bytes(out)


def decompress(data: bytes, uncompressed_size: int) -> bytes:
    """LZ4 block decompress (bounds-checked, LZ4_decompress_safe analog)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        token = data[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated literal length")
                b = data[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("lz4: literal run past input end")
        out += data[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence has no match
        if i + 2 > n:
            raise ValueError("lz4: truncated match offset")
        offset = data[i] | (data[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("lz4: invalid match offset")
        mlen = (token & 0xF) + MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated match length")
                b = data[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        if len(out) + mlen > uncompressed_size:
            raise ValueError("lz4: output overflows declared size")
        start = len(out) - offset
        for k in range(mlen):  # byte-wise: overlapping matches replicate
            out.append(out[start + k])
    if len(out) != uncompressed_size:
        raise ValueError(
            f"lz4: decoded {len(out)} bytes, expected {uncompressed_size}"
        )
    return bytes(out)
