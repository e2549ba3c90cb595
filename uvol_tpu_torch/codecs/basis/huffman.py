"""Canonical Huffman encoding for the BasisLZ/ETC1S wire format.

Exact inverse of the decode side in `transcoder.py` (`read_huffman_table`,
`HuffmanTable`): canonical codes assigned by (length asc, symbol asc),
emitted LSB-first (bit-reversed), code-size arrays compressed with the
deflate-style code-length alphabet in `CODELENGTH_ORDER`.

The port's copy of the reference's `codecs/basis/huffman.py`, unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import heapq

from uvol_tpu_torch.codecs.basis.transcoder import (
    BIG_REPEAT,
    BIG_ZERO_RUN,
    CODELENGTH_ORDER,
    MAX_SYMS_LOG2,
    SMALL_REPEAT,
    SMALL_ZERO_RUN,
    TOTAL_CODELENGTH_CODES,
)

MAX_CODE_LENGTH = 16


class BitWriter:
    """LSB-first bit writer (inverse of transcoder.BitReader)."""

    def __init__(self) -> None:
        self._bits: List[int] = []

    def put_bits(self, value: int, n: int) -> None:
        for i in range(n):
            self._bits.append((value >> i) & 1)

    def getvalue(self) -> bytes:
        out = bytearray((len(self._bits) + 7) // 8)
        for i, b in enumerate(self._bits):
            if b:
                out[i >> 3] |= 1 << (i & 7)
        return bytes(out)

    def __len__(self) -> int:
        return len(self._bits)


def compute_code_sizes(freqs: Sequence[int]) -> List[int]:
    """Huffman code lengths, limited to MAX_CODE_LENGTH (Kraft-fixed)."""
    n = len(freqs)
    used = [(f, s) for s, f in enumerate(freqs) if f > 0]
    sizes = [0] * n
    if not used:
        return sizes
    if len(used) == 1:
        sizes[used[0][1]] = 1
        return sizes
    # standard Huffman via heap of (freq, tiebreak, symbols)
    heap = [(f, s, [s]) for f, s in used]
    heapq.heapify(heap)
    depth: Dict[int, int] = {s: 0 for _, s in used}
    while len(heap) > 1:
        f1, t1, s1 = heapq.heappop(heap)
        f2, t2, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            depth[s] += 1
        heapq.heappush(heap, (f1 + f2, min(t1, t2), s1 + s2))
    for s, d in depth.items():
        sizes[s] = d
    # length-limit: clamp then restore Kraft equality by lengthening the
    # shortest over-budget codes / shortening where there is slack
    if max(sizes) > MAX_CODE_LENGTH:
        for s in range(n):
            if sizes[s] > MAX_CODE_LENGTH:
                sizes[s] = MAX_CODE_LENGTH
        kraft = sum((1 << (MAX_CODE_LENGTH - l)) for l in sizes if l)
        full = 1 << MAX_CODE_LENGTH
        syms_by_len = sorted(
            (s for s in range(n) if sizes[s]), key=lambda s: (-sizes[s], s)
        )
        i = 0
        while kraft > full:
            s = syms_by_len[i % len(syms_by_len)]
            if sizes[s] < MAX_CODE_LENGTH:
                kraft -= 1 << (MAX_CODE_LENGTH - sizes[s] - 1)
                sizes[s] += 1
            i += 1
        # give back slack to the longest codes (optional, keeps optimality)
        changed = True
        while changed:
            changed = False
            for s in sorted(range(n), key=lambda s: -sizes[s]):
                if sizes[s] > 1 and kraft + (1 << (MAX_CODE_LENGTH - sizes[s])) <= full:
                    kraft += 1 << (MAX_CODE_LENGTH - sizes[s])
                    sizes[s] -= 1
                    changed = True
    return sizes


def canonical_codes(code_sizes: Sequence[int]) -> Dict[int, Tuple[int, int]]:
    """symbol → (lsb-first code, length); mirrors HuffmanTable exactly."""
    out: Dict[int, Tuple[int, int]] = {}
    max_len = max(code_sizes) if code_sizes else 0
    code = 0
    for length in range(1, max_len + 1):
        for sym, sz in enumerate(code_sizes):
            if sz == length:
                rev = 0
                c = code
                for _ in range(length):
                    rev = (rev << 1) | (c & 1)
                    c >>= 1
                out[sym] = (rev, length)
                code += 1
        code <<= 1
    return out


class HuffmanEncoder:
    def __init__(self, freqs: Sequence[int]):
        self.code_sizes = compute_code_sizes(freqs)
        self.codes = canonical_codes(self.code_sizes)

    def encode(self, bw: BitWriter, sym: int) -> None:
        code, length = self.codes[sym]
        bw.put_bits(code, length)

    def write_table(self, bw: BitWriter) -> None:
        write_huffman_table(bw, self.code_sizes)


def write_huffman_table(bw: BitWriter, code_sizes: Sequence[int]) -> None:
    """Inverse of transcoder.read_huffman_table."""
    total_used_syms = len(code_sizes)
    bw.put_bits(total_used_syms, MAX_SYMS_LOG2)
    if total_used_syms == 0:
        return

    # RLE-compress the size array into the code-length alphabet
    cl_stream: List[Tuple[int, int, int]] = []  # (symbol, extra_bits, extra)
    i = 0
    n = total_used_syms
    prev_nonzero = 0
    while i < n:
        sz = code_sizes[i]
        if sz == 0:
            run = 1
            while i + run < n and code_sizes[i + run] == 0:
                run += 1
            while run >= 3:
                chunk = min(run, 138)
                if chunk >= 11:
                    cl_stream.append((BIG_ZERO_RUN, 7, chunk - 11))
                else:
                    cl_stream.append((SMALL_ZERO_RUN, 3, chunk - 3))
                run -= chunk
                i += chunk
            for _ in range(run):
                cl_stream.append((0, 0, 0))
                i += 1
        elif sz == prev_nonzero:
            run = 1
            while i + run < n and code_sizes[i + run] == sz:
                run += 1
            while run >= 3:
                chunk = min(run, 134)
                if chunk >= 7:
                    cl_stream.append((BIG_REPEAT, 7, chunk - 7))
                else:
                    chunk = min(chunk, 6)
                    cl_stream.append((SMALL_REPEAT, 2, chunk - 3))
                run -= chunk
                i += chunk
            for _ in range(run):
                cl_stream.append((sz, 0, 0))
                i += 1
        else:
            cl_stream.append((sz, 0, 0))
            prev_nonzero = sz
            i += 1

    cl_freqs = [0] * TOTAL_CODELENGTH_CODES
    for sym, _, _ in cl_stream:
        cl_freqs[sym] += 1
    cl_sizes = compute_code_sizes(cl_freqs)
    # cl code sizes are stored in 3 bits → limit to 7
    while max(cl_sizes) > 7:
        # rescale frequencies to flatten the tree
        cl_freqs = [max(1, f // 2) if f else 0 for f in cl_freqs]
        cl_sizes = compute_code_sizes(cl_freqs)
    # trim trailing zero entries in transmission order
    num_cl = TOTAL_CODELENGTH_CODES
    while num_cl > 1 and cl_sizes[CODELENGTH_ORDER[num_cl - 1]] == 0:
        num_cl -= 1
    bw.put_bits(num_cl, 5)
    for k in range(num_cl):
        bw.put_bits(cl_sizes[CODELENGTH_ORDER[k]], 3)
    cl_codes = canonical_codes(cl_sizes)
    for sym, extra_bits, extra in cl_stream:
        code, length = cl_codes[sym]
        bw.put_bits(code, length)
        if extra_bits:
            bw.put_bits(extra, extra_bits)


def write_vlc(bw: BitWriter, value: int, chunk_bits: int) -> None:
    """Inverse of transcoder.decode_vlc."""
    mask = (1 << chunk_bits) - 1
    while True:
        chunk = value & mask
        value >>= chunk_bits
        if value:
            bw.put_bits(chunk | (1 << chunk_bits), chunk_bits + 1)
        else:
            bw.put_bits(chunk, chunk_bits + 1)
            return
