"""Tunstall variable-to-fixed entropy coder (Corto-compatible).

Reimplements the dictionary construction of the reference's
`tunstall.cpp:createDecodingTables2` (including the low-entropy fast path
for count ≥ 16) so that streams interoperate with the reference's C++/JS
codecs: the stream stores the (symbol, probability) pairs and the decoder
deterministically rebuilds the same dictionary.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

WORDSIZE = 8
DICTIONARY_SIZE = 1 << WORDSIZE


def get_probabilities(data: np.ndarray) -> List[Tuple[int, int]]:
    """(symbol, probability) pairs, probability = count*255//size, sorted by
    probability descending (ties keep symbol order — deterministic where the
    C++ std::sort is unspecified)."""
    counts = np.bincount(data, minlength=256)
    size = len(data)
    pairs = [
        (int(s), int(counts[s]) * 255 // size) for s in range(256) if counts[s] > 0
    ]
    pairs.sort(key=lambda sp: (-sp[1], sp[0]))
    return pairs


def build_decoding_tables(
    probabilities: Sequence[Tuple[int, int]]
) -> Tuple[List[bytes], List[int]]:
    """Returns (words, lengths): the 256-word Tunstall dictionary.

    Faithful to createDecodingTables2: per-symbol queues in a flat array,
    repeatedly splitting the highest-probability word; low-entropy inputs
    (dominant symbol) use the compact run-table construction.
    """
    n_symbols = len(probabilities)
    if n_symbols == 0:
        return [], []
    if n_symbols == 1:
        return [bytes([probabilities[0][0]])], [1]

    syms = [s for s, _ in probabilities]
    probs = [p for _, p in probabilities]

    queues = [0] * (2 * DICTIONARY_SIZE)
    index = [0] * (2 * DICTIONARY_SIZE)
    lengths = [0] * (2 * DICTIONARY_SIZE)
    buffer = bytearray(8192)
    pos = 0
    starts = [0] * n_symbols
    end = 0

    p0 = probs[0] << 8
    p1 = probs[1] << 8
    prob = (p0 * p0) >> 16
    max_count = (DICTIONARY_SIZE - 1) // (n_symbols - 1)
    count = 2
    while prob > p1 and count < max_count:
        prob = (prob * p0) >> 16
        count += 1

    if count >= 16:
        # low-entropy run-table construction
        buffer[pos] = syms[0]
        pos += 1
        for k in range(1, n_symbols):
            for _ in range(count - 1):
                buffer[pos] = syms[0]
                pos += 1
            buffer[pos] = syms[k]
            pos += 1
        starts[0] = (count - 1) * n_symbols
        for k in range(1, n_symbols):
            starts[k] = k
        prob = 0
        for col in range(count):
            for row in range(1, n_symbols):
                dest = row + col * n_symbols
                if col == 0:
                    queues[dest] = probs[row] << 8
                else:
                    queues[dest] = (prob * (probs[row] << 8)) >> 16
                index[dest] = row * count - col
                lengths[dest] = col + 1
            if col == 0:
                prob = p0
            else:
                prob = (prob * p0) >> 16
        first = (count - 1) * n_symbols
        queues[first] = prob
        index[first] = 0
        lengths[first] = count
        n_words = 1 + count * (n_symbols - 1)
        end = count * n_symbols
        assert n_words == pos
    else:
        n_words = n_symbols
        for i in range(n_symbols):
            starts[i] = i
            queues[end] = probs[i] << 8
            index[end] = pos
            lengths[end] = 1
            end += 1
            buffer[pos] = syms[i]
            pos += 1

    while n_words < DICTIONARY_SIZE:
        best = 0
        max_prob = 0
        for i in range(n_symbols):
            p = queues[starts[i]]
            if p > max_prob:
                best = i
                max_prob = p
        symbol = starts[best]
        probability = queues[symbol]
        offset = index[symbol]
        length = lengths[symbol]
        if pos + (length + 1) * n_symbols + 16 > len(buffer):
            buffer.extend(b"\x00" * max(8192, (length + 1) * n_symbols + 16))
        r = 0
        while r < n_symbols:
            queues[end] = (probability * (probs[r] << 8)) >> 16
            index[end] = pos
            lengths[end] = length + 1
            end += 1
            buffer[pos : pos + length] = buffer[offset : offset + length]
            pos += length
            buffer[pos] = syms[r]
            pos += 1
            if n_words + r == DICTIONARY_SIZE - 1:
                break
            r += 1
        if r == n_symbols:
            starts[best] += n_symbols
        n_words += n_symbols - 1

    # compact: skip removed words
    words: List[bytes] = []
    out_lengths: List[int] = []
    row = 0
    for i in range(end):
        if row >= n_symbols:
            row = 0
        if starts[row] > i:
            row += 1
            continue
        words.append(bytes(buffer[index[i] : index[i] + lengths[i]]))
        out_lengths.append(lengths[i])
        row += 1
        if len(words) == DICTIONARY_SIZE:
            break
    return words, out_lengths


def _flat_tables(words: Sequence[bytes]):
    """(concatenated words, per-word start offsets, per-word lengths)."""
    lengths = np.fromiter((len(w) for w in words), np.int32, len(words))
    index = np.zeros(len(words), np.int32)
    if len(words) > 1:
        np.cumsum(lengths[:-1], out=index[1:])
    return b"".join(words), index, lengths


class _TrieNode:
    __slots__ = ("children", "word")

    def __init__(self) -> None:
        self.children: Dict[int, "_TrieNode"] = {}
        self.word = -1


def compress(
    data: np.ndarray, probabilities: Sequence[Tuple[int, int]]
) -> bytes:
    """Greedy dictionary parse (the Tunstall tree is complete, so the trie
    walk is exact). Tail handling pads with any completing word, matching
    the decoder's truncation."""
    if len(probabilities) <= 1:
        return b""
    from uvol_tpu_torch import native

    tables = native.tunstall_tables_native(probabilities)
    if tables is not None:
        flat, index, lengths = tables
        parsed = native.tunstall_parse_native(
            flat, index, lengths, np.asarray(data, np.uint8)
        )
        if parsed is not None:
            return parsed
    words, _ = build_decoding_tables(probabilities)
    flat, index, lengths = _flat_tables(words)
    parsed = native.tunstall_parse_native(
        flat, index, lengths, np.asarray(data, np.uint8)
    )
    if parsed is not None:
        return parsed
    root = _TrieNode()
    for wi, w in enumerate(words):
        node = root
        for b in w:
            node = node.children.setdefault(b, _TrieNode())
        node.word = wi
    out = bytearray()
    data = bytes(np.asarray(data, np.uint8))
    i = 0
    n = len(data)
    while i < n:
        node = root
        j = i
        while j < n and node.word < 0:
            node = node.children[data[j]]
            j += 1
        if node.word >= 0:
            out.append(node.word)
            i = j
        else:
            # tail: input exhausted mid-word; descend to any completion
            while node.word < 0:
                node = next(iter(node.children.values()))
            out.append(node.word)
            break
    return bytes(out)


def decompress(
    compressed: bytes,
    probabilities: Sequence[Tuple[int, int]],
    output_size: int,
) -> np.ndarray:
    out = np.empty(output_size, np.uint8)
    if output_size == 0:
        return out
    if len(probabilities) == 1:
        out[:] = probabilities[0][0]
        return out
    from uvol_tpu_torch import native

    tables = native.tunstall_tables_native(probabilities)
    if tables is None:
        words, _ = build_decoding_tables(probabilities)
        tables = _flat_tables(words)
    flat, index, lengths = tables
    expanded = native.tunstall_expand_native(
        flat, index, lengths, bytes(compressed), output_size
    )
    if expanded is not None:
        return expanded
    words, _ = build_decoding_tables(probabilities)
    pos = 0
    for k in range(len(compressed) - 1):
        w = words[compressed[k]]
        out[pos : pos + len(w)] = np.frombuffer(w, np.uint8)
        pos += len(w)
    if compressed:
        w = words[compressed[-1]]
        rest = output_size - pos
        out[pos:] = np.frombuffer(w[:rest], np.uint8)
    return out
