"""KD-tree point-cloud geometry coding (UVT profile).

The port's copy of `uvol_tpu/codecs/draco/kdtree.py`, unchanged in what it emits; it
calls the port's own native library (`uvol_tpu_torch.native`).

The reference decodes any Draco buffer, including POINT_CLOUD frames with
KD-tree geometry (src/lib/DRACOLoader.js:483; draco's
PointCloudKdTreeDecoder). Draco's own KD bitstream (per-level numbers
coders with rANS/folded-bit policies selected by compression level)
is not reliably reconstructible offline — there is no spec and no
fixture corpus in this environment, and a wrong guess would produce
files that *claim* to be Draco KD-tree but decode as garbage in every
conformant decoder.

This module therefore implements the same capability — spatial KD-split
integer point coding with duplicate collapsing and shared-prefix
savings — as a documented **UVT profile** under its own point-cloud
method id (`UVT_KD_TREE_METHOD = 16`, outside Draco's {sequential=0,
kd_tree=1}), exactly the honesty contract the UASTC module uses: real
Draco decoders reject the unknown method byte cleanly instead of
misdecoding, and this decoder dispatches on it.

Wire layout (all inside the standard `.drc` container framing written
by `sequential.encode_drc_point_cloud`):

  u8 method=16 · u16 flags · varint num_points · attribute headers
  (sequential.py form) · KD stream for attribute 0 (POSITION) ·
  remaining attributes in KD point order via the sequential coders.

KD stream: u8 bit_length · u8 dimension · f32 mins[D] · f32 range ·
bitstream (corto MSB-first u32 words) of the DFS split counts
(ceil(log2(n+1)) bits each) and per-leaf remaining bits.

Points come back in KD (DFS) order — a permutation of the input, which
is semantics-preserving for point clouds (no connectivity).
"""

from __future__ import annotations

from typing import List

import numpy as np

from uvol_tpu_torch.codecs.buffer import DecoderBuffer, EncoderBuffer
from uvol_tpu_torch.codecs.corto.bitstream import BitReader, BitWriter

#: NOT a Draco wire id — Draco defines 0 (sequential) and 1 (kd-tree);
#: 16 marks the UVT KD profile so no conformant decoder misreads it.
UVT_KD_TREE_METHOD = 16

_LEAF_DIRECT = 2  # nodes at or below this size code raw remaining bits


def _ceil_log2(n: int) -> int:
    """Bits needed to code a value in [0, n]."""
    return int(n).bit_length()


def _kd_encode(vals: np.ndarray, bit_length: int, bw: BitWriter) -> np.ndarray:
    """DFS KD split coder over uint ints [N, D]; returns the point order.

    Axis cycles; each split peels the highest undecided bit of the
    current axis and codes the low-half count in ceil(log2(n+1)) bits.
    Leaves (n <= 2, or all bits decided) code raw remaining bits.
    """
    n_total, d = vals.shape
    order: List[np.ndarray] = []
    if n_total == 0:
        return np.zeros(0, np.int64)
    # stack entries: (indices, level[D], last_axis); base bits are implied
    # by the values themselves (encoder side never needs the base)
    stack = [(np.arange(n_total, dtype=np.int64), np.zeros(d, np.int32), d - 1)]
    while stack:
        idx, level, last_axis = stack.pop()
        n = len(idx)
        # next cyclic axis with undecided bits
        axis = -1
        for k in range(1, d + 1):
            a = (last_axis + k) % d
            if level[a] < bit_length:
                axis = a
                break
        if axis < 0:
            # every bit decided: n identical points
            order.append(idx)
            continue
        if n <= _LEAF_DIRECT:
            for i in idx:
                for j in range(d):
                    rem = bit_length - int(level[j])
                    if rem:
                        bw.write(int(vals[i, j]) & ((1 << rem) - 1), rem)
            order.append(idx)
            continue
        split_bit = bit_length - int(level[axis]) - 1
        bit = (vals[idx, axis] >> split_bit) & 1
        left = idx[bit == 0]
        right = idx[bit == 1]
        bw.write(len(left), _ceil_log2(n))
        nlevel = level.copy()
        nlevel[axis] += 1
        # push right first so left decodes first (DFS order)
        if len(right):
            stack.append((right, nlevel, axis))
        if len(left):
            stack.append((left, nlevel, axis))
    return np.concatenate(order)


def _kd_decode(
    br: BitReader, num_points: int, bit_length: int, d: int
) -> np.ndarray:
    """Mirror of `_kd_encode`: returns uint ints [num_points, D] in DFS
    order. Bounds-checked: counts may never exceed the node size and the
    stack depth is capped at d*bit_length splits."""
    out = np.zeros((num_points, d), np.int64)
    pos = 0
    if num_points == 0:
        return out
    stack = [
        (num_points, np.zeros(d, np.int64), np.zeros(d, np.int32), d - 1)
    ]
    max_nodes = 4 * num_points * (d * bit_length + 2) + 64
    seen = 0
    while stack:
        seen += 1
        if seen > max_nodes:
            raise ValueError("kd stream: runaway node count")
        n, base, level, last_axis = stack.pop()
        axis = -1
        for k in range(1, d + 1):
            a = (last_axis + k) % d
            if level[a] < bit_length:
                axis = a
                break
        if axis < 0:
            out[pos : pos + n] = base
            pos += n
            continue
        if n <= _LEAF_DIRECT:
            for _ in range(n):
                for j in range(d):
                    rem = bit_length - int(level[j])
                    v = int(base[j])
                    if rem:
                        v |= br.read(rem)
                    out[pos, j] = v
                pos += 1
            continue
        num_left = br.read(_ceil_log2(n))
        if num_left > n:
            raise ValueError("kd stream: split count exceeds node size")
        split_bit = bit_length - int(level[axis]) - 1
        nlevel = level.copy()
        nlevel[axis] += 1
        rbase = base.copy()
        rbase[axis] |= 1 << split_bit
        if n - num_left:
            stack.append((n - num_left, rbase, nlevel, axis))
        if num_left:
            stack.append((num_left, base, nlevel, axis))
    if getattr(br, "overflow", False) or pos != num_points:
        raise ValueError("kd stream: truncated")
    return out


def encode_drc_point_cloud_kdtree(attributes: List) -> bytes:
    """Point cloud → `.drc` with KD-coded positions (UVT profile).

    `attributes[0]` must be the float position attribute; the remaining
    attributes are re-ordered into KD order and coded with the standard
    sequential coders. Cites: reference consumption point
    src/lib/DRACOLoader.js:483 (any draco buffer); draco
    KdTreeAttributesEncoder (capability being matched)."""
    from uvol_tpu_torch.codecs.draco import constants as K
    from uvol_tpu_torch.codecs.draco.encoder import quantize_attribute
    from uvol_tpu_torch.codecs.draco.sequential import (
        _write_attribute,
        _write_attribute_headers,
    )

    pos_att = attributes[0]
    if pos_att.integer:
        raise ValueError("kd-tree point clouds need a float position first")
    num_points = len(pos_att.values)

    out = EncoderBuffer()
    out.raw(K.MAGIC)
    out.u8(2)
    out.u8(2)
    out.u8(K.POINT_CLOUD)
    out.u8(UVT_KD_TREE_METHOD)
    out.u16(0)
    out.varint(num_points)
    _write_attribute_headers(out, attributes)

    q = quantize_attribute(pos_att.values, pos_att.quantization_bits)
    ints = np.asarray(q.ints, np.int64)
    d = ints.shape[1]
    bw = BitWriter()
    order = _kd_encode(ints, q.bits, bw)
    out.u8(q.bits)
    out.u8(d)
    out.raw(np.asarray(q.mins, "<f4").tobytes())
    out.raw(np.asarray([q.range_value], "<f4").tobytes())
    words = bw.getvalue()
    out.varint(len(words) // 4)
    out.raw(words)

    for att in attributes[1:]:
        perm = type(att)(
            att.attribute_type,
            np.asarray(att.values)[order],
            att.corner_to_value,
            att.quantization_bits,
            integer=att.integer,
        )
        _write_attribute(out, perm, num_points)
    return out.getvalue()


def decode_drc_point_cloud_kdtree(buf: DecoderBuffer):
    from uvol_tpu_torch.codecs.draco import constants as K
    from uvol_tpu_torch.codecs.draco.decoder import DracoMesh
    from uvol_tpu_torch.codecs.draco.sequential import (
        _read_attribute,
        _read_attribute_headers,
    )

    num_points = buf.varint()
    if num_points > buf.remaining() * 64:
        raise ValueError("kd point cloud: implausible point count")
    attrs, _seq_types = _read_attribute_headers(buf)
    if not attrs:
        raise ValueError("kd point cloud: no attributes")

    bits = buf.u8()
    d = buf.u8()
    if not 0 < bits <= 31 or not 0 < d <= 8 or d != attrs[0].num_components:
        raise ValueError("kd point cloud: bad quantization header")
    mins = np.frombuffer(buf.raw(4 * d), "<f4").astype(np.float64)
    rng = float(np.frombuffer(buf.raw(4), "<f4")[0])
    nwords = buf.varint()
    if nwords > buf.remaining() // 4 + 1:
        raise ValueError("kd point cloud: truncated bitstream")
    words = np.frombuffer(buf.raw(nwords * 4), "<u4")
    ints = _kd_decode(BitReader(words), num_points, bits, d)
    delta = rng / ((1 << bits) - 1) if bits else 0.0
    ids = np.arange(num_points, dtype=np.int64)
    attrs[0].values = (mins + ints * delta).astype(np.float32)
    attrs[0].corner_to_value = ids
    for attr in attrs[1:]:
        attr.values = _read_attribute(buf, attr, num_points)
        attr.corner_to_value = ids
    mesh = DracoMesh(
        faces=np.zeros((0, 3), np.int32), attributes=attrs,
        num_points=num_points,
    )
    mesh._point_of_corner = ids
    return mesh
