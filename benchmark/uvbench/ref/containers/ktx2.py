# Frozen copy of the program's `containers/ktx2.py` for the benchmark's plain reference:
# its native fast paths are cut (`uvbench.ref.native` reports no library),
# so only its Python and numpy paths run. Do not edit it to follow the program.
"""KTX2 container reader/writer (pure Python, no vendored ktx-parse).

The port's copy of the reference's `containers/ktx2.py`: the readers
(in memory and from a path) and the writer, the BasisLZ global data and
the DFD, unchanged.

Implements the Khronos KTX 2.0 container layout: identifier, header, index,
level index, Data Format Descriptor, Key/Value Data, and the BasisLZ
supercompression global data (endpoint/selector codebooks + Huffman tables +
per-image slice descriptors) needed by the ETC1S transcoder
(`uvbench.ref.codecs.basis.transcoder`).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

#: 12-byte file identifier: «KTX 20»\r\n\x1a\n
KTX2_IDENTIFIER = b"\xabKTX 20\xbb\r\n\x1a\n"

# supercompressionScheme values
SUPERCOMPRESSION_NONE = 0
SUPERCOMPRESSION_BASISLZ = 1
SUPERCOMPRESSION_ZSTD = 2
SUPERCOMPRESSION_ZLIB = 3

VK_FORMAT_UNDEFINED = 0  # Basis/ETC1S and UASTC use UNDEFINED

# DFD color models of ETC1S and of UASTC
KHR_DF_MODEL_ETC1S = 163
KHR_DF_MODEL_UASTC = 166


@dataclasses.dataclass
class KTX2Header:
    vk_format: int
    type_size: int
    pixel_width: int
    pixel_height: int
    pixel_depth: int
    layer_count: int
    face_count: int
    level_count: int
    supercompression_scheme: int


@dataclasses.dataclass
class KTX2Level:
    """One entry of the level index plus its data bytes."""

    data: bytes
    uncompressed_byte_length: int


@dataclasses.dataclass
class KTX2ImageDesc:
    """BasisLZ per-image slice descriptor (20 bytes each in SGD)."""

    image_flags: int
    rgb_slice_byte_offset: int
    rgb_slice_byte_length: int
    alpha_slice_byte_offset: int
    alpha_slice_byte_length: int

    IS_P_FRAME = 0x02  # imageFlags bit: P-frame (video); else I-frame


@dataclasses.dataclass
class BasisLZGlobalData:
    endpoint_count: int
    selector_count: int
    endpoints_data: bytes
    selectors_data: bytes
    tables_data: bytes
    extended_data: bytes
    image_descs: List[KTX2ImageDesc]

    def pack(self) -> bytes:
        out = struct.pack(
            "<HHIIII",
            self.endpoint_count,
            self.selector_count,
            len(self.endpoints_data),
            len(self.selectors_data),
            len(self.tables_data),
            len(self.extended_data),
        )
        for d in self.image_descs:
            out += struct.pack(
                "<IIIII",
                d.image_flags,
                d.rgb_slice_byte_offset,
                d.rgb_slice_byte_length,
                d.alpha_slice_byte_offset,
                d.alpha_slice_byte_length,
            )
        return out + self.endpoints_data + self.selectors_data + self.tables_data + self.extended_data

    @classmethod
    def unpack(cls, buf: bytes, image_count: int) -> "BasisLZGlobalData":
        (ep_count, sel_count, ep_len, sel_len, tab_len, ext_len) = struct.unpack_from(
            "<HHIIII", buf, 0
        )
        off = 20  # <HHIIII header is 20 bytes
        descs = []
        for _ in range(image_count):
            vals = struct.unpack_from("<IIIII", buf, off)
            descs.append(KTX2ImageDesc(*vals))
            off += 20
        ep = buf[off : off + ep_len]
        off += ep_len
        sel = buf[off : off + sel_len]
        off += sel_len
        tab = buf[off : off + tab_len]
        off += tab_len
        ext = buf[off : off + ext_len]
        return cls(ep_count, sel_count, ep, sel, tab, ext, descs)


@dataclasses.dataclass
class KTX2File:
    header: KTX2Header
    levels: List[KTX2Level]
    dfd: bytes  # raw Data Format Descriptor (includes leading dfdTotalSize u32)
    key_value: Dict[bytes, bytes]
    basis_lz: Optional[BasisLZGlobalData] = None
    raw_sgd: bytes = b""

    # ------------------------------------------------------------------
    @property
    def image_count(self) -> int:
        h = self.header
        return (
            max(h.level_count, 1)
            * max(h.layer_count, 1)
            * max(h.face_count, 1)
            * max(h.pixel_depth, 1)
        )

    def level_payload(self, index: int = 0) -> bytes:
        """Level data with supercompression removed (NONE/ZSTD/ZLIB).

        Mirrors the reference's Zstd raw-KTX2 path
        (src/lib/KTX2Loader.js:799-823, zstddec); BasisLZ levels are
        returned as-is (their slices are decoded by the transcoder).
        """
        lvl = self.levels[index]
        scheme = self.header.supercompression_scheme
        if scheme in (SUPERCOMPRESSION_NONE, SUPERCOMPRESSION_BASISLZ):
            return lvl.data
        if scheme == SUPERCOMPRESSION_ZSTD:
            from uvbench.ref.native import zstd

            return zstd.decompress(lvl.data, lvl.uncompressed_byte_length)
        if scheme == SUPERCOMPRESSION_ZLIB:
            import zlib

            return zlib.decompress(lvl.data)
        raise NotImplementedError(f"supercompression scheme {scheme}")

    def dfd_color_model(self) -> int:
        # DFD: u32 totalSize, then block: u32 vendor/type, u16 ver, u16 size,
        # u8 colorModel at block offset 8.
        if len(self.dfd) < 13:
            return 0
        return self.dfd[12]


def read_ktx2_header(path: str) -> KTX2Header:
    with open(path, "rb") as f:
        buf = f.read(80)
    if buf[:12] != KTX2_IDENTIFIER:
        raise ValueError(f"{path}: not a KTX2 file")
    vals = struct.unpack_from("<9I", buf, 12)
    return KTX2Header(*vals)


def read_ktx2(data: bytes) -> KTX2File:
    if data[:12] != KTX2_IDENTIFIER:
        raise ValueError("not a KTX2 file (bad identifier)")
    if len(data) < 80:  # identifier + header + section index
        raise ValueError(
            f"truncated KTX2 file: {len(data)} bytes < 80-byte header"
        )
    header = KTX2Header(*struct.unpack_from("<9I", data, 12))
    (
        dfd_off,
        dfd_len,
        kvd_off,
        kvd_len,
        sgd_off,
        sgd_len,
    ) = struct.unpack_from("<IIIIQQ", data, 48)

    # level index: max(1, levelCount) × 3 u64; the count is wire data,
    # so bound it by what the buffer can actually hold (hostile counts
    # were a loop/memory bomb before the fuzz pass)
    n_levels = max(header.level_count, 1)
    if 80 + 24 * n_levels > len(data):
        raise ValueError(
            f"truncated KTX2 file: level index needs "
            f"{80 + 24 * n_levels} bytes, have {len(data)}"
        )
    levels: List[KTX2Level] = []
    off = 80
    for _ in range(n_levels):
        byte_off, byte_len, unc_len = struct.unpack_from("<QQQ", data, off)
        levels.append(KTX2Level(data[byte_off : byte_off + byte_len], unc_len))
        off += 24

    dfd = data[dfd_off : dfd_off + dfd_len] if dfd_len else b""

    key_value: Dict[bytes, bytes] = {}
    p = kvd_off
    # kvd offsets are wire data: clamp to the buffer so truncated or
    # hostile section indices fail soft (entries past the end ignored)
    end = min(kvd_off + kvd_len, len(data))
    while p + 4 <= end:
        (kv_len,) = struct.unpack_from("<I", data, p)
        p += 4
        kv = data[p : p + kv_len]
        nul = kv.find(b"\x00")
        if nul >= 0:
            key_value[kv[:nul]] = kv[nul + 1 :]
        p += kv_len
        p += (4 - (p & 3)) & 3  # 4-byte padding between entries

    f = KTX2File(header=header, levels=levels, dfd=dfd, key_value=key_value)
    if sgd_len:
        f.raw_sgd = data[sgd_off : sgd_off + sgd_len]
        if header.supercompression_scheme == SUPERCOMPRESSION_BASISLZ:
            f.basis_lz = BasisLZGlobalData.unpack(f.raw_sgd, f.image_count)
    return f


def read_ktx2_file(path: str) -> KTX2File:
    with open(path, "rb") as fh:
        return read_ktx2(fh.read())


def _align(n: int, a: int) -> int:
    return (n + a - 1) // a * a


def make_basis_dfd(
    *,
    color_model: int = KHR_DF_MODEL_ETC1S,
    srgb: bool = True,
    has_alpha: bool = False,
) -> bytes:
    """Build the minimal DFD basisu writes for ETC1S/UASTC payloads.

    Layout: dfdTotalSize u32 + one basic descriptor block (24 bytes) +
    one 16-byte sample per channel.
    """
    n_samples = 2 if has_alpha else 1
    block_size = 24 + 16 * n_samples
    total = 4 + block_size
    out = struct.pack("<I", total)
    vendor_type = 0  # Khronos vendor (17 bits) | basic descriptor type (15 bits)
    version = 2
    color_primaries = 1  # BT709
    transfer = 2 if srgb else 1  # SRGB / LINEAR
    flags = 0 if srgb else 1  # ALPHA_STRAIGHT when linear premultiplied unused
    out += struct.pack("<IHH", vendor_type, version, block_size)
    out += struct.pack(
        "<BBBB", color_model & 0xFF, color_primaries, transfer, flags
    )
    # texelBlockDimension: 4x4 blocks → stored as dimension-1
    out += struct.pack("<BBBB", 3, 3, 0, 0)
    out += b"\x00" * 8  # bytesPlane0..7 (0 = supercompressed/variable)
    for i in range(n_samples):
        # sample: bitOffset u16, bitLength u8 (len-1), channelType u8,
        # samplePosition u8×4, sampleLower u32, sampleUpper u32
        channel = 0 if i == 0 else 15  # RGB slice / AAA slice
        out += struct.pack("<HBB", 0, 63, channel)
        out += b"\x00" * 4
        out += struct.pack("<II", 0, 0xFFFFFFFF)
    return out


def write_ktx2(
    header: KTX2Header,
    levels: List[KTX2Level],
    *,
    dfd: bytes = b"",
    key_value: Optional[Dict[bytes, bytes]] = None,
    basis_lz: Optional[BasisLZGlobalData] = None,
) -> bytes:
    """Serialize a KTX2 file; inverse of `read_ktx2` (round-trip tested)."""
    key_value = dict(key_value or {})
    key_value.setdefault(b"KTXwriter", b"uvol_tpu\x00")

    kvd = b""
    for k in sorted(key_value):  # spec: keys sorted ascending
        v = key_value[k]
        entry = k + b"\x00" + v
        kvd += struct.pack("<I", len(entry)) + entry
        kvd += b"\x00" * ((4 - (len(kvd) & 3)) & 3)

    sgd = basis_lz.pack() if basis_lz is not None else b""

    n_levels = max(header.level_count, 1)
    if len(levels) != n_levels:
        raise ValueError("level count mismatch")

    header_bytes = KTX2_IDENTIFIER + struct.pack(
        "<9I",
        header.vk_format,
        header.type_size,
        header.pixel_width,
        header.pixel_height,
        header.pixel_depth,
        header.layer_count,
        header.face_count,
        header.level_count,
        header.supercompression_scheme,
    )
    index_off = len(header_bytes)
    level_index_off = index_off + 32
    dfd_off = level_index_off + 24 * n_levels
    kvd_off = dfd_off + len(dfd)
    pos = kvd_off + len(kvd)
    sgd_off = 0
    if sgd:
        pos = _align(pos, 8)
        sgd_off = pos
        pos += len(sgd)

    # mip padding: levels stored smallest-to-largest in the file; for
    # supercompressed payloads alignment requirement is 1, else 8 is safe.
    level_offsets: List[int] = [0] * n_levels
    blobs: List[bytes] = []
    cursor = pos
    for li in range(n_levels - 1, -1, -1):
        if header.supercompression_scheme == SUPERCOMPRESSION_NONE:
            pad = (_align(cursor, 8)) - cursor
            if pad:
                blobs.append(b"\x00" * pad)
                cursor += pad
        level_offsets[li] = cursor
        blobs.append(levels[li].data)
        cursor += len(levels[li].data)

    index = struct.pack(
        "<IIIIQQ",
        dfd_off if dfd else 0,
        len(dfd),
        kvd_off if kvd else 0,
        len(kvd),
        sgd_off,
        len(sgd),
    )
    level_index = b"".join(
        struct.pack(
            "<QQQ",
            level_offsets[i],
            len(levels[i].data),
            levels[i].uncompressed_byte_length,
        )
        for i in range(n_levels)
    )

    out = header_bytes + index + level_index + dfd + kvd
    if sgd:
        out += b"\x00" * (sgd_off - len(out))
        out += sgd
    out += b"".join(blobs)
    return out
