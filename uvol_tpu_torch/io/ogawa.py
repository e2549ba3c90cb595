"""Ogawa container reader/writer — the Alembic `.abc` on-disk format's
low-level layer.

The reference pipeline ingests Alembic via Blender's `bpy`
(scripts/Encoder.py:207-242: `alembic_import` + per-frame OBJ export);
this package does not depend on `bpy` and reads `.abc` directly. Ogawa
(the container) is simple and publicly documented:

  header (16 bytes):
    bytes 0-4   magic ``Ogawa``
    byte  5     frozen flag: 0xFF = complete file, 0x00 = in progress
    bytes 6-7   u16 LE version (1)
    bytes 8-15  u64 LE byte offset of the root group

  group at offset G:
    u64 LE child_count, then child_count u64 LE child references.
    A reference with bit 63 SET points at a data blob; CLEAR points at a
    subgroup. Offset value 0 (group) / bit-63-only (data) mean empty.

  data blob at offset D (after masking bit 63):
    u64 LE byte_length, then the bytes.

The object/property schema stacked on top lives in `io/alembic.py`.

The port's copy of `uvol_tpu/io/ogawa.py`.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Union

MAGIC = b"Ogawa"
FROZEN = 0xFF
VERSION = 1
DATA_BIT = 1 << 63


class OgawaData:
    """A data-blob reference inside an Ogawa file."""

    __slots__ = ("_buf", "offset")

    def __init__(self, buf: bytes, offset: int):
        self._buf = buf
        self.offset = offset  # already masked (bit 63 cleared)

    @property
    def size(self) -> int:
        if self.offset == 0:
            return 0
        if self.offset + 8 > len(self._buf):
            raise ValueError("ogawa: data header past end of file")
        (n,) = struct.unpack_from("<Q", self._buf, self.offset)
        return n

    def read(self) -> bytes:
        if self.offset == 0:
            return b""
        if self.offset + 8 > len(self._buf):
            raise ValueError("ogawa: data header past end of file")
        (n,) = struct.unpack_from("<Q", self._buf, self.offset)
        start = self.offset + 8
        if start + n > len(self._buf):
            raise ValueError("ogawa: data blob past end of file")
        return self._buf[start : start + n]


class OgawaGroup:
    """A group node: an ordered list of subgroup/data children."""

    __slots__ = ("_buf", "offset", "_refs")

    def __init__(self, buf: bytes, offset: int):
        self._buf = buf
        self.offset = offset
        if offset == 0:
            self._refs: List[int] = []
            return
        if offset + 8 > len(buf):
            raise ValueError("ogawa: group header past end of file")
        (count,) = struct.unpack_from("<Q", buf, offset)
        if count > (len(buf) - offset) // 8:
            raise ValueError("ogawa: group child count past end of file")
        self._refs = list(
            struct.unpack_from(f"<{count}Q", buf, offset + 8)
        )

    def __len__(self) -> int:
        return len(self._refs)

    def is_data(self, i: int) -> bool:
        return bool(self._refs[i] & DATA_BIT)

    def group(self, i: int) -> "OgawaGroup":
        ref = self._refs[i]
        if ref & DATA_BIT:
            raise TypeError(f"ogawa: child {i} is data, not a group")
        return OgawaGroup(self._buf, ref)

    def data(self, i: int) -> OgawaData:
        ref = self._refs[i]
        if not ref & DATA_BIT:
            raise TypeError(f"ogawa: child {i} is a group, not data")
        return OgawaData(self._buf, ref & ~DATA_BIT)


class OgawaReader:
    def __init__(self, buf: bytes):
        if len(buf) < 16 or buf[:5] != MAGIC:
            raise ValueError("not an Ogawa file")
        self.frozen = buf[5] == FROZEN
        (self.version,) = struct.unpack_from("<H", buf, 6)
        if not self.frozen:
            raise ValueError("ogawa: file not frozen (incomplete write)")
        (root_off,) = struct.unpack_from("<Q", buf, 8)
        self.root = OgawaGroup(buf, root_off)


Node = Union["GroupSpec", bytes]


class GroupSpec:
    """In-memory group for the writer: children are bytes (data) or
    nested GroupSpec."""

    __slots__ = ("children",)

    def __init__(self, children: Optional[List[Node]] = None):
        self.children: List[Node] = list(children or [])

    def add(self, child: Node) -> "GroupSpec":
        self.children.append(child)
        return self


def write_ogawa(root: GroupSpec) -> bytes:
    """Serialize a GroupSpec tree to frozen Ogawa bytes (children first,
    groups after their children — the same append-only layout the
    reference library produces)."""
    out = bytearray(16)  # header patched at the end

    def emit(node: Node) -> int:
        if isinstance(node, (bytes, bytearray)):
            if len(node) == 0:
                return DATA_BIT  # canonical empty-data reference
            off = len(out)
            out.extend(struct.pack("<Q", len(node)))
            out.extend(node)
            return DATA_BIT | off
        refs = [emit(c) for c in node.children]
        if not refs:
            return 0  # canonical empty-group reference
        off = len(out)
        out.extend(struct.pack("<Q", len(refs)))
        out.extend(struct.pack(f"<{len(refs)}Q", *refs))
        return off

    root_off = emit(root)
    if root_off in (0, DATA_BIT):  # empty root still needs a real node
        root_off = len(out)
        out.extend(struct.pack("<Q", 0))
    struct.pack_into(
        "<5sBHQ", out, 0, MAGIC, FROZEN, VERSION, root_off
    )
    return bytes(out)
