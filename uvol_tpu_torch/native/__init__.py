"""Native host loops of the port (C++, ctypes) — counterpart of
`uvol_tpu/native/__init__.py`, cut to what the port calls.

`entropy.cpp` (the Draco-layout rANS coder) and `etc1s_native.cpp` (the
ETC1S slice emission, slice decode, palette decode, Huffman table parse
and the transcoder's ETC1-word emission) are copies of the reference's
sources. g++ builds both into one library at first use, with the
reference's flags (`-O3 -ffp-contract=off`: the loops are bit-exact
against the Python paths), into `build/uvol_tpu_torch/` at the repo root.
The library is named after the hash of its sources and flags and is
written under a name of its own process and thread, then moved into place
with `os.replace`, so concurrent builds never load or overwrite a partial
file.

The Draco frame codec (`draco_native.cpp`, `draco_frame.cpp`,
`draco_frame_enc.cpp`, unchanged copies of the reference's) is a second
library, linked with `entropy.cpp` as the reference links it, built the
same way by `get_draco_lib()` (~20 s of g++ at first use): the `.drc`
device decode (`models/drc_device.py`) needs its portable frame decode
and its window packer, and the smoke and tests make their frames with
its encoder.

The Corto `.crt` codec (`corto_native.cpp`, `corto_frame.cpp`, unchanged
copies of the reference's) is a third library, linked with `entropy.cpp`
(its Tunstall expand) and zlib as the reference links it, built by
`get_corto_lib()`: the copied `codecs/corto/` takes it first and its
Python paths (identical bytes) without it.

A failed build is not remembered: `get_lib()` and `get_draco_lib()`
return None, the callers take their Python paths (identical bytes,
slower) or, for a `.drc` frame, raise, and the next call tries again.
Without g++ on PATH they return None at once. Every wrapper below
returns None (or False) where its library is unavailable, as the
reference's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "entropy.cpp", _HERE / "etc1s_native.cpp")
DRACO_SOURCES = (_HERE / "draco_native.cpp", _HERE / "draco_frame.cpp",
                 _HERE / "draco_frame_enc.cpp", _HERE / "entropy.cpp")
CORTO_SOURCES = (_HERE / "corto_native.cpp", _HERE / "corto_frame.cpp", _HERE / "entropy.cpp")
CORTO_LIBS = ("-lz",)  # the ZLIB entropy mode of corto_frame.cpp
BUILD_DIR = _HERE.parents[1] / "build" / "uvol_tpu_torch"
GXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_draco_lib: Optional[ctypes.CDLL] = None
_corto_lib: Optional[ctypes.CDLL] = None


def library_path(sources: Optional[Sequence[Path]] = None, stem: str = "host",
                 libs: Sequence[str] = ()) -> Path:
    """The library of `sources` (default `SOURCES`) linked with `libs`,
    named after their hash."""
    h = hashlib.sha256(" ".join([*GXX_FLAGS, *libs]).encode())
    for src in SOURCES if sources is None else sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libuvol_tpu_torch_{stem}_{h.hexdigest()[:16]}.so"


def build(sources: Optional[Sequence[Path]] = None, stem: str = "host",
          libs: Sequence[str] = ()) -> Optional[Path]:
    """Compile the sources (default `SOURCES`), linked with `libs`, if the
    library for their hash is missing; returns its path, or None when g++
    is missing or fails."""
    sources = SOURCES if sources is None else sources
    so = library_path(sources, stem, libs)
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, *map(str, sources), "-o", str(tmp), *libs],
            capture_output=True,
        )
        if proc.returncode != 0:
            return None
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    except OSError:
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return so


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    vp = c.c_void_p
    signatures = {
        "uvt_rans_decode": (c.c_int, [u32p, c.c_int, c.c_int, u8p, c.c_int, u32p, c.c_int]),
        "uvt_rans_encode": (c.c_int, [u32p, c.c_int, c.c_int, u32p, c.c_int, u8p, c.c_int]),
        "uvt_rans_symbol_encode": (c.c_int64, [u32p, c.c_int64, c.c_int64, c.c_int, u8p,
                                               c.c_int64]),
        "uvt_rans_stream_decode": (c.c_int64, [u8p, c.c_int64, c.c_int64, c.c_int,
                                               c.c_int64, u32p]),
        "uvt_tunstall_expand": (c.c_int, [u8p, i32p, i32p, u8p, c.c_int, u8p, c.c_int]),
        "uvt_etc1s_slice": (c.c_int64, [i32p, i32p, vp, vp, c.c_int64, c.c_int64,
                                        c.c_int, c.c_int, c.c_int, c.c_int]
                            + [vp] * 13 + [c.c_int64]),
        "uvt_etc1s_slice_decode": (c.c_int64, [u8p, c.c_int64, c.c_int64, c.c_int64,
                                               c.c_int, c.c_int, c.c_int] + [vp] * 5 + [i32p]),
        "uvt_etc1s_palette_endpoints": (c.c_int64, [u8p, c.c_int64, c.c_int64, c.c_int64,
                                                    c.c_int] + [vp] * 4 + [u8p, u8p]),
        "uvt_etc1s_palette_selectors": (c.c_int64, [u8p, c.c_int64, c.c_int64, c.c_int64,
                                                    vp, u8p]),
        "uvt_huffman_read_table": (c.c_int64, [u8p, c.c_int64, c.c_int64, u8p, i64p]),
        "uvt_etc1s_words": (c.c_int, [i32p, c.c_int64, u32p, c.c_int64, u32p, c.c_int64,
                                      u32p]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def get_lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library once per process; None
    when it cannot be built (tried again on the next call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = build()
            if so is None:
                return None
            lib = ctypes.CDLL(str(so))
            _bind(lib)
            _lib = lib
        return _lib


def _vp(arr):
    return None if arr is None else arr.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# rANS (entropy.cpp)
# ---------------------------------------------------------------------------


def rans_decode_native(
    probs: np.ndarray, precision_bits: int, buf: bytes, n: int
) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n, np.uint32)
    probs = np.ascontiguousarray(probs, np.uint32)
    b = np.frombuffer(buf, np.uint8)
    rc = lib.uvt_rans_decode(
        probs, len(probs), precision_bits, np.ascontiguousarray(b), len(b), out, n
    )
    return out if rc == 0 else None


def rans_encode_native(
    probs: np.ndarray, precision_bits: int, symbols: np.ndarray
) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    symbols = np.ascontiguousarray(symbols, np.uint32)
    out = np.empty(len(symbols) * 4 + 1024, np.uint8)
    rc = lib.uvt_rans_encode(
        np.ascontiguousarray(probs, np.uint32),
        len(probs),
        precision_bits,
        symbols,
        len(symbols),
        out,
        len(out),
    )
    if rc < 0:
        return None
    return out[:rc].tobytes()


def rans_symbol_encode_native(
    symbols: np.ndarray, alphabet: int, precision_bits: int
) -> Optional[bytes]:
    """One-call RAW symbol-stream tail: probability table + rANS payload
    (byte-exact with the Python normalize/table/encode chain), or None."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(symbols, np.uint32)
    cap = len(s) * 4 + 4 * alphabet + 4096
    out = np.empty(cap, np.uint8)
    rc = lib.uvt_rans_symbol_encode(s, len(s), alphabet, precision_bits, out, cap)
    if rc < 0:
        return None
    return out[:rc].tobytes()


def rans_stream_decode(data, end: int, pos: int, precision_bits: int, n: int):
    """Parse + decode a whole Draco rANS symbol section in one call.
    Returns (symbols uint32[n], new_pos) or None."""
    lib = get_lib()
    if lib is None:
        return None
    d = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    out = np.empty(n, np.uint32)
    new_pos = lib.uvt_rans_stream_decode(d, end, pos, precision_bits, n, out)
    if new_pos < 0:
        return None
    return out, int(new_pos)


def tunstall_expand_native(
    words: bytes, index: np.ndarray, lengths: np.ndarray, comp: bytes, out_size: int
) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(out_size, np.uint8)
    rc = lib.uvt_tunstall_expand(
        np.frombuffer(words, np.uint8),
        np.ascontiguousarray(index, np.int32),
        np.ascontiguousarray(lengths, np.int32),
        np.frombuffer(comp, np.uint8),
        len(comp),
        out,
        out_size,
    )
    return out if rc == 0 else None


# ---------------------------------------------------------------------------
# ETC1S/BasisLZ (etc1s_native.cpp)
# ---------------------------------------------------------------------------


def etc1s_slice_native(
    eps, sels, prev, num_endpoints, num_selectors, history_size,
    *, code_tables=None,
):
    """One slice pass. Without `code_tables`: returns dict of per-stream
    frequency arrays. With `code_tables` ({stream: (codes u32, lens u8)}):
    returns the emitted bytes. None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    eps_i = np.ascontiguousarray(eps, np.int32)
    sels_i = np.ascontiguousarray(sels, np.int32)
    nby, nbx = eps_i.shape
    if prev is not None:
        pe = np.ascontiguousarray(prev[0], np.int32)
        ps = np.ascontiguousarray(prev[1], np.int32)
    else:
        pe = ps = None
    if code_tables is None:
        fp = np.zeros(257, np.int64)
        fd = np.zeros(num_endpoints, np.int64)
        fs = np.zeros(num_selectors + history_size + 1, np.int64)
        fr = np.zeros(64, np.int64)
        rc = lib.uvt_etc1s_slice(
            eps_i, sels_i, _vp(pe), _vp(ps), nby, nbx,
            num_endpoints, num_selectors, history_size, 0,
            None, None, None, None, None, None, None, None,
            _vp(fp), _vp(fd), _vp(fs), _vp(fr), None, 0,
        )
        if rc != 0:
            return None
        return {"pred": fp, "delta": fd, "sel": fs, "rle": fr}
    tabs = {}
    for k in ("pred", "delta", "sel", "rle"):
        codes, lens = code_tables[k]
        tabs[k] = (
            np.ascontiguousarray(codes, np.uint32),
            np.ascontiguousarray(lens, np.uint8),
        )
    cap = nby * nbx * 16 + 1024
    out = np.zeros(cap, np.uint8)
    nbits = lib.uvt_etc1s_slice(
        eps_i, sels_i, _vp(pe), _vp(ps), nby, nbx,
        num_endpoints, num_selectors, history_size, 1,
        _vp(tabs["pred"][0]), _vp(tabs["pred"][1]),
        _vp(tabs["delta"][0]), _vp(tabs["delta"][1]),
        _vp(tabs["sel"][0]), _vp(tabs["sel"][1]),
        _vp(tabs["rle"][0]), _vp(tabs["rle"][1]),
        None, None, None, None, _vp(out), cap,
    )
    if nbits < 0:
        return None
    return out[: (nbits + 7) // 8].tobytes()


def etc1s_slice_decode_native(
    data, nby, nbx, num_endpoints, num_selectors, history_size, prev, luts
):
    """Native slice decode. luts: per-stream uint32[65536] flat Huffman
    lookups ((sym<<5)|len). Returns [nby, nbx, 2] int32 or None."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.frombuffer(bytes(data), np.uint8)
    if prev is not None:
        prev = np.ascontiguousarray(prev, np.int32)
    out = np.zeros((nby, nbx, 2), np.int32)
    rc = lib.uvt_etc1s_slice_decode(
        d, len(d), nby, nbx, num_endpoints, num_selectors, history_size,
        _vp(prev), _vp(luts[0]), _vp(luts[1]), _vp(luts[2]), _vp(luts[3]),
        out,
    )
    if rc < 0:
        return None
    return out


def etc1s_palette_endpoints_native(
    data, bit_pos, num_endpoints, grayscale, luts
):
    """Native endpoint palette loop. luts: (model0, model1, model2, inten)
    flat 16-bit Huffman LUTs. Returns (color5 [E,3], inten [E], new_bit_pos)
    or None."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.frombuffer(bytes(data), np.uint8)
    color5 = np.empty((num_endpoints, 3), np.uint8)
    inten = np.empty(num_endpoints, np.uint8)
    pos = lib.uvt_etc1s_palette_endpoints(
        d, len(d), bit_pos, num_endpoints, int(grayscale),
        _vp(luts[0]), _vp(luts[1]), _vp(luts[2]), _vp(luts[3]),
        color5, inten,
    )
    if pos < 0:
        return None
    return color5, inten, int(pos)


def huffman_read_table_native(data, bit_pos: int):
    """Parse one canonical Huffman table header+code sizes
    (transcoder.read_huffman_table). Returns (code_sizes uint8[n] | None,
    new_bit_pos) — None sizes = null table — or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    d = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    sizes = np.zeros(1 << 14, np.uint8)
    n = np.zeros(1, np.int64)
    pos = lib.uvt_huffman_read_table(d, len(d), bit_pos, sizes, n)
    if pos < 0:
        return None
    if int(n[0]) == 0:
        return None, int(pos)
    return sizes[: int(n[0])].copy(), int(pos)


def etc1s_palette_selectors_native(data, bit_pos, num_selectors, lut):
    """Native selector palette loop. Returns ([S,16] codes, new_bit_pos)
    or None."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.frombuffer(bytes(data), np.uint8)
    out = np.empty((num_selectors, 16), np.uint8)
    pos = lib.uvt_etc1s_palette_selectors(
        d, len(d), bit_pos, num_selectors, _vp(lut), out
    )
    if pos < 0:
        return None
    return out, int(pos)


def etc1s_words_native(blocks, word1_of, word2_of) -> Optional[np.ndarray]:
    """One-pass [n, 2] palette-index -> ETC1-word mapping (`uvt_etc1s_words`).
    Returns [n, 2] uint32, or None when the library is unavailable or an
    index is outside its table."""
    lib = get_lib()
    if lib is None:
        return None
    b = np.ascontiguousarray(np.asarray(blocks).reshape(-1, 2), np.int32)
    w1 = np.ascontiguousarray(word1_of, np.uint32)
    w2 = np.ascontiguousarray(word2_of, np.uint32)
    out = np.empty((len(b), 2), np.uint32)
    if lib.uvt_etc1s_words(b, len(b), w1, len(w1), w2, len(w2), out) != 0:
        return None
    return out

# ---------------------------------------------------------------------------
# The Draco frame codec (draco_native.cpp, draco_frame.cpp, draco_frame_enc.cpp)
# ---------------------------------------------------------------------------


def _bind_draco(lib: ctypes.CDLL) -> None:
    c = ctypes
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    vp = c.c_void_p
    signatures = {
        "uvt_pack_bits": (c.c_int, [i32p, c.c_int64, c.c_int, u8p]),
        "uvt_pack_frames": (c.c_int, [c.POINTER(vp), c.POINTER(c.c_int64), c.c_int64,
                                      c.c_int64, c.c_int, vp]),
        "uvt_drc_decode2": (vp, [u8p, c.c_int64, c.c_int64, i64p]),
        "uvt_drc_attr_info": (c.c_int, [vp, c.c_int, i64p]),
        "uvt_drc_attr_fetch": (c.c_int, [vp, c.c_int, vp, i32p]),
        "uvt_drc_attr_deq": (c.c_int, [vp, c.c_int, f64p]),
        "uvt_drc_points_fetch": (c.c_int, [vp, i32p]),
        "uvt_drc_free": (None, [vp]),
        "uvt_drc_encode": (c.c_int64, [i64p, c.c_int64, c.c_int64,
                                       c.c_int64, i32p, u8p, i32p, i32p, i32p, i64p,
                                       f64p, i64p, i64p, i64p,
                                       i64p, c.c_int, u8p, c.c_int64]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def get_draco_lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the Draco library once per process;
    None when it cannot be built (tried again on the next call)."""
    global _draco_lib
    if _draco_lib is not None:
        return _draco_lib
    with _lock:
        if _draco_lib is None:
            so = build(DRACO_SOURCES, "draco")
            if so is None:
                return None
            lib = ctypes.CDLL(str(so))
            _bind_draco(lib)
            _draco_lib = lib
        return _draco_lib


#: upload packing mode (bits) -> (values, bytes) per group (`uvt_pack_bits`)
PACK_GROUPS = {8: (1, 1), 10: (4, 5), 12: (2, 3), 16: (1, 2), 32: (1, 4)}


def pack_bits_native(vals: np.ndarray, mode: int, nbytes: int) -> Optional[np.ndarray]:
    """Flat int32 array -> uint8 upload wire at `mode`-bit granularity
    (`models/drc_device.py`'s packing modes) in one C pass; None when the
    library is unavailable or the host is not little-endian (the 16- and
    32-bit modes are numpy's `.view(uint8)` there)."""
    lib = get_draco_lib()
    if lib is None or sys.byteorder != "little":
        return None
    v = np.ascontiguousarray(vals, np.int32)
    out = np.empty(nbytes, np.uint8)
    if lib.uvt_pack_bits(v, len(v), mode, out) != 0:
        return None
    return out


def pack_frames_native(vals: list, mode: int, stride: int, out: np.ndarray,
                       out_off: int) -> bool:
    """Pack F per-frame int32 value arrays into their padded slots of the
    window buffer `out` from byte `out_off` on, zero-filling the padding
    (`uvt_pack_frames`). `out` may be the numpy view of a pinned tensor:
    the C loop writes at its address. False when the library is
    unavailable (the caller keeps the numpy path). Raises where `out`
    cannot hold the F padded slots."""
    gv, gb = PACK_GROUPS[mode]
    if (out.dtype != np.uint8 or not out.flags.c_contiguous or stride % gv
            or out_off < 0 or out.nbytes < out_off + len(vals) * (stride // gv) * gb):
        raise ValueError(f"{len(vals)} frames of {stride} values at mode {mode} do not fit "
                         f"{out.nbytes} bytes from {out_off}")
    lib = get_draco_lib()
    if lib is None or sys.byteorder != "little":
        return False
    c = ctypes
    f = len(vals)
    arrs = [np.ascontiguousarray(v, np.int32).reshape(-1) for v in vals]
    ptrs = (c.c_void_p * f)(*[a.ctypes.data for a in arrs])
    ns = (c.c_int64 * f)(*[a.size for a in arrs])
    return lib.uvt_pack_frames(ptrs, ns, f, stride, mode, out.ctypes.data + out_off) == 0


def drc_decode_native(data: bytes, *, portable: bool = False):
    """Whole-frame `.drc` decode in one native call (draco_frame.cpp).

    Returns (num_faces, num_points, point_of_corner int32[3F], attrs), each
    attrs entry (att_type, data_type, num_components, normalized,
    unique_id, values ndarray, corner_to_value int32[3F]); or None when
    the stream uses a feature outside the native path (standard coder,
    tagged symbols, sequential or point-cloud encodings) or the library
    is unavailable.

    `portable=True` keeps the integer stages (quantized values,
    octahedral normal ints) and appends each attribute's dequantize
    parameters, (kind, bits, oct_max_quantized, range, mins[nc]): the
    host half of the split whose device half is `models/drc_device.py`.
    """
    lib = get_draco_lib()
    if lib is None:
        return None
    c = ctypes
    d = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int64)
    h = lib.uvt_drc_decode2(d, len(d), 1 if portable else 0, info)
    if not h or int(info[0]) != 0:
        return None
    try:
        num_attrs, num_faces, num_points = int(info[1]), int(info[2]), int(info[3])
        n_corners = 3 * num_faces
        point_of_corner = np.empty(n_corners, np.int32)
        if lib.uvt_drc_points_fetch(h, point_of_corner) != 0:
            return None
        attrs = []
        info8 = np.zeros(8, np.int64)
        for i in range(num_attrs):
            if lib.uvt_drc_attr_info(h, i, info8) != 0:
                return None
            att_type, data_type, ncomp, norm, uid, is_float, nvals, stored_nc = (
                int(x) for x in info8)
            values = np.empty((nvals, stored_nc), np.float32 if is_float else np.int64)
            corner_map = np.empty(n_corners, np.int32)
            if lib.uvt_drc_attr_fetch(h, i, values.ctypes.data_as(c.c_void_p), corner_map) != 0:
                return None
            attr = (att_type, data_type, ncomp, bool(norm), uid, values, corner_map)
            if portable:
                deq = np.zeros(12, np.float64)
                if lib.uvt_drc_attr_deq(h, i, deq) != 0:
                    return None
                attr += ((int(deq[0]), int(deq[1]), int(deq[2]), float(deq[3]),
                          deq[4:4 + max(ncomp, 1)].copy()),)
            attrs.append(attr)
        return num_faces, num_points, point_of_corner, attrs
    finally:
        lib.uvt_drc_free(h)


@dataclass
class AttributeToEncode:
    """One attribute for `drc_encode_native`: the fields it reads of the
    reference encoder's record of the same name."""

    attribute_type: int  # constants.ATT_POSITION / ATT_TEX_COORD / ...
    values: np.ndarray  # [N, C] float32 (or ints for integer attributes)
    corner_to_value: np.ndarray  # [3F] value index per corner
    quantization_bits: int = 11
    integer: bool = False  # SEQ_INTEGER (no quantization header)


def drc_encode_native(faces, attributes: Sequence[AttributeToEncode],
                      standard_traversal: bool = False) -> Optional[bytes]:
    """Whole-frame `.drc` encode in one native call (draco_frame_enc.cpp);
    `attributes[0]` must be the positions. Returns the encoded bytes, or
    None when the library is unavailable or the frame uses a feature
    outside the native path."""
    lib = get_draco_lib()
    if lib is None:
        return None
    from uvol_tpu_torch.codecs.draco import constants as K

    faces = np.ascontiguousarray(np.asarray(faces, np.int64).reshape(-1))
    num_faces = len(faces) // 3
    n = 3 * num_faces
    num_positions = int(faces.max()) + 1 if num_faces else 0
    na = len(attributes)
    att_type = np.zeros(na, np.int32)
    att_integer = np.zeros(na, np.uint8)
    att_dtype = np.zeros(na, np.int32)
    att_qbits = np.zeros(na, np.int32)
    att_ncomp = np.zeros(na, np.int32)
    att_nvals = np.zeros(na, np.int64)
    fvals, ivals, foffs, ioffs = [], [], [], []
    c2v = np.empty((na, n), np.int64)
    fcount = icount = 0
    for i, a in enumerate(attributes):
        vals = np.asarray(a.values)
        if vals.ndim != 2:
            return None
        att_type[i] = a.attribute_type
        att_integer[i] = 1 if a.integer else 0
        att_qbits[i] = a.quantization_bits
        att_ncomp[i] = vals.shape[1]
        att_nvals[i] = vals.shape[0]
        c2v[i] = np.asarray(a.corner_to_value, np.int64).reshape(-1)
        foffs.append(fcount)
        ioffs.append(icount)
        if a.integer:
            att_dtype[i] = K.DT_UINT8 if vals.dtype == np.uint8 else K.DT_INT32
            ivals.append(np.ascontiguousarray(vals.reshape(-1), np.int64))
            icount += vals.size
        else:
            fvals.append(np.ascontiguousarray(vals.reshape(-1), np.float64))
            fcount += vals.size
    fvalues_all = np.concatenate(fvals) if fvals else np.zeros(1, np.float64)
    ivalues_all = np.concatenate(ivals) if icount else np.zeros(1, np.int64)
    cap = (1 << 20) + 8 * (fcount + icount) + 4 * n
    out = np.empty(cap, np.uint8)
    rc = lib.uvt_drc_encode(
        faces, num_faces, num_positions,
        na, att_type, att_integer, att_dtype, att_qbits, att_ncomp, att_nvals,
        fvalues_all, np.asarray(foffs, np.int64), ivalues_all, np.asarray(ioffs, np.int64),
        np.ascontiguousarray(c2v.reshape(-1)), 1 if standard_traversal else 0, out, cap,
    )
    if rc < 0:
        return None
    return out[:rc].tobytes()


# ---------------------------------------------------------------------------
# The Corto codec (corto_native.cpp, corto_frame.cpp): the reference's
# wrappers, each returning None (or False) without the library
# ---------------------------------------------------------------------------


def _bind_corto(lib: ctypes.CDLL) -> None:
    c = ctypes
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    vp = c.c_void_p
    signatures = {
        "uvt_corto_unpack_values": (c.c_int, [u32p, c.c_int64, u8p, c.c_int64, c.c_int, i32p]),
        "uvt_corto_unpack_tuples": (c.c_int, [u32p, c.c_int64, u8p, c.c_int64, c.c_int, i32p]),
        "uvt_corto_unpack_indices": (c.c_int, [u32p, c.c_int64, u8p, c.c_int64, i32p]),
        "uvt_corto_pack_values": (c.c_int64, [i64p, c.c_int64, c.c_int, u8p, u32p, c.c_int64]),
        "uvt_corto_pack_tuples": (c.c_int64, [i64p, c.c_int64, c.c_int, u8p, u32p, c.c_int64]),
        "uvt_corto_pack_indices": (c.c_int64, [i64p, c.c_int64, u8p, u32p, c.c_int64]),
        "uvt_corto_decode_faces": (c.c_int, [u8p, c.c_int64, u32p, c.c_int64, i64p, c.c_int,
                                             c.c_int, c.c_int64, i32p, i32p]),
        "uvt_corto_delta_decode": (c.c_int, [i32p, c.c_int64, c.c_int, vp, c.c_int]),
        "uvt_corto_build_topology": (c.c_int, [i32p, c.c_int64, c.c_int64, i32p]),
        "uvt_corto_enc_new": (vp, [i32p, i32p, c.c_int64, c.c_int64, c.c_int]),
        "uvt_corto_enc_free": (None, [vp]),
        "uvt_corto_enc_group": (c.c_int, [vp, c.c_int64, c.c_int64]),
        "uvt_corto_enc_nclers": (c.c_int64, [vp]),
        "uvt_corto_enc_nwords": (c.c_int64, [vp]),
        "uvt_corto_enc_nverts": (c.c_int64, [vp]),
        "uvt_corto_enc_maxfront": (c.c_int64, [vp]),
        "uvt_corto_enc_get": (c.c_int, [vp, u8p, u32p, i32p, i32p]),
        "uvt_tunstall_parse": (c.c_int64, [u8p, i32p, i32p, c.c_int, u8p, c.c_int64, u8p,
                                           c.c_int64]),
        "uvt_tunstall_tables": (c.c_int, [u8p, u8p, c.c_int, u8p, c.c_int64, i32p, i32p]),
        "uvt_corto_normals_dequant": (c.c_int, [i32p, c.c_int64, c.c_float, f32p]),
        "uvt_crt_decode": (vp, [u8p, c.c_int64, i64p]),
        "uvt_crt_attr_info": (c.c_int, [vp, c.c_int, i64p]),
        "uvt_crt_attr_name": (c.c_int, [vp, c.c_int, c.c_char_p]),
        "uvt_crt_attr_fetch": (c.c_int, [vp, c.c_int, vp]),
        "uvt_crt_faces_fetch": (c.c_int, [vp, i32p]),
        "uvt_crt_free": (None, [vp]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def get_corto_lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the Corto library once per process;
    None when it cannot be built (tried again on the next call)."""
    global _corto_lib
    if _corto_lib is not None:
        return _corto_lib
    with _lock:
        if _corto_lib is None:
            so = build(CORTO_SOURCES, "corto", CORTO_LIBS)
            if so is None:
                return None
            lib = ctypes.CDLL(str(so))
            _bind_corto(lib)
            _corto_lib = lib
        return _corto_lib


def corto_unpack_values(words, logs, size, n):
    lib = get_corto_lib()
    if lib is None:
        return None
    out = np.empty((size, n), np.int32)
    w = np.ascontiguousarray(words, np.uint32)
    lg = np.ascontiguousarray(logs, np.uint8)
    if lg.size < size * n:  # malformed: Tunstall logs shorter than claimed
        raise ValueError("corto value stream: log bytes underrun")
    if lib.uvt_corto_unpack_values(w, len(w), lg, size, n, out) != 0:
        raise ValueError("corto value stream: malformed bit stream")
    return out


def corto_unpack_tuples(words, logs, size, n):
    lib = get_corto_lib()
    if lib is None:
        return None
    out = np.empty((size, n), np.int32)
    w = np.ascontiguousarray(words, np.uint32)
    lg = np.ascontiguousarray(logs, np.uint8)
    if lg.size < size:
        raise ValueError("corto value stream: log bytes underrun")
    if lib.uvt_corto_unpack_tuples(w, len(w), lg, size, n, out) != 0:
        raise ValueError("corto value stream: malformed bit stream")
    return out


def corto_unpack_indices(words, logs, size):
    lib = get_corto_lib()
    if lib is None:
        return None
    out = np.empty(size, np.int32)
    w = np.ascontiguousarray(words, np.uint32)
    lg = np.ascontiguousarray(logs, np.uint8)
    if lg.size < size:
        raise ValueError("corto value stream: log bytes underrun")
    if lib.uvt_corto_unpack_indices(w, len(w), lg, size, out) != 0:
        raise ValueError("corto value stream: malformed bit stream")
    return out


def corto_pack_values(values, size, n):
    """Returns (logs [n, size] u8, words u32) or None."""
    lib = get_corto_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.int64).reshape(size, n)
    logs = np.empty((n, size), np.uint8)
    cap = size * n + 2
    words = np.empty(cap, np.uint32)
    nw = lib.uvt_corto_pack_values(v, size, n, logs.reshape(-1), words, cap)
    if nw < 0:
        return None
    return logs, words[:nw]


def corto_pack_tuples(values, size, n):
    """Returns (logs [size] u8, words u32) or None."""
    lib = get_corto_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.int64).reshape(size, n)
    logs = np.empty(size, np.uint8)
    cap = size * n + 2
    words = np.empty(cap, np.uint32)
    nw = lib.uvt_corto_pack_tuples(v, size, n, logs, words, cap)
    if nw < 0:
        return None
    return logs, words[:nw]


def corto_pack_indices(values, size):
    lib = get_corto_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.int64)
    logs = np.empty(size, np.uint8)
    cap = size + 2
    words = np.empty(cap, np.uint32)
    nw = lib.uvt_corto_pack_indices(v, size, logs, words, cap)
    if nw < 0:
        return None
    return logs, words[:nw]


def corto_decode_faces(clers, words, group_ends, splitbits, nvert, nface):
    """Returns (faces i32[3F], prediction i32[nvert,3], vertex_count) or None."""
    lib = get_corto_lib()
    if lib is None:
        return None
    cl = np.ascontiguousarray(clers, np.uint8)
    w = np.ascontiguousarray(words, np.uint32)
    ge = np.ascontiguousarray(group_ends, np.int64)
    # corrupt group tables must not index past the face buffer
    if len(ge) == 0 or (np.diff(ge) < 0).any() or ge[0] < 0 or ge[-1] > nface:
        raise ValueError("corto group table out of range")
    if not 0 <= splitbits <= 32:
        raise ValueError("corto splitbits out of range")
    faces = np.zeros(3 * nface, np.int32)
    prediction = np.zeros((nvert, 3), np.int32)
    rc = lib.uvt_corto_decode_faces(
        cl, len(cl), w, len(w), ge, len(ge), splitbits, nvert, faces, prediction
    )
    if rc < 0:
        raise ValueError(f"corto CLER decode failed (rc={rc})")
    return faces, prediction, rc


def corto_delta_decode(values, prediction, mode):
    """In-place delta integration on int32 [size, n]. Returns False if the
    native library is unavailable (caller falls back)."""
    lib = get_corto_lib()
    if lib is None:
        return False
    assert values.dtype == np.int32 and values.flags.c_contiguous
    if prediction is None:
        pred_ptr = None
    else:
        prediction = np.ascontiguousarray(prediction, np.int32)
        pred_ptr = prediction.ctypes.data_as(ctypes.c_void_p)
    size, n = values.shape
    if pred_ptr is not None and len(prediction) < size:
        raise ValueError("corto prediction table shorter than value count")
    if lib.uvt_corto_delta_decode(values, size, n, pred_ptr, mode) != 0:
        raise ValueError("corto delta decode: corrupt prediction indices")
    return True


def corto_build_topology(faces, nvert):
    """Returns opposite i32 [F, 3, 2] or None."""
    lib = get_corto_lib()
    if lib is None:
        return None
    f = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    opp = np.empty((len(f), 3, 2), np.int32)
    lib.uvt_corto_build_topology(f, len(f), nvert, opp)
    return opp


class CortoEncoderNative:
    """Native CLER front machine (encode side); state persists across
    per-group calls like the reference's Encoder::encodeFaces."""

    def __init__(self, faces, topology, nvert, splitbits):
        self._lib = get_corto_lib()
        if self._lib is None:
            raise RuntimeError("native corto library unavailable")
        self._faces = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
        self._topo = np.ascontiguousarray(topology, np.int32)
        self._h = self._lib.uvt_corto_enc_new(
            self._faces, self._topo, len(self._faces), nvert, splitbits
        )
        self._nvert = nvert

    def encode_group(self, start, end):
        rc = self._lib.uvt_corto_enc_group(self._h, start, end)
        if rc != 0:
            raise ValueError(f"native corto encode failed (rc={rc})")

    def finish(self):
        """Returns (clers u8, words u32, encoded i32[nvert], prediction
        i32[new_nvert, 4], new_nvert, max_front)."""
        lib = self._lib
        nclers = lib.uvt_corto_enc_nclers(self._h)
        nwords = lib.uvt_corto_enc_nwords(self._h)
        nverts = lib.uvt_corto_enc_nverts(self._h)
        maxfront = lib.uvt_corto_enc_maxfront(self._h)
        clers = np.empty(nclers, np.uint8)
        words = np.empty(nwords, np.uint32)
        encoded = np.empty(self._nvert, np.int32)
        prediction = np.empty((nverts, 4), np.int32)
        lib.uvt_corto_enc_get(self._h, clers, words, encoded, prediction)
        return clers, words, encoded, prediction, int(nverts), int(maxfront)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.uvt_corto_enc_free(self._h)
            self._h = None


def tunstall_parse_native(words, index, lengths, data):
    """Greedy Tunstall dictionary parse. Returns bytes or None."""
    lib = get_corto_lib()
    if lib is None:
        return None
    w = np.frombuffer(words, np.uint8)
    idx = np.ascontiguousarray(index, np.int32)
    ln = np.ascontiguousarray(lengths, np.int32)
    d = np.ascontiguousarray(data, np.uint8)
    out = np.empty(len(d) + 16, np.uint8)
    n = lib.uvt_tunstall_parse(w, idx, ln, len(idx), d, len(d), out, len(out))
    if n < 0:
        return None
    return out[:n].tobytes()


def tunstall_tables_native(probabilities):
    """createDecodingTables2 in C++: [(symbol, prob)] -> (words bytes,
    index i32[n], lengths i32[n]) or None."""
    lib = get_corto_lib()
    if lib is None:
        return None
    syms = np.asarray([s for s, _ in probabilities], np.uint8)
    probs = np.asarray([p for _, p in probabilities], np.uint8)
    cap = 256 * 260
    words = np.empty(cap, np.uint8)
    index = np.empty(256, np.int32)
    lengths = np.empty(256, np.int32)
    n = lib.uvt_tunstall_tables(syms, probs, len(syms), words, cap, index, lengths)
    if n < 0:
        return None
    total = int(index[n - 1] + lengths[n - 1]) if n else 0
    return words[:total].tobytes(), index[:n], lengths[:n]


def corto_normals_dequant_native(st: np.ndarray, unit: float):
    """[N, 2] int -> [N, 3] float32 unit normals, or None."""
    lib = get_corto_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(st, np.int32)
    out = np.empty((len(s), 3), np.float32)
    lib.uvt_corto_normals_dequant(s, len(s), float(unit), out)
    return out


def crt_decode_frame_native(data: bytes):
    """Whole-frame `.crt` decode in one C call (corto_frame.cpp).

    Returns (faces int32 [nface, 3], {name: ndarray}, nvert, nface) or
    None — the caller (codecs/corto/decoder.decode_crt) falls back to the
    staged pipeline, which stays the bit-exact oracle for this path.
    """
    lib = get_corto_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int64)
    h = lib.uvt_crt_decode(buf, len(buf), info)
    if not h:
        return None
    try:
        nattrs, nvert, nface = int(info[1]), int(info[2]), int(info[3])
        attrs = {}
        info4 = np.zeros(4, np.int64)
        for idx in range(nattrs):
            if lib.uvt_crt_attr_info(h, idx, info4) != 0:
                return None
            comps, dtype_code, name_len = int(info4[1]), int(info4[2]), int(info4[3])
            name_buf = ctypes.create_string_buffer(name_len + 1)
            if lib.uvt_crt_attr_name(h, idx, name_buf) != 0:
                return None
            name = name_buf.raw[:name_len].decode()
            dt = {0: np.float32, 1: np.int64, 2: np.uint8}[dtype_code]
            out = np.empty((nvert, comps), dt)
            if lib.uvt_crt_attr_fetch(h, idx, out.ctypes.data_as(ctypes.c_void_p)) != 0:
                return None
            attrs[name] = out
        faces = np.zeros((nface, 3), np.int32)
        if nface:
            if lib.uvt_crt_faces_fetch(h, faces.reshape(-1)) != 0:
                return None
        return faces, attrs, nvert, nface
    finally:
        lib.uvt_crt_free(h)
