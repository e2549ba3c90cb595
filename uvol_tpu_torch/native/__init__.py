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
same way by `get_draco_lib()` (~20 s of g++ at first use): the whole-frame
decode and encode, the `.drc` device decode's portable frame decode and
window packer (`models/drc_device.py`), and the staged helpers of the
copied Python codec (`codecs/draco/`). The reference's switches hold:
`UVT_DISABLE_NATIVE_DRACO=1` turns the whole library off (every Draco
caller takes its Python path), `UVT_DISABLE_NATIVE_FRAME=1` only the
whole-frame decode and encode.

The Corto `.crt` codec (`corto_native.cpp`, `corto_frame.cpp`, unchanged
copies of the reference's) is a third library, linked with `entropy.cpp`
(its Tunstall expand) and zlib as the reference links it, built by
`get_corto_lib()`: the copied `codecs/corto/` takes it first and its
Python paths (identical bytes) without it.

The H.264 slice codec (`h264_native.cpp` with its `h264_tables.inc`,
unchanged copies of the reference's) is a fourth library, loaded by
`native/h264c.py` through `build(H264_SOURCES, "h264", headers=...)`.

A failed build is not remembered: `get_lib()` and `get_draco_lib()`
return None, the callers take their Python paths (identical bytes,
slower), and the next call tries again.
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
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "entropy.cpp", _HERE / "etc1s_native.cpp")
DRACO_SOURCES = (_HERE / "draco_native.cpp", _HERE / "draco_frame.cpp",
                 _HERE / "draco_frame_enc.cpp", _HERE / "entropy.cpp")
CORTO_SOURCES = (_HERE / "corto_native.cpp", _HERE / "corto_frame.cpp", _HERE / "entropy.cpp")
CORTO_LIBS = ("-lz",)  # the ZLIB entropy mode of corto_frame.cpp
H264_SOURCES = (_HERE / "h264_native.cpp",)
H264_HEADERS = (_HERE / "h264_tables.inc",)  # #included by h264_native.cpp
BUILD_DIR = _HERE.parents[1] / "build" / "uvol_tpu_torch"
GXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_draco_lib: Optional[ctypes.CDLL] = None
_corto_lib: Optional[ctypes.CDLL] = None


def library_path(sources: Optional[Sequence[Path]] = None, stem: str = "host",
                 libs: Sequence[str] = (), headers: Sequence[Path] = ()) -> Path:
    """The library of `sources` (default `SOURCES`) linked with `libs`,
    named after their hash and that of the `headers` they include."""
    h = hashlib.sha256(" ".join([*GXX_FLAGS, *libs]).encode())
    for src in [*(SOURCES if sources is None else sources), *headers]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libuvol_tpu_torch_{stem}_{h.hexdigest()[:16]}.so"


def build(sources: Optional[Sequence[Path]] = None, stem: str = "host",
          libs: Sequence[str] = (), headers: Sequence[Path] = ()) -> Optional[Path]:
    """Compile the sources (default `SOURCES`), linked with `libs`, if the
    library for their hash (`headers` included) is missing; returns its
    path, or None when g++ is missing or fails."""
    sources = SOURCES if sources is None else sources
    so = library_path(sources, stem, libs, headers)
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
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = _I64P
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
        # the staged decoder's and encoder's helpers (the reference's bindings)
        "uvt_rabs_decode_bits": (c.c_int, [c.c_uint32, u8p, c.c_int64, u8p, c.c_int64]),
        "uvt_eb_valence_machine": (c.c_int, [u32p, i64p, c.c_int64, c.c_int64, c.c_int64,
                                             i64p, i64p, u8p, c.c_int64,
                                             c.c_uint32, u8p, c.c_int64,
                                             i32p, i32p, i32p, i32p, i64p]),
        "uvt_seam_pass": (c.c_int, [i32p, c.c_int64, c.c_int64, u32p, u8p, i64p, i32p, i64p]),
        "uvt_attr_corner_table": (c.c_int, [i32p, i32p, i32p, c.c_int64, c.c_int64, u8p, u8p,
                                            i32p, i32p, vp, i64p]),
        "uvt_traverse_depth_first": (c.c_int, [i32p, i32p, vp, c.c_int64, c.c_int64, i32p,
                                               c.c_int64, vp, i32p, i32p, i64p]),
        "uvt_decode_parallelogram": (c.c_int, [i64p, c.c_int64, c.c_int, c.c_int64, c.c_int64,
                                               i32p, i32p, vp, i32p, i32p, i64p]),
        "uvt_texcoords_predict": (c.c_int, [i64p, c.c_int64, c.c_int64, c.c_int64,
                                            i32p, i32p, i32p, i64p, i32p, u8p, c.c_int64,
                                            i64p]),
        "uvt_normals_predict": (c.c_int, [i64p, c.c_int64, c.c_int64, c.c_int64,
                                          i32p, i32p, vp, i32p, i64p, i32p,
                                          c.c_uint32, u8p, c.c_int64, c.c_int64, vp, i64p]),
        "uvt_encoder_corner_table": (c.c_int64, [i64p, c.c_int64, c.c_int64, i32p, i32p,
                                                 i32p]),
        "uvt_parallelogram_encode": (c.c_int, [i64p, c.c_int64, c.c_int, c.c_int64,
                                               c.c_int64, i32p, i32p, vp, i32p, i32p, i64p]),
        "uvt_texcoords_encode": (c.c_int64, [i64p, c.c_int64, c.c_int64, c.c_int64,
                                             i32p, i32p, i32p, i64p, i32p, i64p, u8p]),
        "uvt_normals_encode": (c.c_int, [i64p, c.c_int64, c.c_int64, i32p, i32p, vp, i32p,
                                         i64p, i32p, i64p, u8p, c.c_int64, vp]),
        "uvt_quantize_normals": (c.c_int, [f64p, c.c_int64, c.c_int, i64p]),
        "uvt_eb_replay_machine": (c.c_int, [u8p, c.c_int64, c.c_int64, c.c_int64,
                                            i64p, i64p, u8p, c.c_int64, u8p, c.c_int64,
                                            i32p, i32p, i32p, i32p, i32p, i64p]),
        "uvt_rabs_encode_bits": (c.c_int64, [u8p, c.c_int64, c.c_uint32, u8p, c.c_int64]),
        "uvt_point_assembly": (c.c_int64, [i32p, c.c_int64, c.c_int, i32p, i32p]),
        "uvt_eb_traverse": (c.c_int, [i32p, i32p, i64p, c.c_int64, c.c_int64, c.c_int64,
                                      u8p, i32p, u8p, i64p, i64p, u8p, i32p, i32p, i64p]),
        "uvt_eb_encode_maps": (c.c_int, [c.c_int64, c.c_int64, c.c_int64,
                                         i64p, i32p, i32p, i32p, i32p, i64p,
                                         c.c_int64, i64p,
                                         i64p, i64p, u8p, i64p, i64p, i64p]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def get_draco_lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the Draco library once per process;
    None when it cannot be built (tried again on the next call) or when
    `UVT_DISABLE_NATIVE_DRACO=1` holds every Draco caller on its Python
    path, as in the reference."""
    global _draco_lib
    if os.environ.get("UVT_DISABLE_NATIVE_DRACO") == "1":
        return None
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
    `UVT_DISABLE_NATIVE_FRAME=1` refuses every frame, as in the reference
    (the staged helpers stay on).
    """
    if os.environ.get("UVT_DISABLE_NATIVE_FRAME") == "1":
        return None
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


def drc_encode_native(faces, attributes: Sequence, standard_traversal: bool = False
                      ) -> Optional[bytes]:
    """Whole-frame `.drc` encode in one native call (draco_frame_enc.cpp) of
    `codecs/draco/encoder.AttributeToEncode` records; `attributes[0]` must
    be the positions. Returns the encoded bytes, or
    None when the library is unavailable, the frame uses a feature outside
    the native path or `UVT_DISABLE_NATIVE_FRAME=1`."""
    if os.environ.get("UVT_DISABLE_NATIVE_FRAME") == "1":
        return None
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
# The staged Draco decoder's and encoder's helpers (draco_native.cpp,
# draco_frame_enc.cpp): the reference's wrappers, each returning None
# without the library
# ---------------------------------------------------------------------------

def _u8(buf) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(buf, np.uint8))


def _mask_ptr(seam_mask):
    if seam_mask is None:
        return None
    arr = np.ascontiguousarray(seam_mask, np.uint8)
    return arr.ctypes.data_as(ctypes.c_void_p), arr  # keep alive


def rabs_decode_bits_native(prob_zero: int, buf: bytes, n: int):
    lib = get_draco_lib()
    if lib is None:
        return None
    out = np.empty(n, np.uint8)
    rc = lib.uvt_rabs_decode_bits(prob_zero, _u8(buf), len(buf), out, n)
    return out if rc == 0 else None


def eb_valence_machine_native(
    context_symbols, num_symbols, num_faces, max_vertices,
    splits, sf_prob_zero, sf_buf,
):
    lib = get_draco_lib()
    if lib is None:
        return None
    offs = [0]
    parts = []
    for arr in context_symbols:
        a = (
            np.zeros(0, np.uint32)
            if arr is None
            else np.ascontiguousarray(arr, np.uint32)
        )
        parts.append(a)
        offs.append(offs[-1] + len(a))
    ctx = np.concatenate(parts) if offs[-1] else np.zeros(1, np.uint32)
    ctx_off = np.asarray(offs, np.int64)
    ssrc = np.asarray([s.source_symbol_id for s in splits], np.int64)
    sid = np.asarray([s.split_symbol_id for s in splits], np.int64)
    sedge = np.asarray([s.source_edge for s in splits], np.uint8)
    if len(splits) == 0:
        ssrc = np.zeros(1, np.int64)
        sid = np.zeros(1, np.int64)
        sedge = np.zeros(1, np.uint8)
    opposite = np.empty(3 * num_faces, np.int32)
    vertex = np.empty(3 * num_faces, np.int32)
    vertex_corner = np.empty(max_vertices, np.int32)
    processed = np.empty(num_faces, np.int32)
    counts = np.zeros(4, np.int64)
    rc = lib.uvt_eb_valence_machine(
        np.ascontiguousarray(ctx), ctx_off, num_symbols, num_faces,
        max_vertices, ssrc, sid, sedge, len(splits),
        sf_prob_zero, _u8(sf_buf), len(sf_buf),
        opposite, vertex, vertex_corner, processed, counts,
    )
    if rc != 0:
        raise ValueError(f"native edgebreaker machine failed (rc={rc})")
    return opposite, vertex, vertex_corner, processed, counts


def seam_pass_native(opposite, num_faces, streams):
    """streams: list of (prob_zero, payload bytes) per attribute-data."""
    lib = get_draco_lib()
    if lib is None:
        return None
    n = len(streams)
    if n == 0:
        return []
    probs = np.asarray([s[0] for s in streams], np.uint32)
    offs = [0]
    for _, b in streams:
        offs.append(offs[-1] + len(b))
    bufs = np.frombuffer(b"".join(b for _, b in streams) or b"\x00", np.uint8)
    cap = 6 * num_faces
    out = np.empty(n * cap, np.int32)
    counts = np.zeros(n, np.int64)
    rc = lib.uvt_seam_pass(
        np.ascontiguousarray(opposite, np.int32), num_faces, n, probs,
        np.ascontiguousarray(bufs), np.asarray(offs, np.int64), out, counts,
    )
    if rc != 0:
        raise ValueError(f"native seam pass failed (rc={rc})")
    return [out[i * cap : i * cap + counts[i]].copy() for i in range(n)]


def attr_corner_table_native(
    opposite, vertex, vertex_corner, num_vertices, num_corners,
    seam_mask, vertex_on_seam,
):
    lib = get_draco_lib()
    if lib is None:
        return None
    c2v = np.empty(num_corners, np.int32)
    v2c = np.empty(num_corners, np.int32)
    nout = np.zeros(1, np.int64)
    rc = lib.uvt_attr_corner_table(
        np.ascontiguousarray(opposite, np.int32),
        np.ascontiguousarray(vertex, np.int32),
        np.ascontiguousarray(vertex_corner, np.int32),
        num_vertices, num_corners,
        np.ascontiguousarray(seam_mask, np.uint8),
        np.ascontiguousarray(vertex_on_seam, np.uint8),
        c2v, v2c, None, nout,
    )
    if rc != 0:
        raise ValueError(f"native attr corner table failed (rc={rc})")
    return c2v, v2c[: nout[0]]


def traverse_native(
    opposite, view_vertex, seam_mask, num_faces, num_view_vertices,
    corner_order,
):
    lib = get_draco_lib()
    if lib is None:
        return None
    v2d = np.empty(num_view_vertices, np.int32)
    d2c = np.empty(max(num_view_vertices, 1), np.int32)
    nout = np.zeros(1, np.int64)
    ptr_keep = _mask_ptr(seam_mask)
    rc = lib.uvt_traverse_depth_first(
        np.ascontiguousarray(opposite, np.int32),
        np.ascontiguousarray(view_vertex, np.int32),
        ptr_keep[0] if ptr_keep else None,
        num_faces, num_view_vertices,
        np.ascontiguousarray(corner_order, np.int32), len(corner_order),
        None, v2d, d2c, nout,
    )
    if rc != 0:
        raise ValueError(f"native traversal failed (rc={rc})")
    return v2d, d2c[: nout[0]]


def parallelogram_native(
    corr, nc, mn, mx, opposite, view_vertex, seam_mask, vertex_to_data,
    data_to_corner,
):
    lib = get_draco_lib()
    if lib is None:
        return None
    n = corr.size // nc
    out = np.empty(n * nc, np.int64)
    ptr_keep = _mask_ptr(seam_mask)
    rc = lib.uvt_decode_parallelogram(
        np.ascontiguousarray(corr.reshape(-1), np.int64), n, nc, mn, mx,
        np.ascontiguousarray(opposite, np.int32),
        np.ascontiguousarray(view_vertex, np.int32),
        ptr_keep[0] if ptr_keep else None,
        np.ascontiguousarray(vertex_to_data, np.int32),
        np.ascontiguousarray(data_to_corner, np.int32),
        out,
    )
    if rc != 0:
        raise ValueError(f"native parallelogram failed (rc={rc})")
    return out.reshape(n, nc)


def texcoords_native(
    corr, mn, mx, view_vertex, vertex_to_data, data_to_corner,
    positions, pos_data_of_corner, orientations,
):
    lib = get_draco_lib()
    if lib is None:
        return None
    n = corr.size // 2
    out = np.empty(n * 2, np.int64)
    ori = np.ascontiguousarray(orientations, np.uint8)
    if len(ori) == 0:
        ori = np.zeros(1, np.uint8)
    rc = lib.uvt_texcoords_predict(
        np.ascontiguousarray(corr.reshape(-1), np.int64), n, mn, mx,
        np.ascontiguousarray(view_vertex, np.int32),
        np.ascontiguousarray(vertex_to_data, np.int32),
        np.ascontiguousarray(data_to_corner, np.int32),
        np.ascontiguousarray(positions.reshape(-1), np.int64),
        np.ascontiguousarray(pos_data_of_corner, np.int32),
        ori, len(orientations), out,
    )
    if rc != 0:
        raise ValueError(f"native texcoords predictor failed (rc={rc})")
    return out.reshape(n, 2)


def normals_native(
    corr, max_quantized_value, center_value, opposite, view_vertex,
    seam_mask, data_to_corner, positions, pos_data_of_corner,
    flip_prob_zero, flip_buf,
):
    lib = get_draco_lib()
    if lib is None:
        return None
    n = corr.size // 2
    out = np.empty(n * 2, np.int64)
    ptr_keep = _mask_ptr(seam_mask)
    rc = lib.uvt_normals_predict(
        np.ascontiguousarray(corr.reshape(-1), np.int64), n,
        max_quantized_value, center_value,
        np.ascontiguousarray(opposite, np.int32),
        np.ascontiguousarray(view_vertex, np.int32),
        ptr_keep[0] if ptr_keep else None,
        np.ascontiguousarray(data_to_corner, np.int32),
        np.ascontiguousarray(positions.reshape(-1), np.int64),
        np.ascontiguousarray(pos_data_of_corner, np.int32),
        flip_prob_zero, _u8(flip_buf), len(flip_buf),
        len(opposite) // 3, None, out,
    )
    if rc != 0:
        raise ValueError(f"native normals predictor failed (rc={rc})")
    return out.reshape(n, 2)


# ---------------------------------------------------------------------------
# Encode-side wrappers (encoder.py hot loops)


def encoder_corner_table_native(faces: np.ndarray, num_positions: int):
    lib = get_draco_lib()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces.reshape(-1), np.int64)
    n = len(faces)
    opposite = np.empty(n, np.int32)
    corner_vertex = np.empty(n, np.int32)
    vertex_corner = np.empty(max(n, 1), np.int32)
    nv = lib.uvt_encoder_corner_table(
        faces, n // 3, num_positions, opposite, corner_vertex, vertex_corner
    )
    if nv < 0:
        raise ValueError(f"native encoder corner table failed ({nv})")
    return opposite, corner_vertex, vertex_corner[:nv]


def parallelogram_encode_native(
    values, nc, mn, mx, opposite, view_vertex, seam_mask, vertex_to_data,
    data_to_corner,
):
    lib = get_draco_lib()
    if lib is None:
        return None
    n = values.size // nc
    corr = np.empty(n * nc, np.int64)
    ptr_keep = _mask_ptr(seam_mask)
    rc = lib.uvt_parallelogram_encode(
        np.ascontiguousarray(values.reshape(-1), np.int64), n, nc, mn, mx,
        np.ascontiguousarray(opposite, np.int32),
        np.ascontiguousarray(view_vertex, np.int32),
        ptr_keep[0] if ptr_keep else None,
        np.ascontiguousarray(vertex_to_data, np.int32),
        np.ascontiguousarray(data_to_corner, np.int32),
        corr,
    )
    if rc != 0:
        raise ValueError("native parallelogram encode failed")
    return corr.reshape(n, nc)


def texcoords_encode_native(
    values, mn, mx, view_vertex, vertex_to_data, data_to_corner,
    positions, pos_data_of_corner,
):
    lib = get_draco_lib()
    if lib is None:
        return None
    n = values.size // 2
    corr = np.empty(n * 2, np.int64)
    orients = np.empty(max(n, 1), np.uint8)
    n_or = lib.uvt_texcoords_encode(
        np.ascontiguousarray(values.reshape(-1), np.int64), n, mn, mx,
        np.ascontiguousarray(view_vertex, np.int32),
        np.ascontiguousarray(vertex_to_data, np.int32),
        np.ascontiguousarray(data_to_corner, np.int32),
        np.ascontiguousarray(positions.reshape(-1), np.int64),
        np.ascontiguousarray(pos_data_of_corner, np.int32),
        corr, orients,
    )
    if n_or < 0:
        raise ValueError("native texcoords encode failed")
    return corr.reshape(n, 2), orients[:n_or]


def normals_encode_native(
    oct_coords, max_quantized_value, opposite, view_vertex, seam_mask,
    data_to_corner, positions, pos_data_of_corner,
    num_faces=0, vertex_to_data=None,
):
    """num_faces + vertex_to_data (the attr corner table's vertex→data
    map) enable the linear-pass face-normal accumulation; omitted, the
    per-vertex fan walk runs (bit-identical sums either way)."""
    lib = get_draco_lib()
    if lib is None:
        return None
    n = oct_coords.size // 2
    corr = np.empty(n * 2, np.int64)
    flips = np.empty(max(n, 1), np.uint8)
    ptr_keep = _mask_ptr(seam_mask)
    v2d_keep = None  # (ptr, arr): the arr ref keeps the copy alive
    if vertex_to_data is not None:
        arr = np.ascontiguousarray(vertex_to_data, np.int32)
        v2d_keep = (arr.ctypes.data_as(ctypes.c_void_p), arr)
    rc = lib.uvt_normals_encode(
        np.ascontiguousarray(oct_coords.reshape(-1), np.int64), n,
        max_quantized_value,
        np.ascontiguousarray(opposite, np.int32),
        np.ascontiguousarray(view_vertex, np.int32),
        ptr_keep[0] if ptr_keep else None,
        np.ascontiguousarray(data_to_corner, np.int32),
        np.ascontiguousarray(positions.reshape(-1), np.int64),
        np.ascontiguousarray(pos_data_of_corner, np.int32),
        corr, flips,
        int(num_faces),
        v2d_keep[0] if v2d_keep else None,
    )
    if rc != 0:
        raise ValueError("native normals encode failed")
    return corr.reshape(n, 2), flips[:n]


def quantize_normals_native(normals: np.ndarray, bits: int):
    lib = get_draco_lib()
    if lib is None:
        return None
    n = len(normals)
    out = np.empty(n * 2, np.int64)
    rc = lib.uvt_quantize_normals(
        np.ascontiguousarray(normals, np.float64), n, bits, out
    )
    if rc != 0:
        raise ValueError("native quantize normals failed")
    return out.reshape(n, 2)


def eb_replay_machine_native(
    symbols_decode_order, num_faces, max_vertices, splits, sf_bits,
):
    lib = get_draco_lib()
    if lib is None:
        return None
    syms = np.ascontiguousarray(symbols_decode_order, np.uint8)
    num_symbols = len(syms)
    ssrc = np.asarray([s.source_symbol_id for s in splits] or [0], np.int64)
    sid = np.asarray([s.split_symbol_id for s in splits] or [0], np.int64)
    sedge = np.asarray([s.source_edge for s in splits] or [0], np.uint8)
    sfb = np.ascontiguousarray(sf_bits, np.uint8)
    if len(sfb) == 0:
        sfb = np.zeros(1, np.uint8)
    opposite = np.empty(3 * num_faces, np.int32)
    vertex = np.empty(3 * num_faces, np.int32)
    vertex_corner = np.empty(max_vertices, np.int32)
    processed = np.empty(num_faces, np.int32)
    contexts = np.empty(max(num_symbols, 1), np.int32)
    counts = np.zeros(4, np.int64)
    rc = lib.uvt_eb_replay_machine(
        syms, num_symbols, num_faces, max_vertices,
        ssrc, sid, sedge, len(splits),
        sfb, len(sf_bits),
        opposite, vertex, vertex_corner, processed, contexts, counts,
    )
    if rc != 0:
        raise ValueError(f"native replay machine failed (rc={rc})")
    return opposite, vertex, vertex_corner, processed, contexts, counts


def rabs_encode_bits_native(bits, prob_zero: int):
    lib = get_draco_lib()
    if lib is None:
        return None
    b = np.ascontiguousarray(bits, np.uint8)
    out = np.empty(len(b) + 1024, np.uint8)
    n = lib.uvt_rabs_encode_bits(b, len(b), prob_zero, out, len(out))
    if n < 0:
        return None
    return out[:n].tobytes()


def point_assembly_native(keys: np.ndarray, value_counts):
    """Corner-key rows -> (point_of_corner, num_points), first-appearance
    numbering. `value_counts[a]` bounds column a's values (bit width source).
    Returns None when unavailable or keys overflow 63 packed bits."""
    lib = get_draco_lib()
    if lib is None:
        return None
    k = np.ascontiguousarray(keys, np.int32)
    widths = np.asarray(
        [max(int(n - 1).bit_length(), 1) for n in value_counts], np.int32
    )
    out = np.empty(len(k), np.int32)
    n = lib.uvt_point_assembly(k, len(k), k.shape[1], widths, out)
    if n < 0:
        return None
    return out, int(n)


def eb_traverse_native(vertex, opposite, hole_of, num_faces, num_vertices,
                       num_holes):
    """Encoder-side Edgebreaker DFS. Returns (symbols u8, symbol_corners
    i32, start_face_bits u8, (split_src, split_id, split_edge),
    init_face_corners i32, interior_start_corners i32, n_split_symbols)
    or None."""
    lib = get_draco_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertex, np.int32)
    o = np.ascontiguousarray(opposite, np.int32)
    h = np.ascontiguousarray(hole_of, np.int64)
    f = int(num_faces)
    symbols = np.empty(max(f, 1), np.uint8)
    corners = np.empty(max(f, 1), np.int32)
    sf_bits = np.empty(max(f, 1), np.uint8)
    s_src = np.empty(max(f, 1), np.int64)
    s_id = np.empty(max(f, 1), np.int64)
    s_edge = np.empty(max(f, 1), np.uint8)
    initc = np.empty(max(f, 1), np.int32)
    starts = np.empty(max(f, 1), np.int32)
    cnt = np.zeros(5, np.int64)
    rc = lib.uvt_eb_traverse(
        v, o, h, f, int(num_vertices), int(num_holes),
        symbols, corners, sf_bits, s_src, s_id, s_edge, initc, starts, cnt,
    )
    if rc != 0:
        return None
    ns, nb, nsp, ni = int(cnt[0]), int(cnt[1]), int(cnt[2]), int(cnt[3])
    return (
        symbols[:ns], corners[:ns], sf_bits[:nb],
        (s_src[:nsp], s_id[:nsp], s_edge[:nsp]),
        initc[:ni], starts[:ni], int(cnt[4]),
    )


def eb_encode_maps_native(
    num_faces: int,
    num_symbols: int,
    symbol_corners_rev: np.ndarray,
    dvert: np.ndarray,
    enc_vertex: np.ndarray,
    enc_opposite: np.ndarray,
    opp_d: np.ndarray,
    interior_start_corners: np.ndarray,
    c2v_list,
    num_vertex_slots: int,
):
    """Encoder dec<->enc corner maps + per-attribute seam bits in one C
    pass (encoder.py's maps+seams region). Returns (dec2enc int64[3F],
    cs int64[n_edges], bits list[u8[n_edges]], pairs list[i64],
    boundary int64[n_b]) or None when the lib is unavailable. Raises
    AssertionError for the same inconsistency conditions the Python
    region asserts."""
    lib = get_draco_lib()
    if lib is None:
        return None
    n = 3 * num_faces
    na = len(c2v_list)
    c2v_all = (
        np.ascontiguousarray(np.stack(c2v_list)).astype(np.int64)
        if na
        else np.zeros((0, n), np.int64)
    )
    dec2enc = np.empty(n, np.int64)
    cs = np.empty(n, np.int64)
    bits = np.empty((max(na, 1), n), np.uint8)
    pairs = np.empty((max(na, 1), 2 * n), np.int64)
    boundary = np.empty(n, np.int64)
    counts = np.zeros(2 + max(na, 1), np.int64)
    rc = lib.uvt_eb_encode_maps(
        num_faces, num_symbols, num_vertex_slots,
        np.ascontiguousarray(symbol_corners_rev, np.int64),
        np.ascontiguousarray(dvert, np.int32),
        np.ascontiguousarray(enc_vertex, np.int32),
        np.ascontiguousarray(enc_opposite, np.int32),
        np.ascontiguousarray(opp_d, np.int32),
        np.ascontiguousarray(interior_start_corners, np.int64),
        na, c2v_all.reshape(-1),
        dec2enc, cs, bits.reshape(-1), pairs.reshape(-1), boundary, counts,
    )
    if rc == -2:
        raise AssertionError("inconsistent vertex correspondence")
    if rc == -3:
        raise AssertionError("init face vertex unmapped")
    if rc in (-4, -5):
        raise AssertionError("incomplete corner correspondence")
    if rc != 0:
        return None
    n_edges, n_b = int(counts[0]), int(counts[1])
    bit_list = [bits[a, :n_edges].copy() for a in range(na)]
    pair_list = [
        pairs[a, : int(counts[2 + a])].copy() for a in range(na)
    ]
    return dec2enc, cs[:n_edges].copy(), bit_list, pair_list, boundary[:n_b].copy()


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
