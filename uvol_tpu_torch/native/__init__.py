"""Native host loops of the port (C++, ctypes) — counterpart of
`uvol_tpu/native/__init__.py`, cut to what the port calls.

`entropy.cpp` (the Draco-layout rANS coder) and `etc1s_native.cpp` (the
ETC1S slice emission, slice decode, palette decode and Huffman table
parse) are copies of the reference's sources. g++ builds both into one
library at first use, with the reference's flags (`-O3
-ffp-contract=off`: the loops are bit-exact against the Python paths),
into `build/uvol_tpu_torch/` at the repo root. The library is named
after the hash of its sources and flags and is written under a name of
its own process and thread, then moved into place with `os.replace`, so
concurrent builds never load or overwrite a partial file.

A failed build is not remembered: `get_lib()` returns None, the callers
take their Python paths (identical bytes, slower), and the next call
tries again. Without g++ on PATH it returns None at once. Every wrapper
below returns None where the library is unavailable, as the reference's
do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "entropy.cpp", _HERE / "etc1s_native.cpp")
BUILD_DIR = _HERE.parents[1] / "build" / "uvol_tpu_torch"
GXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libuvol_tpu_torch_host_{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the sources if the library for their hash is missing;
    returns its path, or None when g++ is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)],
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
