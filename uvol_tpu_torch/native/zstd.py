"""Zstandard bindings over the system libzstd (ctypes).

Replaces the reference's vendored zstddec.module.js (inline-base64 WASM,
consumed at src/lib/KTX2Loader.js:799-823 for Zstd-supercompressed KTX2
levels). Zstd stays on the host per SURVEY §7 hard part (e); device work
overlaps with it in the prefetch pools.

The port's copy of the reference's `native/zstd.py` (compress and
decompress).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_lib: Optional[ctypes.CDLL] = None


def _zstd() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        lib = ctypes.CDLL(name)
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t
        ]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t
        ]
        _lib = lib
    return _lib


def compress(data: bytes, level: int = 3) -> bytes:
    lib = _zstd()
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(out, bound, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise ValueError("zstd compression failed")
    return out.raw[:n]


def decompress(data: bytes, expected_size: Optional[int] = None) -> bytes:
    lib = _zstd()
    if expected_size is None:
        size = lib.ZSTD_getFrameContentSize(data, len(data))
        if size in (2**64 - 1, 2**64 - 2):  # ERROR / UNKNOWN
            raise ValueError("zstd frame content size unknown")
        expected_size = int(size)
    out = ctypes.create_string_buffer(expected_size)
    n = lib.ZSTD_decompress(out, expected_size, data, len(data))
    if lib.ZSTD_isError(n):
        raise ValueError("zstd decompression failed")
    return out.raw[:n]
