"""Loader for the native H.264 intra slice codec (h264_native.cpp).

Bit-identical fast path for codecs/h264.py — the Python SliceCoder
(codecs/h264_intra.py) stays as oracle and fallback; parity is locked by
tests/test_h264_intra.py. ~100x faster per slice on 1024² frames, which
is what makes the compressed V1 texture track usable at the reference's
real frame sizes.

The port's copy of `uvol_tpu/native/h264c.py`: the same ctypes bindings
and wrappers, over a library that the port's `native.build` compiles
into `build/uvol_tpu_torch/` (named after the hash of the source and its
`h264_tables.inc`, written under a temporary name and moved into place)
instead of the package directory. As for the port's other libraries, a
failed build is not remembered. `UVT_DISABLE_NATIVE_H264=1` turns the
library off, checked on every call, so a test can take the Python path
after the library was loaded.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

_lib = None
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    vp = ctypes.c_void_p  # nullable plane pointers (prev/recon)
    ci = ctypes.c_int
    lib.uvt_h264_decode_slice.argtypes = [
        u8p, ctypes.c_long, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,
        vp, vp, vp, u8p, u8p, u8p,
    ]
    lib.uvt_h264_decode_slice.restype = ci
    lib.uvt_yuv420_to_rgb.argtypes = [u8p, u8p, u8p, ci, ci, u8p]
    lib.uvt_yuv420_to_rgb.restype = None
    lib.uvt_h264_encode_slice_motion.argtypes = [
        u8p, u8p, u8p, ci, ci, ci, ci,
        vp, vp, vp, ci, ctypes.c_double, vp, vp, vp,
        u8p, ctypes.c_long,
    ]
    lib.uvt_h264_encode_slice_motion.restype = ctypes.c_long
    lib.uvt_h264_encode_slice.argtypes = [
        u8p, u8p, u8p, ci, ci, ci, ci, ci,
        vp, vp, vp, ci, ctypes.c_double, vp, vp, vp,
        u8p, ctypes.c_long,
    ]
    lib.uvt_h264_encode_slice.restype = ctypes.c_long


def get_h264_lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library once per process; None when
    `UVT_DISABLE_NATIVE_H264=1` or when it cannot be built (tried again
    on the next call)."""
    global _lib
    if os.environ.get("UVT_DISABLE_NATIVE_H264") == "1":
        return None
    if _lib is not None:
        return _lib
    from uvol_tpu_torch.native import H264_HEADERS, H264_SOURCES, build

    with _lock:
        if _lib is None:
            so = build(H264_SOURCES, "h264", headers=H264_HEADERS)
            if so is None:
                return None
            lib = ctypes.CDLL(str(so))
            _bind(lib)
            _lib = lib
        return _lib


def _vp(arr):
    import ctypes as _c

    if arr is None:
        return None
    return arr.ctypes.data_as(_c.c_void_p)


def encode_slice_native(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
    qp: int, pcm_from_mby: int, idr_pic_id: int,
    want_recon: bool = False,
):
    """Whole IDR slice RBSP (header + MBs + trailing). None → fallback.
    want_recon=True returns (rbsp, (ry, rcb, rcr)) — the encoder's own
    reconstruction, i.e. the reference for a following P slice."""
    lib = get_h264_lib()
    if lib is None:
        return None
    h, w = y.shape
    cap = w * h * 2 + (w * h * 3) // 2 + 4096
    out = np.empty(cap, np.uint8)
    ry = rcb = rcr = None
    if want_recon:
        ry = np.empty((h, w), np.uint8)
        rcb = np.empty((h // 2, w // 2), np.uint8)
        rcr = np.empty((h // 2, w // 2), np.uint8)
    rc = lib.uvt_h264_encode_slice(
        np.ascontiguousarray(y), np.ascontiguousarray(cb),
        np.ascontiguousarray(cr), w, h, qp, pcm_from_mby, idr_pic_id,
        None, None, None, 0, 0.0, _vp(ry), _vp(rcb), _vp(rcr),
        out, cap,
    )
    if rc < 0:
        return None
    if want_recon:
        return bytes(out[:rc]), (ry, rcb, rcr)
    return bytes(out[:rc])


def encode_p_slice_native(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
    prev,  # (prev_y, prev_cb, prev_cr) reconstructed reference planes
    qp: int, pcm_from_mby: int, frame_num: int, skip_thresh: float,
):
    """Whole P slice RBSP + recon planes; None → Python fallback."""
    lib = get_h264_lib()
    if lib is None:
        return None
    h, w = y.shape
    cap = w * h * 2 + (w * h * 3) // 2 + 4096
    out = np.empty(cap, np.uint8)
    prev_y = np.ascontiguousarray(prev[0])
    prev_cb = np.ascontiguousarray(prev[1])
    prev_cr = np.ascontiguousarray(prev[2])
    ry = np.empty((h, w), np.uint8)
    rcb = np.empty((h // 2, w // 2), np.uint8)
    rcr = np.empty((h // 2, w // 2), np.uint8)
    rc = lib.uvt_h264_encode_slice(
        np.ascontiguousarray(y), np.ascontiguousarray(cb),
        np.ascontiguousarray(cr), w, h, qp, pcm_from_mby, 0,
        _vp(prev_y), _vp(prev_cb), _vp(prev_cr),
        frame_num, float(skip_thresh), _vp(ry), _vp(rcb), _vp(rcr),
        out, cap,
    )
    if rc < 0:
        return None
    return bytes(out[:rc]), (ry, rcb, rcr)


def native_motion_available() -> bool:
    """True when the native motion-compensated P coder is built —
    encode_annexb(motion=None) auto-selects on this (the Python
    reference coder runs ~40 s/frame at 1024^2)."""
    return get_h264_lib() is not None


def encode_p_slice_motion_native(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
    prev, qp: int, pcm_from_mby: int, frame_num: int, skip_thresh: float,
):
    """Whole MOTION-COMPENSATED P slice RBSP + recon planes; None →
    Python fallback. Bit-identical native mirror of the round-4 inter
    coder (coarse+refine integer search, P_L0_16x16 with spec MV
    prediction, P_Skip with the derived skip MV, trial-encode RD over
    skip/inter/I16/I4 — codecs/h264.py:encode_p_planes(motion=True));
    parity locked by tests/test_h264_inter.py."""
    lib = get_h264_lib()
    if lib is None:
        return None
    h, w = y.shape
    cap = w * h * 2 + (w * h * 3) // 2 + 4096
    out = np.empty(cap, np.uint8)
    prev_y = np.ascontiguousarray(prev[0])
    prev_cb = np.ascontiguousarray(prev[1])
    prev_cr = np.ascontiguousarray(prev[2])
    ry = np.empty((h, w), np.uint8)
    rcb = np.empty((h // 2, w // 2), np.uint8)
    rcr = np.empty((h // 2, w // 2), np.uint8)
    rc = lib.uvt_h264_encode_slice_motion(
        np.ascontiguousarray(y), np.ascontiguousarray(cb),
        np.ascontiguousarray(cr), w, h, qp, pcm_from_mby,
        _vp(prev_y), _vp(prev_cb), _vp(prev_cr),
        frame_num, float(skip_thresh), _vp(ry), _vp(rcb), _vp(rcr),
        out, cap,
    )
    if rc < 0:
        return None
    return bytes(out[:rc]), (ry, rcb, rcr)


def decode_slice_native(
    rbsp: bytes, sps, pps, idr: bool, prev=None, nal_ref_idc: int = 3
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """One I slice RBSP → (y, cb, cr) planes; None → Python fallback.

    Raises the same error classes the Python decoder raises for
    unsupported-but-parsed shapes (deblocking on)."""
    lib = get_h264_lib()
    if lib is None:
        return None

    cw = sps.coded_width or sps.width
    ch = sps.coded_height or sps.height
    y = np.zeros((ch, cw), np.uint8)
    cb = np.zeros((ch // 2, cw // 2), np.uint8)
    cr = np.zeros((ch // 2, cw // 2), np.uint8)
    data = np.frombuffer(rbsp, np.uint8)
    if prev is not None:
        prev = tuple(np.ascontiguousarray(p) for p in prev)
    rc = lib.uvt_h264_decode_slice(
        data, len(data), cw, ch, sps.log2_max_frame_num, sps.poc_type,
        sps.log2_max_poc_lsb, pps.pic_init_qp, pps.chroma_qp_offset,
        1 if pps.deblocking_control_present else 0,
        1 if pps.bottom_field_poc_present else 0,
        1 if pps.redundant_pic_cnt_present else 0,
        1 if idr else 0, nal_ref_idc,
        _vp(prev[0]) if prev is not None else None,
        _vp(prev[1]) if prev is not None else None,
        _vp(prev[2]) if prev is not None else None,
        y, cb, cr,
    )
    if rc == -3:
        raise NotImplementedError(
            "h264: deblocking enabled (encode with the filter off)"
        )
    if rc == -2:
        return None  # shape the native path doesn't handle → Python
    if rc != 0:
        raise ValueError("h264: invalid or truncated slice data")
    return y, cb, cr


def yuv420_to_rgb_native(y, cb, cr):
    """[H,W]+[H/2,W/2]x2 uint8 planes -> [H,W,3] RGB; None -> numpy
    fallback (codecs/h264.py:_yuv420_to_rgb_numpy is the oracle)."""
    lib = get_h264_lib()
    if lib is None:
        return None
    h, w = y.shape
    if h % 2 or w % 2 or cb.shape != (h // 2, w // 2) or cb.shape != cr.shape:
        return None
    out = np.empty((h, w, 3), np.uint8)
    lib.uvt_yuv420_to_rgb(
        np.ascontiguousarray(y), np.ascontiguousarray(cb),
        np.ascontiguousarray(cr), w, h, out.reshape(-1),
    )
    return out
