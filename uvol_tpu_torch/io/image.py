"""PNG input for the encoder CLI, with zlib and numpy only.

The reference CLI reads its images with Pillow (`encoder_cli.load_image`:
`np.asarray(Image.open(path).convert("RGB"))`). The port reads PNG itself,
so it needs no Pillow, and returns the same array: [H, W, 3] uint8.

Read: 8-bit gray, gray + alpha, RGB and RGBA; palette images at 1, 2, 4
and 8 bits a pixel; non-interlaced; the five row filters. Alpha and a
`tRNS` chunk are dropped, as `convert("RGB")` drops them. Anything else
(16-bit samples, gray below 8 bits, Adam7 interlace, another file
format) raises `ValueError` naming what it met.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: color type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (only PNG input is read)")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before its IEND chunk")


def _header(ihdr: bytes) -> Tuple[int, int, int, int, int]:
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    return w, h, depth, ctype, interlace


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) from the IHDR chunk, as `Image.open(path).size`."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file starting with IHDR")
    w, h = struct.unpack(">II", head[16:24])
    return w, h


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[H, 1 + stride] filtered scanlines -> [H, stride] uint8 bytes."""
    ftype = rows[:, 0]
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} is not one of 0-4")
    filt = rows[:, 1:].astype(np.int32)
    h, stride = filt.shape
    # out[y + 1, x + bpp] is the reconstructed byte (y, x); row 0 and the first
    # bpp columns are the zeros the filters take outside the image
    out = np.zeros((h + 1, stride + bpp), np.int32)
    if not np.isin(ftype, (3, 4)).any():  # None, Sub, Up: whole rows at once
        for y in range(h):
            row = filt[y]
            if ftype[y] == 2:
                row = row + out[y, bpp:]
            elif ftype[y] == 1:  # a running sum in each of the bpp lanes
                pad = (-stride) % bpp
                lanes = np.concatenate([row, np.zeros(pad, np.int32)]).reshape(-1, bpp)
                row = np.cumsum(lanes, axis=0).reshape(-1)[:stride]
            out[y + 1, bpp:] = row & 0xFF
        return out[1:, bpp:].astype(np.uint8)
    # Average and Paeth read the reconstructed left neighbour: sweep the
    # anti-diagonals of (row, pixel), whose pixels depend only on earlier ones
    npix = -(-stride // bpp)
    for d in range(h + npix - 1):
        y = np.arange(max(0, d - npix + 1), min(h, d + 1))
        x0 = (d - y) * bpp
        x = (x0[:, None] + np.arange(bpp)[None, :]).reshape(-1)
        yy = np.repeat(y, bpp)
        keep = x < stride
        x, yy = x[keep], yy[keep]
        f = filt[yy, x]
        a = out[yy + 1, x]  # left: column x - bpp, shifted by bpp
        b = out[yy, x + bpp]  # up
        c = out[yy, x]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[yy]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[yy + 1, x + bpp] = (f + pred) & 0xFF
    return out[1:, bpp:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """A PNG file -> [H, W, 3] uint8 RGB, what Pillow's
    `np.asarray(Image.open(path).convert("RGB"))` gives for it."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = _header(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, ctype, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG color type {ctype} is not a valid one")
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG is not read (write it non-interlaced)")
    if ctype == 3:
        if depth not in (1, 2, 4, 8):
            raise ValueError(f"{path}: palette PNG at {depth} bits a pixel")
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    elif depth != 8:
        raise ValueError(f"{path}: {depth}-bit samples (color type {ctype}) are not read; "
                         "only 8-bit samples are")
    nch = _CHANNELS[ctype]
    stride = (w * nch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, "
                         f"{h} rows need {h * (stride + 1)}")
    rows = _unfilter(raw[:h * (stride + 1)].reshape(h, stride + 1), max(1, nch * depth // 8))
    if ctype == 3:
        if depth < 8:
            bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
            idx = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1)
        else:
            idx = rows
        # indices past the palette read as black, as Pillow's padded palette does
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[idx]
    px = rows.reshape(h, w, nch)
    if nch <= 2:  # gray, gray + alpha
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
