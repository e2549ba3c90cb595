"""Frame-sequence codecs (PyTorch) — counterpart of `uvol_tpu/models/sequence.py`.

  - GeometrySequenceCodec: [F, N, 3/2] attribute batches → quantize →
    delta → zigzag on the device in the planar [F, C, N] layout, rANS
    per frame on the host, `.uvtg` framing. Decode runs host rANS, then
    cumsum → dequantize on the device. The device stages are plain torch
    ops, as the reference's are plain XLA ops.
  - TextureSequenceCodec: [L, H, W, 3] uint8 layers → ETC1 words
    (`etc_cuda`: the CUDA kernels on a card, the plain twins on the CPU)
    → one KTX2 segment (ETC2 RGB, vk_format 147), and back.

Wire bytes are identical to the reference codecs'. The host layers
(rANS symbol coding, buffers, KTX2, zstd) are the reference package's
own jax-free modules. Multi-device (`mesh=`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from uvol_tpu.codecs.buffer import DecoderBuffer, EncoderBuffer
from uvol_tpu.codecs.symbol_coding import decode_symbols, encode_symbols
from uvol_tpu.containers.ktx2 import (  # read_ktx2: the decode side's reader
    SUPERCOMPRESSION_NONE,
    SUPERCOMPRESSION_ZSTD,
    KTX2File,
    KTX2Header,
    KTX2Level,
    read_ktx2,  # noqa: F401
    write_ktx2,
)
from uvol_tpu_torch._device import DeviceLike, resolve_device, synchronize, true_div
from uvol_tpu_torch.codecs.basis.etc import pack_etc1_payload, unpack_etc1_payload
from uvol_tpu_torch.codecs.basis.etc_cuda import (
    decode_etc1_images,
    encode_etc1_images,
    pack_words2,
    unpack_words2,
)
from uvol_tpu_torch.ops.prediction import delta_decode, delta_encode
from uvol_tpu_torch.ops.quantize import (
    compute_quantization_transform,
    dequantize_scaled,
    symbols_from_numpy,
    symbols_to_numpy,
    zigzag_decode,
    zigzag_encode,
)

Tensor = torch.Tensor

#: magic of the geometry frame format ("UVTG" = uvol-tpu geom)
UVTG_MAGIC = b"UVTG"
VK_FORMAT_ETC2_R8G8B8_UNORM_BLOCK = 147


@dataclasses.dataclass
class GeometryFrameSet:
    """Padded batch of frames plus per-frame validity counts."""

    positions: Any  # [F, N, 3] float32 numpy (or planar [F, 3, N] tensor)
    uvs: Optional[Any]  # [F, N, 2]
    counts: np.ndarray  # [F] valid vertex count per frame
    faces: List[np.ndarray]  # per-frame [Mf, 3] int32


def bucket_frames_by_count(counts, max_waste: float = 0.25):
    """Group frame indices into padding buckets for ragged sequences.

    Copy of `uvol_tpu.parallel.mesh.bucket_frames_by_count` for one
    device (`mesh_size=1`): frames are sorted by count and cut greedily
    so each bucket's padded waste (1 - sum(counts)/(len*max)) stays
    under `max_waste`."""
    counts = np.asarray(counts, np.int64)
    order = np.argsort(counts, kind="stable")
    buckets = []
    start = 0
    n = len(order)
    while start < n:
        end = start + 1
        total = int(counts[order[start]])
        while end < n:
            c = int(counts[order[end]])
            new_total = total + c
            # order is count-sorted, so c IS the running max
            waste = 1.0 - new_total / ((end - start + 1) * max(c, 1))
            if waste > max_waste:
                break
            total = new_total
            end += 1
        buckets.append(order[start:end])
        start = end
    return buckets


def _syms(xt: Tensor, bits: int, mask: Tensor):
    """Quantize + delta + zigzag in the planar [F, C, N] layout; returns
    (syms [F, C, N] int32 bit patterns, min [F, C], range [F]).

    The rounding step is the reference codec's own, `floor(x * (max_q /
    range) + 0.5)` with no clip, which differs in float32 from
    `ops.quantize.quantize`'s `x * (1 / (range / max_q))`; the min/range,
    delta and zigzag are the `ops` functions."""
    mn, rng = compute_quantization_transform(xt.transpose(1, 2), mask)
    inv = true_div(float((1 << bits) - 1), rng)
    xm = torch.where(mask[:, None, :], xt - mn[..., None], 0.0)
    q = torch.floor(xm * inv[:, None, None] + 0.5).to(torch.int32)
    return zigzag_encode(delta_encode(q, dim=-1)), mn, rng


def encode_device(pos: Tensor, uv: Optional[Tensor], mask: Tensor,
                  position_bits: int, uv_bits: int) -> Dict[str, Tensor]:
    """Device encode stage: planar pos [F, 3, N], uv [F, 2, N], mask [F, N]."""
    pos_syms, pmin, prng = _syms(pos, position_bits, mask)
    out = {"pos_syms": pos_syms, "pos_min": pmin, "pos_range": prng}
    if uv is not None:
        uv_syms, umin, urng = _syms(uv, uv_bits, mask)
        out.update(uv_syms=uv_syms, uv_min=umin, uv_range=urng)
    return out


def _dequantize_planar(syms: Tensor, mn: Tensor, scale: Tensor) -> Tensor:
    q = delta_decode(zigzag_decode(syms), torch.int32, dim=-1)  # [F, C, N]
    return dequantize_scaled(q.transpose(1, 2), mn, scale).transpose(1, 2).contiguous()


def decode_device(pos_syms: Tensor, pos_min: Tensor, pos_scale: Tensor,
                  uv_syms: Tensor, uv_min: Tensor, uv_scale: Tensor):
    """Device decode stage: planar syms [F, C, N] → cumsum (int32) →
    min + q * scale, per frame. Outputs stay planar [F, C, N]."""
    return (_dequantize_planar(pos_syms, pos_min, pos_scale),
            _dequantize_planar(uv_syms, uv_min, uv_scale))


def host_rans_is_native() -> bool:
    """Whether the host rANS runs in the compiled library (built with g++
    at first use); otherwise it runs in Python, slower but identical."""
    from uvol_tpu.native import get_lib

    return get_lib() is not None


def _fan_out(fn, items, f: int):
    """Per-frame host work over up to 8 threads (the native rANS loops
    release the GIL), as the reference does."""
    if f > 1:
        with ThreadPoolExecutor(min(8, f)) as pool:
            return list(pool.map(fn, items))
    return [fn(x) for x in items]


class GeometrySequenceCodec:
    """Batched quantize + delta + entropy codec for mesh attribute sequences.

    `device`: where the device stages run (see `resolve_device`)."""

    def __init__(self, position_bits: int = 11, uv_bits: int = 10, *,
                 device: DeviceLike = None):
        self.position_bits = position_bits
        self.uv_bits = uv_bits
        self.device = resolve_device(device)

    def _to_dev(self, a: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- encode --------------------------------------------------------------
    def encode(self, frames: GeometryFrameSet) -> List[bytes]:
        """Returns one `.uvtg` blob per frame (device batch + host entropy)."""
        f, n, _ = frames.positions.shape
        mask = np.arange(n)[None, :] < np.asarray(frames.counts)[:, None]
        def planar(a):  # [F, N, C] → the device stage's planar [F, C, N] f32
            return self._to_dev(np.asarray(a, np.float32).transpose(0, 2, 1))

        dev = encode_device(
            planar(frames.positions),
            planar(frames.uvs) if frames.uvs is not None else None,
            self._to_dev(mask),
            self.position_bits, self.uv_bits,
        )
        host = {
            k: symbols_to_numpy(v) if k.endswith("_syms") else v.cpu().numpy()
            for k, v in dev.items()
        }
        return _fan_out(lambda i: self._frame_blob(frames, host, i), range(f), f)

    def _frame_blob(self, frames: GeometryFrameSet, dev, i: int) -> bytes:
        count = int(frames.counts[i])
        out = EncoderBuffer()
        out.raw(UVTG_MAGIC)
        out.u8(1)  # version
        out.u8(self.position_bits)
        out.u8(self.uv_bits if frames.uvs is not None else 0)
        out.varint(count)
        faces = frames.faces[i]
        out.varint(len(faces))
        for c in range(3):
            out.f32(float(dev["pos_min"][i, c]))
        out.f32(float(dev["pos_range"][i]))
        encode_symbols(
            np.ascontiguousarray(dev["pos_syms"][i][:, :count].T).reshape(-1), 3, out
        )
        if frames.uvs is not None:
            for c in range(2):
                out.f32(float(dev["uv_min"][i, c]))
            out.f32(float(dev["uv_range"][i]))
            encode_symbols(
                np.ascontiguousarray(dev["uv_syms"][i][:, :count].T).reshape(-1),
                2, out,
            )
        # connectivity: delta + zigzag coded indices (host)
        flat = faces.reshape(-1).astype(np.int64)
        deltas = np.diff(flat, prepend=0)
        syms = np.where(deltas >= 0, deltas * 2, -deltas * 2 - 1).astype(np.uint32)
        encode_symbols(syms, 1, out)
        return out.getvalue()

    def encode_bucketed(self, positions, uvs, faces, *,
                        max_waste: float = 0.25) -> List[bytes]:
        """Ragged-sequence encode: frames of differing vertex counts are
        bucketed so each device batch pads to its own max count. Blobs
        come back in input order, byte-identical to any other batching
        (quantization is per frame)."""
        counts = np.array([len(p) for p in positions], np.int64)
        out: List[Optional[bytes]] = [None] * len(counts)
        for idx in bucket_frames_by_count(counts, max_waste):
            nmax = int(counts[idx].max())
            pos = np.zeros((len(idx), nmax, 3), np.float32)
            uv = np.zeros((len(idx), nmax, 2), np.float32) if uvs is not None else None
            for j, i in enumerate(idx):
                pos[j, : counts[i]] = positions[i]
                if uv is not None:
                    uv[j, : counts[i]] = uvs[i]
            fs = GeometryFrameSet(
                pos, uv, counts[idx], [np.asarray(faces[i], np.int32) for i in idx]
            )
            for j, blob in enumerate(self.encode(fs)):
                out[int(idx[j])] = blob
        return out  # type: ignore[return-value]

    # -- decode --------------------------------------------------------------
    @staticmethod
    def _frame_parse(blob: bytes):
        buf = DecoderBuffer(blob)
        if buf.raw(4) != UVTG_MAGIC:
            raise ValueError("not a UVTG frame")
        _ver = buf.u8()
        pbits = buf.u8()
        ubits = buf.u8()
        count = buf.varint()
        nfaces = buf.varint()
        pmin = [buf.f32() for _ in range(3)]
        prange = buf.f32()
        ps = decode_symbols(count * 3, 3, buf).reshape(count, 3)
        meta = dict(pmin=pmin, prange=prange, pbits=pbits, ubits=ubits)
        us = None
        if ubits:
            umin = [buf.f32() for _ in range(2)]
            urange = buf.f32()
            us = decode_symbols(count * 2, 2, buf).reshape(count, 2)
            meta.update(umin=umin, urange=urange)
        idx_syms = decode_symbols(nfaces * 3, 1, buf)
        signed = np.where(idx_syms % 2 == 0, idx_syms // 2, -((idx_syms + 1) // 2))
        flat = np.cumsum(signed)
        return count, ps, us, meta, flat.reshape(nfaces, 3).astype(np.int32)

    def decode(self, blobs: Sequence[bytes], *, as_numpy: bool = True
               ) -> GeometryFrameSet:
        """`as_numpy=False` leaves the decoded attributes on the device as
        planar [F, C, N] tensors (after the device has finished)."""
        f = len(blobs)
        parsed = _fan_out(self._frame_parse, blobs, f)
        counts = np.array([p[0] for p in parsed], np.int64)
        max_n = int(counts.max()) if f else 0
        # planar [F, C, N] upload (the device stage's contract)
        pos_batch = np.zeros((f, 3, max_n), np.uint32)
        uv_batch = np.zeros((f, 2, max_n), np.uint32)
        pmin = np.zeros((f, 3), np.float32)
        pscale = np.zeros(f, np.float32)
        umin = np.zeros((f, 2), np.float32)
        uscale = np.zeros(f, np.float32)
        any_uv = False
        for i, (count, ps, us, meta, _faces) in enumerate(parsed):
            pos_batch[i, :, :count] = ps.T
            pmin[i] = meta["pmin"]
            pscale[i] = meta["prange"] / ((1 << meta["pbits"]) - 1)
            if us is not None:
                any_uv = True
                uv_batch[i, :, :count] = us.T
                umin[i] = meta["umin"]
                uscale[i] = meta["urange"] / ((1 << meta["ubits"]) - 1)
        pos, uv = decode_device(
            symbols_from_numpy(pos_batch, self.device), self._to_dev(pmin),
            self._to_dev(pscale), symbols_from_numpy(uv_batch, self.device),
            self._to_dev(umin), self._to_dev(uscale),
        )
        if not any_uv:
            uv = None  # UV-less streams: honor the Optional contract
        if as_numpy:
            # host boundary converts back to per-vertex [F, N, C] rows
            pos = np.ascontiguousarray(pos.cpu().numpy().transpose(0, 2, 1))
            uv = (np.ascontiguousarray(uv.cpu().numpy().transpose(0, 2, 1))
                  if uv is not None else None)
        else:
            synchronize(self.device)
        return GeometryFrameSet(positions=pos, uvs=uv, counts=counts,
                                faces=[p[4] for p in parsed])


class TextureSequenceCodec:
    """ETC1/ETC2 block encode + KTX2 batching of `sequence_size` layers.

    `supercompression="zstd"` wraps the level in Zstandard."""

    def __init__(self, sequence_size: int = 5, supercompression: str = "none",
                 *, device: DeviceLike = None):
        if supercompression not in ("none", "zstd"):
            raise ValueError(
                f"unknown supercompression {supercompression!r} "
                "(supported: 'none', 'zstd')"
            )
        self.sequence_size = sequence_size
        self.supercompression = supercompression
        self.device = resolve_device(device)

    def encode_words(self, frames: np.ndarray) -> Tensor:
        """[L, H, W, 3] uint8 host layers → [L*nb, 2] int32 words on the device."""
        x = torch.from_numpy(np.ascontiguousarray(frames, dtype=np.uint8))
        return encode_etc1_images(x.to(self.device))

    def segment_from_words(self, words: Tensor, l: int, h: int, w: int) -> bytes:
        """[L*nb, 2] int32 words → one `.ktx2` (layers = frames, ETC2 RGB)."""
        payload = pack_etc1_payload(pack_words2(words, l).reshape(-1, 2))
        raw_len = len(payload)
        scheme = SUPERCOMPRESSION_NONE
        if self.supercompression == "zstd":
            from uvol_tpu.native import zstd

            payload = zstd.compress(payload)
            scheme = SUPERCOMPRESSION_ZSTD
        header = KTX2Header(
            vk_format=VK_FORMAT_ETC2_R8G8B8_UNORM_BLOCK,
            type_size=1,
            pixel_width=w,
            pixel_height=h,
            pixel_depth=0,
            layer_count=l,
            face_count=1,
            level_count=1,
            supercompression_scheme=scheme,
        )
        return write_ktx2(header, [KTX2Level(payload, raw_len)])

    def encode_segment(self, frames: np.ndarray) -> bytes:
        """[L, H, W, 3] uint8 → one `.ktx2` (layers = frames, ETC2 RGB)."""
        l, h, w, _ = frames.shape
        return self.segment_from_words(self.encode_words(frames), l, h, w)

    def decode_segment(self, ktx2: KTX2File, *, as_numpy: bool = True):
        """KTX2 (ETC2 RGB layers, optionally supercompressed) → [L, H, W, 3]
        uint8; `as_numpy=False` keeps the layers on the device."""
        h = ktx2.header.pixel_height
        w = ktx2.header.pixel_width
        l = max(ktx2.header.layer_count, 1)
        nb = (h // 4) * (w // 4)
        data = ktx2.level_payload(0)
        words = unpack_etc1_payload(data[: l * nb * 8]).reshape(l, nb, 2)
        dev_words = torch.from_numpy(unpack_words2(words)).to(self.device)
        out = decode_etc1_images(dev_words, l, h, w)
        if as_numpy:
            return out.cpu().numpy()
        synchronize(self.device)
        return out
