"""Minimal ISO-BMFF (MP4) container: write + read for video sample tracks.

UVOL 1.0 carries its texture stream as an MP4 video with a binary frame
counter baked into the bottom pixel rows (reference:
deprecated/README.md:63, example/texture_encoder.py — which shells out to
ffmpeg for H.264). No H.264 codec exists in this environment, so the
TPU-native build stores **Motion-JPEG** samples ('jpeg' VisualSampleEntry)
— the container layout (moov/trak/stbl indexing, chunk offsets) is exactly
ISO/IEC 14496-12, and the codec substitution is explicit in the sample
entry fourcc rather than a mislabeled stream.

The reader is deliberately general: stts/stsc/stsz/stco(+co64) walking,
multiple chunks, any single video track — so it also parses externally
produced MP4s structurally (sample payloads are returned as opaque bytes;
only 'jpeg' samples can be pixel-decoded here).

The port's copy of `uvol_tpu/containers/mp4.py`.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Dict, List, Optional, Tuple

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return _U32.pack(8 + len(payload)) + fourcc + payload


def _full_box(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def write_mp4_video(
    samples: List[bytes],
    *,
    width: int,
    height: int,
    fps: float,
    codec: bytes = b"jpeg",
    timescale: int = 90000,
    avcc: bytes = b"",
    sync_samples: "Optional[List[int]]" = None,
) -> bytes:
    """Pack encoded video frames (one sample each) into a faithful MP4.

    Layout: ftyp | mdat | moov. One track, one chunk (all samples
    contiguous in mdat), constant frame duration. `codec=b"avc1"` writes
    a real H.264 track: pass the AVCDecoderConfigurationRecord as `avcc`
    (codecs/h264.make_avcc) and length-prefixed NAL samples
    (codecs/h264.encode_avc_samples) — the reference's V1 texture wire
    (deprecated/README.md:63).
    """
    n = len(samples)
    if n == 0:
        raise ValueError("no samples")
    delta = int(round(timescale / fps))
    duration = n * delta

    ftyp = _box(b"ftyp", b"isom" + _U32.pack(0x200) + b"isom" + b"iso2" + b"mp41")
    mdat_payload = b"".join(samples)
    mdat = _box(b"mdat", mdat_payload)
    mdat_data_offset = len(ftyp) + 8  # first sample byte position in file

    mvhd = _full_box(
        b"mvhd",
        0,
        0,
        struct.pack(
            ">IIII",
            0,  # creation
            0,  # modification
            timescale,
            duration,
        )
        + struct.pack(">iH", 0x00010000, 0x0100)  # rate 1.0, volume 1.0
        + b"\x00" * 10
        + struct.pack(
            ">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000
        )  # identity matrix
        + b"\x00" * 24
        + _U32.pack(2),  # next track id
    )

    tkhd = _full_box(
        b"tkhd",
        0,
        7,  # enabled | in movie | in preview
        struct.pack(">IIIII", 0, 0, 1, 0, duration)
        + b"\x00" * 8
        + struct.pack(">hhhh", 0, 0, 0, 0)  # layer, group, volume, reserved
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", width << 16, height << 16),
    )

    mdhd = _full_box(
        b"mdhd",
        0,
        0,
        struct.pack(">IIII", 0, 0, timescale, duration)
        + struct.pack(">HH", 0x55C4, 0),  # language 'und'
    )
    hdlr = _full_box(
        b"hdlr", 0, 0, _U32.pack(0) + b"vide" + b"\x00" * 12 + b"VideoHandler\x00"
    )

    # sample description: VisualSampleEntry
    compressor = b"AVC Coding" if codec == b"avc1" else b"Motion JPEG"
    entry = (
        b"\x00" * 6
        + struct.pack(">H", 1)  # data reference index
        + b"\x00" * 16  # pre_defined / reserved
        + struct.pack(">HH", width, height)
        + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
        + _U32.pack(0)
        + struct.pack(">H", 1)  # frame count per sample
        + struct.pack(">B", len(compressor))
        + compressor.ljust(31, b"\x00")
        + struct.pack(">Hh", 24, -1)  # depth, pre_defined
    )
    if codec == b"avc1":
        if not avcc:
            raise ValueError("avc1 track requires an avcC record")
        entry += _box(b"avcC", avcc)
    stsd = _full_box(b"stsd", 0, 0, _U32.pack(1) + _box(codec, entry))
    stts = _full_box(b"stts", 0, 0, _U32.pack(1) + struct.pack(">II", n, delta))
    stsc = _full_box(b"stsc", 0, 0, _U32.pack(1) + struct.pack(">III", 1, n, 1))
    stsz = _full_box(
        b"stsz",
        0,
        0,
        _U32.pack(0)
        + _U32.pack(n)
        + b"".join(_U32.pack(len(s)) for s in samples),
    )
    stco = _full_box(b"stco", 0, 0, _U32.pack(1) + _U32.pack(mdat_data_offset))
    # sync-sample box: required whenever not every sample is a random
    # access point (ISO 14496-12 8.6.2 — absence means all-sync, which
    # would send external players seeking into P samples)
    stss = b""
    if sync_samples is not None and len(sync_samples) != n:
        stss = _full_box(
            b"stss", 0, 0,
            _U32.pack(len(sync_samples))
            + b"".join(_U32.pack(i + 1) for i in sorted(sync_samples)),
        )
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco + stss)

    vmhd = _full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dref = _full_box(b"dref", 0, 0, _U32.pack(1) + _full_box(b"url ", 0, 1, b""))
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", vmhd + dinf + stbl)
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    trak = _box(b"trak", tkhd + mdia)
    moov = _box(b"moov", mvhd + trak)
    return ftyp + mdat + moov


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Mp4VideoTrack:
    codec: str
    width: int
    height: int
    timescale: int
    sample_deltas: List[int]  # per-sample durations (timescale units)
    samples: List[bytes]
    avcc: bytes = b""  # AVCDecoderConfigurationRecord (avc1 tracks)
    #: 0-based sync-sample indices from stss; None = no stss box, i.e.
    #: EVERY sample is a random-access point (ISO 14496-12 8.6.2)
    sync_samples: "Optional[List[int]]" = None

    @property
    def num_frames(self) -> int:
        return len(self.samples)

    @property
    def fps(self) -> float:
        if not self.sample_deltas:
            return 0.0
        avg = sum(self.sample_deltas) / len(self.sample_deltas)
        return self.timescale / avg if avg else 0.0

    @property
    def duration(self) -> float:
        return sum(self.sample_deltas) / self.timescale if self.timescale else 0.0

    def sample_time(self, i: int) -> float:
        return sum(self.sample_deltas[:i]) / self.timescale

    def frame_at(self, t: float) -> int:
        """Frame index playing at time t (constant-rate fast path)."""
        if not self.sample_deltas:
            return 0
        d = self.sample_deltas[0]
        if all(x == d for x in self.sample_deltas):
            i = int(t * self.timescale // d)
        else:
            acc, i = 0, 0
            while i + 1 < len(self.sample_deltas) and acc + self.sample_deltas[i] <= t * self.timescale:
                acc += self.sample_deltas[i]
                i += 1
        return max(0, min(i, len(self.samples) - 1))


def _iter_boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size = _U32.unpack_from(data, pos)[0]
        fourcc = data[pos + 4 : pos + 8]
        header = 8
        if size == 1:
            size = _U64.unpack_from(data, pos + 8)[0]
            header = 16
        elif size == 0:
            size = end - pos
        if size < header or pos + size > end:
            raise ValueError(f"malformed box {fourcc!r} at {pos}")
        yield fourcc, pos + header, pos + size
        pos += size


def _find(data: bytes, start: int, end: int, fourcc: bytes) -> Optional[Tuple[int, int]]:
    for fc, s, e in _iter_boxes(data, start, end):
        if fc == fourcc:
            return s, e
    return None


def read_mp4_video(data: bytes) -> Mp4VideoTrack:
    """Parse the first video track: stsd/stts/stsc/stsz/stco(+co64)."""
    moov = _find(data, 0, len(data), b"moov")
    if moov is None:
        raise ValueError("no moov box")
    for fc, ts, te in _iter_boxes(data, *moov):
        if fc != b"trak":
            continue
        mdia = _find(data, ts, te, b"mdia")
        if mdia is None:
            continue
        hdlr = _find(data, *mdia, b"hdlr")
        if hdlr is None or data[hdlr[0] + 8 : hdlr[0] + 12] != b"vide":
            continue
        mdhd = _find(data, *mdia, b"mdhd")
        version = data[mdhd[0]]
        if version == 1:
            timescale = _U32.unpack_from(data, mdhd[0] + 4 + 16)[0]
        else:
            timescale = _U32.unpack_from(data, mdhd[0] + 4 + 8)[0]
        minf = _find(data, *mdia, b"minf")
        stbl = _find(data, *minf, b"stbl")

        # stsd: codec + dimensions
        stsd = _find(data, *stbl, b"stsd")
        entry_fourcc = data[stsd[0] + 12 : stsd[0] + 16]
        entry = stsd[0] + 16
        width, height = struct.unpack_from(">HH", data, entry + 24)
        # avc1: the avcC config record lives in a sub-box after the
        # 78-byte VisualSampleEntry body
        avcc = b""
        if entry_fourcc == b"avc1":
            entry_size = _U32.unpack_from(data, stsd[0] + 8)[0]
            sub = _find(data, entry + 78, stsd[0] + 8 + entry_size, b"avcC")
            if sub is not None:
                avcc = data[sub[0] : sub[1]]

        # stts
        stts = _find(data, *stbl, b"stts")
        cnt = _U32.unpack_from(data, stts[0] + 4)[0]
        deltas: List[int] = []
        p = stts[0] + 8
        for _ in range(cnt):
            num, delta = struct.unpack_from(">II", data, p)
            deltas.extend([delta] * num)
            p += 8

        # stsz
        stsz = _find(data, *stbl, b"stsz")
        fixed = _U32.unpack_from(data, stsz[0] + 4)[0]
        n = _U32.unpack_from(data, stsz[0] + 8)[0]
        if fixed:
            sizes = [fixed] * n
        else:
            sizes = list(
                struct.unpack_from(f">{n}I", data, stsz[0] + 12)
            )

        # stss (optional): explicit sync samples
        sync_samples = None
        stss = _find(data, *stbl, b"stss")
        if stss is not None:
            cnt_s = _U32.unpack_from(data, stss[0] + 4)[0]
            sync_samples = [
                _U32.unpack_from(data, stss[0] + 8 + 4 * k)[0] - 1
                for k in range(cnt_s)
            ]

        # stco / co64
        stco = _find(data, *stbl, b"stco")
        if stco is not None:
            m = _U32.unpack_from(data, stco[0] + 4)[0]
            offsets = list(struct.unpack_from(f">{m}I", data, stco[0] + 8))
        else:
            co64 = _find(data, *stbl, b"co64")
            m = _U32.unpack_from(data, co64[0] + 4)[0]
            offsets = list(struct.unpack_from(f">{m}Q", data, co64[0] + 8))

        # stsc: chunk -> samples-per-chunk runs
        stsc = _find(data, *stbl, b"stsc")
        sc = _U32.unpack_from(data, stsc[0] + 4)[0]
        runs = [
            struct.unpack_from(">III", data, stsc[0] + 8 + 12 * i)
            for i in range(sc)
        ]

        samples: List[bytes] = []
        si = 0
        for ci, chunk_off in enumerate(offsets, start=1):
            spc = 0
            for first, count, _desc in runs:
                if ci >= first:
                    spc = count
            pos = chunk_off
            for _ in range(spc):
                if si >= n:
                    break
                samples.append(data[pos : pos + sizes[si]])
                pos += sizes[si]
                si += 1
        if si != n:
            raise ValueError(f"chunk map yielded {si} samples, stsz says {n}")

        return Mp4VideoTrack(
            codec=entry_fourcc.decode("ascii", "replace"),
            width=width,
            height=height,
            timescale=timescale,
            sample_deltas=deltas,
            samples=samples,
            avcc=avcc,
            sync_samples=sync_samples,
        )
    raise ValueError("no video track")
