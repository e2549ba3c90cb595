"""Audio duration probing (WAV via stdlib, MP3 via frame-header walk).

Replaces the reference's audioread duration cross-check
(upstream `scripts/Encoder.py:330-348`): the encoder warns when the
audio track is shorter/longer than the geometry timeline. No ffmpeg in
this environment, so MP3 duration comes from walking MPEG frame headers
(handles CBR and VBR, skips ID3v2).

The port's copy of `uvol_tpu/io/audio.py`, unchanged.
"""

from __future__ import annotations

import struct
from typing import Optional

_MPEG1_L3_BITRATES = [
    0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320,
]
_MPEG2_L3_BITRATES = [
    0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160,
]
_SAMPLE_RATES = {
    3: [44100, 48000, 32000],  # MPEG1
    2: [22050, 24000, 16000],  # MPEG2
    0: [11025, 12000, 8000],  # MPEG2.5
}


def wav_duration(path: str) -> float:
    import wave

    with wave.open(path, "rb") as w:
        return w.getnframes() / float(w.getframerate())


def mp3_duration(path: str) -> float:
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    if data[:3] == b"ID3":  # skip ID3v2 tag (syncsafe length)
        size = (
            (data[6] << 21) | (data[7] << 14) | (data[8] << 7) | data[9]
        )
        pos = 10 + size
    total = 0.0
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF or (data[pos + 1] & 0xE0) != 0xE0:
            pos += 1
            continue
        b1, b2 = data[pos + 1], data[pos + 2]
        version = (b1 >> 3) & 3  # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
        layer = (b1 >> 1) & 3  # 1 = layer III
        if version == 1 or layer != 1:
            pos += 1
            continue
        bitrate_idx = (b2 >> 4) & 0xF
        sr_idx = (b2 >> 2) & 3
        if bitrate_idx in (0, 15) or sr_idx == 3:
            pos += 1
            continue
        table = _MPEG1_L3_BITRATES if version == 3 else _MPEG2_L3_BITRATES
        bitrate = table[bitrate_idx] * 1000
        sr = _SAMPLE_RATES[version][sr_idx]
        padding = (b2 >> 1) & 1
        spf = 1152 if version == 3 else 576  # samples per L3 frame
        frame_len = spf // 8 * bitrate // sr + padding
        if frame_len <= 0:
            pos += 1
            continue
        total += spf / sr
        pos += frame_len
    return total


def audio_duration(path: str) -> Optional[float]:
    p = path.lower()
    try:
        if p.endswith(".wav"):
            return wav_duration(path)
        if p.endswith(".mp3"):
            return mp3_duration(path)
    except (OSError, struct.error, EOFError):
        return None
    return None
