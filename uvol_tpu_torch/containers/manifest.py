"""Manifest file I/O and validation.

Readers/writers for the UVOL manifests:
  - V2 `uvol.json` (reference writer: scripts/Encoder.py:311-363; reader:
    src/Player.ts:159-162 + src/V2/player.ts:199-222). We emit the
    Record-of-targets form the player actually consumes (SURVEY.md §2.1).
  - V1 `.manifest` JSON (written by deprecated/encoder/src/Encoder30.js:113-160).

Validation mirrors the reference encoder's checks (scripts/Encoder.py:45-154):
mandatory fields, geometry/texture frame-rate compatibility (each must be a
factor of the other), and segment-count consistency.

The port's copy of `uvol_tpu/containers/manifest.py`, cut to the
reader, the writer and the V2 checks (`manifest_for_directory` is left
out: no path of the port calls it).
"""

from __future__ import annotations

import json
import os
from typing import List

from uvol_tpu_torch.interfaces import (
    UVOLManifestSchema,
    V2Schema,
    parse_manifest,
)


def load_manifest(path: str) -> UVOLManifestSchema:
    with open(path, "rb") as f:
        return parse_manifest(f.read())


def save_manifest(manifest: UVOLManifestSchema, path: str) -> None:
    d = manifest.to_json()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(d, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)  # atomic: resumable encoders rewrite manifests


class ManifestError(ValueError):
    pass


def _rates_compatible(a: float, b: float) -> bool:
    """True when one rate is an integer multiple of the other.

    Reference check: scripts/Encoder.py:368-373 warns when
    `geometry_frame_rate % texture_frame_rate != 0` (and vice versa).
    """
    if a <= 0 or b <= 0:
        return False
    hi, lo = max(a, b), min(a, b)
    ratio = hi / lo
    return abs(ratio - round(ratio)) < 1e-9


def validate_v2_manifest(manifest: V2Schema) -> List[str]:
    """Return a list of human-readable problems (empty == valid)."""
    problems: List[str] = []
    if not manifest.geometry.targets:
        problems.append("geometry.targets is empty")
    if not manifest.texture.targets:
        problems.append("texture.targets is empty")
    if "[" not in manifest.geometry.path:
        problems.append("geometry.path has no template substitutions")

    for name, g in manifest.geometry.targets.items():
        if g.frameCount <= 0:
            problems.append(f"geometry target {name!r}: frameCount={g.frameCount}")
        if g.frameRate <= 0:
            problems.append(f"geometry target {name!r}: frameRate={g.frameRate}")

    for name, t in manifest.texture.targets.items():
        if t.format == "ktx2":
            if t.sequenceSize <= 0:
                problems.append(f"texture target {name!r}: sequenceSize={t.sequenceSize}")
            if t.sequenceCount <= 0:
                problems.append(
                    f"texture target {name!r}: sequenceCount={t.sequenceCount}"
                )
        for g_name, g in manifest.geometry.targets.items():
            if t.frameRate and not _rates_compatible(g.frameRate, t.frameRate):
                problems.append(
                    f"frame rates of geometry target {g_name!r} ({g.frameRate}) and "
                    f"texture target {name!r} ({t.frameRate}) are not factors of "
                    "each other"
                )
            # total duration must agree: frames/rate vs (segments*batch)/rate
            if t.frameRate and t.sequenceSize and g.frameRate:
                g_dur = g.frameCount / g.frameRate
                t_frames = t.sequenceCount * t.sequenceSize
                t_dur = t_frames / t.frameRate
                # allow one trailing partial segment of slack
                slack = t.sequenceSize / t.frameRate
                if abs(g_dur - t_dur) > slack + 1e-6:
                    problems.append(
                        f"duration mismatch: geometry {g_name!r} {g_dur:.3f}s vs "
                        f"texture {name!r} {t_dur:.3f}s"
                    )
    return problems

