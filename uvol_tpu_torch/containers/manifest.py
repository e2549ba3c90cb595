"""Manifest file I/O and validation.

Readers/writers for the UVOL manifests:
  - V2 `uvol.json` (reference writer: scripts/Encoder.py:311-363; reader:
    src/Player.ts:159-162 + src/V2/player.ts:199-222). We emit the
    Record-of-targets form the player actually consumes (SURVEY.md §2.1).
  - V1 `.manifest` JSON (written by deprecated/encoder/src/Encoder30.js:113-160).

Validation mirrors the reference encoder's checks (scripts/Encoder.py:45-154):
mandatory fields, geometry/texture frame-rate compatibility (each must be a
factor of the other), and segment-count consistency.

The port's copy of `uvol_tpu/containers/manifest.py`: the reader, the
writer, the V2 checks and `manifest_for_directory`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

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


def manifest_for_directory(
    out_dir: str,
    *,
    geometry_dir: str = "geometry_draco",
    texture_dir_template: str = "texture_[target]_[type]_[tag]",
) -> Dict[str, Any]:
    """Reconstruct a V2 manifest dict by inspecting an output directory laid
    out like the reference sample (`example/public/liam/output/`). Used for
    tests and for recovering from a missing top-level manifest (the
    reference's own `liam.uvol.json` is an absent git-lfs blob)."""
    from uvol_tpu_torch.containers.ktx2 import read_ktx2_header

    geometry_path = os.path.join(out_dir, geometry_dir)
    drc = sorted(p for p in os.listdir(geometry_path) if p.endswith(".drc"))
    tex_dirs = [
        d
        for d in os.listdir(out_dir)
        if d.startswith("texture_") and os.path.isdir(os.path.join(out_dir, d))
    ]
    manifest: Dict[str, Any] = {
        "version": "v2",
        "geometry": {
            "targets": {
                geometry_dir.replace("geometry_", ""): {
                    "frameRate": 30,
                    "frameCount": len(drc),
                    "format": "draco",
                }
            },
            "path": f"output/{geometry_dir}/[#####][ext]",
        },
        "texture": {"targets": {}, "path": ""},
    }
    for d in tex_dirs:
        # directory name encodes texture_[target]_[type]_[tag]
        parts = d.split("_")
        target, ttype, tag = parts[1], parts[2], "_".join(parts[3:]) or "default"
        files = sorted(
            p for p in os.listdir(os.path.join(out_dir, d)) if p.endswith(".ktx2")
        )
        hdr = read_ktx2_header(os.path.join(out_dir, d, files[0]))
        manifest["texture"]["targets"][target] = {
            "format": "ktx2",
            "frameRate": 30,
            "resolution": [hdr.pixel_width, hdr.pixel_height],
            "sequenceSize": max(hdr.layer_count, 1),
            "sequenceCount": len(files),
            "type": ttype,
            "tag": tag,
        }
        manifest["texture"]["path"] = "output/texture_[target]_[type]_[tag]/[#####][ext]"
    return manifest
