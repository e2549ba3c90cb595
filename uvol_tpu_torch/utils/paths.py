"""Path-template utilities.

Behavioral parity with the reference's URL templating:
  - `pad` / `countHashChar` (src/utils.ts:10-24)
  - `getAbsoluteURL` (src/utils.ts:38-45)
  - `[#####]` → `%05u` pattern conversion (scripts/Encoder.py:16-19)
  - geometry/texture path expansion (src/V2/player.ts:141-174)

The port's copy of `uvol_tpu/utils/paths.py`, unchanged.
"""

from __future__ import annotations

import re
from typing import Dict, Optional


def pad(n: int, width: int) -> str:
    """Zero-pad `n` to at least `width` chars (src/utils.ts:10-14)."""
    s = str(n)
    return s if len(s) >= width else "0" * (width - len(s)) + s


def count_hash_char(url: str) -> int:
    """Count '#' characters in a template (src/utils.ts:16-24)."""
    return url.count("#")


def get_absolute_url(manifest_url: str, new_segment: str) -> str:
    """Resolve a manifest-relative path (src/utils.ts:38-45).

    Absolute http(s) URLs pass through; otherwise the last path segment of
    the manifest URL is replaced by `new_segment`.
    """
    if new_segment.startswith("http"):
        return new_segment
    segments = manifest_url.split("/")
    segments.pop()
    segments.append(new_segment)
    return "/".join(segments)


_HASH_RUN = re.compile(r"\[(#+)\]")


def pattern_to_printf(path: str) -> str:
    """`a/[#####][ext]` → `a/%05u[ext]` (scripts/Encoder.py:16-19)."""

    def repl(m: "re.Match[str]") -> str:
        return "%%0%du" % len(m.group(1))

    return _HASH_RUN.sub(repl, path)


def pattern_to_glob(path: str) -> str:
    """`a/[#####][ext]` → `a/*[ext]` — for enumerating produced files."""
    return _HASH_RUN.sub("*", path)


def expand_template(
    path: str,
    *,
    index: Optional[int] = None,
    target: Optional[str] = None,
    type: Optional[str] = None,  # noqa: A002 - matches manifest key name
    tag: Optional[str] = None,
    ext: Optional[str] = None,
) -> str:
    """Expand a manifest path template.

    Supported substitutions (src/Interfaces.ts:100-131):
      [target], [type], [tag], [ext], and a run of '#' as a 0-padded index.
    Exactly mirrors the player's INPUTS replacement (src/V2/player.ts:141-174):
    each key is replaced once.
    """
    inputs: Dict[str, str] = {}
    if target is not None:
        inputs["[target]"] = target
    if type is not None:
        inputs["[type]"] = type
    if tag is not None:
        inputs["[tag]"] = tag
    if ext is not None:
        inputs["[ext]"] = ext
    if index is not None:
        width = count_hash_char(path)
        if width:
            inputs["[" + "#" * width + "]"] = pad(index, width)
    for key, value in inputs.items():
        path = path.replace(key, value, 1)
    return path
