"""Config-driven UVOL 2.0 sequence encoder CLI — the port of
`uvol_tpu/encoder_cli.py`, on the card.

Usage:
  python -m uvol_tpu_torch.encoder_cli path/to/project-config.json
  python -m uvol_tpu_torch.encoder_cli create-template [path]

The same config file gives the same files as the reference CLI, byte for
byte: `geometry_draco/*.drc` or `geometry_uvtg/*.uvtg`, the `.ktx2`
segments under `texture_<target>_baseColor_default/`, each directory's
`.content_hashes.json` resume index, and `<name>.uvol.json`. A rerun
encodes only what changed; a rerun where nothing changed writes nothing
(the reference rewrites its indexes and manifest with the same bytes).

`UVT_PLATFORM` chooses the device (the reference's JAX platform switch):
unset runs on the CUDA card and raises where there is none; `cpu` runs
on the CPU. Every device codec the CLI builds is given that device (the
`uastc` texture codec is the spec wire's host encode, as in the
reference). Draco frames
go through the copied `codecs/draco/encoder.encode_drc` in a spawned
process pool, as the reference's workers call it (the native whole-frame
encoder, else the staged Python encoder; the workers import `io.meshio`,
the encoder and the C library, no torch: the CLI's own process may hold a
CUDA context and threads, which a fork would copy); images are read as
PNG by `io.image`, without Pillow.

Refused before any output is written: an `ABCFilePath` input
(ROADMAP.md §1 item 5).

A script that calls `main()` itself does so under
`if __name__ == "__main__":`: the spawned Draco workers import the
caller's main module, as every spawned `multiprocessing` worker does.

Each stage's wall time goes into `utils.stats.STATS` (`cli.*_s`).
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional

import numpy as np

TEMPLATE = {
    "name": "sample",
    "OBJFilesPath": "./OBJ/[#####].obj",
    "ImagesPath": "./images/[#####].png",
    "OutputDirectory": "./output",
    "GEOMETRY_FRAME_RATE": 30,
    "TEXTURE_FRAME_RATE": 30,
    "KTX2_BATCH_SIZE": 5,
    "Q_POSITION_ATTR": 11,
    "Q_TEXTURE_ATTR": 10,
    "Q_NORMAL_ATTR": 8,
    "Q_GENERIC_ATTR": 8,
    "AudioURL": None,
    "TEXTURE_RESOLUTION": [1024, 1024],
    # "draco": real per-frame .drc bitstreams (reference-interoperable,
    # scripts/Encoder.py:260-267); "uvtg": this framework's batched
    # device-encoded format (declared honestly in the manifest)
    "GEOMETRY_CODEC": "draco",
    # "etc1s": BasisLZ-supercompressed KTX2 (reference-interoperable wire,
    # scripts/Encoder.py:286-298); "uastc": Zstd-supercompressed UASTC KTX2
    # (the reference's `basisu -uastc` high-quality mode; see
    # codecs/basis/uastc.py for offline-interop caveats); "etc": raw ETC2
    # payload KTX2 (fast path)
    "TEXTURE_CODEC": "etc1s",
    # palette sizes trade quality for rate: 1024/1024 reaches ~45 dB on
    # liam-like 1k video (256/256: ~39 dB at ~10% fewer bytes)
    "ETC1S_ENDPOINTS": 1024,
    "ETC1S_SELECTORS": 1024,
    "ENCODE_WORKERS": 0,  # 0 = os.cpu_count()
}

_COMMENT_RE = re.compile(r"^\s*//.*$", re.M)


def load_config(path: str) -> Dict:
    text = open(path).read()
    text = _COMMENT_RE.sub("", text)  # commentjson-style // comments
    cfg = dict(TEMPLATE)
    cfg.update(json.loads(text))
    return cfg


def check_all_fields(cfg: Dict) -> List[str]:
    """Mandatory-field validation (reference scripts/Encoder.py:45-84)."""
    problems = []
    if not cfg.get("name"):
        problems.append("name is required")
    if not (cfg.get("OBJFilesPath") or cfg.get("ABCFilePath")):
        problems.append("one of OBJFilesPath/ABCFilePath is required")
    g, t = cfg["GEOMETRY_FRAME_RATE"], cfg["TEXTURE_FRAME_RATE"]
    if g % t != 0 and t % g != 0:
        problems.append(
            f"frame rates {g}/{t} are not factors of each other "
            "(reference warns at scripts/Encoder.py:368-373)"
        )
    return problems


def _texture_codec_names(cfg: Dict) -> List[str]:
    # one or several targets: the V2 manifest is a Record of targets and
    # the player picks by TEXTURE_FORMAT_PRIORITY + device support
    # (reference src/V2/player.ts:207-222)
    tex_cfg = cfg.get("TEXTURE_CODEC", "etc1s")
    return (
        [c.strip() for c in tex_cfg.split(",") if c.strip()]
        if isinstance(tex_cfg, str)
        else list(tex_cfg)
    ) or ["etc"]  # empty config value keeps the fast-path target


def unported_inputs(cfg: Dict) -> List[str]:
    """What the port refuses before it writes anything, each naming the
    ROADMAP item that would port it."""
    problems = []
    if cfg.get("ABCFilePath"):
        problems.append("ABCFilePath: the Alembic input (io/alembic.py, io/ogawa.py) is not "
                        "ported (ROADMAP.md §1 item 5); give OBJFilesPath")
    return problems


def _expand(pattern: str) -> List[str]:
    from uvol_tpu_torch.utils.paths import pattern_to_glob

    return sorted(glob.glob(pattern_to_glob(pattern)))


def load_obj(path: str):
    """Vertex-UV view of a mesh for the batched UVTG codec (which has no
    per-corner seam channel). Full per-corner ingest: io.meshio.load_mesh.
    """
    from uvol_tpu_torch.io.meshio import load_mesh

    m = load_mesh(path)
    v = m.positions
    u = None
    if m.uvs is not None and m.uv_faces is not None:
        # collapse per-corner UVs to per-vertex (first corner wins); exact
        # seams are preserved only by the draco path
        u = np.zeros((len(v), 2), np.float32)
        u[m.faces.reshape(-1)] = m.uvs[m.uv_faces.reshape(-1)]
    return v, u, m.faces.astype(np.int32)


def _content_hash(*arrays) -> str:
    import hashlib

    h = hashlib.sha1()
    for a in arrays:
        if a is None:
            h.update(b"\x00none")
        elif isinstance(a, (bytes, str)):
            h.update(a.encode() if isinstance(a, str) else a)
        else:
            arr = np.ascontiguousarray(a)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


class _ResumeIndex:
    """Content-addressed resume: a sidecar maps output name → input content
    hash; an output is skipped only when its recorded hash matches the
    current input (not just the blob size)."""

    def __init__(self, directory: str):
        self.path = os.path.join(directory, ".content_hashes.json")
        try:
            with open(self.path) as f:
                self.hashes = json.load(f)
        except (OSError, ValueError):
            self.hashes = {}

    def fresh(self, name: str, content_hash: str, out_path: str) -> bool:
        return self.hashes.get(name) == content_hash and os.path.exists(out_path)

    def record(self, name: str, content_hash: str) -> None:
        self.hashes[name] = content_hash

    def save(self) -> None:
        text = json.dumps(self.hashes)
        if not _holds(self.path, text):
            with open(self.path, "w") as f:
                f.write(text)


def _holds(path: str, text: str) -> bool:
    """True when the file at `path` already holds exactly `text`: a rerun
    that changes nothing then leaves every file and its mtime as they were
    (the reference rewrites its indexes and manifest with the same bytes)."""
    try:
        with open(path, "rb") as f:
            return f.read() == text.encode()
    except OSError:
        return False


def _encode_draco_frame(args):
    """Worker: one OBJ/PLY frame → .drc bytes by the copied `encode_drc`
    (the native whole-frame encoder, else the staged Python encoder with
    the native helpers; numpy and C only: it runs in spawned processes,
    which import no torch)."""
    path, qp, qt, qn = args
    from uvol_tpu_torch.codecs.draco import constants as K
    from uvol_tpu_torch.codecs.draco.encoder import AttributeToEncode, encode_drc
    from uvol_tpu_torch.io.meshio import load_mesh

    m = load_mesh(path)
    # drop degenerate triangles like draco_encoder does (the reference
    # pipeline encodes scan frames containing slivers without failing)
    faces = np.asarray(m.faces)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]
    atts = [
        AttributeToEncode(K.ATT_POSITION, m.positions, faces.reshape(-1), qp)
    ]
    if m.uvs is not None:
        atts.append(
            AttributeToEncode(
                K.ATT_TEX_COORD, m.uvs,
                np.asarray(m.uv_faces)[good].reshape(-1), qt,
            )
        )
    if m.normals is not None:
        atts.append(
            AttributeToEncode(
                K.ATT_NORMAL, m.normals,
                np.asarray(m.normal_faces)[good].reshape(-1), qn,
            )
        )
    return encode_drc(faces, atts)


def load_image(path: str) -> np.ndarray:
    from uvol_tpu_torch.io.image import read_png

    return read_png(path)


def _encode_geometry_draco(cfg: Dict, objs: List[str], out_dir: str) -> str:
    """Per-frame real Draco bitstreams, fanned out over a host process pool
    (the reference runs one draco_encoder subprocess per frame sequentially,
    scripts/Encoder.py:256-267 — here frames are embarrassingly parallel)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from uvol_tpu_torch import native

    # built here, before the pool, so the workers find the library built
    # (without g++ the workers take the Python encoder: the same bytes)
    native.get_draco_lib()
    geo_dir = os.path.join(out_dir, "geometry_draco")
    os.makedirs(geo_dir, exist_ok=True)
    resume = _ResumeIndex(geo_dir)
    qp, qt, qn = (
        cfg["Q_POSITION_ATTR"], cfg["Q_TEXTURE_ATTR"], cfg["Q_NORMAL_ATTR"]
    )
    jobs = []
    for i, path in enumerate(objs):
        name = f"{i:05d}.drc"
        h = _content_hash(open(path, "rb").read(), f"{qp}/{qt}/{qn}")
        target = os.path.join(geo_dir, name)
        if resume.fresh(name, h, target):
            continue
        jobs.append((i, name, h, path))
    if jobs:
        workers = cfg.get("ENCODE_WORKERS") or os.cpu_count() or 1
        args = [(path, qp, qt, qn) for _, _, _, path in jobs]
        if workers > 1 and len(jobs) > 1:
            # spawned, not forked: the CLI's process may hold a CUDA context and
            # threads (torch's, JAX's in tests). A spawned worker imports this
            # module, numpy, meshio and the C library, no torch; it gets the
            # worker by its module's name (under `python -m` this module is also
            # `__main__`, whose functions a pool cannot pickle). A worker that
            # dies (a caller's script run again without its `__main__` guard)
            # breaks the executor, which raises instead of waiting
            from uvol_tpu_torch.encoder_cli import _encode_draco_frame as work

            ctx = mp.get_context("spawn")
            with ProcessPoolExecutor(min(workers, len(jobs)), mp_context=ctx) as pool:
                blobs = list(pool.map(work, args))
        else:
            blobs = [_encode_draco_frame(a) for a in args]
        for (i, name, h, _), blob in zip(jobs, blobs):
            with open(os.path.join(geo_dir, name), "wb") as f:
                f.write(blob)
            resume.record(name, h)
        resume.save()
    return geo_dir


def _encode_geometry_uvtg(cfg: Dict, objs: List[str], out_dir: str, device) -> str:
    """Whole-sequence batched device encode (this framework's own format)."""
    from uvol_tpu_torch.models.sequence import GeometryFrameSet, GeometrySequenceCodec

    frames = [load_obj(p) for p in objs]
    max_n = max(len(v) for v, _, _ in frames)
    F = len(frames)
    pos = np.zeros((F, max_n, 3), np.float32)
    uv = np.zeros((F, max_n, 2), np.float32)
    counts = np.zeros(F, np.int64)
    faces = []
    for i, (v, u, fidx) in enumerate(frames):
        pos[i, : len(v)] = v
        if u is not None:
            uv[i, : len(u)] = u
        counts[i] = len(v)
        faces.append(fidx)
    codec = GeometrySequenceCodec(
        position_bits=cfg["Q_POSITION_ATTR"], uv_bits=cfg["Q_TEXTURE_ATTR"], device=device
    )
    blobs = codec.encode(GeometryFrameSet(pos, uv, counts, faces))
    geo_dir = os.path.join(out_dir, "geometry_uvtg")
    os.makedirs(geo_dir, exist_ok=True)
    resume = _ResumeIndex(geo_dir)
    for i, blob in enumerate(blobs):
        name = f"{i:05d}.uvtg"
        h = _content_hash(blob)
        target = os.path.join(geo_dir, name)
        if resume.fresh(name, h, target):
            continue
        with open(target, "wb") as f:
            f.write(blob)
        resume.record(name, h)
    resume.save()
    return geo_dir


class _Etc1sSegmentCodec:
    def __init__(self, cfg: Dict, device):
        self.num_endpoints = cfg["ETC1S_ENDPOINTS"]
        self.num_selectors = cfg["ETC1S_SELECTORS"]
        self.device = device

    def encode_segment(self, px: np.ndarray) -> bytes:
        from uvol_tpu_torch.codecs.basis.etc1s_encode import encode_ktx2_etc1s

        return encode_ktx2_etc1s(px, num_endpoints=self.num_endpoints,
                                 num_selectors=self.num_selectors, device=self.device)


class _UastcSegmentCodec:
    """Fills the role of `basisu -uastc` (scripts/Encoder.py:33-39):
    Zstd-supercompressed UASTC KTX2, the spec wire's host encode (numpy),
    as the reference's CLI runs it."""

    def __init__(self, cfg: Dict):
        self.quality = int(cfg.get("UASTC_QUALITY", 0))

    def encode_segment(self, px: np.ndarray) -> bytes:
        from uvol_tpu_torch.codecs.basis.uastc import encode_uastc_ktx2

        return encode_uastc_ktx2(px, quality=self.quality)


def _encode_textures(cfg: Dict, imgs: List[str], out_dir: str, device) -> Dict:
    """KTX2_BATCH_SIZE layers per `.ktx2`, one directory per target; returns
    the manifest's texture targets."""
    from uvol_tpu_torch.io.image import png_size
    from uvol_tpu_torch.models.sequence import TextureSequenceCodec
    from uvol_tpu_torch.utils.stats import STATS

    batch = cfg["KTX2_BATCH_SIZE"]
    # codec setups first; then one pass over segments so each chunk's
    # bytes/pixels are read and decoded once, not once per codec
    setups = []
    for codec_name in _texture_codec_names(cfg):
        if codec_name == "etc1s":
            codec = _Etc1sSegmentCodec(cfg, device)
            target_name = "etc1s-tpu"
        elif codec_name == "uastc":
            codec = _UastcSegmentCodec(cfg)
            target_name = "uastc-tpu"
        else:  # any other name is the raw-ETC fast path, as in the reference
            codec = TextureSequenceCodec(sequence_size=batch, device=device)
            target_name = "etc-tpu"
        tex_dir = os.path.join(out_dir, f"texture_{target_name}_baseColor_default")
        os.makedirs(tex_dir, exist_ok=True)
        setups.append({"codec": codec, "name": target_name, "dir": tex_dir,
                       "resume": _ResumeIndex(tex_dir), "n_seg": 0})
    h = w = 0
    for s0 in range(0, len(imgs), batch):
        chunk = imgs[s0 : s0 + batch]
        seg_name = f"{s0 // batch:05d}.ktx2"
        chunk_bytes = [open(p, "rb").read() for p in chunk]
        ch = _content_hash(*chunk_bytes, str(batch))
        frames_px = None  # decoded lazily, shared across codecs
        for st in setups:
            target = os.path.join(st["dir"], seg_name)
            st["n_seg"] += 1
            if st["resume"].fresh(seg_name, ch, target):
                if not (h and w):
                    w, h = png_size(chunk[0])
                continue
            if frames_px is None:
                with STATS.timer("cli.images_s"):
                    frames_px = np.stack([load_image(p) for p in chunk])
                h, w = frames_px.shape[1:3]
            with STATS.timer(f"cli.texture.{st['name']}_s"):
                blob = st["codec"].encode_segment(frames_px)
            with open(target, "wb") as f:
                f.write(blob)
            st["resume"].record(seg_name, ch)
    tex_targets = {}
    for st in setups:
        st["resume"].save()
        tex_targets[st["name"]] = {
            "format": "ktx2",
            "frameRate": cfg["TEXTURE_FRAME_RATE"],
            "resolution": [w, h],
            "sequenceSize": batch,
            "sequenceCount": st["n_seg"],
            "type": "baseColor",
            "tag": "default",
        }
        print(f"texture: {st['n_seg']} segments -> {st['dir']}")
    return tex_targets


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    if argv[0] == "create-template":
        out = argv[1] if len(argv) > 1 else "project-config.json"
        with open(out, "w") as f:
            json.dump(TEMPLATE, f, indent=2)
        print(f"wrote {out}")
        return 0

    from uvol_tpu_torch._device import resolve_device
    from uvol_tpu_torch.utils.stats import STATS

    cfg = load_config(argv[0])
    problems = check_all_fields(cfg)
    if problems:
        for p in problems:
            print(f"error: {p}")
        return 1
    refused = unported_inputs(cfg)
    if refused:
        for p in refused:
            print(f"error: {p}")
        return 1
    # the card unless UVT_PLATFORM names the CPU; no card raises here,
    # before anything is written
    device = resolve_device(os.environ.get("UVT_PLATFORM") or None)

    out_dir = cfg["OutputDirectory"]
    name = cfg["name"]
    os.makedirs(out_dir, exist_ok=True)

    manifest: Dict = {
        "version": "v2",
        "geometry": {"targets": {}, "path": ""},
        "texture": {"targets": {}, "path": ""},
    }
    if cfg.get("AudioURL"):
        audio_url = cfg["AudioURL"]
        fmt = "wav" if audio_url.lower().endswith(".wav") else "mp3"
        manifest["audio"] = {"path": audio_url, "format": fmt}

    # ---- geometry -----------------------------------------------------------
    n_geo = 0
    if cfg.get("OBJFilesPath"):
        objs = _expand(cfg["OBJFilesPath"])
        if not objs:
            print(f"error: no OBJ files match {cfg['OBJFilesPath']}")
            return 1
        n_geo = len(objs)
        codec_name = cfg.get("GEOMETRY_CODEC", "draco")
        t0 = time.perf_counter()
        if codec_name == "draco":
            geo_dir = _encode_geometry_draco(cfg, objs, out_dir)
        elif codec_name == "uvtg":
            geo_dir = _encode_geometry_uvtg(cfg, objs, out_dir, device)
        else:
            print(f"error: unknown GEOMETRY_CODEC {codec_name}")
            return 1
        STATS.observe("cli.geometry_s", time.perf_counter() - t0)
        manifest["geometry"] = {
            "targets": {
                codec_name: {
                    "frameRate": cfg["GEOMETRY_FRAME_RATE"],
                    "frameCount": n_geo,
                    "format": codec_name,  # honest: draco means real .drc
                }
            },
            "path": "geometry_[target]/[#####][ext]",
        }
        print(f"geometry ({codec_name}): {n_geo} frames -> {geo_dir}")

        # audio-duration cross-check (reference scripts/Encoder.py:330-348)
        if cfg.get("AudioURL") and os.path.exists(cfg["AudioURL"]):
            from uvol_tpu_torch.io.audio import audio_duration

            dur = audio_duration(cfg["AudioURL"])
            track = n_geo / cfg["GEOMETRY_FRAME_RATE"]
            if dur is None:
                print("warning: could not probe audio duration")
            elif abs(dur - track) > 1.0 / cfg["GEOMETRY_FRAME_RATE"] + 0.05:
                print(
                    f"warning: audio duration {dur:.2f}s != geometry "
                    f"track {track:.2f}s (reference fails fast here)"
                )

    # ---- texture: ETC blocks on the device, KTX2_BATCH_SIZE layers per file --
    if cfg.get("ImagesPath"):
        imgs = _expand(cfg["ImagesPath"])
        if imgs:
            manifest["texture"] = {
                "targets": _encode_textures(cfg, imgs, out_dir, device),
                "path": "texture_[target]_[type]_[tag]/[#####][ext]",
            }

    # ---- frame-count/rate cross-validation (reference :103-154) ------------
    from uvol_tpu_torch.containers.manifest import save_manifest, validate_v2_manifest
    from uvol_tpu_torch.interfaces import parse_manifest

    with STATS.timer("cli.manifest_s"):
        manifest_path = os.path.join(out_dir, f"{name}.uvol.json")
        if manifest["texture"]["targets"]:
            m = parse_manifest(manifest)
            for p in validate_v2_manifest(m):
                print(f"warning: {p}")
            # save_manifest's text: json.dump(indent=2) and a newline
            if not _holds(manifest_path, json.dumps(m.to_json(), indent=2) + "\n"):
                save_manifest(m, manifest_path)
            print(f"manifest: {manifest_path}")
        else:
            text = json.dumps(manifest, indent=2)
            if not _holds(manifest_path, text):
                with open(manifest_path, "w") as f:
                    f.write(text)
            print(f"manifest (geometry only): {manifest_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
