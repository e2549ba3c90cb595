"""Corto-style CLI: encode a mesh to `.crt` and self-verify with stats.

Capability match for the reference's corto binary — its only automated
correctness+perf harness (`deprecated/encoder/dev/src/main.cpp:46-67`
flags; self-check roundtrip with ratio/bpv/MT/s stats at :238-284).

Usage:
  python -m uvol_tpu_torch.corto_cli mesh.obj|mesh.ply [-o out.crt]
         [-v pos_bits] [-N] [-u]

Always decodes its own output in-process and asserts vertex/face counts
match before writing the file (main.cpp:242-244).

The port's copy of `uvol_tpu/corto_cli.py`, over the port's Corto
codec and mesh reader.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mesh", help="input .obj or .ply")
    ap.add_argument("-o", "--output", default=None, help="output .crt path")
    ap.add_argument(
        "-v", "--vertex-bits", type=int, default=12,
        help="position quantization bits (reference -v)",
    )
    ap.add_argument(
        "-N", "--normals", action="store_true",
        help="encode normals when present (reference -N)",
    )
    ap.add_argument(
        "-u", "--uvs", action="store_true", default=True,
        help="encode UVs when present (reference -u)",
    )
    args = ap.parse_args(argv)

    from uvol_tpu_torch.codecs.corto.decoder import decode_crt
    from uvol_tpu_torch.codecs.corto.encoder import encode_crt
    from uvol_tpu_torch.io.meshio import load_mesh

    t0 = time.perf_counter()
    mesh = load_mesh(args.mesh)
    nvert, nface = len(mesh.positions), len(mesh.faces)
    print(f"loaded {args.mesh}: {nvert} vertices, {nface} faces")

    # per-vertex UVs only (the .crt vertex pipeline; per-corner UVs are the
    # draco path's job)
    uvs = None
    if args.uvs and mesh.uvs is not None and mesh.uv_faces is not None:
        uvs = np.zeros((nvert, 2), np.float32)
        uvs[mesh.faces.reshape(-1)] = mesh.uvs[mesh.uv_faces.reshape(-1)]
    normals = None
    if args.normals and mesh.normals is not None:
        normals = np.zeros((nvert, 3), np.float32)
        normals[mesh.faces.reshape(-1)] = mesh.normals[
            mesh.normal_faces.reshape(-1)
        ]

    bbox = mesh.positions.max(0) - mesh.positions.min(0)
    diag = float(np.linalg.norm(bbox))
    step = (diag if diag > 0 else 1.0) / (1 << args.vertex_bits)

    t1 = time.perf_counter()
    blob = encode_crt(
        mesh.positions, mesh.faces, uvs=uvs, normals=normals,
        position_step=step, exif=mesh.exif,
    )
    t2 = time.perf_counter()

    # self-check roundtrip (main.cpp:238-284)
    dec = decode_crt(blob)
    t3 = time.perf_counter()
    if len(dec.faces) != nface:
        print(f"FAILED: decoded {len(dec.faces)} faces != {nface}")
        return 1

    raw_bytes = nvert * 12 + nface * 12 + (nvert * 8 if uvs is not None else 0)
    header = f"encoded in {(t2 - t1) * 1000:.1f} ms, decoded in {(t3 - t2) * 1000:.1f} ms"
    print(header)
    print(
        f"compressed {len(blob)} bytes, ratio {raw_bytes / len(blob):.1f}x, "
        f"{8 * len(blob) / nvert:.2f} bits/vertex"
    )
    mt = nface / max(t3 - t2, 1e-9) / 1e6
    print(f"decode throughput {mt:.2f} MT/s")

    out_path = args.output or (args.mesh.rsplit(".", 1)[0] + ".crt")
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
