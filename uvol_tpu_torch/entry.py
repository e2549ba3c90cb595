"""The driver's entry points — counterparts of `__graft_entry__`.

`entry`: the fused per-batch encode step. Geometry quantize + delta +
zigzag on the interleaved [F, N, C] layout, and the ETC1 encode of the
texture layers (kernel K1 on a card, its plain twin on the CPU), from
the same numpy inputs as the reference.

`dryrun_multichip(n)`: the multi-device checks of
`__graft_entry__.dryrun_multichip` on n spawned ranks.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from uvol_tpu_torch._device import DeviceLike, resolve_device
from uvol_tpu_torch.codecs.basis.etc_cuda import encode_etc1_images
from uvol_tpu_torch.ops.prediction import delta_encode
from uvol_tpu_torch.ops.quantize import quantize, zigzag_encode


def forward(positions, uvs, mask, textures):
    """positions [F, N, 3] f32, uvs [F, N, 2] f32, mask [F, N] bool,
    textures [F, H, W, 3] uint8 → symbols (int32 bit patterns of the
    reference's uint32), per-frame min/range and [F, nb, 2] ETC1 words."""
    qp = quantize(positions, 11, mask=mask)
    qu = quantize(uvs, 10, mask=mask)
    f = textures.shape[0]
    return {
        "pos_syms": zigzag_encode(delta_encode(qp.values)),
        "uv_syms": zigzag_encode(delta_encode(qu.values)),
        "pos_min": qp.min_value,
        "pos_range": qp.range_value,
        "uv_min": qu.min_value,
        "uv_range": qu.range_value,
        "tex_words": encode_etc1_images(textures).reshape(f, -1, 2),
    }


def example_inputs(f: int = 4, n: int = 4096, size: int = 128):
    """The reference's numpy example batch, from `default_rng(0)`."""
    r = np.random.default_rng(0)
    return (
        r.normal(size=(f, n, 3)).astype(np.float32),
        r.uniform(size=(f, n, 2)).astype(np.float32),
        np.ones((f, n), bool),
        r.integers(0, 256, (f, size, size, 3)).astype(np.uint8),
    )


def entry(device: DeviceLike = None):
    """(forward, example_args) with the example batch on `device`."""
    dev = resolve_device(device)
    return forward, tuple(torch.from_numpy(a).to(dev) for a in example_inputs())


def _dryrun_rank(n: int, device_type: str) -> dict:
    """One rank of `dryrun_multichip`: the sharded geometry and texture
    codecs against one device, the sharded ETC1S palette build, two
    codebook training steps, and for an even n >= 4 the streams x frames
    mesh with its nested sums. Returns what every rank must agree on."""
    from uvol_tpu_torch.codecs.basis.etc1s_encode import build_palettes
    from uvol_tpu_torch.containers.ktx2 import read_ktx2
    from uvol_tpu_torch.models.codebook import make_sharded_train_step
    from uvol_tpu_torch.models.sequence import (
        GeometryFrameSet,
        GeometrySequenceCodec,
        TextureSequenceCodec,
    )
    from uvol_tpu_torch.parallel.mesh import (
        all_sum_in_rank_order,
        axis_rank,
        make_mesh,
        mesh_device,
        shard_frames,
    )

    mesh = make_mesh(n, device_type=device_type)
    dev = mesh_device(mesh)
    r = np.random.default_rng(0)
    f = n * 2  # frames sharded over the ranks, 2 a rank
    n_verts, hw = 256, 32

    # ---- the production geometry codec, frame-sharded
    positions = r.normal(size=(f, n_verts, 3)).astype(np.float32)
    uvs = r.uniform(0, 1, (f, n_verts, 2)).astype(np.float32)
    counts = np.full(f, n_verts, np.int64)
    k = np.arange(64)
    faces = [np.stack([k, k + 1, k + 2], 1).astype(np.int32) % n_verts] * f
    frames = GeometryFrameSet(positions, uvs, counts, faces)
    blobs = GeometrySequenceCodec(mesh=mesh).encode(frames)
    dec = GeometrySequenceCodec(mesh=mesh).decode(blobs)
    if len(blobs) != f or dec.positions.shape[0] != f:
        raise AssertionError("the sharded geometry codec lost frames")
    if GeometrySequenceCodec(device=dev).encode(frames) != blobs:
        raise AssertionError("sharded .uvtg bytes differ from one device's")

    # ---- the production texture codec, layer-sharded
    tex_frames = r.integers(0, 256, (f, hw, hw, 3)).astype(np.uint8)
    texc = TextureSequenceCodec(sequence_size=f, mesh=mesh)
    tex_blob = texc.encode_segment(tex_frames)
    if texc.decode_segment(read_ktx2(tex_blob)).shape != tex_frames.shape:
        raise AssertionError("sharded texture decode shape")
    if TextureSequenceCodec(sequence_size=f, device=dev).encode_segment(tex_frames) != tex_blob:
        raise AssertionError("sharded .ktx2 bytes differ from one device's")

    # ---- the production ETC1S palette build, block-sharded
    pal = build_palettes(tex_frames, 32, 32, kmeans_iters=2, rdo=False, mesh=mesh)
    if pal.block_endpoint.shape != (f, (hw // 4) ** 2) or len(pal.color5) != 32 \
            or len(pal.selectors) != 32:
        raise AssertionError("sharded palette shapes")

    # ---- the codebook training step: frame-sharded blocks, cross-rank sums
    blocks = r.integers(0, 256, (f, (hw // 4) ** 2, 48)).astype(np.float32)
    codebook = torch.from_numpy(r.integers(0, 256, (128, 48)).astype(np.float32)).to(dev)
    step = make_sharded_train_step(mesh)
    local = shard_frames(mesh, blocks)
    new_codebook, distortion = step(local, codebook)
    d0 = float(distortion)
    _, distortion2 = step(local, new_codebook)  # Lloyd: no increase
    if not float(distortion2) <= d0 + 1e-3:
        raise AssertionError(f"Lloyd step raised the distortion: {d0} -> {float(distortion2)}")
    out = {
        "geo_blobs": hashlib.sha256(b"".join(blobs)).hexdigest(),
        "tex_blob": hashlib.sha256(tex_blob).hexdigest(),
        "palette": hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in (
            pal.color5, pal.inten, pal.selectors, pal.block_endpoint,
            pal.block_selector))).hexdigest(),
        "codebook": hashlib.sha256(new_codebook.cpu().numpy().tobytes()).hexdigest(),
        "distortion": [d0, float(distortion2)],
    }

    # ---- streams x frames: frame-parallel within a stream, then across streams
    if n >= 4 and n % 2 == 0:
        from uvol_tpu_torch.ops.prediction import delta_encode
        from uvol_tpu_torch.ops.quantize import quantize, zigzag_encode

        streams_ax, frames_ax = 2, n // 2
        mesh2 = make_mesh(n, axis_shapes=(streams_ax, frames_ax),
                          axis_names=("streams", "frames"), device_type=device_type)
        sf_pos = r.normal(size=(streams_ax * 2, frames_ax * 2, n_verts, 3)).astype(np.float32)
        s, fr = axis_rank(mesh2, "streams"), axis_rank(mesh2, "frames")
        local = torch.from_numpy(sf_pos[2 * s:2 * s + 2, 2 * fr:2 * fr + 2].copy()).to(dev)
        q = quantize(local.reshape(-1, n_verts, 3), 11)
        syms = zigzag_encode(delta_encode(q.values)).reshape(local.shape)
        total = all_sum_in_rank_order(
            mesh2, all_sum_in_rank_order(mesh2, q.values.sum(), "frames"), "streams")
        if tuple(syms.shape) != (2, 2, n_verts, 3) or not float(total) >= 0:
            raise AssertionError("streams x frames step")
        out["streams_total"] = float(total)
    return out


def dryrun_multichip(n: int, *, device_type: str = "cuda", timeout: float = 600.0) -> dict:
    """The multi-device checks of `__graft_entry__.dryrun_multichip` on n
    spawned ranks (`parallel.ranks.run_ranks`): on the card unless
    `device_type="cpu"`, where the ranks stand in for the reference's
    virtual CPU devices. Raises if a rank fails or the ranks disagree;
    returns rank 0's record."""
    from uvol_tpu_torch.parallel.ranks import run_ranks

    resolve_device(device_type)
    if device_type == "cuda":  # once here, not once a rank
        from uvol_tpu_torch import _build

        _build.build()
    results = run_ranks(_dryrun_rank, n, n, device_type, device_type=device_type,
                        timeout=timeout)
    if any(res != results[0] for res in results[1:]):
        raise AssertionError(f"the ranks disagree: {results}")
    d0, d1 = results[0]["distortion"]
    print(f"dryrun_multichip ok: {n} ranks ({device_type}), production geo/tex/etc1s codecs "
          f"sharded ({2 * n} frames), kmeans distortion {d0:.1f} -> {d1:.1f}"
          + (", streams-mesh ok" if "streams_total" in results[0] else ""))
    return results[0]
