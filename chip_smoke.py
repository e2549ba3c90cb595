#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`uvol_tpu_torch`) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from `uvol_tpu_torch/csrc/` (nvcc, sm_90a),
holds each kernel bit-for-bit against its plain PyTorch twin, drives the
flagship codec chain at full width (32 frames x 26,145 vertices, 32
layers of 1024x1024) and the ETC1S/BasisLZ segment encoder at the
encoder CLI's segment (5 layers of 1024x1024, 256/256 palettes) through
the codecs' public entry points, holds every K4-K6 call that a segment
encode makes against the plain twin on the same inputs, checks the
bytes against the CPU codecs, times kernels and chains with CUDA
events, and traces one pass
of each codec stage with `torch.profiler` to split its time between
host and device. Each phase prints one JSON line; then come the card's
`nvidia-smi` name/power-limit line, the kernels line, and last
`{"ok": true, "device": {...}}`.

Any failed check raises and the script exits non-zero without the last
line. Without a CUDA card, or without the rest of the repository beside
it, it exits non-zero before printing anything on stdout.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
F, N, H, W = 32, 26145, 1024, 1024  # the bench's liam-scale batch
REPS = 5  # timed runs per number (median), after one warmup
PARITY_SIDE = 1024  # random parity inputs: one 1024^2 layer = 65,536 blocks
ETC1S_LAYERS = 5  # the encoder CLI's KTX2_BATCH_SIZE: one segment
ETC1S_PALETTE = 256  # endpoints = selectors, encode_ktx2_etc1s's default
ETC1S_ENTRIES = (256, 1024)  # K4 endpoints / K6 centroids held at parity
ETC1S_CPU_SIDE = 256  # the CPU comparison: 1 layer of 256x256
ETC1S_REPS = 3  # timed segment encodes (median), after the warmup
#: K4-K6 kernel names in a profiler trace (csrc/etc1s.cu)
ETC1S_KERNEL_NAMES = ("assign_endpoints_kernel", "inten_errors_kernel",
                      "kmeans_tile_kernel", "pair_sum_kernel")
#: K4-K6: launch-count name -> (wrapper, plain twin) in etc1s_cuda
ETC1S_KERNELS = {
    "etc1s_assign_endpoints": ("assign_endpoints", "assign_endpoints_plain"),
    "etc1s_inten_errors": ("inten_errors", "inten_errors_plain"),
    "etc1s_kmeans_iter": ("kmeans_iter", "kmeans_iter_plain"),
}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def hold(err: dict, name: str, got, *twins) -> None:
    """Fail unless the kernel's output `got` (a tensor or a tuple of
    them) equals every twin's; keep the largest |difference| in err[name].
    int32 indices and errors, f32 sums: all exact in f64."""
    got = got if isinstance(got, tuple) else (got,)
    for tw in twins:
        tw = tw if isinstance(tw, tuple) else (tw,)
        for g, t in zip(got, tw, strict=True):
            e = float((g.cpu().double() - t.cpu().double()).abs().max())
            check(e == 0, f"{name} differs from its plain twin")
            err[name] = max(err.get(name, 0), e)


@contextlib.contextmanager
def recorded_etc1s_calls(k):
    """Keep (name, arguments, output) of every K4-K6 call made inside, as
    the encoder made it; the calls launch as they would without this."""
    calls = []
    saved = {fn: getattr(k, fn) for fn, _ in ETC1S_KERNELS.values()}

    def recording(name, fn):
        def call(*args):
            out = fn(*args)
            calls.append((name, args, out))
            return out
        return call

    for name, (fn, _) in ETC1S_KERNELS.items():
        setattr(k, fn, recording(name, saved[fn]))
    try:
        yield calls
    finally:
        for fn, f in saved.items():
            setattr(k, fn, f)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def bench_batch():
    """The synthetic liam-scale batch of bench.py (smooth surface, strip
    connectivity, shifted gradient texture), from default_rng(0)."""
    r = np.random.default_rng(0)
    theta = r.uniform(0, np.pi, N)
    phi = r.uniform(0, 2 * np.pi, N)
    base = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1
    )
    positions = np.stack([base * (1 + 0.01 * k) for k in range(F)]).astype(np.float32)
    uvs = r.uniform(0, 1, (F, N, 2)).astype(np.float32)
    counts = np.full(F, N, np.int64)
    k = np.arange(2 * N - 2)
    strip = np.stack([k // 2, k // 2 + 1 + (k % 2), k // 2 + 2 - (k % 2)], 1)
    faces = [(strip % N).astype(np.int32) for _ in range(F)]
    yy, xx = np.mgrid[0:H, 0:W]
    tex = np.stack([(xx // 4) % 256, (yy // 4) % 256, ((xx + yy) // 8) % 256], -1)
    textures = np.stack([np.roll(tex, s, axis=1) for s in range(F)]).astype(np.uint8)
    return positions, uvs, counts, faces, textures


def boundary_blocks() -> np.ndarray:
    """Rounding-boundary blocks (tests/test_pallas_parity.py) and one flat
    block per value 0..255."""
    b = np.zeros((4, 4, 4, 3), np.uint8)
    b[0] = 127
    b[0, 0, 0, :] = 131
    b[1, :, :, 1] = 128
    b[3] = 255
    flat = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None, None],
                           (256, 4, 4, 3))
    return np.concatenate([b, flat])


def check_full_f32(torch) -> None:
    """The port runs its f32 matmuls in full f32 (TF32 off): the ETC1S
    selector errors are integer sums below 2^24 that TF32 would round."""
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 convolutions are on")
    check(torch.get_float32_matmul_precision() == "highest", "f32 matmul precision")


def etc1s_parity(torch, dev, textures, bb) -> dict:
    """K4, K5 and K6 against their plain twins on the card (and on the
    CPU for the boundary blocks): max_abs_err per kernel."""
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis.etc1s_encode import block_features

    r = np.random.default_rng(2)
    inputs = {
        "bench_texture_1x1024": textures[0].reshape(H // 4, 4, W // 4, 4, 3)
        .transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3),
        "random_blocks": r.integers(0, 256, ((PARITY_SIDE // 4) ** 2, 16, 3), dtype=np.uint8),
        "boundary_blocks": bb.reshape(-1, 16, 3),
    }
    err = {}
    for name, blocks_np in inputs.items():
        blocks = torch.from_numpy(np.ascontiguousarray(blocks_np))
        n = len(blocks)
        small = n < 4096  # the CPU twin too, where it is quick
        bd = blocks.to(dev)
        base = torch.from_numpy(r.integers(0, 256, (n, 3)).astype(np.int32))
        base[: min(n, 4)] = torch.tensor([[0, 0, 0], [255, 255, 255], [4, 251, 128],
                                          [251, 4, 7]])[: min(n, 4)]
        got = k.inten_errors(bd, base.to(dev))
        hold(err, "etc1s_inten_errors", got, k.inten_errors_plain(bd, base.to(dev)),
             *([k.inten_errors_plain(blocks, base)] if small else []))
        feats = block_features(bd)
        for e in ETC1S_ENTRIES:
            eb = torch.from_numpy(r.integers(0, 256, (e, 3)).astype(np.int32))
            ei = torch.from_numpy(r.integers(0, 8, e).astype(np.int32))
            eb[e - 1], ei[e - 1] = eb[0], ei[0]  # a duplicate endpoint: ties
            table = k.endpoint_table(eb, ei)
            got = k.assign_endpoints(bd, table.to(dev))
            hold(err, "etc1s_assign_endpoints", got,
                 k.assign_endpoints_plain(bd, table.to(dev)),
                 *([k.assign_endpoints_plain(blocks, table)] if small else []))
            pick = torch.from_numpy(r.integers(0, n, e)).to(dev)
            cb = feats[pick] + torch.from_numpy(r.random((e, 4)).astype(np.float32)).to(dev)
            hold(err, "etc1s_kmeans_iter", k.kmeans_iter(feats, cb),
                 k.kmeans_iter_plain(feats, cb),
                 *([k.kmeans_iter_plain(feats.cpu(), cb.cpu())] if small else []))
    torch.cuda.synchronize()
    emit({"phase": "etc1s_kernel_parity", "inputs": list(inputs), "entries": ETC1S_ENTRIES,
          "max_abs_err": err})
    return err


def etc1s_main_path(torch, textures) -> tuple:
    """`encode_ktx2_etc1s` on one segment at full width: launches, byte
    determinism, every K4-K6 call of the encode against its twin on the
    same inputs, transcoded PSNR, the quality floor's rebuilds, and the
    CPU port at 1 layer of 256x256. Returns (launches, max_abs_err)."""
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis.etc1s_encode import (
        encode_ktx2_etc1s, read_ktx2, transcode_ktx2_etc1s)

    frames = textures[:ETC1S_LAYERS]
    kw = dict(num_endpoints=ETC1S_PALETTE, num_selectors=ETC1S_PALETTE)
    encode_ktx2_etc1s(frames[:1, :256, :256], device=DEVICE, **kw)  # warmup
    torch.cuda.synchronize()
    k.reset_launches()
    t = time.perf_counter()
    blob = encode_ktx2_etc1s(frames, device=DEVICE, **kw)
    first_s = time.perf_counter() - t
    launches = dict(k.LAUNCHES)
    for name, v in launches.items():
        check(v >= 1, f"the ETC1S main path never launched {name}")
    # every palette build runs K5 three times (cluster_inten)
    builds = launches["etc1s_inten_errors"] // 3
    # the second encode keeps each kernel call's inputs (the real blocks,
    # endpoint tables and centroids, with their near-ties) and output
    with recorded_etc1s_calls(k) as calls:
        again = encode_ktx2_etc1s(frames, device=DEVICE, **kw)
    check(again == blob, "two CUDA encodes of one segment gave different bytes")
    err = {}
    replayed = {name: {"calls": 0, "shapes": []} for name in ETC1S_KERNELS}
    for name, args, out in calls:
        hold(err, name, out, getattr(k, ETC1S_KERNELS[name][1])(*args))
        rec, shapes = replayed[name], [list(a.shape) for a in args]
        rec["calls"] += 1
        if shapes not in rec["shapes"]:
            rec["shapes"].append(shapes)
    for name, rec in replayed.items():
        check(rec["calls"] == launches[name], f"{name}: calls differ between two encodes")
    dec = transcode_ktx2_etc1s(read_ktx2(blob))[..., :3]
    check(dec.shape == frames.shape and dec.dtype == np.uint8, "transcoded shape")
    mse = float(((dec.astype(np.float64) - frames) ** 2).mean())
    psnr = 10 * np.log10(255.0**2 / mse)
    check(np.isfinite(psnr) and psnr >= 24.0, f"ETC1S PSNR {psnr:.2f} dB")

    small = np.ascontiguousarray(frames[:1, :ETC1S_CPU_SIDE, :ETC1S_CPU_SIDE])
    t = time.perf_counter()
    cpu_blob = encode_ktx2_etc1s(small, device="cpu", **kw)
    cpu_s = time.perf_counter() - t
    cuda_blob = encode_ktx2_etc1s(small, device=DEVICE, **kw)
    same = cpu_blob == cuda_blob

    def small_psnr(b):
        out = transcode_ktx2_etc1s(read_ktx2(b))[..., :3].astype(np.float64)
        return 10 * np.log10(255.0**2 / float(((out - small) ** 2).mean()))

    p_cpu, p_cuda = small_psnr(cpu_blob), small_psnr(cuda_blob)
    check(same or (abs(p_cpu - p_cuda) <= 0.05
                   and abs(len(cpu_blob) - len(cuda_blob)) <= 0.01 * len(cpu_blob)),
          "CUDA and CPU ETC1S encodes differ beyond quality parity")
    emit({"phase": "etc1s_main_path", "layers": ETC1S_LAYERS, "size": [H, W],
          "palette": ETC1S_PALETTE, "launches": launches, "ktx2_bytes": len(blob),
          "transcoded_psnr_db": psnr, "lam_ladder_builds": builds,
          "first_encode_s": first_s, "deterministic": True,
          "calls_vs_twin": {"max_abs_err": err, "calls": replayed},
          "cpu_compare": {"size": [ETC1S_CPU_SIDE] * 2, "bytes_equal": same,
                          "cpu_bytes": len(cpu_blob), "cuda_bytes": len(cuda_blob),
                          "cpu_psnr_db": p_cpu, "cuda_psnr_db": p_cuda, "cpu_s": cpu_s}})
    return launches, err


def etc1s_times(torch, dev, textures, median_cuda_ms) -> tuple:
    """K4-K6 and their twins at the main path's shapes (5 x 1024^2 =
    327,680 blocks, 256 entries), each output held against its twin's;
    the palette core on device-resident blocks, the palette build and
    the segment encode, host-inclusive. Returns (ms, max_abs_err)."""
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis.etc1s_encode import (
        _blocks_of, block_features, build_palettes, encode_ktx2_etc1s, palette_core)

    frames = textures[:ETC1S_LAYERS]
    bd = torch.from_numpy(_blocks_of(frames)).to(dev)
    n = len(bd)
    r = np.random.default_rng(3)
    feats = block_features(bd)
    cb = feats[torch.from_numpy(r.integers(0, n, ETC1S_PALETTE)).to(dev)]
    eb = torch.from_numpy(r.integers(0, 256, (ETC1S_PALETTE, 3)).astype(np.int32)).to(dev)
    ei = torch.from_numpy(r.integers(0, 8, ETC1S_PALETTE).astype(np.int32)).to(dev)
    table = k.endpoint_table(eb, ei)
    base = eb[k.kmeans_iter(feats, cb)[2].long()]
    ms, err = {}, {}
    for name, args in (("etc1s_assign_endpoints", (bd, table)),
                       ("etc1s_inten_errors", (bd, base)),
                       ("etc1s_kmeans_iter", (feats, cb))):
        kernel, twin = (getattr(k, fn) for fn in ETC1S_KERNELS[name])
        hold(err, name, kernel(*args), twin(*args))
        ms[name] = median_cuda_ms(lambda: kernel(*args), REPS)
        ms[name + "_plain"] = median_cuda_ms(lambda: twin(*args), REPS)
    # the encode, and the two stages inside it: the device-resident palette
    # core, and the build (upload, core, refine, fetch, host relabel)
    kw = dict(num_endpoints=ETC1S_PALETTE, num_selectors=ETC1S_PALETTE, device=DEVICE)
    ms["etc1s_palette_core"] = median_cuda_ms(
        lambda: palette_core(bd, ETC1S_PALETTE, ETC1S_PALETTE, 6), ETC1S_REPS)
    ms["etc1s_build_palettes"] = median_cuda_ms(
        lambda: build_palettes(frames, ETC1S_PALETTE, ETC1S_PALETTE, device=DEVICE),
        ETC1S_REPS, warmup=0)
    ms["etc1s_segment_encode"] = median_cuda_ms(lambda: encode_ktx2_etc1s(frames, **kw),
                                                ETC1S_REPS, warmup=0)
    emit({"phase": "etc1s_times", "blocks": n, "entries": ETC1S_PALETTE, "reps": REPS,
          "max_abs_err": err, "ms": ms,
          "segment_layers_per_s": ETC1S_LAYERS / (ms["etc1s_segment_encode"] / 1e3)})
    return ms, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    # the port; alone in a directory this import fails before any output
    from uvol_tpu_torch import _build
    from uvol_tpu_torch.codecs.basis import etc as tetc
    from uvol_tpu_torch.codecs.basis import etc_cuda
    from uvol_tpu_torch.models.sequence import (
        GeometryFrameSet,
        GeometrySequenceCodec,
        TextureSequenceCodec,
        decode_device,
        encode_device,
        host_rans_is_native,
        read_ktx2,
    )
    from uvol_tpu_torch.codecs.basis.etc1s_encode import encode_ktx2_etc1s
    from uvol_tpu_torch._device import true_div
    from uvol_tpu_torch.utils.timing import device_time_ms, device_trace, median_cuda_ms

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    check_full_f32(torch)

    # ---- 1. environment ------------------------------------------------------
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "native_rans_loaded": host_rans_is_native()})

    # ---- 2. build --------------------------------------------------------------
    t = time.perf_counter()
    so = _build.build()
    _build.get_lib()
    emit({"phase": "build", "library": str(so.relative_to(so.parents[2])),
          "seconds": time.perf_counter() - t})

    # ---- 3. kernel parity: kernel (CUDA) vs plain twin on CUDA and on CPU -----
    positions, uvs, counts, faces, textures = bench_batch()
    r = np.random.default_rng(1)
    bb = boundary_blocks()
    enc_inputs = {
        "bench_texture_4x1024": textures[:4],
        "random_blocks": r.integers(0, 256, (1, PARITY_SIDE, PARITY_SIDE, 3),
                                    dtype=np.uint8),
        "boundary_blocks": tetc.blocks_to_image(torch.from_numpy(bb)[None], 4,
                                                4 * len(bb)).numpy(),
    }
    err = {"etc1_encode": 0, "etc1_decode": 0}
    dec_inputs = {}
    for name, img in enc_inputs.items():
        x = torch.from_numpy(np.ascontiguousarray(img))
        got = etc_cuda.encode_etc1_images(x.to(dev))
        twin_dev = etc_cuda.encode_etc1_images_plain(x.to(dev))
        twin_cpu = etc_cuda.encode_etc1_images_plain(x)
        got_h = got.cpu().to(torch.int64)
        e = max(int((got_h - twin_dev.cpu()).abs().max()),
                int((got_h - twin_cpu).abs().max()))
        check(e == 0, f"K1 differs from its plain twin on {name}")
        err["etc1_encode"] = max(err["etc1_encode"], e)
        dec_inputs[name] = (got.cpu(), img.shape[:3])
    rw = r.integers(0, 2**32, ((PARITY_SIDE // 4) ** 2, 2), dtype=np.uint32)
    dec_inputs["random_words"] = (torch.from_numpy(rw.view(np.int32)),
                                  (1, PARITY_SIDE, PARITY_SIDE))
    for name, (words, (l, h, w)) in dec_inputs.items():
        got = etc_cuda.decode_etc1_images(words.to(dev), l, h, w).cpu().to(torch.int16)
        twin_dev = etc_cuda.decode_etc1_images_plain(words.to(dev), l, h, w).cpu()
        twin_cpu = etc_cuda.decode_etc1_images_plain(words, l, h, w)
        e = max(int((got - twin_dev.to(torch.int16)).abs().max()),
                int((got - twin_cpu.to(torch.int16)).abs().max()))
        check(e == 0, f"K2 differs from its plain twin on {name}")
        err["etc1_decode"] = max(err["etc1_decode"], e)
    emit({"phase": "kernel_parity", "inputs_k1": list(enc_inputs),
          "inputs_k2": list(dec_inputs), "max_abs_err": err})
    err.update(etc1s_parity(torch, dev, textures, bb))

    # ---- 4. main path at full width ---------------------------------------------
    frames = GeometryFrameSet(positions, uvs, counts, faces)
    geo = GeometrySequenceCodec(position_bits=11, uv_bits=10, device=DEVICE)
    texc = TextureSequenceCodec(sequence_size=F, device=DEVICE)

    def encode_all():
        return geo.encode(frames), texc.encode_segment(textures)

    def decode_all(blobs, tex_blob):
        return (geo.decode(blobs, as_numpy=False),
                texc.decode_segment(read_ktx2(tex_blob), as_numpy=False))

    decode_all(*encode_all())  # warmup: allocator, library load
    etc_cuda.reset_launches()
    blobs, tex_blob = encode_all()
    dec, tex_dec = decode_all(blobs, tex_blob)
    torch.cuda.synchronize()
    launches = dict(etc_cuda.LAUNCHES)
    for k, v in launches.items():
        check(v >= 1, f"main path never launched {k}")

    # geometry: bytes equal to the CPU codec's, error within one step
    geo_cpu = GeometrySequenceCodec(position_bits=11, uv_bits=10, device="cpu")
    check(geo_cpu.encode(frames) == blobs, ".uvtg bytes differ between CUDA and CPU")
    dec_cpu = geo_cpu.decode(blobs, as_numpy=False)
    check(tuple(dec.positions.shape) == (F, 3, N), "decoded positions shape")
    pos_dev = dec.positions.cpu()
    check(bool(torch.isfinite(pos_dev).all()), "non-finite decoded positions")
    geo_err = float((pos_dev - dec_cpu.positions).abs().max())
    uv_err = float((dec.uvs.cpu() - dec_cpu.uvs).abs().max())
    # same float32 ops in the same order on both devices: expected 0
    check(geo_err == 0.0 and uv_err == 0.0, "decoded floats differ CUDA vs CPU")
    step = float((positions[0].max(0) - positions[0].min(0)).max()) / 2047
    pos_err = float(np.abs(pos_dev[0].numpy().T - positions[0]).max())
    check(pos_err <= step, f"position error {pos_err} > step {step}")

    # texture: bytes equal to the plain twin on CUDA (32 layers) and to the
    # CPU codec (2 layers); pixels equal to the plain twin's decode
    tex_dev = torch.from_numpy(textures).to(dev)
    words_plain = etc_cuda.encode_etc1_images_plain(tex_dev)
    check(texc.segment_from_words(words_plain, F, H, W) == tex_blob,
          ".ktx2 bytes differ between K1 and its plain twin")
    check(bool(torch.equal(etc_cuda.decode_etc1_images_plain(words_plain, F, H, W),
                           tex_dec)), "decoded layers differ from the plain twin")
    tex2_cuda = TextureSequenceCodec(sequence_size=2, device=DEVICE)
    tex2_cpu = TextureSequenceCodec(sequence_size=2, device="cpu")
    check(tex2_cuda.encode_segment(textures[:2]) == tex2_cpu.encode_segment(textures[:2]),
          ".ktx2 bytes differ between CUDA and CPU at 2 layers")
    check(tuple(tex_dec.shape) == (F, H, W, 3) and tex_dec.dtype == torch.uint8,
          "decoded texture shape")
    mse = float(((tex_dec.float() - tex_dev.float()) ** 2).mean())
    psnr = 10 * np.log10(255.0**2 / mse)
    check(psnr > 30.0, f"texture PSNR {psnr:.2f} dB")
    emit({"phase": "main_path", "frames": F, "vertices": N, "layers": F,
          "size": [H, W], "launches": launches, "uvtg_bytes": sum(map(len, blobs)),
          "ktx2_bytes": len(tex_blob), "pos_err": pos_err, "step": step,
          "cuda_vs_cpu_max_abs_err": {"positions": geo_err, "uvs": uv_err},
          "texture_psnr_db": psnr})
    etc1s_launches, main_err = etc1s_main_path(torch, textures)
    launches.update(etc1s_launches)

    # ---- 5. times (CUDA events, median of REPS after one warmup) -----------------
    words = etc_cuda.encode_etc1_images(tex_dev)
    ms = {
        "etc1_encode": median_cuda_ms(lambda: etc_cuda.encode_etc1_images(tex_dev), REPS),
        "etc1_encode_plain": median_cuda_ms(
            lambda: etc_cuda.encode_etc1_images_plain(tex_dev), REPS),
        "etc1_decode": median_cuda_ms(
            lambda: etc_cuda.decode_etc1_images(words, F, H, W), REPS),
        "etc1_decode_plain": median_cuda_ms(
            lambda: etc_cuda.decode_etc1_images_plain(words, F, H, W), REPS),
    }
    dev_pos = torch.from_numpy(positions.transpose(0, 2, 1).copy()).to(dev)
    dev_uv = torch.from_numpy(uvs.transpose(0, 2, 1).copy()).to(dev)
    dev_mask = torch.ones((F, N), dtype=torch.bool, device=dev)

    def device_chain():
        out = encode_device(dev_pos, dev_uv, dev_mask, 11, 10)
        w = etc_cuda.encode_etc1_images(tex_dev)
        pos2, uv2 = decode_device(
            out["pos_syms"], out["pos_min"], true_div(out["pos_range"], 2047.0),
            out["uv_syms"], out["uv_min"], true_div(out["uv_range"], 1023.0),
        )
        return pos2, uv2, etc_cuda.decode_etc1_images(w, F, H, W)

    ms["device_chain"] = median_cuda_ms(device_chain, REPS)
    ms["host_encode"] = median_cuda_ms(encode_all, REPS)
    ms["host_decode"] = median_cuda_ms(lambda: decode_all(blobs, tex_blob), REPS)
    fps = {k: F / (ms[k] / 1e3) for k in ("device_chain", "host_encode", "host_decode")}
    emit({"phase": "times", "frames": F, "reps": REPS, "ms": ms, "frames_per_s": fps})
    etc1s_ms, times_err = etc1s_times(torch, dev, textures, median_cuda_ms)
    ms.update(etc1s_ms)
    for e in (main_err, times_err):  # the kernels line: the worst of every comparison
        for name, v in e.items():
            err[name] = max(err[name], v)

    # ---- 6. one torch.profiler pass per host-inclusive stage ------------------
    # wall_ms includes the profiler's own overhead; device_ms sums the
    # device-side events (one stream, so they do not overlap)
    stages = {
        "geometry_encode": lambda: geo.encode(frames),
        "texture_encode": lambda: texc.encode_segment(textures),
        "geometry_decode": lambda: geo.decode(blobs, as_numpy=False),
        "texture_decode": lambda: texc.decode_segment(read_ktx2(tex_blob), as_numpy=False),
        "etc1s_segment_encode": lambda: encode_ktx2_etc1s(
            textures[:ETC1S_LAYERS], num_endpoints=ETC1S_PALETTE,
            num_selectors=ETC1S_PALETTE, device=DEVICE),
    }
    profile = {}
    for name, fn in stages.items():
        with device_trace() as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        by_name = device_time_ms(prof)
        kinds = {"h2d": 0.0, "d2h": 0.0, "etc1_kernels": 0.0, "etc1s_kernels": 0.0,
                 "other": 0.0}
        for k, v in by_name.items():
            kind = ("h2d" if k.startswith("Memcpy HtoD") else
                    "d2h" if k.startswith("Memcpy DtoH") else
                    "etc1_kernels" if "etc1_" in k else
                    "etc1s_kernels" if any(kn in k for kn in ETC1S_KERNEL_NAMES) else "other")
            kinds[kind] += v
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        profile[name] = {
            "wall_ms": wall, "device_ms": kinds, "device_busy_share": busy / wall,
            "host_ms": wall - busy, "top": [[k[:80], v] for k, v in top],
        }
    emit({"phase": "profile", "stages": profile, "total_s": time.perf_counter() - t_start})

    check_full_f32(torch)
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": [
        {"name": "etc1_encode", "route": "cuda", "source": "uvol_tpu_torch/csrc/etc1.cu",
         "replaces": "uvol_tpu/codecs/basis/etc_pallas.py:230",
         "launches": launches["etc1_encode"], "max_abs_err": err["etc1_encode"],
         "ms": ms["etc1_encode"], "plain_ms": ms["etc1_encode_plain"]},
        {"name": "etc1_decode", "route": "cuda", "source": "uvol_tpu_torch/csrc/etc1.cu",
         "replaces": "uvol_tpu/codecs/basis/etc_pallas.py:350",
         "launches": launches["etc1_decode"], "max_abs_err": err["etc1_decode"],
         "ms": ms["etc1_decode"], "plain_ms": ms["etc1_decode_plain"]},
    ] + [
        {"name": name, "route": "cuda", "source": "uvol_tpu_torch/csrc/etc1s.cu",
         "replaces": f"uvol_tpu/codecs/basis/etc1s_pallas.py:{line}",
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": ms[name + "_plain"]}
        for name, line in (("etc1s_assign_endpoints", 149), ("etc1s_inten_errors", 217),
                           ("etc1s_kmeans_iter", 310))
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
