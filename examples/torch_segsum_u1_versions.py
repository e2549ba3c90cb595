"""Time the segment sum, K6 and U1 of one tree of this repository on one CUDA card.

    python3 examples/torch_segsum_u1_versions.py [--tree DIR] [--label NAME]

Imports `uvol_tpu_torch` from DIR (default: this checkout) and builds its
kernels there, so that two versions compare in one call on one card:
unpack another commit with `git archive` into a directory that
`.gitignore` lists (under `build/`) and run parent, change, change,
parent. The timing helpers come from this checkout's `chip_smoke.py`.

On the encoder CLI's segment (the bench texture's first 5 layers of
1024^2: 327,680 blocks) it records every segment-sum and K6 call that
`palette_core` makes at 256/256 and at 1,024/1,024, holds each against
its plain twin bit for bit, and times each alone (profiler device time,
`chip_smoke.kernel_only_ms`): per call and summed per build. Then the
segment sum at N = 327,680, D = 64 on random assignments at k = 256,
1,024 and 2,048 and on skewed ones (90% of the rows in one segment), and
K6 at 256 centroids, alone and per call (CUDA events). Then U1 at
2,097,152 blocks with modes [0, 5] on four block classes (the bench's
gradient blocks, random, flat, two-colour), alone and per call, each
held against its twin. Where the tree exports `uastc_cuda.weight_index`,
it is held against the scan for every float32 in [0, 64] on each weight
table. Prints the card's `nvidia-smi` name/power-limit line and one JSON
object, also written to `build/versions_<NAME>.json` (`--out`).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REPS = 3
SEG_N, SEG_D = 327680, 64
U1_MODES = (0, 5)
WEIGHT_CHUNK = 1 << 25  # floats a weight-index comparison takes at a time


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_bits(torch, got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))
    import torch

    cs = load_chip_smoke()
    from uvol_tpu_torch import _build
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis import uastc_cuda
    from uvol_tpu_torch.codecs.basis.etc1s_encode import _blocks_of, block_features, palette_core
    from uvol_tpu_torch.utils.timing import median_cuda_ms

    check = cs.check
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    _build.get_lib()
    out = {"label": a.label, "package": str(Path(k.__file__).resolve().parents[2]),
           "build_s": time.perf_counter() - t0}
    textures = cs.bench_batch()[4]
    bd = torch.from_numpy(_blocks_of(textures[:cs.ETC1S_LAYERS])).to(dev)
    seg_names = cs.WRAPPER_KERNELS["etc1s_segment_sum"]
    km_names = cs.WRAPPER_KERNELS["etc1s_kmeans_iter"]

    # the segment-sum and K6 calls of two palette builds, replayed
    builds = {}
    for palette in (256, 1024):
        with cs.recorded_etc1s_calls(k) as calls:
            palette_core(bd, palette, palette, 6)
        rows, total = [], {"etc1s_segment_sum": 0.0, "etc1s_kmeans_iter": 0.0}
        for name, args, got in calls:
            if name not in total:
                continue
            plain = getattr(k, cs.ETC1S_KERNELS[name][1])
            check(same_bits(torch, got, plain(*args)), f"{name} differs from its twin")
            fn = getattr(k, cs.ETC1S_KERNELS[name][0])
            ms, _ = cs.kernel_only_ms(torch, lambda: fn(*args),
                                      seg_names if name == "etc1s_segment_sum" else km_names,
                                      REPS)
            total[name] += ms
            shape = ([args[1], list(args[2].shape)] if name == "etc1s_segment_sum"
                     else [list(args[0].shape), list(args[1].shape)])
            rows.append([name, shape, ms])
        builds[f"{palette}/{palette}"] = {"alone_ms_sum": total, "calls": rows}
    out["builds"] = builds

    # the segment sum at N x 64: random k = 256, 1,024, 2,048 and skewed
    r = np.random.default_rng(12)
    x = torch.from_numpy(r.integers(-400, 400, (SEG_N, SEG_D)).astype(np.float32)).to(dev)
    seg = {}
    for kk, skew in ((256, False), (1024, False), (2048, False), (256, True), (1024, True)):
        idx = r.integers(0, kk, SEG_N)
        if skew:
            idx = np.where(r.random(SEG_N) < 0.9, kk // 3, idx)
        idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
        check(same_bits(torch, k.segment_sum(idx, kk, x), k.segment_sum_plain(idx, kk, x)),
              "the segment sum differs from its twin")
        alone, _ = cs.kernel_only_ms(torch, lambda: k.segment_sum(idx, kk, x), seg_names, REPS)
        per_kernel = {n: cs.kernel_only_ms(torch, lambda: k.segment_sum(idx, kk, x), (n,),
                                           REPS)[0] for n in seg_names}
        seg[f"k{kk}{'_skew90' if skew else ''}"] = {
            "alone_ms": alone, "per_kernel_ms": per_kernel,
            "call_ms": median_cuda_ms(lambda: k.segment_sum(idx, kk, x), REPS)}
    out["segment_sum_n327680_d64"] = seg
    feats = block_features(bd)
    cb = feats[torch.from_numpy(r.integers(0, len(bd), 256)).to(dev)]
    check(same_bits(torch, k.kmeans_iter(feats, cb), k.kmeans_iter_plain(feats, cb)),
          "K6 differs from its twin")
    out["kmeans_iter_256"] = {
        "alone_ms": cs.kernel_only_ms(torch, lambda: k.kmeans_iter(feats, cb), km_names, REPS)[0],
        "call_ms": median_cuda_ms(lambda: k.kmeans_iter(feats, cb), REPS)}
    del x, feats, bd

    # U1 on four block classes at the main path's 2,097,152 blocks
    grad = cs.uastc_blocks(textures)
    nb = len(grad)
    classes = {
        "bench_gradient": grad,
        "random": r.integers(0, 256, (nb, 16, 4), dtype=np.uint8),
        "flat": np.repeat(r.integers(0, 256, (nb, 1, 4), dtype=np.uint8), 16, 1),
        "two_colour": np.where(r.random((nb, 16, 1)) < 0.5, r.integers(0, 256, (nb, 1, 4)),
                               r.integers(0, 256, (nb, 1, 4))).astype(np.uint8),
    }
    u1 = {}
    for name, px in classes.items():
        px = torch.from_numpy(np.ascontiguousarray(px)).to(dev)
        check(same_bits(torch, uastc_cuda.device_fit(px, U1_MODES),
                        uastc_cuda.device_fit_select_plain(px, U1_MODES)),
              f"U1 differs from its twin on {name}")
        u1[name] = {
            "alone_ms": cs.kernel_only_ms(torch, lambda: uastc_cuda.device_fit(px, U1_MODES),
                                          cs.WRAPPER_KERNELS["uastc_device_fit"], REPS)[0],
            "call_ms": median_cuda_ms(lambda: uastc_cuda.device_fit(px, U1_MODES), REPS)}
    out["u1_2097152_blocks_modes_0_5"] = u1

    # the closed-form weight index against the scan, every float32 in [0, 64]
    if hasattr(uastc_cuda, "weight_index"):
        from uvol_tpu_torch.codecs.basis.uastc import WEIGHT_TABLES

        top = int(np.float32(64.0).view(np.int32))
        t = time.perf_counter()
        bad = {}
        for levels in WEIGHT_TABLES:
            bad[levels] = 0
            for lo in range(0, top + 1, WEIGHT_CHUNK):
                w = torch.arange(lo, min(lo + WEIGHT_CHUNK, top + 1), dtype=torch.int32,
                                 device=dev).view(torch.float32)
                bad[levels] += int((uastc_cuda.weight_index(w, levels)
                                    != uastc_cuda.weight_index_plain(w, levels)).sum())
        torch.cuda.synchronize()
        out["weight_index_exhaustive"] = {"floats": top + 1, "mismatches": bad,
                                          "s": time.perf_counter() - t}
        check(not any(bad.values()), f"the closed-form weight index misses: {bad}")

    attrs = _build.kernel_attrs()  # pass 1's dynamic bytes: those of its last launch above
    out["kernel_attrs"] = {n: attrs[n] for n in (*seg_names, *km_names,
                                                 *cs.WRAPPER_KERNELS["uastc_device_fit"])}
    dest = Path(a.out or ROOT / "build" / f"versions_{a.label}.json")
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
