"""Time K6, the segment sum and K7 past 2,048 centroids, segments or entries, for one tree of this repository, on one CUDA card.

    python3 examples/torch_wide_palette_versions.py [--tree DIR] [--label NAME] [--out FILE]
        [--parts kmeans,segment_sum,rate_sweep,segment_b]

K6 is `etc1s_cuda.kmeans_iter`, the segment sum `etc1s_cuda.segment_sum`, K7
`etc1s_cuda.rate_sweep_frame` (`csrc/etc1s.cu`); `--parts` picks the
sections (default: all). Imports `uvol_tpu_torch` from DIR (default: this
checkout) and builds its kernels there, so that two versions compare in one
call on one card: unpack another commit with `git archive` into a directory
that `.gitignore` lists (under `build/`) and run parent, change, change,
parent, each in a process of its own. The timing helpers come from this
checkout's `chip_smoke.py`.

K6 on segment B's 327,680 blocks (5 layers of 1024^2 of the bench
texture; the features the smoke's wide phase times: mean color and mean
channel deviation) with centroids drawn from them, at 256 (the one-window
kernel), 4,096 and 16,128: the call, the kernels alone (each and together),
the kernels a call launches (the profiler's host records), the plain twin
once, every output bit for bit against the twin on the card, and the bound
(8 FLOP a row and centroid). Where the tree has K6's wide assignment
(`kmeans_assign_wide_kernel`): the share of (row, centroid) pairs
re-checked exactly and of warp steps that took the re-check path (its
counters, `chip_smoke.kmeans_recheck_rates`); the same at 4,096 on an
all-equal codebook; and the filter's loop in the library's SASS, whose
steady block's instructions a (row, centroid) set the floor at 33.5 T
thread-instructions/s.

The segment sum at the palette build's sel_update shape (327,680 rows,
D = 64) at k = 256 and 2,048 (the one-window path) and at 4,096 and 16,128
(past it), on random and on 90%-one-segment assignments: the call
(CUDA-event median), the kernels alone (profiler: every launch of a call
summed) together and each, the
plain twin once, `index_add_` of the same rows as the library yardstick,
and the bound (the rows read once, the sums written once); every output bit
for bit against the twin on the card. K7 on one 1024^2 frame (65,536
blocks, a previous frame) at 2,048, 4,096 and 16,128 entries: call, alone,
its twin once, `feat @ mat.T` (the error product) as the yardstick, the
bound (21 operations a block and entry); where the tree has the wide
path's variants (`uvt_etc1s_rate_sweep_variant`: one or two block rows a
CTA, the entry table in shared memory or read from device memory), each
variant's call and alone time, its output held to the wrapper's, and at
4,096 entries on a 256^2 frame (64 block rows, fewer than the card's SMs)
one and two rows a CTA. Then the
smoke's segment B (5 layers of 1024^2 of the bench texture) encoded at
4,096/4,096 on the card: the bytes' SHA-256 (equal between trees), the
encode's wall ms and each kernel's launches in one encode.
Prints the card's `nvidia-smi` name and power-limit line and one JSON
object, also written to `--out` (default
`build/wide_palette_versions_<NAME>.json`).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REPS = 5
SEG_ROWS, SEG_D = 327680, 64
SEG_KS = (256, 2048, 4096, 16128)
K7_ES = (2048, 4096, 16128)
SEGMENT_PALETTE = 4096
SMALL_FRAME = (64, 64)  # block rows and columns of a 256^2 frame: fewer rows than SMs
KM_KS = (256, 4096, 16128)
KM_EQUAL_K = 4096  # the all-equal codebook: every pair re-checked
PARTS = ("kmeans", "segment_sum", "rate_sweep", "segment_b")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms_per_call(cs, torch, fn, names, reps: int = REPS) -> float:
    """Device ms of the named kernels per call of fn (profiler), every
    launch summed over `reps` calls: the parent launches a kernel once a
    window, which a mean launch (`chip_smoke.kernel_only_ms`) would count
    once. A trace in which a kernel's launches are not a nonzero multiple
    of `reps` (the profiler dropped some) is taken again."""
    fn()
    for _ in range(cs.TRACE_ATTEMPTS):
        with cs.padded_trace(torch) as prof:
            for _ in range(reps):
                fn()
        total, seen = 0.0, {n: 0 for n in names}
        for e in cs.device_events(torch, prof):
            hit = next((n for n in names if n in e.name), None)
            if hit is not None:
                total += e.time_range.elapsed_us() / 1e3
                seen[hit] += 1
        if all(c and c % reps == 0 for c in seen.values()):
            return total / reps
    cs.check(False, f"no whole trace of {names} in {cs.TRACE_ATTEMPTS} attempts: {seen}")


def kmeans_section(cs, torch, k, _build, attrs, alone, r) -> dict:
    """K6 at KM_KS centroids on segment B's features (the module's note)."""
    from uvol_tpu_torch.utils.timing import median_cuda_ms

    dev = torch.device("cuda")
    feats = cs.wide_features(torch, cs.bench_batch()[4][:cs.ETC1S_LAYERS], dev)
    ne = feats.shape[0]
    wide = cs.KMEANS_WIDE_KERNEL in attrs
    res = {}
    if wide:  # the filter's loop: 4 FFMA a (row, centroid)
        blocks = cs.loop_sass(_build.library_path(), _build.find_nvcc(), cs.KMEANS_WIDE_KERNEL,
                              "FFMA", 4)
        steady = cs.steady_block(blocks)
        res["filter_sass"] = blocks
        res["filter_instructions_per_pair"] = steady["instructions"] / steady["entry_rows"]

    def measure(cb, tag):
        kk = cb.shape[0]
        fn = lambda: k.kmeans_iter(feats, cb)  # noqa: E731
        got = fn()
        plain_ms = cs.once_ms(torch, lambda: k.kmeans_iter_plain(feats, cb))
        want = k.kmeans_iter_plain(feats, cb)
        cs.check(all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                     for g, w in zip(got, want)), f"kmeans_iter differs from its twin ({tag})")
        names = ((cs.KMEANS_WIDE_KERNEL, "seg_sum_sparse_chunk_kernel",
                  "seg_sum_roots_kernel") if kk > 2048 and wide
                 else ("kmeans_chunk_kernel", "seg_sum_tree_kernel"))
        ms_alone, per = alone(fn, names)
        entry = {"shape": [ne, kk], "call_ms": median_cuda_ms(fn, REPS), "alone_ms": ms_alone,
                 "per_kernel_ms": per, "plain_ms": plain_ms,
                 "launches_per_call": cs.launches_per_call(torch, fn, names),
                 **dict(zip(("bound_ms", "bound_by"), cs.bound(
                     ne * 16 + kk * 16 + ne * 4 + kk * 20, cs.OPS["etc1s_kmeans_iter"] * ne * kk,
                     cs.F32_FLOP_PER_S)))}
        if kk > 2048 and wide:  # re-checked pairs and warp steps, as shares
            entry.update(cs.kmeans_recheck_rates(torch, k, feats, cb))
        print(json.dumps({f"kmeans_iter_{tag}": entry}), flush=True)
        return entry

    for kk in KM_KS:
        res[f"k{kk}"] = measure(
            feats[torch.from_numpy(r.choice(ne, kk, replace=False)).to(dev)] + 0.25, f"k{kk}")
    if wide:  # every pair passes the filter
        res[f"k{KM_EQUAL_K}_all_equal"] = measure(
            (feats[:1] + 0.25).expand(KM_EQUAL_K, 4).contiguous(), f"k{KM_EQUAL_K}_all_equal")
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", default=",".join(PARTS))
    a = ap.parse_args()
    parts = set(a.parts.split(","))
    sys.path.insert(0, str(Path(a.tree).resolve()))
    import torch

    cs = load_chip_smoke()
    from uvol_tpu_torch import _build
    from uvol_tpu_torch.codecs.basis import etc1s_cuda as k
    from uvol_tpu_torch.codecs.basis.etc1s_encode import encode_ktx2_etc1s
    from uvol_tpu_torch.utils.timing import median_cuda_ms

    check = cs.check
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    _build.get_lib()
    attrs = _build.kernel_attrs()
    out = {"label": a.label, "package": str(Path(k.__file__).resolve().parents[3]),
           "build_s": time.perf_counter() - t0,
           "k7_wide_sass": {m: cs.loop_sass(_build.library_path(), _build.find_nvcc(), m)
                            for m in ("rate_sweep_rows_kernelILi2ELb1E",
                                      "rate_sweep_frame_kernelILb1E")},
           "kernel_attrs": {n: v for n, v in attrs.items()
                            if n.startswith(("seg_sum", "rate_sweep", "sweep_table", "kmeans"))}}

    def alone(fn, names):  # every launch of a call summed: the parent sums by windows
        return (device_ms_per_call(cs, torch, fn, names),
                {n: device_ms_per_call(cs, torch, fn, (n,)) for n in names})

    r = np.random.default_rng(19)
    if "kmeans" in parts:
        out["kmeans_iter"] = kmeans_section(cs, torch, k, _build, attrs, alone, r)

    # ---- the segment sum at sel_update's shape
    if "segment_sum" in parts:
        xs = torch.from_numpy((r.normal(size=(SEG_ROWS, SEG_D)) * 1e3).astype(np.float32)).to(dev)
        xs[:, ::7] = -0.0
        seg = {}
        for kk in SEG_KS:
            idx = torch.from_numpy(r.integers(0, kk, SEG_ROWS)).to(dev)
            skew = torch.where(torch.rand(SEG_ROWS, device=dev) < 0.9, kk - 1, idx)
            sparse = kk > 2048 and "seg_sum_roots_kernel" in attrs
            names = (("seg_sum_sparse_chunk_kernel", "seg_sum_roots_kernel") if sparse
                     else ("seg_sum_chunk_kernel", "seg_sum_tree_kernel"))
            for kind, ix in (("random", idx), ("skewed", skew)):
                fn = lambda ix=ix, kk=kk: k.segment_sum(ix, kk, xs)  # noqa: E731
                got = fn()
                plain_ms = cs.once_ms(torch, lambda: k.segment_sum_plain(ix, kk, xs))
                want = k.segment_sum_plain(ix, kk, xs)
                check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                      f"segment_sum differs from its twin at k = {kk} ({kind})")
                acc = torch.zeros((kk, SEG_D), dtype=torch.float32, device=dev)
                ms_alone, per = alone(fn, names)
                seg[f"k{kk}_{kind}"] = {
                    "shape": [SEG_ROWS, kk, SEG_D], "call_ms": median_cuda_ms(fn, REPS),
                    "alone_ms": ms_alone, "per_kernel_ms": per, "plain_ms": plain_ms,
                    "library_ms": median_cuda_ms(lambda ix=ix: acc.index_add_(0, ix, xs), REPS),
                    **dict(zip(("bound_ms", "bound_by"), cs.bound(
                        SEG_ROWS * (SEG_D + 1) * 4 + kk * SEG_D * 4, SEG_ROWS * SEG_D,
                        cs.F32_FLOP_PER_S)))}
                print(json.dumps({f"segment_sum_k{kk}_{kind}": seg[f"k{kk}_{kind}"]}), flush=True)
        out["segment_sum"] = seg

    # ---- K7 on one 1024^2 frame, and the wide path's variants where the tree has them
    if "rate_sweep" in parts:
        nby, nbx = cs.H // 4, cs.W // 4
        nr = nby * nbx
        variants = hasattr(_build.get_lib(), "uvt_etc1s_rate_sweep_variant")
        k7 = {}
        for e in K7_ES:
            args = cs.to_device(cs.sweep_frame(torch, r, nby, nbx, e, False, True, "mixed"), dev)
            fn = lambda args=args: k.rate_sweep_frame(*args, 0, 60.0, 1.5, nbx)  # noqa: E731
            got = fn()
            plain_ms = cs.once_ms(torch, lambda: k.rate_sweep_frame_plain(*args, 0, 60.0, 1.5, nbx))
            want = k.rate_sweep_frame_plain(*args, 0, 60.0, 1.5, nbx)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"rate_sweep_frame differs from its twin at E = {e}")
            wide = e > 2048
            rows_kernel = any(n.startswith("rate_sweep_rows_kernel") for n in attrs)
            names = ((("rate_sweep_rows_kernel" if rows_kernel else "rate_sweep_frame_kernel"),
                      "sweep_table_kernel") if wide else ("rate_sweep_frame_kernel",))
            ms_alone, per = alone(fn, names)
            p_sq, feat, mat = k.sweep_features(*args[:4], args[6])
            entry = {"shape": [nr, e], "call_ms": median_cuda_ms(fn, REPS), "alone_ms": ms_alone,
                     "per_kernel_ms": per, "plain_ms": plain_ms,
                     "library_ms": median_cuda_ms(lambda: feat @ mat.T, REPS),
                     **dict(zip(("bound_ms", "bound_by"), cs.bound(
                         nr * 48 + e * (12 + 16 + 4) + 8 * 64 + nr * 4 * 4 + nr * 2 * 4,
                         cs.OPS["etc1s_rate_sweep"] * nr * e, cs.INT_OPS_PER_S)))}
            if wide and variants:
                table = torch.empty((e, 8), dtype=torch.int32, device=dev)
                pairs = [t.contiguous() for t in (*args[:7], *args[7])]
                for rows in (1, 2):
                    for staged in ((0, 1) if e <= k.SWEEP_STAGED_MAX_E else (0,)):
                        oe, os_ = torch.empty_like(got[0]), torch.empty_like(got[1])

                        def var(rows=rows, staged=staged, oe=oe, os_=os_, pairs=pairs, table=table, e=e):
                            _build.launch("uvt_etc1s_rate_sweep_variant", dev,
                                          *(t.data_ptr() for t in pairs), 1, 0, 60.0, 1.5, nby, nbx,
                                          e, table.data_ptr(), oe.data_ptr(), os_.data_ptr(), rows,
                                          staged)

                        var()
                        check(torch.equal(oe, got[0]) and torch.equal(os_, got[1]),
                              f"K7's variant rows={rows} staged={staged} differs at E = {e}")
                        entry.setdefault("variants", {})[f"rows{rows}_staged{staged}"] = {
                            "call_ms": median_cuda_ms(var, REPS),
                            "alone_ms": device_ms_per_call(cs, torch, var, names)}
            k7[f"e{e}"] = entry
            print(json.dumps({f"rate_sweep_e{e}": entry}), flush=True)
        if variants:  # a frame with fewer block rows than SMs: one row a CTA or two
            sby, sbx = SMALL_FRAME
            e = K7_ES[1]
            args = cs.to_device(cs.sweep_frame(torch, r, sby, sbx, e, False, True, "mixed"), dev)
            got = k.rate_sweep_frame(*args, 0, 60.0, 1.5, sbx)
            table = torch.empty((e, 8), dtype=torch.int32, device=dev)
            pairs = [t.contiguous() for t in (*args[:7], *args[7])]
            small = {"shape": [sby * sbx, e],
                     "call_ms": median_cuda_ms(lambda: k.rate_sweep_frame(*args, 0, 60.0, 1.5, sbx),
                                               REPS)}
            for rows in (1, 2):
                oe, os_ = torch.empty_like(got[0]), torch.empty_like(got[1])

                def var(rows=rows, oe=oe, os_=os_):
                    _build.launch("uvt_etc1s_rate_sweep_variant", dev, *(t.data_ptr() for t in pairs),
                                  1, 0, 60.0, 1.5, sby, sbx, e, table.data_ptr(), oe.data_ptr(),
                                  os_.data_ptr(), rows, 1)

                var()
                check(torch.equal(oe, got[0]) and torch.equal(os_, got[1]),
                      f"K7's variant rows={rows} differs on the small frame")
                small[f"rows{rows}_staged1"] = {"call_ms": median_cuda_ms(var, REPS),
                                                "alone_ms": device_ms_per_call(cs, torch, var, names)}
            k7[f"e{e}_small_frame"] = small
            print(json.dumps({f"rate_sweep_e{e}_small_frame": small}), flush=True)
        out["rate_sweep"] = k7

    # ---- segment B at 4,096/4,096: bytes, encode time, launches
    if "segment_b" in parts:
        frames = cs.bench_batch()[4][:cs.ETC1S_LAYERS]
        kw = {"num_endpoints": SEGMENT_PALETTE, "num_selectors": SEGMENT_PALETTE}
        blob = encode_ktx2_etc1s(frames, device="cuda", **kw)
        k.reset_launches()
        check(encode_ktx2_etc1s(frames, device="cuda", **kw) == blob,
              "the 4,096-entry segment encode is not deterministic")
        out["segment_b"] = {"palette": SEGMENT_PALETTE, "sha256": hashlib.sha256(blob).hexdigest(),
                            "bytes": len(blob), "launches": dict(k.LAUNCHES),
                            "encode_ms": cs.wall_ms(torch, lambda: encode_ktx2_etc1s(
                                frames, device="cuda", **kw), cs.ETC1S_REPS)}
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line, flush=True)
    dest = Path(a.out) if a.out else ROOT / "build" / f"wide_palette_versions_{a.label}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
