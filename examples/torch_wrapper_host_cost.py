"""Host time of the port's kernel wrappers, piece by piece, on one CUDA card.

    python3 examples/torch_wrapper_host_cost.py

A wrapper call of `uvol_tpu_torch` is host work (argument checks, output
allocation, the stream lookup, the ctypes call, the launch) beside its
kernel. This script times those pieces on the host clock, each in a loop
of `LOOPS` iterations that ends in one `torch.cuda.synchronize()`, at the
geometry encode's shapes (32 frames x 26,145 vertices), at the palette
build's (327,680 blocks, 256 entries) and at a `.drc` decode window's (K8:
8 frames of 28,672 vertices, three attributes), and prints one JSON object with
microseconds per iteration, after the card's `nvidia-smi` name/power-limit
line. A loop whose kernels take longer than its host work reads the
kernels' time, so `wrapper_*` lines give the larger of the two.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from uvol_tpu_torch import _build  # noqa: E402
from uvol_tpu_torch.codecs.basis import etc1s_cuda as k  # noqa: E402
from uvol_tpu_torch.models import drc_device as dd  # noqa: E402
from uvol_tpu_torch.ops import pallas_kernels as pk  # noqa: E402

LOOPS = 2000
F, N = 32, 26145
BLOCKS, ENTRIES = 327680, 256


def per_call_us(fn, loops: int = LOOPS) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(loops):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / loops * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = _build.get_lib()
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.normal(size=(F, 3, N)).astype(np.float32)).to(dev)
    mask = torch.ones((F, N), dtype=torch.bool, device=dev)
    xm, inv, _, _ = pk.quantize_offsets(x, 11, mask)
    mn, mx = pk.geometry_minmax(x, mask)
    out = torch.empty((F, 3, N), dtype=torch.int32, device=dev)
    stream = _build._raw_stream(0)
    ptr = x.data_ptr()
    us = {
        "pass": per_call_us(lambda: None),
        "torch_empty_symbols": per_call_us(
            lambda: torch.empty((F, 3, N), dtype=torch.int32, device=dev)),
        "torch_empty_32_floats": per_call_us(
            lambda: torch.empty(F, dtype=torch.float32, device=dev)),
        "current_device": per_call_us(torch.cuda.current_device),
        "raw_stream": per_call_us(lambda: _build._raw_stream(0)),
        "data_ptr": per_call_us(x.data_ptr),
        "contiguous": per_call_us(x.contiguous),
        "check_stage": per_call_us(lambda: pk._check_stage(x, mask)),
        # f = 0: the entry point returns before it launches
        "ctypes_call_12_args_no_launch": per_call_us(lambda: lib.uvt_quantize_delta_zigzag(
            ptr, None, None, None, ptr, 0, ptr, None, 0, 3, N, stream)),
        "build_launch_no_launch": per_call_us(lambda: _build.launch(
            "uvt_quantize_delta_zigzag", dev, ptr, None, None, None, ptr, 0, ptr, None, 0, 3, N)),
        "ctypes_call_launching_k3": per_call_us(lambda: lib.uvt_quantize_delta_zigzag(
            xm.data_ptr(), None, None, None, inv.data_ptr(), 0, out.data_ptr(), None, F, 3, N,
            stream)),
        "wrapper_k3_offsets_given": per_call_us(lambda: pk.fused_quantize_delta_zigzag(xm, inv)),
        "wrapper_geometry_minmax": per_call_us(lambda: pk.geometry_minmax(x, mask)),
        "wrapper_quantize_from_bounds": per_call_us(
            lambda: pk.quantize_from_bounds(x, mask, mn, mx, 11)),
        "wrapper_geometry_stage": per_call_us(lambda: pk.geometry_quantize_stage(x, mask, 11)),
    }
    # the palette build's wrappers
    blocks = torch.from_numpy(r.integers(0, 256, (BLOCKS, 16, 3), dtype=np.uint8)).to(dev)
    base = torch.from_numpy(r.integers(0, 256, (BLOCKS, 3)).astype(np.int32)).to(dev)
    feats = torch.from_numpy((r.random((BLOCKS, 4)) * 255).astype(np.float32)).to(dev)
    cb = feats[:ENTRIES].clone()
    idx = torch.from_numpy(r.integers(0, ENTRIES, BLOCKS).astype(np.int32)).to(dev)
    idx64 = idx.long()
    us["wrapper_inten_errors"] = per_call_us(lambda: k.inten_errors(blocks, base), 200)
    us["wrapper_kmeans_iter"] = per_call_us(lambda: k.kmeans_iter(feats, cb), 200)
    us["wrapper_segment_sum_d4"] = per_call_us(lambda: k.segment_sum(idx, ENTRIES, feats), 200)
    us["wrapper_segment_sum_d4_int64_idx"] = per_call_us(
        lambda: k.segment_sum(idx64, ENTRIES, feats), 200)
    # K8's wrapper and its pieces on the main path's window
    import chip_smoke as cs

    packed, specs, mo, ml = cs.drc_window(torch, ((1, 12, 1 << 11, 3), (1, 10, 1 << 10, 2),
                                                  (2, 8, 255)), 8, 28672, 0)
    packed = packed.to(dev)
    plan = dd._plan(specs, mo, ml)
    dout = torch.empty(plan.total, dtype=torch.float32, device=dev)
    k8 = dd._k8()
    empty_table = (dd._Spec * dd.MAX_SPECS)()  # f = 0: the entry point launches nothing
    empty_table[0].kind, empty_table[0].mode, empty_table[0].nc = 1, 8, 1
    us["k8_plan_cached"] = per_call_us(lambda: dd._plan(specs, mo, ml))
    us["k8_torch_empty_out"] = per_call_us(
        lambda: torch.empty(plan.total, dtype=torch.float32, device=dev))
    us["k8_views"] = per_call_us(lambda: tuple(dout.as_strided(sh, st, at)
                                               for sh, st, at in plan.views))
    us["k8_build_launch_no_launch"] = per_call_us(lambda: _build.launch(
        k8, dev, packed.data_ptr(), packed.numel(), ctypes.addressof(empty_table), 1, mo,
        dout.data_ptr()))
    us["k8_ctypes_call_launching"] = per_call_us(lambda: k8(
        packed.data_ptr(), packed.numel(), ctypes.addressof(plan.table), len(specs), mo,
        dout.data_ptr(), stream), 200)
    us["wrapper_k8_8_frames"] = per_call_us(lambda: dd.fused_batch(packed, specs, mo, ml), 200)
    print(json.dumps({"loops": LOOPS, "us_per_call": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
