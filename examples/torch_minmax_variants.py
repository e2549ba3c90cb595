"""Time `geometry_minmax_kernel` at other unroll depths and CTA sizes, on one CUDA card.

    python3 examples/torch_minmax_variants.py

Compiles `uvol_tpu_torch/csrc/geometry.cu` once per variant of
(`kRedThreads`, `kRedUnroll`) into `build/minmax_variants/` (the constants
are rewritten in a copy of the source; the repository's file is not
touched), checks each variant's minimum and maximum against
`geometry_minmax_plain` on the geometry encode's positions (32 x 3 x
26,145), and times it with CUDA events around `LOOPS` back-to-back
launches, with the inputs in the L2 cache and with the cache overwritten
before every launch (the memset's own time, measured alone, is taken off).
Prints the card's `nvidia-smi` name/power-limit line and one JSON object
of microseconds per launch.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from uvol_tpu_torch import _build  # noqa: E402
from uvol_tpu_torch.ops import pallas_kernels as pk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = ((1024, 8), (1024, 16), (1024, 32), (512, 8), (512, 16), (256, 16))
LOOPS = 200
F, C, N = 32, 3, 26145


def build(threads: int, unroll: int) -> ctypes.CDLL:
    out = ROOT / "build" / "minmax_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "geometry.cu").read_text()
    src, a = re.subn(r"kRedThreads = \d+;", f"kRedThreads = {threads};", src)
    src, b = re.subn(r"kRedUnroll = \d+;", f"kRedUnroll = {unroll};", src)
    assert a == 1 and b == 1
    cu = out / f"geometry_{threads}_{unroll}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                    "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.uvt_geometry_minmax.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
    return lib


def events_us(fn, loops: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(loops):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / loops * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.normal(size=(F, C, N)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(np.arange(N)[None, :] < r.integers(N // 2, N + 1, F)[:, None]).to(dev)
    want = torch.stack(pk.geometry_minmax_plain(x, mask))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    flush_us = events_us(flush.zero_, LOOPS)
    us = {"flush_alone": flush_us}
    for threads, unroll in VARIANTS:
        lib = build(threads, unroll)
        got = torch.empty((2, F, C), dtype=torch.float32, device=dev)

        def launch():
            err = lib.uvt_geometry_minmax(x.data_ptr(), mask.data_ptr(), got.data_ptr(),
                                          got.data_ptr() + 4 * F * C, F, C, N, stream)
            assert err == 0, err

        def cold():
            flush.zero_()
            launch()

        launch()
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (threads, unroll)
        us[f"threads{threads}_unroll{unroll}"] = {
            "l2_warm": events_us(launch, LOOPS),
            "l2_cold": events_us(cold, LOOPS) - flush_us,
        }
    print(json.dumps({"loops": LOOPS, "shape": [F, C, N], "us_per_launch": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
