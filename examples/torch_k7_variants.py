"""Time variants of K7 (`rate_sweep_frame_kernel`) on one CUDA card, to see where its time goes.

    python3 examples/torch_k7_variants.py

Compiles `uvol_tpu_torch/csrc/etc1s.cu` once per variant into
`build/k7_variants/` (the variant is rewritten into a copy of the source;
the repository's file is not touched):

  - `as_is`: the kernel as it stands;
  - `bits_twice`: the bits table held twice over in shared memory, so the
    index (e - left) mod E is one add, without the compare and select;
  - `no_errors`: no error arithmetic in the column loop (each error a
    constant): what the scan, its reductions and barriers cost alone. Its
    output is not the sweep's and is not checked.

On a random 1024^2 frame (65,536 blocks, `chip_smoke.sweep_frame`, with a
previous frame) at 1,024 and 2,048 entries it checks each other variant
against `rate_sweep_frame_plain` and times it with CUDA events around
`LOOPS` back-to-back launches (median of 3). Prints the card's
`nvidia-smi` name/power-limit line, each variant's registers and stack
from `-Xptxas -v`, and one JSON object of ms per launch.
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

import chip_smoke  # noqa: E402
from uvol_tpu_torch import _build  # noqa: E402
from uvol_tpu_torch.codecs.basis import etc1s_cuda as k  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOOPS = 20
PRICE = """            int dm = k - origin;
            if (dm < 0) dm += e;
            float b = s_bits[dm];"""
VARIANTS = {
    "as_is": [],
    "bits_twice": [
        ("  for (int k = tid; k < e; k += nthreads) s_bits[k] = bits[k];",
         "  __shared__ float s_bits2[2 * kSegMaxK];\n"
         "  for (int k = tid; k < 2 * e; k += nthreads) s_bits2[k] = bits[k < e ? k : k - e];"),
        (PRICE, "            float b = s_bits2[k - origin + e];"),
    ],
    "no_errors": [("  return __int2float_rn(acc - 2 * (int)dot);",
                   "  return (float)(t.sq[0] + f.p_sq);")],
}


def build(name: str):
    out = ROOT / "build" / "k7_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "etc1s.cu").read_text()
    for old, new in VARIANTS[name]:
        src, n = re.subn(re.escape(old), lambda _: new, src)
        assert n == 1, (name, old)
    cu = out / f"etc1s_{name}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    log = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                          str(_build.CSRC), "-shared", "-o", str(so), str(cu)],
                         check=True, capture_output=True, text=True).stderr
    lines = log.splitlines()
    at = next(i for i, line in enumerate(lines) if "Compiling" in line and "rate_sweep_frame" in line)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uvt_etc1s_rate_sweep.argtypes = [vp] * 9 + [ci, ci, cf, cf, ci, ci, ci, vp, vp, vp, vp]
    return lib, [line.split(":", 1)[-1].strip() for line in lines[at + 2:at + 4]]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    libs = {}
    for name in VARIANTS:
        libs[name], ptxas = build(name)
        print(name, ptxas, flush=True)
    r = np.random.default_rng(0)
    out = {}
    for e in (1024, 2048):
        args = chip_smoke.to_device(
            chip_smoke.sweep_frame(torch, r, 256, 256, e, False, True, "mixed"), dev)
        want = k.rate_sweep_frame_plain(*args, 0, 60.0, 1.5, 256)
        blocks, base, mods, sel_cb, bits, ep, sel, (prev_ep, prev_sel) = args
        ptrs = [t.data_ptr() for t in (blocks, base, mods, sel_cb, bits, ep, sel, prev_ep, prev_sel)]
        for name, lib in libs.items():
            o_ep, o_sel = torch.empty_like(ep), torch.empty_like(sel)

            def call():
                err = lib.uvt_etc1s_rate_sweep(*ptrs, 1, 0, 60.0, 1.5, 256, 256, e, None,
                                               o_ep.data_ptr(), o_sel.data_ptr(),
                                               torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            call()
            torch.cuda.synchronize()
            if name != "no_errors":
                assert torch.equal(o_ep, want[0]) and torch.equal(o_sel, want[1]), name
            times = []
            for _ in range(3):
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(LOOPS):
                    call()
                t1.record()
                torch.cuda.synchronize()
                times.append(t0.elapsed_time(t1) / LOOPS)
            out[f"{name}@{e}"] = float(np.median(times))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
