"""Time variants of the segment-sum kernels on one CUDA card.

    python3 examples/torch_segsum_variants.py [--out FILE] [VARIANT ...]

The kernels are `seg_sum_chunk_kernel` and `seg_sum_tree_kernel`.
Compiles `uvol_tpu_torch/csrc/etc1s.cu` once per variant into
`build/segsum_variants/`, all variants at once (the variant is rewritten
into a copy of the source; the repository's file is not touched). A
variant is a list of (text, replacement) pairs on the source; `VARIANTS`
names them (`as_is` is the source as it stands).

At N = 327,680 rows, for each (k, D) in `SHAPES` (the palette build's
calls, its largest k, and 90% of the rows in one segment), it holds every
variant against `segment_sum_plain` bit for bit and times each
kernel alone with the profiler (`chip_smoke.kernel_only_ms`). Prints the
card's `nvidia-smi` name/power-limit line, each variant's registers,
spills and shared memory from `-Xptxas -v`, and one JSON object, also
written to FILE (default `build/segsum_variants.json`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from uvol_tpu_torch import _build  # noqa: E402
from uvol_tpu_torch.codecs.basis import etc1s_cuda as k  # noqa: E402

N = 327680
REPS = 3
#: (k, D, skewed): the bisect's first and last levels at D = 9 and 33,
#: cluster_inten and the residual means, sel_update at 256 and 1,024, the
#: largest k, and sel_update's shape with 90% of the rows in one segment
SHAPES = ((1, 9, False), (256, 9, False), (1, 33, False), (256, 33, False), (256, 8, False),
          (256, 4, False), (256, 64, False), (1024, 64, False), (2048, 64, False),
          (256, 64, True))
KERNELS = ("seg_sum_chunk_kernel", "seg_sum_tree_kernel")
VARIANTS = {
    "as_is": [],
    "cols8": [("constexpr int kSegGroupCols = 16;", "constexpr int kSegGroupCols = 8;")],
    "threads256": [("constexpr int kSegThreads = 512;", "constexpr int kSegThreads = 256;")],
    "threads1024": [("constexpr int kSegThreads = 512;", "constexpr int kSegThreads = 1024;")],
    # pass 2 with 8 threads an element at every size, as before its rows were a choice
    "tree_rows8": [("constexpr int kTreeRowsSmall = 32; ", "constexpr int kTreeRowsSmall = 8;  ")],
}


def build_all(names):
    out = ROOT / "build" / "segsum_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = (_build.CSRC / "etc1s.cu").read_text()
        for old, new in VARIANTS[name]:
            src, n = re.subn(re.escape(old), lambda _: new, src)
            assert n == 1, (name, old)
        cu = out / f"etc1s_{name}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
             "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        lines = log.splitlines()
        ptxas = {}
        for kern_name in KERNELS:
            at = next(i for i, line in enumerate(lines)
                      if "Compiling" in line and kern_name in line)
            ptxas[kern_name] = " | ".join(line.split(":", 1)[-1].strip()
                                          for line in lines[at + 1:at + 4])
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.uvt_etc1s_segment_sum.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
        libs[name] = (lib, ptxas)
    return libs


def call(lib, idx, kk, x):
    n, d = x.shape
    m = max(1, -(-n // 1024))
    part = torch.empty((m, kk, d), dtype=torch.float32, device=x.device)
    out = torch.empty((kk, d), dtype=torch.float32, device=x.device)
    rc = lib.uvt_etc1s_segment_sum(idx.data_ptr(), x.data_ptr(), n, d, kk, part.data_ptr(),
                                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "segsum_variants.json"))
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    a = ap.parse_args()
    print(cs.nvidia_smi_line(), flush=True)
    libs = build_all(a.variants)
    dev = torch.device("cuda")
    r = np.random.default_rng(5)
    res = {"rows": N, "shapes": SHAPES,
           "ptxas": {name: ptxas for name, (_, ptxas) in libs.items()}, "ms": {}}
    for kk, d, skew in SHAPES:
        idx = r.integers(0, kk, N)
        if skew:
            idx = np.where(r.random(N) < 0.9, kk // 3, idx)
        idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
        x = torch.from_numpy(r.integers(-400, 400, (N, d)).astype(np.float32)).to(dev)
        want = k.segment_sum_plain(idx, kk, x).view(torch.int32)
        key = f"k{kk}_d{d}{'_skew90' if skew else ''}"
        res["ms"][key] = {}
        for name, (lib, _) in libs.items():
            cs.check(torch.equal(call(lib, idx, kk, x).view(torch.int32), want),
                     f"{name} differs from the twin at {key}")
            res["ms"][key][name] = {
                kn: cs.kernel_only_ms(torch, lambda: call(lib, idx, kk, x), (kn,), REPS)[0]
                for kn in KERNELS}
        print(key, json.dumps(res["ms"][key]), flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
