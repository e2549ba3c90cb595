"""Times of the port's ETC1S segment encode on one CUDA card, for one tree.

    python3 examples/torch_etc1s_segment_times.py [ROOT]

Imports `uvol_tpu_torch` from ROOT (default: this checkout), so that one
call can time two trees in turns (parent, change, change, parent). On the
smoke segment of chip_smoke.py (the first 5 layers of bench.py's synthetic
1024x1024 texture) it times, each as the median of `REPS` runs after one
warmup, on the host clock around work that ends in
`torch.cuda.synchronize()`: the palette core on device-resident blocks,
`build_palettes` and `encode_ktx2_etc1s` at 256/256 palettes, and, where
the tree has the delta-aware stage, `encode_ktx2_etc1s` at the encoder
CLI's 1024/1024 and one `rate_sweep_assignments` pass on the segment's
1024/1024 palette: its time, its peak memory above what was allocated
before it (`torch.cuda.max_memory_allocated`), and its device kernels per
frame (one `torch.profiler` trace, copies left out). Prints the card's
nvidia-smi name/power-limit line, then one JSON object (ms; null where the
tree raises NotImplementedError).
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPS = 5
LAYERS, SIDE = 5, 1024


def segment() -> np.ndarray:
    """chip_smoke.bench_batch's texture, its first `LAYERS` layers."""
    yy, xx = np.mgrid[0:SIDE, 0:SIDE]
    tex = np.stack([(xx // 4) % 256, (yy // 4) % 256, ((xx + yy) // 8) % 256], -1)
    return np.stack([np.roll(tex, s, axis=1) for s in range(LAYERS)]).astype(np.uint8)


def main(argv) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(argv[1]) if len(argv) > 1 else here
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from uvol_tpu_torch.codecs.basis import etc1s_encode as enc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    def median_ms(fn):
        fn()
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    frames = segment()
    blocks = torch.from_numpy(enc._blocks_of(frames)).cuda()
    out = {"module": os.path.relpath(enc.__file__, root), "root": root, "reps": REPS,
           "palette_core_256": median_ms(lambda: enc.palette_core(blocks, 256, 256, 6)),
           "build_palettes_256": median_ms(
               lambda: enc.build_palettes(frames, 256, 256, device="cuda")),
           "segment_encode_256": median_ms(lambda: enc.encode_ktx2_etc1s(
               frames, num_endpoints=256, num_selectors=256, device="cuda"))}
    try:
        out["segment_encode_1024"] = median_ms(lambda: enc.encode_ktx2_etc1s(
            frames, num_endpoints=1024, num_selectors=1024, device="cuda"))
    except NotImplementedError:
        out["segment_encode_1024"] = None
        print(json.dumps(out), flush=True)
        return 0
    nby = nbx = SIDE // 4
    pal = enc.build_palettes(frames, 1024, 1024, delta_window=16, device="cuda")

    def sweep():
        enc.rate_sweep_assignments(copy.deepcopy(pal), nby, nbx, dev_blocks=blocks,
                                   lam_bits=60.0, lam_cr=1.5)

    out["sweep_1024"] = median_ms(sweep)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    sweep()
    torch.cuda.synchronize()
    out["sweep_1024_peak_bytes"] = torch.cuda.max_memory_allocated() - held
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sweep()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Mem")]
    out["sweep_1024_kernels_per_frame"] = len(kernels) / LAYERS
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
