#!/usr/bin/env python3
"""Does `torch.profiler` still see the card after what the encoder CLI and
the player do to a process?

Run on a CUDA card from the repository root:

    python3 examples/torch_profiler_after_cli.py

It traces one ETC1 texture encode (K1, 5 layers of 1024^2, the H2D copy
and the D2H copy) `ATTEMPTS` times at each step and counts the device
events each trace holds:

  1. `baseline`: CUDA live, nothing else done;
  2. `after_fork_pool`: after a forked `multiprocessing` pool of 8 workers
     that ran numpy only (the CLI's Draco workers);
  3. `after_cuda_threads`: after a pool of 4 threads that launched K1 and
     K2 (the player's `async_prefetch` decoders), shut down without
     waiting, as `PrefetchPool.close` does;
  4. `after_threads_joined`: the same threads, joined.

Prints one JSON object: per step, the device events of each trace.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ATTEMPTS = 5


def _numpy_work(i: int) -> float:
    return float(np.sort(np.random.default_rng(i).random(200_000)).sum())


def main() -> int:
    from uvol_tpu_torch.codecs.basis import etc_cuda
    from uvol_tpu_torch.models.sequence import TextureSequenceCodec
    from uvol_tpu_torch.utils.timing import device_trace

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    yy, xx = np.mgrid[0:1024, 0:1024]
    tex = np.stack([np.stack([(xx + i) % 256, yy % 256, (xx ^ yy) % 256], -1)
                    for i in range(5)]).astype(np.uint8)
    codec = TextureSequenceCodec(device="cuda")
    codec.encode_segment(tex)  # warm: library load, allocator

    def traces():
        counts = []
        for _ in range(ATTEMPTS):
            with device_trace() as prof:
                codec.encode_segment(tex)
                torch.cuda.synchronize()
            counts.append(sum(1 for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA))
        return counts

    out = {"device": torch.cuda.get_device_name(0), "baseline": traces()}
    with mp.get_context("fork").Pool(8) as pool:
        pool.map(_numpy_work, range(32))
    out["after_fork_pool"] = traces()

    words = etc_cuda.encode_etc1_images(torch.from_numpy(tex).cuda())

    def decode(_):
        return etc_cuda.decode_etc1_images(words, 5, 1024, 1024).cpu().numpy().sum()

    threads = ThreadPoolExecutor(max_workers=4)
    list(threads.map(decode, range(16)))
    threads.shutdown(wait=False)
    out["after_cuda_threads"] = traces()
    threads = ThreadPoolExecutor(max_workers=4)
    list(threads.map(decode, range(16)))
    threads.shutdown(wait=True)
    out["after_threads_joined"] = traces()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
