"""Run a function on every rank of a group of spawned processes.

`run_ranks(fn, n, *args)` starts n processes (the `spawn` method: no
CUDA context or thread is copied), joins them to one group through a
`file://` store in a fresh temporary directory (no TCP port, so groups
started at the same time never meet), calls `fn(*args)` on each rank and
returns the ranks' results in rank order. Every rank that raises, and a
run that outlasts `timeout`, kills the ranks still running and raises
here: a hung rank never outlives its caller.

`fn` must be importable by name (a module-level function) and its
arguments and result picklable. On the card the kernels are built once
in the caller (`_build.build()`) before the ranks start.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, List


def _rank_main(fn: Callable, rank: int, world_size: int, init_method: str,
               device_type: str, out_path: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    from uvol_tpu_torch.parallel.mesh import initialize_distributed

    if device_type == "cpu":  # ranks share the host's cores
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // world_size)))
    try:
        initialize_distributed(init_method, world_size, rank, local_rank=rank,
                               local_world_size=world_size, device_type=device_type)
        result = ("ok", fn(*args))
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out_path, "wb") as fh:
        pickle.dump(result, fh)
    if result[0] != "ok":
        os._exit(1)  # no teardown: the other ranks may be waiting in a collective
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args, device_type: str = "cuda",
              timeout: float = 600.0) -> List[Any]:
    """`fn(*args)` on `world_size` spawned ranks; their results in rank
    order. Raises RuntimeError naming the ranks that failed (with their
    tracebacks) and TimeoutError after `timeout` seconds, having killed
    every rank still running."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="uvt_ranks_") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, name=f"uvt-rank-{r}",
                             args=(fn, r, world_size, init, device_type, outs[r], args))
                 for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {[procs.index(p) for p in running]} still "
                                       f"running after {timeout} s: killed")
                for sentinel in wait([p.sentinel for p in running], left):
                    p = next(q for q in running if q.sentinel == sentinel)
                    p.join()
                    running.remove(p)
                    if p.exitcode != 0:
                        running = []  # one rank failed: the others may wait on it forever
                        break
        finally:
            for p in procs:
                if p.pid is None:  # never started
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
        results, failed = [], []
        for r, (p, out) in enumerate(zip(procs, outs)):
            if not os.path.exists(out):
                failed.append(f"rank {r}: exit code {p.exitcode}, no result")
                continue
            with open(out, "rb") as fh:
                status, value = pickle.load(fh)
            if status != "ok":
                failed.append(f"rank {r}:\n{value}")
            results.append(value)
        if failed:
            raise RuntimeError(f"{len(failed)} of {world_size} ranks failed:\n"
                               + "\n".join(failed))
        return results
