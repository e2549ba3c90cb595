"""Each pytest-xdist worker's share of the host's cores, for the port's tests.

PyTorch runs its CPU operators on an OpenMP pool, and numpy its products on
an OpenBLAS pool, each as wide as the machine, and both spin while they wait
at a barrier. Under `pytest -n W` every worker holds such pools: W pools of
`cores` threads on `cores` cores. On 8 cores, six processes each running the
54 sparse segment-sum model cases at once took 494 s each, against 7.4 s
for one alone and 9 s each with one OpenMP thread a process.

Imported by every `tests/test_torch_*.py`. Under xdist the worker's pools,
and the processes its tests start (`OMP_NUM_THREADS`, `OPENBLAS_NUM_THREADS`),
take cores // W threads, at least 1; a run without xdist keeps the libraries'
defaults. The port's tests pass at either width: its float sums run in a
fixed order, not in the pool's.
"""

import os

import numpy  # noqa: F401  (loads numpy's OpenBLAS before its pool is limited)
import torch


def worker_threads() -> int | None:
    """cores // workers under pytest-xdist (at least 1), else None."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers < 1:
        return None
    return max(1, len(os.sched_getaffinity(0)) // workers)


def _share(n: int) -> None:
    for name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(name, str(n))
    if torch.get_num_threads() > n:
        torch.set_num_threads(n)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # numpy's pool keeps its width
        return
    threadpool_limits(n, user_api="blas")


THREADS = worker_threads()
if THREADS is not None:
    _share(THREADS)
