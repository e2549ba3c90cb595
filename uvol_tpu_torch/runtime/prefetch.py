"""Host-side async fetch+decode service — the L5 "decode services" layer.

TPU-native replacement for the reference's Web-Worker parallelism:
  - DRACOLoader's ≤4-worker least-loaded pool (src/lib/DRACOLoader.js:24,
    312-366) and its task cache keyed by buffer (:110-133)
  - the Basis WorkerPool's bitmask idle set + FIFO queue
    (src/lib/WorkerPool.js:29-91)
  - the V1 worker's ≤3-in-flight request pacing (src/V1/player.ts:209-227)

Here, fetch+decode runs on host threads (fetch is I/O-bound; decode is
numpy/C++ releasing the GIL, or a device call XLA serializes anyway) so the
player tick never blocks; results land in a completion queue the player
drains each update. Failures complete with an error marker instead of
killing the pipeline (the reference posts an empty payload on worker error,
src/V1/worker.ts:70-73).

The port's copy of `uvol_tpu/runtime/prefetch.py`, unchanged. The
port's decoders run on the card from these threads: each returns host
arrays only after its device work has finished.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Hashable, Optional, Tuple


class PrefetchPool:
    """Deduplicating fetch+decode pool with bounded in-flight requests.

    `work` runs on a worker thread: `work(*args) -> result`. Each key is
    processed at most once (task-cache semantics); completed results are
    collected with `poll()`. `max_in_flight` mirrors the reference's
    request pacing (V1: 3, DRACO pool: 4 workers).
    """

    def __init__(
        self,
        work: Callable[..., Any],
        *,
        workers: int = 4,
        max_in_flight: Optional[int] = None,
    ) -> None:
        self._work = work
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._max_in_flight = max_in_flight
        self._lock = threading.Lock()
        self._seen: set = set()
        self._queue: list = []  # (key, args) waiting for an in-flight slot
        self._in_flight = 0
        self._done: Dict[Hashable, Tuple[Any, Optional[Exception]]] = {}
        self._closed = False

    # -- submission -----------------------------------------------------------
    def request(self, key: Hashable, *args) -> bool:
        """Enqueue work for `key` once; returns False if already seen."""
        with self._lock:
            if self._closed or key in self._seen:
                return False
            self._seen.add(key)
            if (
                self._max_in_flight is not None
                and self._in_flight >= self._max_in_flight
            ):
                self._queue.append((key, args))
                return True
            self._launch(key, args)
            return True

    def _launch(self, key: Hashable, args) -> None:
        self._in_flight += 1
        self._pool.submit(self._run, key, args)

    def _run(self, key: Hashable, args) -> None:
        try:
            result, err = self._work(*args), None
        except Exception as e:  # degrade, don't die (V1/worker.ts:70-73)
            result, err = None, e
        with self._lock:
            self._done[key] = (result, err)
            self._in_flight -= 1
            while self._queue and (
                self._max_in_flight is None
                or self._in_flight < self._max_in_flight
            ):
                k, a = self._queue.pop(0)
                self._launch(k, a)

    # -- completion -----------------------------------------------------------
    def poll(self) -> Dict[Hashable, Tuple[Any, Optional[Exception]]]:
        """Drain completed results: {key: (result, error)}."""
        with self._lock:
            done, self._done = self._done, {}
            return done

    @property
    def pending(self) -> int:
        with self._lock:
            return self._in_flight + len(self._queue)

    def wait_idle(self, timeout: float = 30.0) -> None:
        """Block until nothing is pending (tests/shutdown)."""
        import time

        deadline = time.monotonic() + timeout
        while self.pending and time.monotonic() < deadline:
            time.sleep(0.002)

    def forget(self, key: Hashable) -> None:
        """Allow a key to be requested again (e.g. after eviction)."""
        with self._lock:
            self._seen.discard(key)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._queue.clear()
        self._pool.shutdown(wait=False)
