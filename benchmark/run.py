"""Run one cell of the benchmark of `uvol_tpu_torch` once, on one H100.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the checks against the plain reference
as the last lines of standard error and one JSON object as the last line
of standard output; exits non-zero without a result where no card is
found, or where JAX or the JAX package was loaded. `benchmark/uvbench/harness.py`
says how a cell is found and run.
"""

import time

T0 = time.perf_counter()  # the set-up time counts from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(BENCH.parent / "build" / "bench-cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH.parent / "build" / "bench-cache" / "torch_extensions")
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    from uvbench.harness import main

    sys.exit(main(sys.argv[1:], T0))
