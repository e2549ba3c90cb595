"""The benchmark's own CPU tests: `python -m pytest benchmark/tests -q` from
the root of the repository. They put the checkout and `benchmark/` on the
path as `benchmark/run.py` does, and run cells on the CPU at tiny sizes."""

import os
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("USE_FLAX", "0")

#: tiny sizes of each configuration and traffic kind for a CPU run
TINY_CONFIG = {"TEXTURE_RESOLUTION": [32, 64], "grid": [6, 11]}
TINY_PARAMS = {"segment_encode": {"frames": 10, "control_palettes": [8, 8]}}


@pytest.fixture
def tiny_cell():
    """`tiny_cell(name)`: the cell loaded from its files, cut to a CPU size."""
    from uvbench import harness

    def load(name):
        cell = harness.load_cell(name)
        cell.config.update(TINY_CONFIG)
        if "ETC1S_ENDPOINTS" in cell.config:
            cell.config.update(ETC1S_ENDPOINTS=16, ETC1S_SELECTORS=16, ENCODE_WORKERS=2)
        cell.workload["params"].update(TINY_PARAMS[cell.workload["kind"]])
        return cell

    return load
