"""The harness: finds a cell's pieces by name, runs it once, prints its line.

Everything is found from `BENCHMARK.json` at the checkout's root:

  - the cell `<name>`: `benchmark/workloads/<name>.json` (its configuration,
    traffic mix, traffic kind, the kind's parameters and why it exists);
  - its configuration: the `file` that `BENCHMARK.json` names for it;
  - its traffic kind: `benchmark/traffic/<kind>.py`, a module with
    `setup(run)`, `window(run)`, `end_to_end(run)`, `release(run)` and
    `check(run)`;
  - each per-layer metric `<metric>`: `benchmark/metrics/<metric>.py`, a
    module with `read(run)` that returns a number, or None where it finds
    nothing to read.

A run: set-up (inputs from the seed, the program built and warmed up on
every shape the traffic uses), the measured window of `--seconds`, then
with the window closed the device's peak memory, the import check, the
program's state freed, and the comparison with the plain reference that
decides `correct`. With `--trace 1` one device trace covers the window's
last stretch and the line carries the per-layer metrics; with `--trace 0`
the end-to-end ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from uvbench.spans import Spans
from uvbench.trace import MAX_TRACE_S, DeviceTrace

BENCH_DIR = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH_DIR.parent
#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "uvol_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return "uvbench_" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit (at most)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    workload: Dict[str, Any]
    traffic: Any
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, Any]


def load_benchmark(checkout: Path = CHECKOUT) -> Dict[str, Any]:
    with open(checkout / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(metric: Dict[str, Any], cell: str, e2e_names: Optional[List[str]] = None) -> bool:
    """Whether a metric is the cell's: the cells its `workloads` key lists;
    without the key every cell for an end-to-end metric, and for a per-layer
    one every cell that reports the end-to-end metric it `moves`."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell's files, found by name."""
    bench = load_benchmark(bench_dir.parent) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    with open(bench_dir / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {workload[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(bench_dir.parent / cfg_entry["file"]) as f:
        config = json.load(f)
    traffic = load_module(bench_dir / "traffic" / f"{workload['kind']}.py",
                          _module_name("traffic", workload["kind"]))
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, name)]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _for_cell(m, name, e2e_names)]
    readers = {m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                      _module_name("metric", m["name"]))
               for m in per_layer}
    return Cell(name, config, workload, traffic, e2e, per_layer, readers)


class Run:
    """The state of one run, handed to the traffic module and the readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 control: bool = False):
        self.cell = cell
        self.cfg = cell.config
        self.params = cell.workload["params"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.control = control
        self.spans = Spans()
        self.state: Dict[str, Any] = {}
        self.records: List[dict] = []
        self.attempted = 0
        self.failed = 0
        self.start = self.deadline = self.end = 0.0
        self.tracer: Optional[DeviceTrace] = DeviceTrace() if trace else None
        self.t0 = time.perf_counter()
        self.summary = None

    def rng(self, *tags: int) -> np.random.Generator:
        """A numpy generator drawn from the seed and `tags`."""
        return np.random.default_rng([self.seed % (1 << 64), *tags])

    def log(self, what: str) -> None:
        """A set-up stage's end, on standard error, with the time since the start."""
        print(f"{what}: {time.perf_counter() - self.t0:.3f} s", file=sys.stderr, flush=True)

    def sub_seed(self, *tags: int) -> int:
        return int(self.rng(*tags).integers(0, 1 << 62))

    def tick(self, now: float) -> None:
        """Called by the traffic between requests: starts the trace once the
        window's last `MAX_TRACE_S` seconds have come."""
        t = self.tracer
        if t is not None and not t.running and t.summary is None \
                and now >= self.deadline - min(MAX_TRACE_S, self.seconds):
            t.start()

    def stop_trace(self) -> None:
        t = self.tracer
        if t is not None and t.running:
            t.stop(list(self.spans.spans))
            self.summary = t.summary


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _number(v: float) -> float:
    """A finite float for the line (a comparison that could not be made
    reads 1e300, past any limit)."""
    return float(v) if math.isfinite(v) else 1e300


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             control: bool = False) -> Dict[str, Any]:
    """One run of the cell; returns {"result": the line's object,
    "checks": [Check], "forbidden": [module]}."""
    run = Run(cell, seed, seconds, trace, device, control)
    run.t0 = t0
    cuda = run.device.type == "cuda"
    cell.traffic.setup(run)
    if cuda:
        torch.cuda.synchronize(run.device)
        if trace:
            DeviceTrace.prime()
    setup_s = time.perf_counter() - t0
    print(f"setup_s {setup_s!r}", file=sys.stderr, flush=True)
    run.start = time.perf_counter()
    run.deadline = run.start + run.seconds
    cell.traffic.window(run)
    run.stop_trace()
    run.end = time.perf_counter()
    took = sorted(r["end"] - r["start"] for r in run.records if "end" in r)
    if took:
        print(f"window: {len(run.records)} requests, {run.end - run.start:.3f} s; request s "
              f"min {took[0]:.4f} median {took[len(took) // 2]:.4f} max {took[-1]:.4f}",
              file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    metrics: Dict[str, Dict[str, Any]] = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        if run.summary is None:
            raise RuntimeError("the window closed before the trace started")
        for name, reader in cell.readers.items():
            v = reader.read(run)
            if v is not None:
                metrics[name] = {"value": _number(v), "unit": units[name]}
    else:
        e2e = cell.traffic.end_to_end(run)
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": _number(e2e[m["name"]]), "unit": m["unit"]}
    forbidden = forbidden_modules()
    cell.traffic.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = list(cell.traffic.check(run))
    checks.append(Check("failed_requests", run.failed, 0))
    forbidden = sorted(set(forbidden) | set(forbidden_modules()))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": all(c.ok for c in checks), "attempted": run.attempted,
                              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        s = run.summary
        dev["busy_s"], dev["window_s"] = s.busy_s, s.window_s
        result["breakdown"] = s.breakdown()
    result["checks"] = {c.name: {"value": _number(c.value), "limit": c.limit} for c in checks}
    return {"result": result, "checks": checks, "forbidden": forbidden, "run": run}


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: List[str], t0: float) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    bench = load_benchmark()
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s): torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(f"card: {nvidia_smi_line()}", file=sys.stderr, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    if out["forbidden"]:
        print(f"JAX modules loaded in this process: {out['forbidden'][:8]}", file=sys.stderr)
        return 3
    for c in out["checks"]:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}){'' if c.ok else '  FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0
