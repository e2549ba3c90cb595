#!/usr/bin/env python3
"""Does `torch.profiler` still see the card after what the encoder CLI, the
player and the point-cloud phase of `chip_smoke.py` do to a process?

Run on a CUDA card from the repository root:

    python3 examples/torch_profiler_after_cli.py [--out PATH]

It traces one ETC1 texture encode (K1, 5 layers of 1024^2, the H2D copy
and the D2H copy) `ATTEMPTS` times at the start of a process and after
each step, and counts what each trace holds: the device events, and the
host-side runtime records (`cuda*`/`cu*` calls) beside them. The steps:

  - `fork_pool`: a forked `multiprocessing` pool of 8 workers that ran
    numpy only;
  - `cuda_threads`: a pool of 4 threads that launched K1 and K2 (the
    player's `async_prefetch` decoders), shut down without waiting, as
    `PrefetchPool.close` does; `threads_joined`: the same, joined;
  - `many_traces`: 200 traces of a one-layer K1 encode in a row;
  - `draco_pool`: the CLI's Draco stage (`encoder_cli._encode_geometry_draco`,
    `ENCODE_WORKERS` = 8 spawned workers) on the smoke's 32 OBJ frames;
  - `cli_run`: a whole `python -m uvol_tpu_torch.encoder_cli` run in this
    process through `runpy` (the CLI's defaults: Draco, ETC1S at
    1024/1024, on the smoke's 32 frames and layers);
  - `player_async`: the facade `Player` with `async_prefetch`, its pools
    waited for after each tick (`chip_smoke.play`), on a project encoded
    beforehand in another process;
  - `u3`, `u4_sort`, `u5`, `probe`, `crt`: the point-cloud phase's parts:
    `estimate_normals` on its 32 grids, the point-cloud stage (U4 and the
    stable `torch.sort`) on 8 x 2^20 points, the parallelogram pair, the
    dependent-add probe kernel, the `.crt` codec's encode and decode;
  - `pointcloud_phase`, `cli_player_phase`: the smoke's whole
    `pointcloud_trajectory_path` and `cli_player_path`.

Each step runs alone in a process of its own (`alone`), then the steps run
in the smoke's order in one process (`sequence`), and that order once more
with `TEARDOWN_CUPTI=0` in the environment (`sequence_teardown_off`): Kineto
then keeps CUPTI subscribed between traces instead of tearing it down after
each, as `uvol_tpu_torch.utils.timing.device_trace` has it do otherwise.
Every series below may be run with `TEARDOWN_CUPTI=0` too: its traces are
then taken as they were before `device_trace` tore CUPTI down. Prints one
JSON object.

    python3 examples/torch_profiler_after_cli.py --steps u3,cli_run

runs the named steps in this process and prints that process's record.

    python3 examples/torch_profiler_after_cli.py --clock SECONDS

is the clock series: no step, only time. After SECONDS of sleep with the
CUDA context made, it traces at `CLOCK_AGES` seconds after its first
trace: 3 K1 encodes, one with `MARGIN_S` of sleep inside the trace before
and after the work, and one of PyTorch's own work (an H2D copy, a
multiply, a D2H copy). For each device event it prints its start and end
in the trace (us from the trace's start), the trace's last host event,
and its skew: its start less that of the runtime call that launched it
(the same correlation id), which is positive when the two clocks agree.

    python3 examples/torch_profiler_after_cli.py --idle

is the idle series: a traced K1 encode after 10, 30 and 60 s with the
card idle, taken plain, after an untraced spin kernel (`woken`), inside
the smoke's `padded_trace`, and as the second of two traces in a row.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import runpy
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ATTEMPTS = 5
MANY_TRACES = 200
CLOCK_AGES = (0, 2, 5, 10, 20, 40, 80, 160)  # s after the clock series' first trace
MARGIN_S = 0.1
IDLE_GAPS = (10, 30, 60)  # s of an idle card before each trace of the idle series
WORK = ROOT / "build" / "profiler_after_cli"
SMOKE_ORDER = ("u3", "u4_sort", "u5", "probe", "crt", "pointcloud_phase",
               "draco_pool", "cli_run", "player_async", "cli_player_phase")
ALONE = ("fork_pool", "cuda_threads", "threads_joined", "many_traces", *SMOKE_ORDER)


def _smoke():
    """`chip_smoke.py` as a module: its phases and inputs, not its `main`."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _numpy_work(i: int) -> float:
    return float(np.sort(np.random.default_rng(i).random(200_000)).sum())


def _counts(torch, prof) -> tuple:
    """(device events, host-side runtime records) of a finished trace."""
    dev = host = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev += 1
        elif e.name.startswith(("cuda", "cu")):
            host += 1
    return dev, host


def _state() -> dict:
    """What a step may leave behind in the process."""
    import multiprocessing as mp

    return {"threads": sorted(t.name for t in threading.enumerate()),
            "os_threads": len(os.listdir("/proc/self/task")),
            "children": len(mp.active_children())}


class Context:
    """The card, the smoke's inputs and the traced K1 encode of one process."""

    def __init__(self) -> None:
        import torch

        from uvol_tpu_torch.models.sequence import TextureSequenceCodec

        self.torch = torch
        self.dev = torch.device("cuda")
        self.cs = _smoke()
        self.textures = self.cs.bench_batch()[4]
        self.tex = self.textures[:5]
        self.codec = TextureSequenceCodec(device="cuda")
        self.codec.encode_segment(self.tex)  # warm: library load, allocator

    def k1(self) -> None:
        self.codec.encode_segment(self.tex)

    def traces(self, n: int = ATTEMPTS, layers=None) -> dict:
        from uvol_tpu_torch.utils.timing import device_trace

        torch, tex = self.torch, self.tex if layers is None else layers
        dev, host = [], []
        for _ in range(n):
            with device_trace() as prof:
                self.codec.encode_segment(tex)
                torch.cuda.synchronize()
            d, h = _counts(torch, prof)
            dev.append(d)
            host.append(h)
        return {"device_events": dev, "runtime_records": host}

    def grids(self):
        from uvol_tpu_torch.codecs.draco.grid import grid_mesh

        cs, torch = self.cs, self.torch
        grids = [grid_mesh(*cs.DRC_GRID, 1000 + k) for k in range(cs.PC_FRAMES)]
        pos = np.stack([g[0] for g in grids])
        return pos, torch.from_numpy(pos).to(self.dev), torch.from_numpy(grids[0][3]).to(self.dev)


def step_fork_pool(ctx: Context) -> None:
    import multiprocessing as mp

    with mp.get_context("fork").Pool(8) as pool:
        pool.map(_numpy_work, range(32))


def _k2_threads(ctx: Context, wait: bool) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from uvol_tpu_torch.codecs.basis import etc_cuda

    words = etc_cuda.encode_etc1_images(ctx.torch.from_numpy(ctx.tex).to(ctx.dev))

    def decode(_):
        return etc_cuda.decode_etc1_images(words, 5, 1024, 1024).cpu().numpy().sum()

    threads = ThreadPoolExecutor(max_workers=4)
    list(threads.map(decode, range(16)))
    threads.shutdown(wait=wait)


def step_cuda_threads(ctx: Context) -> None:
    _k2_threads(ctx, wait=False)


def step_threads_joined(ctx: Context) -> None:
    _k2_threads(ctx, wait=True)


def step_many_traces(ctx: Context) -> dict:
    got = ctx.traces(MANY_TRACES, layers=ctx.tex[:1, :64, :64])
    return {"traces_without_device_events": sum(1 for d in got["device_events"] if d == 0)}


def _project_config(ctx: Context, name: str) -> str:
    """A fresh output directory under the CLI's defaults (the smoke's project A)."""
    out = WORK / "runs" / f"{name}_{os.getpid()}_{time.monotonic_ns()}"
    out.parent.mkdir(parents=True, exist_ok=True)
    return ctx.cs.cli_config(out.with_suffix(".json"), inputs(ctx.cs), out)


def step_draco_pool(ctx: Context) -> None:
    from uvol_tpu_torch import encoder_cli

    cfg = json.loads(Path(_project_config(ctx, "draco")).read_text())
    objs = sorted(str(p) for p in (WORK / "inputs" / "OBJ").glob("*.obj"))
    os.makedirs(cfg["OutputDirectory"], exist_ok=True)
    encoder_cli._encode_geometry_draco(cfg, objs, cfg["OutputDirectory"])


def step_cli_run(ctx: Context) -> None:
    cfg = _project_config(ctx, "cli")
    argv = sys.argv
    sys.argv = ["uvol_tpu_torch.encoder_cli", cfg]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_module("uvol_tpu_torch.encoder_cli", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (0, None):
            raise RuntimeError(f"the encoder CLI returned {e.code}") from None
    finally:
        sys.argv = argv


def step_player_async(ctx: Context) -> dict:
    ticks = ctx.cs.play(ctx.torch, str(WORK / "project" / "smoke.uvol.json"), True)[0]
    return {"ticks": len(ticks), "ok_ticks": sum(1 for r in ticks if r.status == "ok")}


def step_u3(ctx: Context) -> None:
    from uvol_tpu_torch.ops import mesh_cuda as mc

    _, pos_d, faces_d = ctx.grids()
    for k in range(len(pos_d)):
        mc.estimate_normals(pos_d[k], faces_d)
    ctx.torch.cuda.synchronize()


def step_u4_sort(ctx: Context) -> None:
    from uvol_tpu_torch.models.pointcloud import PointCloudSequenceCodec

    torch = ctx.torch
    gen = torch.Generator(device=ctx.dev).manual_seed(15)
    cloud = torch.randn((*ctx.cs.PC_CLOUD, 3), generator=gen, device=ctx.dev) * 2.0
    PointCloudSequenceCodec(ctx.cs.PC_BITS[0], device="cuda").device_stage(cloud)  # U4, sort
    torch.cuda.synchronize()


def step_u5(ctx: Context) -> None:
    from uvol_tpu_torch.ops import mesh_cuda as mc
    from uvol_tpu_torch.ops.prediction import parallelogram_encode
    from uvol_tpu_torch.ops.quantize import quantize

    cs, torch = ctx.cs, ctx.torch
    _, pos_d, _ = ctx.grids()
    pidx = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        cs.grid_parallelograms(*cs.DRC_GRID), (len(pos_d), pos_d.shape[1], 3)))).to(ctx.dev)
    q = quantize(pos_d, cs.PC_BITS[0]).values
    back = mc.parallelogram_decode(parallelogram_encode(q, pidx), pidx)
    if not torch.equal(back, q):
        raise RuntimeError("the parallelogram decode did not give back its input")


def step_probe(ctx: Context) -> dict:
    from uvol_tpu_torch.ops import mesh_cuda as mc

    return {"cycles": mc.dependent_add_cycles(ctx.dev)}


def step_crt(ctx: Context) -> None:
    from uvol_tpu_torch.models.pointcloud import PointCloudSequenceCodec

    pos = ctx.grids()[0]
    codec = PointCloudSequenceCodec(ctx.cs.PC_BITS[0], device="cuda")
    codec.decode(codec.encode(pos))


def step_pointcloud_phase(ctx: Context) -> dict:
    from uvol_tpu_torch.utils.timing import median_cuda_ms

    with contextlib.redirect_stdout(io.StringIO()):
        ctx.cs.pointcloud_trajectory_path(ctx.torch, ctx.dev, median_cuda_ms)
    return {"smoke_traces_retaken": list(ctx.cs.TRACES_RETAKEN)}


def step_cli_player_phase(ctx: Context) -> dict:
    with contextlib.redirect_stdout(io.StringIO()):
        ctx.cs.cli_player_path(ctx.torch, ctx.textures)
    return {}


STEPS = {name: globals()[f"step_{name}"] for name in ALONE}


def _events(torch, prof) -> dict:
    """A finished trace's device events as [name, start, end, skew] (us
    from the trace's start; skew: start less its launching runtime call's),
    and its last host event's end."""
    cpu = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA]
    launch = {e.id: e.time_range.start for e in cpu if e.name.startswith(("cuda", "cu"))}
    dev = [[e.name[:48], e.time_range.start, e.time_range.end,
            None if e.id not in launch else e.time_range.start - launch[e.id]]
           for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kineto = sum(1 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA)
    return {"device": dev, "kineto_device": kineto,
            "host_end": max((e.time_range.end for e in cpu), default=None)}


def _traced(ctx: "Context", work, margin: float = 0.0) -> dict:
    """`_events` of one trace of `work`, with `margin` s of sleep inside the
    trace before and after it."""
    from uvol_tpu_torch.utils.timing import device_trace

    with device_trace() as prof:
        time.sleep(margin)
        work()
        ctx.torch.cuda.synchronize()
        time.sleep(margin)
    return _events(ctx.torch, prof)


def clock_series(first_trace_after: float) -> dict:
    """K1's traces, and PyTorch's, at `CLOCK_AGES` seconds after the first
    (taken `first_trace_after` seconds after the warm encode)."""
    ctx = Context()
    torch = ctx.torch
    x = torch.from_numpy(ctx.tex)
    time.sleep(first_trace_after)
    t0 = time.monotonic()
    rows = []
    for age in CLOCK_AGES:
        time.sleep(max(0.0, t0 + age - time.monotonic()))
        rows.append({"age_s": time.monotonic() - t0,
                     "k1": [_traced(ctx, ctx.k1) for _ in range(3)],
                     "k1_margin": _traced(ctx, ctx.k1, MARGIN_S),
                     "torch": _traced(ctx, lambda: (x.to(ctx.dev).float() * 2).cpu())})
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": ctx.cs.nvidia_smi_line(),
            "first_trace_after_s": first_trace_after, "rows": rows}


def _smi_state() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=pstate,clocks.sm,clocks.mem,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def idle_series() -> dict:
    """After each of `IDLE_GAPS` seconds with the card idle, one traced K1
    encode taken four ways: `plain`; `woken`, after an untraced spin kernel
    and a synchronise; `padded`, the smoke's `padded_trace` (a spin kernel
    inside the trace, then 10 ms of sleep, before the work); and `second`,
    the second of two traces in a row, the first of an empty region. Each
    way after a gap of its own; the card's P-state and clocks read just
    before it."""
    ctx = Context()
    torch, cs = ctx.torch, ctx.cs

    def padded() -> dict:
        with cs.padded_trace(torch) as prof:
            ctx.k1()
        return _events(torch, prof)

    def woken() -> dict:
        torch.cuda._sleep(cs.PAD_CYCLES)
        torch.cuda.synchronize()
        return _traced(ctx, ctx.k1)

    def second() -> dict:
        _traced(ctx, lambda: None)
        return _traced(ctx, ctx.k1)

    ways = {"plain": lambda: _traced(ctx, ctx.k1), "woken": woken, "padded": padded,
            "second": second}
    rows = [{"gap_s": 0, "way": "plain", "card": _smi_state(), **ways["plain"]()}]
    for gap in IDLE_GAPS:
        for name, way in ways.items():
            time.sleep(gap)
            card = _smi_state()
            rows.append({"gap_s": gap, "way": name, "card": card, **way()})
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
            "rows": rows}


def inputs(cs) -> tuple:
    """The smoke's CLI inputs (32 OBJ grids, 32 PNG layers), made once."""
    root = WORK / "inputs"
    if not (root / "done").exists():
        cs.cli_inputs(root, cs.CLI_FRAMES, cs.DRC_GRID, cs.bench_batch()[4][:cs.CLI_FRAMES])
        (root / "done").write_text("")
    return str(root / "OBJ" / "[#####].obj"), str(root / "images" / "[#####].png")


def run_steps(names) -> dict:
    """This process: the K1 traces at the start and after each step."""
    ctx = Context()
    out = {"baseline": ctx.traces(), "start": _state(), "steps": []}
    for name in names:
        t = time.perf_counter()
        extra = STEPS[name](ctx) or {}
        took = time.perf_counter() - t
        out["steps"].append({"step": name, "step_s": took, **ctx.traces(), **_state(), **extra})
    return out


def _child(steps, env: dict, timeout: float) -> dict:
    proc = subprocess.run([sys.executable, __file__, "--steps", ",".join(steps)],
                          env={**os.environ, **env}, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)
    if proc.returncode != 0:
        return {"error": proc.returncode, "stderr": proc.stderr[-3000:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", help="comma-separated steps to run in this process")
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--alone", default=",".join(ALONE), help="steps to run alone")
    ap.add_argument("--clock", type=float, help="the clock series, first trace after this many s")
    ap.add_argument("--idle", action="store_true", help="the idle series")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if args.steps or args.clock is not None or args.idle:
        out = (idle_series() if args.idle else clock_series(args.clock)
               if args.clock is not None else run_steps([s for s in args.steps.split(",") if s]))
        text = json.dumps(out)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(text)
        print(text)
        return 0
    from uvol_tpu_torch import _build

    cs = _smoke()
    _build.build()  # once, before the processes that load it
    t0 = time.perf_counter()
    inputs(cs)
    cfg = cs.cli_config(WORK / "project.json", inputs(cs), WORK / "project")
    subprocess.run([sys.executable, "-m", "uvol_tpu_torch.encoder_cli", cfg], check=True,
                   cwd=ROOT, stdout=subprocess.DEVNULL)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
           "torch": torch.__version__, "cuda": torch.version.cuda, "attempts": ATTEMPTS,
           "setup_s": time.perf_counter() - t0, "alone": {}}
    for name in [s for s in args.alone.split(",") if s]:
        out["alone"][name] = _child([name], {}, 900)
    out["sequence"] = _child(SMOKE_ORDER, {}, 1500)
    out["sequence_teardown_off"] = _child(SMOKE_ORDER, {"TEARDOWN_CUPTI": "0"}, 1500)
    out["total_s"] = time.perf_counter() - t0
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
