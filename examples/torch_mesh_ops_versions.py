"""Time U3 and U5 of one tree of this repository on one CUDA card.

    python3 examples/torch_mesh_ops_versions.py [--tree DIR] [--label NAME] [--out FILE]

U3 is `estimate_normals`, U5 `parallelogram_decode` (`csrc/mesh_ops.cu`).
Imports `uvol_tpu_torch` from DIR (default: this checkout) and builds its
kernels there, so that two versions compare in one call on one card:
unpack another commit with `git archive` into a directory that
`.gitignore` lists (under `build/`) and run parent, change, change,
parent, each in a process of its own. The timing helpers come from this
checkout's `chip_smoke.py`.

U3 on one displaced 83 x 315 grid (26,145 vertices, 51,496 faces, the
smoke's frame): the call (CUDA-event median), the device time of one call
summed over every device event a trace holds (the tree's own kernels and
any PyTorch op its wrapper runs), the device events a call runs and the
last traced call's timeline, the kernels of U3 alone (together and
each), the host time a call takes to return, and `index_add_` of the
corner normals as the library yardstick; held bit for bit against
`estimate_normals_plain` on the card; and on a long row: vertex 0 under
PADDING -1 rows (a row of 3 x PADDING keys and more), call and alone. U5
on the grid's parallelograms at [32, 26,145, 3] (positions) and
[32, 26,145, 2] (UVs); at [32, 26,145, 3] on near references (a grid of
the same vertex count in rows of 105, shorter than the kernel's tile) and
on a = -1 alone (each step predicts from the one before; nothing to
stage but the residuals); and on random chains at [8, 200,000, 3]
(mostly a = i - 1, references up to 2^16 back): the call and the kernel
alone, each held against the CPU twin (the positions' decodes also give
back their input). And U5's machine code for 3 components (`cuobjdump
-sass` of the built library): every straight-line block that stores a
whole tile's steps, its instructions a step by opcode.
Prints the card's `nvidia-smi` name and power-limit line and one JSON
object, also written to `--out` (default
`build/mesh_ops_versions_<NAME>.json`).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REPS = 5
GRID = (83, 315)
FRAMES = 32
WIDE = (8, 200000, 3)
NEAR_GRID = (249, 105)  # GRID's 26,145 vertices in rows shorter than a tile
PADDING = 100000


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms_per_call(cs, torch, fn, reps: int = REPS) -> tuple:
    """(ms, events, names, timeline): every device event of `reps` traced
    calls, summed, per call; the events a call runs and their names; and
    the last call's events as [name, start, duration] in us from its first
    event's start (the gaps between a call's kernels)."""
    fn()
    with cs.padded_trace(torch) as prof:
        for _ in range(reps):
            fn()
    events = sorted(cs.device_events(torch, prof), key=lambda e: e.time_range.start)
    names = sorted({e.name.split("(")[0][-60:] for e in events})
    per = len(events) // reps
    last = events[-per:] if per else []
    t0 = last[0].time_range.start if last else 0
    timeline = [[e.name.split("(")[0][-40:], e.time_range.start - t0, e.time_range.elapsed_us()]
                for e in last]
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps, len(events) / reps, names,
            timeline)


def host_ms(torch, fn, calls: int = 200) -> float:
    """Host ms a call of `fn` takes to return (no synchronise inside the
    loop: the launches' enqueue, not the device work), the mean of `calls`."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def step_sass(lib: Path, nvcc: str, steps: int = 128) -> list:
    """U5 for 3 components in the library's SASS: each straight-line block
    (no branch target inside, ended by a branch, exit or barrier) holding
    `steps` or more shared stores, as {"instructions", "per_step": opcode ->
    count / stores}. A tile's steps each store one output, so the stores
    count its steps."""
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    if "parallelogram_decode_kernelILi3E" not in sass:
        return []  # a tree whose U5 is not templated on its components
    body = sass.split("parallelogram_decode_kernelILi3E", 1)[1].split("Function :", 1)[0]
    ins = [(int(m.group(1), 16), m.group(2).strip())
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    targets = {int(t, 16) for _, i in ins for t in re.findall(r"BRA (0x[0-9a-f]+)", i)}
    blocks, cur = [], []
    for addr, i in ins:
        if addr in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append(i)
        if re.search(r"\b(BRA|EXIT|BAR)\b", i):
            blocks.append(cur)
            cur = []
    out = []
    for b in blocks + [cur]:
        ops = {}
        for i in b:
            op = (i.split()[1] if i.startswith("@") else i.split()[0]).split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        if ops.get("STS", 0) >= steps:
            out.append({"instructions": len(b),
                        "per_step": {k: v / ops["STS"] for k, v in sorted(ops.items())}})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))
    import torch

    cs = load_chip_smoke()
    from uvol_tpu_torch import _build
    from uvol_tpu_torch.codecs.draco.grid import grid_mesh
    from uvol_tpu_torch.ops import mesh_cuda as mc
    from uvol_tpu_torch.ops.prediction import parallelogram_encode
    from uvol_tpu_torch.ops.quantize import quantize
    from uvol_tpu_torch.utils.timing import median_cuda_ms

    check = cs.check
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    _build.get_lib()
    out = {"label": a.label, "package": str(Path(mc.__file__).resolve().parents[2]),
           "build_s": time.perf_counter() - t0,
           "u5_sass_blocks": step_sass(_build.library_path(), _build.find_nvcc())}

    # U3 on one frame of the grid
    ny, nx = GRID
    grids = [grid_mesh(ny, nx, 1000 + k) for k in range(FRAMES)]
    pos = torch.from_numpy(np.stack([g[0] for g in grids])).to(dev)
    faces = torch.from_numpy(grids[0][3]).to(dev)
    p0 = pos[0]
    got = mc.estimate_normals(p0, faces)
    want = mc.estimate_normals_plain(p0, faces)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "estimate_normals differs from its twin")
    names = tuple(n for n in ("normals_count_kernel", "normals_fill_kernel",
                              "estimate_normals_kernel")
                  if n in _build.kernel_attrs())
    call = lambda: mc.estimate_normals(p0, faces)  # noqa: E731
    device_ms, events, event_names, timeline = device_ms_per_call(cs, torch, call)
    fn3 = mc.face_normals_plain(p0, faces).repeat(3, 1)
    corners = faces.t().reshape(-1).long()
    acc = torch.zeros_like(p0)
    out["estimate_normals"] = {
        "shape": [p0.shape[0], faces.shape[0]],
        "call_ms": median_cuda_ms(call, REPS),
        "host_ms": host_ms(torch, call),
        "device_ms": device_ms, "device_events_per_call": events, "device_event_names": event_names,
        "device_timeline_us": timeline,
        "alone_ms": cs.kernel_only_ms(torch, call, names)[0], "kernels": names,
        "per_kernel_ms": {nm: cs.kernel_only_ms(torch, call, (nm,))[0] for nm in names},
        "library_ms": median_cuda_ms(lambda: acc.index_add_(0, corners, fn3), REPS),
        "library_host_ms": host_ms(torch, lambda: acc.index_add_(0, corners, fn3))}
    r = np.random.default_rng(18)
    lp = torch.from_numpy(r.normal(size=(200, 3)).astype(np.float32)).to(dev)
    lf = torch.from_numpy(np.concatenate([r.integers(0, 200, (100, 3)),
                                          np.full((PADDING, 3), -1)]).astype(np.int32)).to(dev)
    check(torch.equal(mc.estimate_normals(lp, lf).view(torch.int32),
                      mc.estimate_normals_plain(lp, lf).view(torch.int32)),
          "estimate_normals differs from its twin on the long row")
    call = lambda: mc.estimate_normals(lp, lf)  # noqa: E731
    out["estimate_normals_long_row"] = {
        "padding": PADDING, "row_keys": int((lf.clamp(min=0) == 0).sum()),
        "call_ms": median_cuda_ms(call, REPS), "alone_ms": cs.kernel_only_ms(torch, call, names)[0]}

    # U5 on the grid's parallelograms (positions and UVs) and on random chains
    pidx = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        cs.grid_parallelograms(ny, nx), (FRAMES, ny * nx, 3)))).to(dev)
    uvs = torch.from_numpy(np.stack([g[1] for g in grids])).to(dev)
    near = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        cs.grid_parallelograms(*NEAR_GRID), (FRAMES, ny * nx, 3)))).to(dev)
    prev = torch.full_like(pidx, -1)
    q_pos = quantize(pos, 11).values
    u5 = {}
    for key, q, p in (("positions", q_pos, pidx), ("uvs", quantize(uvs, 10).values, pidx),
                      ("positions_near", q_pos, near), ("positions_a_minus_1", q_pos, prev)):
        res = parallelogram_encode(q, p)
        back = mc.parallelogram_decode(res, p)
        check(torch.equal(back, q), f"the {key} decode did not give back its input")
        check(torch.equal(back.cpu(), mc.parallelogram_decode_plain(res.cpu(), p.cpu())),
              f"parallelogram_decode differs from its twin on the {key}")
        fn = lambda res=res, p=p: mc.parallelogram_decode(res, p)  # noqa: E731
        u5[key] = {"shape": list(res.shape), "call_ms": median_cuda_ms(fn, REPS),
                   "alone_ms": cs.kernel_only_ms(torch, fn, ("parallelogram_decode_kernel",))[0]}
    f, n, d = WIDE
    res, p = cs.u5_chain(np.random.default_rng(16), f, n, d)
    res_d, p_d = torch.from_numpy(res).to(dev), torch.from_numpy(p).to(dev)
    got = mc.parallelogram_decode(res_d, p_d)
    check(torch.equal(got.cpu(), mc.parallelogram_decode_plain(torch.from_numpy(res),
                                                               torch.from_numpy(p))),
          "parallelogram_decode differs from its twin on the random chains")
    fn = lambda: mc.parallelogram_decode(res_d, p_d)  # noqa: E731
    u5["random"] = {"shape": [f, n, d], "call_ms": median_cuda_ms(fn, REPS),
                    "alone_ms": cs.kernel_only_ms(torch, fn, ("parallelogram_decode_kernel",))[0]}
    out["parallelogram_decode"] = u5
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line, flush=True)
    dest = Path(a.out) if a.out else ROOT / "build" / f"mesh_ops_versions_{a.label}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
