"""Time K8 (the `.drc` window's device stage) of one tree of this repository on one CUDA card.

    python3 examples/torch_k8_versions.py [--tree DIR] [--label NAME] [--out FILE]
                                          [--variants NAME ...]

Imports `uvol_tpu_torch` from DIR (default: this checkout) and builds its
kernels there, so that two versions compare in one call on one card:
unpack another commit with `git archive` into a directory that
`.gitignore` lists (under `build/`) and run parent, change, change,
parent. The windows, cases and timing helpers come from this checkout's
`chip_smoke.py`.

On windows of the main path's layout (8 and 64 frames of 26,145 vertices
bucketed to 28,672: positions at 12 bits, texcoords at 10, normals at 8;
`chip_smoke.drc_window`) it times K8 per call (CUDA events around
`fused_batch`), in a loop of back-to-back calls (the larger of the
wrapper's host work and the kernel), alone (profiler device time), and
alone at 8 frames
with the 50 MB L2 cache overwritten before each call; it holds K8 bit for
bit against its twin there and on the smoke's random windows
(`chip_smoke.drc_cases`: 1 to 4 components, frames that CTAs cross,
every offset residue, windows off a 16-byte boundary). It counts K8's
64-bit divisions and remainders (`div`/`rem` .s64/.u64 in its PTX, which
sm_90 runs as calls to a software routine) and the CALL instructions of
its SASS in the tree's built library (`cuobjdump -sass`). `--variants`
also builds copies of the tree's `csrc/drc.cu` with other values a CTA
(`VARIANTS`) into `build/k8_variants/` and times each through the same
wrapper. Prints the card's `nvidia-smi` name/power-limit
line and one JSON object, also written to `build/k8_versions_<NAME>.json`
(`--out`).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 5
LOOP = 200  # calls a back-to-back timing takes
NMAX = 28672  # 26,145 vertices in buckets of 4,096
#: (kind, mode, values hi, components): the main path's attributes at 11/10/8 bits
MAIN_ATTRS = ((1, 12, 1 << 11, 3), (1, 10, 1 << 10, 2), (2, 8, 255))
VARIANTS = {f"values{v}": [("constexpr int kValues = 2048;", f"constexpr int kValues = {v};")]
            for v in (1024, 4096)}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def div64(_build, src: Path, so: Path, kernel: str) -> dict:
    """64-bit divisions and remainders in `kernel`: the `div`/`rem` .s64 and
    .u64 instructions of its PTX (`nvcc -ptx` of `src` with the library's
    flags), which sm_90 runs as calls to a software routine, and the CALL
    instructions of its SASS in the built library `so` (`cuobjdump -sass`,
    None where the toolkit has none; SASS does not name a call's target)."""
    ptx_path = ROOT / "build" / f"{src.stem}.{os.getpid()}.ptx"
    flags = [f for f in _build.NVCC_FLAGS if not f.startswith(("-gencode", "arch="))]
    subprocess.run([_build.find_nvcc(), "-ptx", "-arch=sm_90a", *flags, "-I", str(src.parent),
                    "-o", str(ptx_path), str(src)], check=True, capture_output=True)
    text = ptx_path.read_text()
    ptx_path.unlink()
    entry = next(e for e in text.split(".entry ")[1:] if kernel in e.split("(", 1)[0])
    res = {"ptx_div64": len(re.findall(r"\b(?:div|rem)\.[su]64\b", entry))}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {**res, "cuobjdump": None}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    body = "\n".join(f for f in re.split(r"\n\s*Function : ", sass)[1:]
                     if kernel in f.split("\n", 1)[0])
    return {**res, "cuobjdump": tool,
            "sass_calls": sum("CALL" in line for line in body.splitlines()),
            "sass_instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/", body))}


def build_variant(_build, name: str) -> tuple:
    out = ROOT / "build" / "k8_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "drc.cu").read_text()
    for old, new in VARIANTS[name]:
        src, n = re.subn(re.escape(old), lambda _: new, src)
        if n != 1:
            raise RuntimeError(f"{name}: {old!r} is not in drc.cu")
    cu = out / f"drc_{name}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                           str(_build.CSRC), "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}"[-4000:])
    lib = ctypes.CDLL(str(so))
    fn = lib.uvt_drc_fused_batch
    fn.argtypes = _build.entry("uvt_drc_fused_batch").argtypes
    fn.restype = ctypes.c_int
    ptxas = [line.split(":", 1)[-1].strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "ptxas info" in line and ("Used" in line or "bytes stack" in line)]
    return fn, ptxas, so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="this")
    ap.add_argument("--out", default=None)
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))
    import torch

    cs = load_chip_smoke()
    from uvol_tpu_torch import _build
    from uvol_tpu_torch.models import drc_device as dd
    from uvol_tpu_torch.utils.timing import cuda_timer, median_cuda_ms

    check = cs.check
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    so = _build.build()
    _build.get_lib()
    names = cs.WRAPPER_KERNELS["drc_fused_batch"]
    out = {"label": a.label, "package": str(Path(dd.__file__).resolve().parents[2]),
           "build_s": time.perf_counter() - t0,
           "kernel_attrs": {n: _build.kernel_attrs()[n] for n in names},
           "div64": div64(_build, _build.CSRC / "drc.cu", so, names[0])}

    def same(got, want) -> bool:
        for g, w in zip(got, want, strict=True):
            g, w = g.cpu(), w.cpu()
            gn, wn = torch.isnan(g), torch.isnan(w)
            if not (torch.equal(gn, wn) and torch.equal(g[~gn].view(torch.int32),
                                                        w[~wn].view(torch.int32))):
                return False
        return True

    # the smoke's random windows, each against the twin
    cases = [(f"{kind}_{mode}_{nmax}", *cs.drc_window(torch, [(kind, mode, hi)], 3, nmax,
                                                       mode + nmax, maxv=(254.0, 0.0, -1.0)), 0)
             for kind, mode, hi in cs.DRC_ATTRS for nmax in cs.DRC_NMAX] + cs.drc_cases(torch)
    for name, packed, specs, mo, ml, base in cases:
        check(same(dd.fused_batch(cs.on_card_at(torch, dev, packed, base), specs, mo, ml),
                   dd.fused_batch_plain(packed, specs, mo, ml)),
              f"K8 differs from its twin on {name}")
    out["random_cases"] = len(cases)

    # the main path's windows: per call, alone, alone with L2 overwritten
    windows = {}
    for frames in (8, 64):
        packed, specs, mo, ml = cs.drc_window(torch, MAIN_ATTRS, frames, NMAX, frames)
        args = (packed.to(dev), specs, mo, ml)
        check(same(dd.fused_batch(*args), dd.fused_batch_plain(packed, specs, mo, ml)),
              f"K8 differs from its twin on the {frames}-frame window")
        windows[frames] = args
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def times(launch) -> dict:
        res = {}
        for frames, args in windows.items():
            res[f"f{frames}_call_ms"] = median_cuda_ms(lambda: launch(*args), REPS)
            with cuda_timer() as t:  # back to back: the larger of host work and kernel
                for _ in range(LOOP):
                    launch(*args)
            res[f"f{frames}_in_loop_ms"] = t.ms / LOOP
            res[f"f{frames}_alone_ms"] = cs.kernel_only_ms(torch, lambda: launch(*args), names,
                                                           REPS)[0]

        def cold():
            flush.zero_()
            return launch(*windows[8])

        res["f8_alone_l2_cold_ms"] = cs.kernel_only_ms(torch, cold, names, REPS)[0]
        res["window_bytes"] = {f: int(args[0].numel()) for f, args in windows.items()}
        return res

    out["ms"] = times(dd.fused_batch)
    out["ms"]["f8_plain_ms"] = median_cuda_ms(lambda: dd.fused_batch_plain(*windows[8]), REPS)

    if a.variants:  # the same wrapper over other builds of this tree's drc.cu
        k8 = dd._k8
        out["variants"] = {}
        try:
            for name in a.variants:
                fn, ptxas, vso = build_variant(_build, name)
                dd._k8 = lambda fn=fn: fn
                for cname, packed, specs, mo, ml, base in cases:
                    check(same(dd.fused_batch(cs.on_card_at(torch, dev, packed, base), specs,
                                              mo, ml), dd.fused_batch_plain(packed, specs, mo, ml)),
                          f"variant {name} differs from the twin on {cname}")
                out["variants"][name] = {"ptxas": ptxas,
                                         "ms": times(dd.fused_batch)}
        finally:
            dd._k8 = k8

    dest = Path(a.out or ROOT / "build" / f"k8_versions_{a.label}.json")
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
