"""Build the CUDA sources under `csrc/` into one shared library.

The pattern of `uvol_tpu/native/__init__.py` (compile at first use,
load with ctypes), with nvcc in place of g++: every `csrc/*.cu` file is
compiled for Hopper (`sm_90a`), one nvcc per source, all started
together, and linked into `build/uvol_tpu_torch/` at the repo root,
under a name carrying the hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.

The library has a plain C interface: each entry point takes its
pointers and the CUDA stream as `void*`, launches, and returns
`cudaGetLastError()`. No PyTorch header is compiled, which keeps the
build to seconds.

`-fmad=false` and no `--use_fast_math`: the ETC1 encoder's 5-bit mean
must round exactly like the reference's float32 op chain.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "uvol_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
]

#: one per source: `fn(which, out, name)` of `csrc/func_attrs.cuh`
_FUNC_ATTRS = ("uvt_etc1_func_attrs", "uvt_etc1s_func_attrs", "uvt_geometry_func_attrs",
               "uvt_drc_func_attrs", "uvt_uastc_func_attrs", "uvt_mesh_func_attrs")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: the current stream's handle without a `torch.cuda.Stream` object built
#: around it, far cheaper than the public lookup; absent from CPU builds
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def find_nvcc() -> str:
    """`nvcc` from PATH, else `$CUDA_HOME/bin/nvcc` (default
    /usr/local/cuda). Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of uvol_tpu_torch are compiled with nvcc at first use"
    )


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libuvol_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the library for their hash is missing;
    returns its path. Raises on a missing nvcc or a compile error."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    cus = [p for p in _sources() if p.suffix == ".cu"]
    objs = [so.with_name(f"{tag}.{p.stem}.o") for p in cus]
    tmp = so.with_name(f"{tag}.tmp")
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p, o in zip(cus, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [f"{p.name}:\n{log}"
                  for p, proc, log in zip(cus, procs, logs) if proc.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                failed.append(f"link:\n{link.stdout}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return so


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            signatures = {
                "uvt_etc1_encode": [vp, vp, ci, ci, ci, vp],
                "uvt_etc1_decode": [vp, vp, ci, ci, ci, vp],
                "uvt_etc1s_inten_errors": [vp, vp, vp, ci, vp],
                "uvt_etc1s_assign_endpoints": [vp, vp, vp, ci, ci, vp],
                "uvt_etc1s_kmeans_iter": [vp, vp, ci, ci, vp, vp, vp, vp],
                "uvt_etc1s_segment_sum": [vp, vp, ci, ci, ci, vp, vp, vp],
                "uvt_etc1s_rate_sweep": [vp] * 9 + [ci, ci, ctypes.c_float, ctypes.c_float,
                                                    ci, ci, ci, vp, vp, vp, vp],
                "uvt_geometry_minmax": [vp, vp, vp, vp, ci, ci, ci, vp],
                "uvt_quantize_delta_zigzag": [vp, vp, vp, vp, vp, ci, vp, vp, ci, ci, ci, vp],
                "uvt_drc_fused_batch": [vp, ctypes.c_int64, vp, ci, ctypes.c_int64, vp, vp],
                "uvt_uastc_device_fit": [vp, vp, ci, ctypes.c_int64] + [vp] * 7,
                "uvt_uastc_weight_index": [vp, ctypes.c_int64, ci, vp, vp, vp],
                "uvt_estimate_normals": [vp, vp, vp, vp, vp, ci, vp],
                "uvt_morton_keys": [vp, vp, vp, ci, vp, ci, ci, vp],
                "uvt_parallelogram_decode": [vp, vp, vp, ci, ci, ci, vp],
            }
            attrs = [ci, ctypes.POINTER(ci), ctypes.POINTER(ctypes.c_char_p)]
            signatures.update({fn: attrs for fn in _FUNC_ATTRS})
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ci
            lib.uvt_cuda_error_string.argtypes = [ci]
            lib.uvt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def entry(name: str):
    """The library's entry point `name`, argtypes set (built and loaded at
    first use)."""
    return getattr(_lib or get_lib(), name)


def launch(fn, device: torch.device, *args) -> None:
    """Call the library's entry point `fn` (its name, or the function
    `entry` returned) as `fn(*args, stream)` on `device`'s current stream;
    raises if the launch is refused. The caller has checked that `device`
    is a CUDA device."""
    call = entry(fn) if isinstance(fn, str) else fn
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = (_raw_stream(index) if _raw_stream is not None
              else torch.cuda.current_stream(index).cuda_stream)
    if index == current:
        err = call(*args, stream)
    else:  # the launch needs its device current
        with torch.cuda.device(index):
            err = call(*args, stream)
    if err != 0:
        msg = _lib.uvt_cuda_error_string(err).decode()
        raise RuntimeError(f"{call.__name__} launch failed: {msg} ({err})")


def kernel_attrs() -> dict:
    """{kernel: {"registers", "stack_bytes", "static_shared_bytes",
    "dynamic_shared_limit_bytes"}} of every kernel of the library, from
    `cudaFuncGetAttributes` (`csrc/func_attrs.cuh`); needs the card. The
    dynamic limit of a kernel whose launcher raises it is the bytes of its
    last launch in this process."""
    lib = get_lib()
    out = {}
    for fn in _FUNC_ATTRS:
        for which in itertools.count():
            vals, name = (ctypes.c_int * 4)(), ctypes.c_char_p()
            err = getattr(lib, fn)(which, vals, ctypes.byref(name))
            if err == -1:  # past the source's last kernel
                break
            if err != 0:
                raise RuntimeError(f"{fn}({which}): {lib.uvt_cuda_error_string(err).decode()}")
            out[name.value.decode()] = {"registers": vals[0], "stack_bytes": vals[1],
                                        "static_shared_bytes": vals[2],
                                        "dynamic_shared_limit_bytes": vals[3]}
    return out
