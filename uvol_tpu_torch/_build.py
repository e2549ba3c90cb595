"""Build the CUDA sources under `csrc/` into one shared library.

The pattern of `uvol_tpu/native/__init__.py` (compile at first use,
load with ctypes), with nvcc in place of g++: every `csrc/*.cu` file is
compiled for Hopper (`sm_90a`) into `build/uvol_tpu_torch/` at the repo
root, under a name carrying the hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded.

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
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "uvol_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cus = [str(p) for p in _sources() if p.suffix == ".cu"]
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *cus],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
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
                "uvt_etc1s_kmeans_iter": [vp, vp, ci, ci, vp, vp, vp, vp, vp],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ci
            lib.uvt_cuda_error_string.argtypes = [ci]
            lib.uvt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
