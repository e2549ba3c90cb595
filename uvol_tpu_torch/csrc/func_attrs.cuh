// Registers, stack and static shared bytes of a source's kernels, read
// with cudaFuncGetAttributes. Each .cu lists its kernels once with
// UVT_KERNEL and exports `uvt_<source>_func_attrs`, which returns
// fill_func_attrs of that list; _build.kernel_attrs reads them all.

#pragma once

#include <cuda_runtime.h>

namespace {

struct KernelRef {
  const void* fn;
  const char* name;
};

#define UVT_KERNEL(f) KernelRef{(const void*)(f), #f}

// Kernel `which` of `ks`: its name, and out[0..3] = registers per thread,
// local (stack) bytes, static shared bytes, and the dynamic shared bytes
// a launch may take (the limit a launcher last set with
// cudaFuncSetAttribute, else 48 KB minus the static bytes). -1 past the
// last kernel, else the CUDA error.
template <size_t N>
int fill_func_attrs(const KernelRef (&ks)[N], int which, int* out, const char** name) {
  if (which < 0 || which >= (int)N) return -1;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, ks[which].fn);
  if (err != cudaSuccess) return (int)err;
  *name = ks[which].name;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace
