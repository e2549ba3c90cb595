// Fused geometry quantize + delta + zigzag (K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of uvol_tpu/ops/pallas_kernels.py:
//   K3  `_kernel` (fused_quantize_delta_zigzag): q = floor(xm * inv + 0.5),
//       the difference along the vertex axis (row 0 against 0), zigzag.
// The TPU kernel runs on an interleaved [TILE_N, 128] layout (C = 2..3
// components padded to 128 lanes) and carries the delta seam across tiles
// through a per-tile previous-row input. Neither is needed here: the
// kernel reads the geometry encode's planar [F, C, N] float32 batch, one
// thread per output element, so neighbouring threads read and write
// neighbouring addresses, and each thread recomputes q[n-1] from xm[n-1]
// (an L1/L2 hit of its neighbour's load), so no seam crosses a block.
//
// Rounding: one fused multiply-add rounded once (__fmaf_rn), then floorf,
// then int -- what XLA compiles the Pallas kernel's floor(xm * inv + 0.5)
// into on the CPU (the plain twin in ops/pallas_kernels.py says where the
// codec's own XLA loop departs from it). The
// zigzag is taken on unsigned bits, ((uint32)d << 1) ^ (uint32)(d >> 31):
// a left shift of a negative int is not defined in C++17.
//
// Bound: 4 bytes read and 4 written per element, ~10 integer and float
// instructions. At the geometry encode's batch (F = 32, N = 26,145) the
// positions (C = 3) move 20.1 MB, 6.0 us at 3.35 TB/s, and the UVs
// (C = 2) 13.4 MB, 4.0 us; the instructions take ~1 us at the SMs' dispatch
// rate. The kernel is bound by memory; at these sizes a call's launch and
// host wrapper cost more than the kernel itself (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "func_attrs.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int quantize(float x, float inv) {
  return (int)floorf(__fmaf_rn(x, inv, 0.5f));
}

// xm, out: [f, c, n] row-major; inv: [f].
__global__ void quantize_delta_zigzag_kernel(const float* __restrict__ xm,
                                             const float* __restrict__ inv,
                                             int32_t* __restrict__ out, int c, int n,
                                             int64_t total) {
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  int64_t row = i / n;                    // (frame, component) row
  int col = (int)(i - row * n);           // vertex
  float s = inv[row / c];
  int q = quantize(xm[i], s);
  int prev = col ? quantize(xm[i - 1], s) : 0;
  int d = q - prev;
  out[i] = (int32_t)(((uint32_t)d << 1) ^ (uint32_t)(d >> 31));
}

}  // namespace

extern "C" {

// xm: [f, c, n] float32; inv: [f] float32; out: [f, c, n] int32.
int uvt_quantize_delta_zigzag(const void* xm, const void* inv, void* out, int f, int c,
                              int n, void* stream) {
  const int64_t total = (int64_t)f * c * n;
  if (total > 0) {
    const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
    quantize_delta_zigzag_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)xm, (const float*)inv, (int32_t*)out, c, n, total);
  }
  return (int)cudaGetLastError();
}

int uvt_geometry_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {UVT_KERNEL(quantize_delta_zigzag_kernel)};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
