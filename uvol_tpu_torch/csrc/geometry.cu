// The geometry encode's device stage for Hopper (sm_90a): two kernels per
// attribute, from the planar batch x[F, C, N] float32 and its validity mask
// [F, N] to the zigzag symbols, the per-row minimum and the frame's range.
//
//   geometry_minmax_kernel         the masked minimum and maximum of each
//       (frame, component) row. The reference leaves this reduction to XLA
//       (uvol_tpu/models/sequence.py, `_syms`: jnp.min / jnp.max over
//       where(mask, x, +-big)); it is written by hand here because it is
//       two thirds of the stage's traffic.
//   quantize_delta_zigzag_kernel   K3, replacing the Pallas TPU kernel of
//       uvol_tpu/ops/pallas_kernels.py (`_kernel`,
//       fused_quantize_delta_zigzag): q = floor(xm * inv + 0.5), the
//       difference along the vertex axis (vertex 0 against 0), zigzag. Here
//       it also takes what the reference computes before it: the frame's
//       range max_c(mx - mn) with range <= 0 -> 1, inv = (2^bits - 1) /
//       range, and xm = x - mn on valid vertices, 0 on padded ones. With
//       `inv` given and no mask or minimum it is the Pallas kernel's function
//       alone (`fused_quantize_delta_zigzag(xm, inv)`); the arithmetic
//       exists once.
//
// The TPU kernel runs on an interleaved [TILE_N, 128] layout (C = 2..3
// components padded to 128 lanes) and carries the delta seam across tiles
// through a per-tile previous-row input. None of that is kept.
//
// Design of K3. A CTA takes one component (blockIdx.x) of one frame
// (blockIdx.z) and one tile of 1,024 vertices of that row (blockIdx.y): no
// thread divides to find its row. Thread 0 forms the row's constants once
// (the range over the frame's components, one IEEE division for inv; the
// first CTA of a frame writes the range out). Each thread then takes 4 consecutive vertices: one 16-byte
// load, 4 mask bytes, a rounded subtract and one fused multiply-add each,
// and one 16-byte store. The left neighbour of its first vertex comes from
// the lane below by a warp shuffle; only lane 0 of a warp reads one more
// float. A padded vertex quantizes to 0 and hands that 0 on, so the symbol
// at n = count is zigzag(-q[count - 1]) as in the reference.
// Rows start at multiples of N floats and N is odd on the main path
// (26,145), so rows are not 16-byte aligned. The threads' groups of 4 are
// therefore laid on the 16-byte grid of the buffer, not on the row: group g
// of row r holds vertices 4g - pad .. 4g - pad + 3 with pad = (r * N) mod 4.
// Every group inside the row is then an aligned float4 / int4; the row's
// first and last groups may hang over its ends and take scalar accesses.
// When x or out itself is off a 16-byte boundary (a view into a larger
// buffer) pad is 0 and every group takes scalar accesses.
//
// Design of the minimum/maximum. One CTA of 1,024 threads per row
// (blockIdx.x the component, blockIdx.y the frame); a thread
// keeps 8 independent 4-byte loads (and their mask bytes) in flight per
// step, so a row's 32 warps hold 32 KB in flight, enough to cover the
// memory's latency at one SM's share of its rate. Then warp shuffles, then
// one value per warp through shared memory. A padded vertex counts as
// +FLT_MAX for the minimum and -FLT_MAX for the maximum, as the reference's
// `where` makes it, so a row without a valid vertex gives exactly those.
// fminf / fmaxf order the zeros (-0.0 < +0.0), as XLA's minimum does; NaN
// positions are outside the contract.
//
// Rounding: the subtract is rounded (__fsub_rn, never contracted), then one
// fused multiply-add rounded once (__fmaf_rn), floorf, int -- what XLA
// compiles the Pallas kernel's floor(xm * inv + 0.5) into on the CPU (the
// plain twin in ops/pallas_kernels.py says where the codec's own XLA loop
// departs from it). inv is __fdiv_rn, the IEEE quotient the reference takes.
// The zigzag is taken on unsigned bits, ((uint32)d << 1) ^ (uint32)(d >> 31):
// a left shift of a negative int is not defined in C++17.
//
// Bound: bytes. At the geometry encode's batch (F = 32, N = 26,145) the
// positions (C = 3) are 10.0 MB and the mask 0.8 MB: the minimum reads them
// once (10.9 MB, 3.2 us at 3.35 TB/s) and K3 reads them and writes 10.0 MB
// of symbols (20.9 MB, 6.2 us); the UVs (C = 2) two thirds of that. K3's ~12
// operations per vertex take ~1 us at the SMs' dispatch rate. PERF.md
// section 6 has the measured times.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "func_attrs.cuh"

namespace {

constexpr int kThreads = 256;          // K3: threads per CTA
constexpr int kPerThread = 4;          // K3: vertices per thread
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxGridYZ = 65535;      // tiles of a row; frames of a batch
constexpr int kRedThreads = 1024;      // minimum/maximum: threads per CTA
constexpr int kRedUnroll = 8;          // loads a thread keeps in flight
constexpr unsigned kFullWarp = 0xffffffffu;

// ---------------------------------------------------------------------------
// Masked minimum and maximum of each (frame, component) row
// ---------------------------------------------------------------------------

// x: [f, c, n]; mask: [f, n] bytes (0 = padded); mn, mx: [f, c].
__global__ void __launch_bounds__(kRedThreads)
geometry_minmax_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                       float* __restrict__ mn, float* __restrict__ mx, int n) {
  __shared__ float s_mn[kRedThreads / 32], s_mx[kRedThreads / 32];
  const int row = blockIdx.y * gridDim.x + blockIdx.x;
  const float* xr = x + (int64_t)row * n;
  const uint8_t* mr = mask + (int64_t)blockIdx.y * n;
  float lo = INFINITY, hi = -INFINITY;  // a vertex past the row counts for neither
  for (int base = threadIdx.x; base < n; base += kRedThreads * kRedUnroll) {
    float v[kRedUnroll];
    bool valid[kRedUnroll];
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u) {
      const int i = base + u * kRedThreads;
      v[u] = i < n ? xr[i] : 0.0f;
      valid[u] = i < n && mr[i] != 0;
    }
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u) {
      const bool in = base + u * kRedThreads < n;
      lo = fminf(lo, valid[u] ? v[u] : in ? FLT_MAX : INFINITY);
      hi = fmaxf(hi, valid[u] ? v[u] : in ? -FLT_MAX : -INFINITY);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_down_sync(kFullWarp, lo, off));
    hi = fmaxf(hi, __shfl_down_sync(kFullWarp, hi, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_mn[warp] = lo;
    s_mx[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kRedThreads / 32 ? s_mn[lane] : INFINITY;
    hi = lane < kRedThreads / 32 ? s_mx[lane] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_down_sync(kFullWarp, lo, off));
      hi = fmaxf(hi, __shfl_down_sync(kFullWarp, hi, off));
    }
    if (lane == 0) {
      mn[row] = lo;
      mx[row] = hi;
    }
  }
}

// ---------------------------------------------------------------------------
// K3: offsets, quantize, delta, zigzag
// ---------------------------------------------------------------------------

// q of one vertex: xm = valid ? x - mn : 0.
__device__ __forceinline__ int quantize(float x, bool valid, float mn, float inv) {
  const float xm = valid ? __fsub_rn(x, mn) : 0.0f;
  return (int)floorf(__fmaf_rn(xm, inv, 0.5f));
}

__device__ __forceinline__ int32_t zigzag(int d) {
  return (int32_t)(((uint32_t)d << 1) ^ (uint32_t)(d >> 31));
}

// x, out: [f, c, n]; mask: [f, n] bytes or null (every vertex valid); mn, mx:
// [f, c] or both null (no subtract; then inv is given); inv: [f] or null
// (then formed from mn, mx and max_q); rng_out: [f] or null. `vec`: x and out
// are 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
quantize_delta_zigzag_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                             const float* __restrict__ mn, const float* __restrict__ mx,
                             const float* __restrict__ inv, float max_q,
                             int32_t* __restrict__ out, float* __restrict__ rng_out, int n,
                             int vec) {
  __shared__ float s_inv, s_mn;
  const int c = gridDim.x, f = blockIdx.z;
  const int row = f * c + blockIdx.x;
  if (threadIdx.x == 0) {
    float scale;
    if (inv != nullptr) {
      scale = inv[f];
    } else {
      float rng = -INFINITY;
      for (int k = 0; k < c; ++k)
        rng = fmaxf(rng, __fsub_rn(mx[f * c + k], mn[f * c + k]));
      if (rng <= 0.0f) rng = 1.0f;
      scale = __fdiv_rn(max_q, rng);
      if (rng_out != nullptr && blockIdx.x == 0 && blockIdx.y == 0) rng_out[f] = rng;
    }
    s_inv = scale;
    s_mn = mn != nullptr ? mn[row] : 0.0f;
  }
  __syncthreads();
  const float scale = s_inv, lo = s_mn;  // without a minimum lo is 0, and x - 0 is x

  const int64_t row0 = (int64_t)row * n;
  const float* xr = x + row0;
  int32_t* outr = out + row0;
  const uint8_t* mr = mask != nullptr ? mask + (int64_t)f * n : nullptr;
  const int pad = vec ? (int)(row0 & 3) : 0;
  // first vertex of this thread's group of 4; below 0 or past n at the row's ends
  const int col0 = (blockIdx.y * kThreads + threadIdx.x) * kPerThread - pad;
  const bool whole = col0 >= 0 && col0 + kPerThread <= n;

  float v[kPerThread];
  bool ok[kPerThread];
  if (whole && vec) {
    const float4 t = *reinterpret_cast<const float4*>(xr + col0);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int col = col0 + j;
      v[j] = (col >= 0 && col < n) ? xr[col] : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int col = col0 + j;
    const bool in = col >= 0 && col < n;
    ok[j] = in && (mr == nullptr || mr[col] != 0);
  }
  int q[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)  // outside the row: not valid, q = 0 (vertex 0's left)
    q[j] = quantize(v[j], ok[j], lo, scale);

  // the left neighbour of the group's first vertex: the lane below's last q;
  // lane 0 of a warp recomputes it from memory
  int prev = __shfl_up_sync(kFullWarp, q[kPerThread - 1], 1);
  if ((threadIdx.x & 31) == 0) {
    const int col = col0 - 1;
    prev = 0;
    if (col >= 0 && col < n) {
      const bool valid = mr == nullptr || mr[col] != 0;
      prev = quantize(xr[col], valid, lo, scale);
    }
  }
  int32_t s[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    s[j] = zigzag(q[j] - prev);
    prev = q[j];
  }
  if (whole && vec) {
    *reinterpret_cast<int4*>(outr + col0) = make_int4(s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int col = col0 + j;
      if (col >= 0 && col < n) outr[col] = s[j];
    }
  }
}

}  // namespace

extern "C" {

// x: [f, c, n] float32; mask: [f, n] bytes; mn, mx: [f, c] float32.
int uvt_geometry_minmax(const void* x, const void* mask, void* mn, void* mx, int f, int c,
                        int n, void* stream) {
  if (f < 0 || f > kMaxGridYZ || c <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (f > 0)
    geometry_minmax_kernel<<<dim3((unsigned)c, (unsigned)f), kRedThreads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)x, (const uint8_t*)mask, (float*)mn, (float*)mx, n);
  return (int)cudaGetLastError();
}

// x: [f, c, n] float32; out: [f, c, n] int32. Either inv: [f] float32 (mask,
// mn, mx null: x is taken as the offsets), or mn, mx: [f, c] float32 with
// mask: [f, n] bytes or null and rng_out: [f] float32 or null; bits sets
// max_q = 2^bits - 1 for the second form.
int uvt_quantize_delta_zigzag(const void* x, const void* mask, const void* mn, const void* mx,
                              const void* inv, int bits, void* out, void* rng_out, int f,
                              int c, int n, void* stream) {
  // + 3: the largest shift of the groups of 4 against the row
  const int64_t tiles = ((int64_t)n + 3 + kTile - 1) / kTile;
  if (f < 0 || f > kMaxGridYZ || c <= 0 || n <= 0 || tiles > kMaxGridYZ ||
      (mn == nullptr) != (mx == nullptr) || (inv == nullptr) == (mn == nullptr) ||
      (inv == nullptr && (bits < 1 || bits > 30)))
    return (int)cudaErrorInvalidValue;
  if (f > 0) {
    const int vec = ((uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0) ? 1 : 0;
    const float max_q = inv == nullptr ? (float)((1 << bits) - 1) : 0.0f;
    quantize_delta_zigzag_kernel<<<dim3((unsigned)c, (unsigned)tiles, (unsigned)f), kThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const float*)x, (const uint8_t*)mask, (const float*)mn, (const float*)mx,
        (const float*)inv, max_q, (int32_t*)out, (float*)rng_out, n, vec);
  }
  return (int)cudaGetLastError();
}

int uvt_geometry_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {UVT_KERNEL(geometry_minmax_kernel),
                                 UVT_KERNEL(quantize_delta_zigzag_kernel)};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
