// ETC1S palette-build kernels K4, K5 and K6 for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of uvol_tpu/codecs/basis/etc1s_pallas.py:
//   K4  `_assign_kernel` (assign_endpoints_pallas): per block, the exact
//       clip-aware error against every endpoint, argmin over endpoints;
//   K5  `_inten_kernel` (inten_errors_pallas): per block, the error of its
//       base color under each of the 8 intensity tables;
//   K6  the k-means `_kernel` (kmeans_iter_pallas): one fused Lloyd step,
//       nearest centroid plus per-cluster sums and counts.
// K4 and K5 read the [N, 16, 3] uint8 blocks of the segment upload
// directly; the TPU's [N*16, 3] rows, [48, N] lane-major relayout and
// 128-lane endpoint padding have no counterpart here.
//
// K4 and K5 are exact integer arithmetic, as the TPU kernels are by
// construction (every f32 term there is an integer below 2^24): int32
// throughout, argmin ties to the first minimum with a strict `<`.
//
// K4 -- one thread per block, 48 pixel values in registers. The endpoint
// table ([E, 20] int32: per code j the row (-2*me_r, -2*me_g, -2*me_b, q),
// then (-2*base_r, -2*base_g, -2*base_b, 16*|base|^2)) is staged through
// shared memory in chunks of kEpChunk endpoints, so any E fits; every
// thread of a warp reads the same entry (a broadcast). ~450 integer ops
// per (block, endpoint): ~37 G ops for 327,680 blocks x 256 endpoints,
// bound by integer ALU work.
//
// K5 -- one thread per block, the 8x4 modifier table in __constant__.
// ~4k integer ops per block; ALU-bound as K4, at 1/60 of its work.
//
// K6 -- f32, mirroring the TPU kernel's op order: dist = c2[k], then
// + f[j] * (-2*cb[k,j]) for j = 0..3, each step rounded (__fadd_rn /
// __fmul_rn; the library is built with -fmad=false as well), first-minimum
// argmin. The per-cluster sums are DETERMINISTIC (no float atomics) in
// one fixed order, the order of `segment_sum` in codecs/basis/etc1s_cuda.py:
// rows in order within consecutive tiles of kSegTile rows (from 0.0),
// then tiles added pairwise, level by level (adjacent pairs; an odd last
// tile is added to 0.0). Counts are sums of 1.0 in that order, exact
// below 2^24. One thread per row for the assignment (centroids in shared
// memory, K <= kKmMaxK); per tile, one thread per cluster scans the tile's
// rows. The tile partials cost a [ceil(N/64), K, 5] f32 scratch buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// uvol_tpu.codecs.basis.transcoder.INTEN_TABLES, code order
__constant__ int kInten[8][4] = {
    {-8, -2, 2, 8},       {-17, -5, 5, 17},     {-29, -9, 9, 29},
    {-42, -13, 13, 42},   {-60, -18, 18, 60},   {-80, -24, 24, 80},
    {-106, -33, 33, 106}, {-183, -47, 47, 183},
};

constexpr int kThreads = 256;
constexpr int kEpChunk = 256;   // endpoints per shared-memory chunk: 20 KB
constexpr int kSegTile = 64;    // rows per fixed-order partial sum
constexpr int kKmMaxK = 2048;   // centroids held in shared memory: 40 KB
constexpr int kKmDim = 4;       // feature width
constexpr int kKmCols = kKmDim + 1;  // features ++ 1.0 (the count)

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// ---- K5 ---------------------------------------------------------------

__global__ void inten_errors_kernel(const uint8_t* __restrict__ blocks,
                                    const int32_t* __restrict__ base,
                                    int32_t* __restrict__ out, int n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int b[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) b[c] = base[i * 3 + c];
  int d[16][3];
  const uint8_t* px = blocks + i * 48;
#pragma unroll
  for (int p = 0; p < 16; ++p)
#pragma unroll
    for (int c = 0; c < 3; ++c) d[p][c] = (int)px[p * 3 + c] - b[c];
#pragma unroll 1
  for (int t = 0; t < 8; ++t) {
    int me[4][3], me2[4];
#pragma unroll
    for (int code = 0; code < 4; ++code) {
      me2[code] = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        me[code][c] = clamp255(b[c] + kInten[t][code]) - b[c];
        me2[code] += me[code][c] * me[code][c];
      }
    }
    int acc = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      int best = 0;
#pragma unroll
      for (int code = 0; code < 4; ++code) {
        const int cand =
            me2[code] - 2 * (d[p][0] * me[code][0] + d[p][1] * me[code][1] +
                             d[p][2] * me[code][2]);
        best = code == 0 ? cand : min(best, cand);
      }
      acc += best;
    }
    out[i * 8 + t] = acc;
  }
}

// ---- K4 ---------------------------------------------------------------

__global__ void assign_endpoints_kernel(const uint8_t* __restrict__ blocks,
                                        const int4* __restrict__ table,
                                        int32_t* __restrict__ out, int n, int e) {
  __shared__ int4 s_tab[kEpChunk * 5];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  int px[16][3];
  int ps[3] = {0, 0, 0};
  if (live) {
    const uint8_t* src = blocks + i * 48;
#pragma unroll
    for (int p = 0; p < 16; ++p)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        px[p][c] = src[p * 3 + c];
        ps[c] += px[p][c];
      }
  }
  int best = 0x7fffffff, best_e = 0;
  for (int e0 = 0; e0 < e; e0 += kEpChunk) {
    const int cnt = min(kEpChunk, e - e0);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < cnt * 5; k += blockDim.x)
      s_tab[k] = table[(int64_t)e0 * 5 + k];
    __syncthreads();
    if (!live) continue;
#pragma unroll 1
    for (int k = 0; k < cnt; ++k) {
      const int4 m0 = s_tab[k * 5 + 0], m1 = s_tab[k * 5 + 1];
      const int4 m2 = s_tab[k * 5 + 2], m3 = s_tab[k * 5 + 3];
      const int4 bt = s_tab[k * 5 + 4];
      int err = bt.w + ps[0] * bt.x + ps[1] * bt.y + ps[2] * bt.z;
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const int r = px[p][0], g = px[p][1], bl = px[p][2];
        int c = m0.w + r * m0.x + g * m0.y + bl * m0.z;
        c = min(c, m1.w + r * m1.x + g * m1.y + bl * m1.z);
        c = min(c, m2.w + r * m2.x + g * m2.y + bl * m2.z);
        c = min(c, m3.w + r * m3.x + g * m3.y + bl * m3.z);
        err += c;
      }
      if (err < best) {  // strict: the first minimum wins
        best = err;
        best_e = e0 + k;
      }
    }
  }
  if (live) out[i] = best_e;
}

// ---- K6 ---------------------------------------------------------------

// cent: [5, k] rows -2*cb[:, 0..3] and c2. part: [ceil(n/kSegTile), k, 5].
__global__ void kmeans_tile_kernel(const float* __restrict__ feats,
                                   const float* __restrict__ cent, int n, int k,
                                   float* __restrict__ part,
                                   int32_t* __restrict__ assign) {
  __shared__ float s_c[kKmCols][kKmMaxK];
  __shared__ float s_f[kThreads][kKmCols];
  __shared__ int s_a[kThreads];
  for (int j = threadIdx.x; j < kKmCols * k; j += blockDim.x)
    s_c[j / k][j % k] = cent[j];
  __syncthreads();

  const int tid = threadIdx.x;
  const int64_t row = (int64_t)blockIdx.x * kThreads + tid;
  int bi = -1;
  float f[kKmDim] = {0.f, 0.f, 0.f, 0.f};
  if (row < n) {
#pragma unroll
    for (int j = 0; j < kKmDim; ++j) f[j] = feats[row * kKmDim + j];
    float best = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      float d = s_c[kKmDim][kk];
#pragma unroll
      for (int j = 0; j < kKmDim; ++j) d = __fadd_rn(d, __fmul_rn(f[j], s_c[j][kk]));
      if (kk == 0 || d < best) {  // strict: the first minimum wins
        best = d;
        bi = kk;
      }
    }
    assign[row] = bi;
  }
  s_a[tid] = bi;
#pragma unroll
  for (int j = 0; j < kKmDim; ++j) s_f[tid][j] = f[j];
  s_f[tid][kKmDim] = 1.f;
  __syncthreads();

  // this thread's tile of kSegTile rows, and its lane within it
  const int q = tid / kSegTile, lane = tid % kSegTile;
  const int64_t tile = (int64_t)blockIdx.x * (kThreads / kSegTile) + q;
  if (tile * kSegTile >= n) return;
  const int r0 = q * kSegTile;
  for (int kk = lane; kk < k; kk += kSegTile) {
    float acc[kKmCols] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < kSegTile; ++r) {
      if (s_a[r0 + r] != kk) continue;
#pragma unroll
      for (int j = 0; j < kKmCols; ++j) acc[j] = __fadd_rn(acc[j], s_f[r0 + r][j]);
    }
    float* dst = part + (tile * k + kk) * kKmCols;
#pragma unroll
    for (int j = 0; j < kKmCols; ++j) dst[j] = acc[j];
  }
}

// One level of the pairwise tile sum: out[t] = in[2t] + in[2t+1] (0.0 past
// the last of the m input tiles), each tile `width` floats.
__global__ void pair_sum_kernel(const float* __restrict__ in, float* __restrict__ out,
                                int m, int64_t width) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t half = (m + 1) / 2;
  if (i >= half * width) return;
  const int64_t t = i / width, w = i % width;
  const float a = in[2 * t * width + w];
  const float b = 2 * t + 1 < m ? in[(2 * t + 1) * width + w] : 0.f;
  out[i] = __fadd_rn(a, b);
}

unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// blocks: [n, 16, 3] uint8; base: [n, 3] int32; out: [n, 8] int32.
int uvt_etc1s_inten_errors(const void* blocks, const void* base, void* out, int n,
                           void* stream) {
  if (n > 0)
    inten_errors_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int32_t*)base, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// blocks: [n, 16, 3] uint8; table: [e, 20] int32 (16-byte aligned); out: [n] int32.
int uvt_etc1s_assign_endpoints(const void* blocks, const void* table, void* out, int n,
                               int e, void* stream) {
  if (n > 0 && e > 0)
    assign_endpoints_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int4*)table, (int32_t*)out, n, e);
  return (int)cudaGetLastError();
}

// feats: [n, 4] f32; cent: [5, k] f32 (k <= 2048); part, part2: scratch of
// ceil(n/64) * k * 5 f32 each; sums: [k, 5] f32 (features ++ count);
// assign: [n] int32.
int uvt_etc1s_kmeans_iter(const void* feats, const void* cent, int n, int k, void* part,
                          void* part2, void* sums, void* assign, void* stream) {
  if (n <= 0 || k <= 0 || k > kKmMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  kmeans_tile_kernel<<<grid_for(n), kThreads, 0, s>>>(
      (const float*)feats, (const float*)cent, n, k, (float*)part, (int32_t*)assign);
  const int64_t width = (int64_t)k * kKmCols;
  int m = (n + kSegTile - 1) / kSegTile;
  if (m == 1) {
    cudaMemcpyAsync(sums, part, width * sizeof(float), cudaMemcpyDeviceToDevice, s);
    return (int)cudaGetLastError();
  }
  float* src = (float*)part;
  float* dst = (float*)part2;
  while (m > 1) {
    const int next = (m + 1) / 2;
    float* o = next == 1 ? (float*)sums : dst;
    pair_sum_kernel<<<grid_for(next * width), kThreads, 0, s>>>(src, o, m, width);
    src = o;
    dst = src == (float*)part ? (float*)part2 : (float*)part;
    m = next;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
