// The mesh and point-cloud ops' device programs for Hopper (sm_90a). The
// reference leaves each of them to XLA (no Pallas site); they are written by
// hand here so that the port's ops run on the card with the reference's
// exact arithmetic and order:
//
//   estimate_normals_kernel      U3, uvol_tpu/ops/normals.py:66-84
//       (`estimate_normals`): per face cross(p1 - p0, p2 - p0), zero for a
//       row whose first index is negative, added onto its three corners,
//       then each vertex's sum normalised (a zero norm divides by 1).
//   morton_keys_kernel           U4, uvol_tpu/models/pointcloud.py:31-35:
//       the quantize of uvol_tpu/ops/quantize.py:58-79 with the frame's
//       minimum and 1 / delta given, then the 63-bit Morton key of
//       uvol_tpu/ops/morton.py:40-63 as one int64, top << 60 | mid << 30 |
//       lo, which orders as the reference's 3-key sort compares (top, mid,
//       lo). The sort itself stays torch.sort(stable=True).
//   parallelogram_decode_kernel  U5, uvol_tpu/ops/prediction.py:56-90
//       (`parallelogram_decode`, a lax.scan over vertices).
//
// U3. The reference adds the face normals with three scatters, one per
// corner k, each over the faces in order; XLA runs them one after another
// on the CPU, so a vertex's sum is 0.0 + n_0 + n_1 + ... over its corners
// in (k, face) order. Atomics keep no order, so the wrapper builds a CSR of
// the corners: one stable sort of the flat corner list (entry k * M + face)
// by vertex gives each vertex its faces in that order. One thread per
// vertex walks its row, computes each face's normal from the face's three
// indices (each face three times, once per corner: no face-normal buffer)
// and adds it. An index >= N is clamped for the gathers and its corner is
// dropped from the sum, as XLA's gather and scatter do. Float rules, from
// what XLA compiles the reference into on the CPU: the differences are
// rounded, each cross component is one FMA, fma(a_i, b_j, -(a_j * b_i)),
// with the second product rounded; the norm's squares are x * x, then
// fma(y, y, .), fma(z, z, .), and its sqrt and the divisions are IEEE.
// Bound: bytes (the positions and faces read once, the normals written);
// the CSR's sort and offsets are PyTorch calls of the wrapper, not counted.
//
// U4. One thread per point: three 4-byte loads, (x - min) * inv + 0.5
// rounded at each step (what the port's ops/quantize.quantize computes,
// no FMA), floor, clamp to [0, 2^bits - 1], then the interleave, and one
// 8-byte store. Bound: bytes (12 in, 8 out per point).
//
// U5. Each component of each frame is an independent chain: out[i][d]
// depends only on column d. One CTA takes one (frame, component) chain
// (blockIdx.x = frame * D + component, so any frame count fits the grid) and
// keeps the chain's whole prefix in shared memory (N int32, zero-filled, so
// a read of out[k] with k >= i reads 0 as the scan's zero-filled carry
// does) while N is at most kChainMaxVertices; a longer chain keeps its
// prefix in its own output column in device memory, zero-filled by the CTA
// first, and thread 0 reads and writes it there (each step then waits for
// L2 instead of shared memory). Tiles of 1,024 steps are staged: every
// thread loads the tile's
// residuals and index triples into shared memory, thread 0 runs the tile's
// steps, every thread stores the tile's outputs. Indices: a < 0 predicts
// from the previous output (0 at i = 0), b and c below 0 read out[0], and
// every index >= N is clamped to N - 1, as XLA's gather clamps. Sums wrap
// in uint32 (int32 overflow is undefined in C++). Bound: the dependent
// chain, not bytes: each step waits for a shared load whose address came
// from a shared load, and the next step may read what this one stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "func_attrs.cuh"

namespace {

constexpr int kThreads = 256;        // U3 and U4: threads per CTA
constexpr int kMaxGridY = 65535;     // U4: frames of one launch (more go in slices)
constexpr int kChainThreads = 128;   // U5: threads per CTA (one chain)
constexpr int kChainTile = 1024;     // U5: steps staged per tile
constexpr int kMaxSharedBytes = 232448;  // what one CTA may take on sm_90
constexpr int kChainMaxVertices = (kMaxSharedBytes - kChainTile * 16) / 4;
constexpr int kChainsPerLaunch = 1 << 30;  // U5: gridDim.x of one launch, at most

// ---------------------------------------------------------------------------
// U3: area-weighted vertex normals in the reference's sum order
// ---------------------------------------------------------------------------

// pos: [n, 3] float32; faces: [m, 3] int32; row: [n + 1] int32 offsets into
// face_of: [row[n]] int32, each vertex's faces in (corner, face) order;
// out: [n, 3] float32.
__global__ void __launch_bounds__(kThreads)
    estimate_normals_kernel(const float* __restrict__ pos, const int32_t* __restrict__ faces,
                            const int32_t* __restrict__ row, const int32_t* __restrict__ face_of,
                            float* __restrict__ out, int n) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const int last = n - 1;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  const int end = row[v + 1];
  for (int e = row[v]; e < end; ++e) {
    const int32_t* f = faces + 3 * (int64_t)face_of[e];
    const int i0 = f[0], i1 = f[1], i2 = f[2];
    const float valid = i0 >= 0 ? 1.0f : 0.0f;
    const float* p0 = pos + 3 * (int64_t)min(max(i0, 0), last);
    const float* p1 = pos + 3 * (int64_t)min(max(i1, 0), last);
    const float* p2 = pos + 3 * (int64_t)min(max(i2, 0), last);
    const float ax = __fsub_rn(p1[0], p0[0]), ay = __fsub_rn(p1[1], p0[1]),
                az = __fsub_rn(p1[2], p0[2]);
    const float bx = __fsub_rn(p2[0], p0[0]), by = __fsub_rn(p2[1], p0[1]),
                bz = __fsub_rn(p2[2], p0[2]);
    const float cx = __fmaf_rn(ay, bz, -__fmul_rn(az, by));
    const float cy = __fmaf_rn(az, bx, -__fmul_rn(ax, bz));
    const float cz = __fmaf_rn(ax, by, -__fmul_rn(ay, bx));
    sx = __fadd_rn(sx, __fmul_rn(cx, valid));
    sy = __fadd_rn(sy, __fmul_rn(cy, valid));
    sz = __fadd_rn(sz, __fmul_rn(cz, valid));
  }
  const float ss = __fmaf_rn(sz, sz, __fmaf_rn(sy, sy, __fmul_rn(sx, sx)));
  const float norm = __fsqrt_rn(ss);
  const float d = norm > 0.0f ? norm : 1.0f;  // NaN > 0 is false: NaN stays
  float* o = out + 3 * (int64_t)v;
  o[0] = __fdiv_rn(sx, d);
  o[1] = __fdiv_rn(sy, d);
  o[2] = __fdiv_rn(sz, d);
}

// ---------------------------------------------------------------------------
// U4: quantize and the 63-bit Morton key
// ---------------------------------------------------------------------------

// The low 10 bits of x spread to every third bit (morton.py `_part1by2_10`).
__device__ __forceinline__ uint32_t part1by2_10(uint32_t x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

__device__ __forceinline__ uint32_t morton30(uint32_t qx, uint32_t qy, uint32_t qz) {
  return part1by2_10(qx) | (part1by2_10(qy) << 1) | (part1by2_10(qz) << 2);
}

// x: [f, n, 3] float32; mn: [f, 3]; inv: [f]; key: [f, n] int64. blockIdx.y
// is the frame.
__global__ void __launch_bounds__(kThreads)
    morton_keys_kernel(const float* __restrict__ x, const float* __restrict__ mn,
                       const float* __restrict__ inv, float max_q, int64_t* __restrict__ key,
                       int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t frame = blockIdx.y;
  const int64_t p = frame * n + i;
  const float s = inv[frame];
  uint32_t q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t = __fadd_rn(__fmul_rn(__fsub_rn(x[3 * p + c], mn[3 * frame + c]), s), 0.5f);
    q[c] = (uint32_t)fminf(fmaxf(floorf(t), 0.0f), max_q);
  }
  const uint32_t lo = morton30(q[0], q[1], q[2]);
  const uint32_t mid = morton30(q[0] >> 10, q[1] >> 10, q[2] >> 10);
  const uint32_t top = ((q[2] >> 20) & 1u) << 2 | ((q[1] >> 20) & 1u) << 1 | ((q[0] >> 20) & 1u);
  key[p] = (int64_t)((uint64_t)top << 60 | (uint64_t)mid << 30 | (uint64_t)lo);
}

// ---------------------------------------------------------------------------
// U5: the parallelogram decode's sequential chain
// ---------------------------------------------------------------------------

// res: [f, n, d] int32; idx: [f, n, 3] int32; out: [f, n, d] int32.
// Chain chain0 + blockIdx.x is (frame, component) = divmod(chain, d).
// Dynamic shared memory: n (kShared only) + 4 * kChainTile words.
template <bool kShared>
__global__ void __launch_bounds__(kChainThreads)
    parallelogram_decode_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ idx,
                                int32_t* __restrict__ out, int n, int d, int64_t chain0) {
  extern __shared__ uint32_t smem[];
  const int64_t chain = chain0 + blockIdx.x, frame = chain / d, comp = chain % d;
  const int32_t* r = res + frame * n * d + comp;
  const int32_t* ix = idx + frame * n * 3;
  int32_t* o = out + frame * n * d + comp;
  uint32_t* prefix = kShared ? smem : (uint32_t*)o;  // kShared: stride 1, else d
  const int64_t stride = kShared ? 1 : d;
  int32_t* ta = (int32_t*)(smem + (kShared ? n : 0));
  int32_t* tb = ta + kChainTile;
  int32_t* tc = tb + kChainTile;
  uint32_t* tr = (uint32_t*)(tc + kChainTile);
  for (int i = threadIdx.x; i < n; i += kChainThreads) prefix[i * stride] = 0u;
  const int last = n - 1;
  uint32_t prev = 0u;  // the scan's carry: only thread 0 uses it
  for (int t0 = 0; t0 < n; t0 += kChainTile) {
    const int len = min(kChainTile, n - t0);
    for (int j = threadIdx.x; j < len; j += kChainThreads) {
      const int64_t i = t0 + j;
      ta[j] = ix[3 * i];
      tb[j] = ix[3 * i + 1];
      tc[j] = ix[3 * i + 2];
      tr[j] = (uint32_t)r[i * d];
    }
    __syncthreads();  // the tile is staged (and, at the first, the prefix zeroed)
    if (threadIdx.x == 0) {
      for (int j = 0; j < len; ++j) {
        const int a = ta[j];
        uint32_t pred = prev;
        if (a >= 0) {
          const int b = max(tb[j], 0), c = max(tc[j], 0);
          pred = prefix[min(a, last) * stride] + prefix[min(b, last) * stride] -
                 prefix[min(c, last) * stride];
        }
        prev = tr[j] + pred;
        prefix[(t0 + j) * stride] = prev;
      }
    }
    __syncthreads();  // the tile's outputs are in the prefix
    if (kShared)
      for (int j = threadIdx.x; j < len; j += kChainThreads)
        o[(int64_t)(t0 + j) * d] = (int32_t)prefix[t0 + j];
    __syncthreads();  // the tile's arrays are free for the next tile
  }
}

}  // namespace

extern "C" {

// pos: [n, 3] float32; faces: [m, 3] int32; row: [n + 1] int32; face_of:
// [row[n]] int32; out: [n, 3] float32.
int uvt_estimate_normals(const void* pos, const void* faces, const void* row,
                         const void* face_of, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  estimate_normals_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)pos, (const int32_t*)faces, (const int32_t*)row, (const int32_t*)face_of,
      (float*)out, n);
  return (int)cudaGetLastError();
}

// x: [f, n, 3] float32; mn: [f, 3] float32; inv: [f] float32; key: [f, n]
// int64; bits in 1..21. One launch per kMaxGridY frames.
int uvt_morton_keys(const void* x, const void* mn, const void* inv, int bits, void* key, int f,
                    int n, void* stream) {
  if (f <= 0 || n <= 0 || bits < 1 || bits > 21) return (int)cudaErrorInvalidValue;
  for (int f0 = 0; f0 < f; f0 += kMaxGridY) {
    const int64_t p0 = (int64_t)f0 * n;
    morton_keys_kernel<<<dim3((unsigned)((n + kThreads - 1) / kThreads),
                              (unsigned)min(kMaxGridY, f - f0)),
                         kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x + 3 * p0, (const float*)mn + 3 * (int64_t)f0, (const float*)inv + f0,
        (float)((1 << bits) - 1), (int64_t*)key + p0, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// res: [f, n, d] int32; idx: [f, n, 3] int32; out: [f, n, d] int32; one CTA
// per chain (f * d of them), a launch per kChainsPerLaunch. The prefix lives
// in shared memory up to kChainMaxVertices, in `out` above.
int uvt_parallelogram_decode(const void* res, const void* idx, void* out, int f, int n, int d,
                             void* stream) {
  if (f <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const bool shared = n <= kChainMaxVertices;
  const int bytes = ((shared ? n : 0) + 4 * kChainTile) * 4;
  const void* kernel = shared ? (const void*)parallelogram_decode_kernel<true>
                              : (const void*)parallelogram_decode_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t chains = (int64_t)f * d;
  for (int64_t c0 = 0; c0 < chains; c0 += kChainsPerLaunch) {
    const unsigned grid = (unsigned)min((int64_t)kChainsPerLaunch, chains - c0);
    if (shared)
      parallelogram_decode_kernel<true><<<grid, kChainThreads, bytes, (cudaStream_t)stream>>>(
          (const int32_t*)res, (const int32_t*)idx, (int32_t*)out, n, d, c0);
    else
      parallelogram_decode_kernel<false><<<grid, kChainThreads, bytes, (cudaStream_t)stream>>>(
          (const int32_t*)res, (const int32_t*)idx, (int32_t*)out, n, d, c0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

int uvt_mesh_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {UVT_KERNEL(estimate_normals_kernel),
                                 UVT_KERNEL(morton_keys_kernel),
                                 KernelRef{(const void*)parallelogram_decode_kernel<true>,
                                           "parallelogram_decode_kernel"},
                                 KernelRef{(const void*)parallelogram_decode_kernel<false>,
                                           "parallelogram_decode_kernel_global"}};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
