// The UASTC device fit (U1) for Hopper (sm_90a): every candidate mode of
// every 4x4 block fitted, quantized and scored, and each block's winner
// chosen, in one launch.
//
//   uastc_device_fit_kernel   replaces the XLA program of
//       uvol_tpu/codecs/basis/uastc.py, `_device_fit_fn` (not a Pallas site:
//       the reference leaves the fit to XLA as one jitted program over the
//       block batch) and the host's `errs.argmin(0)` after it. For each block
//       and each single-subset candidate mode (one plane, or CEM 12 with
//       alpha on a second plane): endpoints as the per-channel minimum and
//       maximum; each pixel's weight by projecting it onto the endpoint axis
//       and taking the nearest weight-table entry; endpoints quantized to
//       the mode's bits; the exact integer reconstruction and its mean
//       squared error. The winner is the first minimum of the error in the
//       caller's mode order; the kernel writes its index and its fields.
//
// Arithmetic: that of the plain twin (codecs/basis/uastc.py,
// `device_fit_plain`) and of what XLA compiles the reference into on the
// CPU. Every value is an integer below 2^24 held exactly, in int32 here
// (float32 there), except: t = num / denom, an IEEE division (__fdiv_rn);
// the endpoint scale, e * f32(scale / 255) then round half to even
// (rintf); and the error, the exact sum times f32(1 / 48) plus the exact
// alpha mean as one FMA for RGB modes (XLA contracts them), the sum times
// 1 / 64 for RGBA modes. The weight is the first minimum of
// |w64 - table[k]|. Built with -fmad=false: nothing else is contracted.
//
// What bounds it: operations (PERF.md section 6: ~1,500 a block for the
// default pair [0, 5] against 64 bytes in and 45 out). The first design, one
// thread a block, ran at 7% of that bound: it scanned up to 16 weight
// entries a pixel and mode, refitted the endpoints and redivided every
// pixel for every mode, needed 223 registers (8 warps an SM) and read a
// block as four 16-byte loads 64 bytes apart from its neighbour's. This
// design:
//
//   - four lanes a block, each one 16-byte load of 4 pixels, so a warp
//     reads 8 blocks, 512 contiguous bytes. The per-channel minimum and
//     maximum, the alpha term and each mode's error sum combine over the
//     quad by __shfl_xor_sync (integers: exact in any order); each lane
//     keeps its pixels' float work with the twin's roundings and stores its
//     4 weight bytes; lanes 0-3 store the winner, q0, q1 and the error;
//   - the fit's mode-independent work once a block: the endpoints, and
//     each pixel's w64 = clamp(t) * 64 once per plane layout the mode list
//     holds (RGB, RGBA, alpha): t depends only on the plane, and the twin
//     computes the same value for every mode;
//   - the nearest entry in closed form: every table is round(k * 64 /
//     (L - 1)), so c = floor(w64 * (L - 1) / 64) (at most L - 2) leaves
//     the nearest entry at c or c + 1, and c + 1 wins only on a strictly
//     smaller |w64 - table[k]|, as in the scan (weight_index_kernel exports
//     the function; chip_smoke.py holds it against the scan for every
//     float32 in [0, 64] on each table);
//   - the mode table (and each table's float32 copy) in shared memory,
//     each plane layout a template, and the w64 of each lane's pixels in
//     shared memory through the mode loop, the endpoints a byte each in
//     one word: 72 registers and no stack, 7 CTAs of 128 threads (28
//     warps) an SM. Capped at 64 registers (32 warps), the compiler spills
//     8 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "func_attrs.cuh"

namespace {

constexpr int kThreads = 128;  // 32 blocks a CTA
constexpr int kCtasPerSm = 7;  // at most 72 registers a thread: 28 warps an SM
constexpr int kLanes = 4;      // lanes a block, 4 pixels each
constexpr int kMaxModes = 16;
// one mode's row of the table: nc, dual, ep_bits, levels, scale (float
// bits), 1/(16 nc) (float bits), 2 unused, then the weight table
constexpr int kRow = 24;
constexpr int kTable = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int ch(uint32_t p, int c) { return (p >> (8 * c)) & 0xFF; }

__device__ __forceinline__ int expand(int q, int bits) {
  return bits == 8 ? q : (q << (8 - bits)) | (q >> (2 * bits - 8));
}

__device__ __forceinline__ int quad_min(int v) {
  v = min(v, __shfl_xor_sync(kFull, v, 1));
  return min(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ int quad_max(int v) {
  v = max(v, __shfl_xor_sync(kFull, v, 1));
  return max(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// The index of the first entry of least |w64 - table[k]| in a table of
// `levels` entries round(k * 64 / (levels - 1)) (tf: as float32), for w64
// in [0, 64]: c = floor(w64 * f), f = (levels - 1) / 64, at most
// levels - 2; the nearest entry is c or c + 1, and c + 1 only where it is
// strictly nearer.
__device__ __forceinline__ int nearest_weight(float w64, float f, int last, const float* tf) {
  const int c = min(__float2int_rz(__fmul_rn(w64, f)), last);
  const float d0 = fabsf(__fsub_rn(w64, tf[c]));
  const float d1 = fabsf(__fsub_rn(w64, tf[c + 1]));
  return d1 < d0 ? c + 1 : c;
}

// w64 = clamp(num / denom, 0, 1) * 64 of the lane's 4 pixels on the plane
// of channels C0 .. C0 + CN - 1 (t = 0.5 where the axis has length 0), to
// w[j * kThreads] for pixel j.
template <int C0, int CN>
__device__ __forceinline__ void plane_w64(const uint32_t (&p)[4], const int (&e0)[4],
                                          const int (&e1)[4], float* w) {
  int denom = 0;
#pragma unroll
  for (int c = C0; c < C0 + CN; ++c) denom += (e1[c] - e0[c]) * (e1[c] - e0[c]);
  const float den = (float)denom;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int num = 0;
#pragma unroll
    for (int c = C0; c < C0 + CN; ++c) num += (ch(p[j], c) - e0[c]) * (e1[c] - e0[c]);
    const float t = denom > 0 ? __fdiv_rn((float)num, den) : 0.5f;
    w[j * kThreads] = __fmul_rn(fminf(fmaxf(t, 0.0f), 1.0f), 64.0f);
  }
}

// One mode on the lane's 4 pixels: its quantized endpoints (a byte per
// channel), the lane's weight indices (a byte per pixel) on each plane, and
// the block's error (the same on the 4 lanes). e0, e1: the endpoints, a
// byte per channel; wm, wa: the w64 of the main plane and of the alpha
// plane (pixel j at [j * kThreads]); sa: the block's sum of
// (255 - alpha)^2.
template <int NC, bool DUAL>
__device__ __forceinline__ void eval_mode(const uint32_t (&p)[4], uint32_t e0, uint32_t e1,
                                          const float* wm, const float* wa, const int* row,
                                          const float* tf, int sa, uint32_t& q0p, uint32_t& q1p,
                                          uint32_t& im, uint32_t& ia, float& err) {
  const int levels = row[3];
  const float f = __fmul_rn((float)(levels - 1), 0.015625f);  // exact
  const int* table = row + kTable;
  im = ia = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    im |= (uint32_t)nearest_weight(wm[j * kThreads], f, levels - 2, tf) << (8 * j);
    if (DUAL) ia |= (uint32_t)nearest_weight(wa[j * kThreads], f, levels - 2, tf) << (8 * j);
  }
  const int bits = row[2];
  const int scale = (1 << bits) - 1;
  const float k = __int_as_float(row[4]);
  q0p = q1p = 0;
  int sq = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int q0 = (int)fminf(fmaxf(rintf(__fmul_rn((float)ch(e0, c), k)), 0.0f), (float)scale);
    const int q1 = (int)fminf(fmaxf(rintf(__fmul_rn((float)ch(e1, c), k)), 0.0f), (float)scale);
    q0p |= (uint32_t)q0 << (8 * c);
    q1p |= (uint32_t)q1 << (8 * c);
    const int x0 = expand(q0, bits), x1 = expand(q1, bits);
    const int c0 = (x0 << 8) | x0, c1 = (x1 << 8) | x1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int wv = table[((DUAL && c == 3 ? ia : im) >> (8 * j)) & 0xFF];
      const int d = (((c0 * (64 - wv) + c1 * wv + 32) >> 6) >> 8) - ch(p[j], c);
      sq += d * d;
    }
  }
  sq = quad_sum(sq);
  const float inv_n = __int_as_float(row[5]);
  err = NC == 3 ? __fmaf_rn((float)sq, inv_n, __fmul_rn((float)sa, 0.0625f))
                : __fmul_rn((float)sq, inv_n);
}

// Each block of px [nblocks, 16, 4] (as 16-byte words, 4 a block) on a
// quad of lanes. No lane returns before the shuffles: the lanes of a block
// past nblocks compute on zeros and store nothing.
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    uastc_device_fit_kernel(const uint4* __restrict__ px, const int* __restrict__ modes, int n,
                            int64_t nblocks, uint8_t* __restrict__ winner,
                            uint32_t* __restrict__ q0_out, uint32_t* __restrict__ q1_out,
                            uint32_t* __restrict__ wm_out, uint32_t* __restrict__ wa_out,
                            float* __restrict__ err_out) {
  __shared__ int s_modes[kMaxModes * kRow];
  __shared__ float s_tabf[kMaxModes * 16];
  // each thread's w64 on the RGB, RGBA and alpha planes, pixel j of plane P
  // at [(4 P + j) * kThreads + thread]: read once per mode, not held in
  // registers through the mode loop
  __shared__ float s_w64[3 * 4 * kThreads];
  for (int i = threadIdx.x; i < n * kRow; i += kThreads) s_modes[i] = modes[i];
  for (int i = threadIdx.x; i < n * 16; i += kThreads)
    s_tabf[i] = (float)modes[(i >> 4) * kRow + kTable + (i & 15)];
  __syncthreads();
  bool rgb = false, rgba = false, alpha = false, sa_needed = false;  // the layouts the modes use
  for (int i = 0; i < n; ++i) {
    const int* row = s_modes + i * kRow;
    rgb |= row[1] || row[0] == 3;
    rgba |= !row[1] && row[0] == 4;
    alpha |= row[1] != 0;
    sa_needed |= row[0] == 3;
  }
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;  // = 4 * block + lane
  const int64_t b = g / kLanes;
  const int lane = threadIdx.x & (kLanes - 1);
  const bool live = b < nblocks;
  const uint4 v = live ? px[g] : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t p[4] = {v.x, v.y, v.z, v.w};
  int e0[4], e1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int lo = ch(p[0], c), hi = lo;
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      lo = min(lo, ch(p[j], c));
      hi = max(hi, ch(p[j], c));
    }
    e0[c] = quad_min(lo);
    e1[c] = quad_max(hi);
  }
  float* const w_rgb = s_w64 + threadIdx.x;
  float* const w_rgba = w_rgb + 4 * kThreads;
  float* const w_a = w_rgba + 4 * kThreads;
  if (rgb) plane_w64<0, 3>(p, e0, e1, w_rgb);
  if (rgba) plane_w64<0, 4>(p, e0, e1, w_rgba);
  if (alpha) plane_w64<3, 1>(p, e0, e1, w_a);
  uint32_t e0p = 0, e1p = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    e0p |= (uint32_t)e0[c] << (8 * c);
    e1p |= (uint32_t)e1[c] << (8 * c);
  }
  int sa = 0;
  if (sa_needed) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sa += (255 - ch(p[j], 3)) * (255 - ch(p[j], 3));
    sa = quad_sum(sa);
  }
  int best_i = 0;
  uint32_t best_q0 = 0, best_q1 = 0, best_wm = 0, best_wa = 0;
  float best_err = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int* row = s_modes + i * kRow;
    const float* tf = s_tabf + i * 16;
    uint32_t q0, q1, im, ia;
    float err;
    if (row[1])
      eval_mode<4, true>(p, e0p, e1p, w_rgb, w_a, row, tf, sa, q0, q1, im, ia, err);
    else if (row[0] == 4)
      eval_mode<4, false>(p, e0p, e1p, w_rgba, w_rgba, row, tf, sa, q0, q1, im, ia, err);
    else
      eval_mode<3, false>(p, e0p, e1p, w_rgb, w_rgb, row, tf, sa, q0, q1, im, ia, err);
    if (i == 0 || err < best_err) {  // strict: the first minimum wins
      best_i = i;
      best_q0 = q0;
      best_q1 = q1;
      best_wm = im;
      best_wa = ia;
      best_err = err;
    }
  }
  if (!live) return;
  wm_out[g] = best_wm;  // the lane's 4 pixels: bytes 4 * lane .. of the block's 16
  wa_out[g] = best_wa;
  if (lane == 0) winner[b] = (uint8_t)best_i;
  if (lane == 1) q0_out[b] = best_q0;
  if (lane == 2) q1_out[b] = best_q1;
  if (lane == 3) err_out[b] = best_err;
}

// nearest_weight on every value of w64 [n] (each in [0, 64]) with the table
// of `levels` entries table [levels] int32: out [n] int32.
__global__ void weight_index_kernel(const float* __restrict__ w64, int64_t n, int levels,
                                    const int* __restrict__ table, int32_t* __restrict__ out) {
  __shared__ float s_tabf[16];
  if (threadIdx.x < 16)
    s_tabf[threadIdx.x] = (int)threadIdx.x < levels ? (float)table[threadIdx.x] : 0.f;
  __syncthreads();
  const float f = __fmul_rn((float)(levels - 1), 0.015625f);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = nearest_weight(w64[i], f, levels - 2, s_tabf);
}

}  // namespace

extern "C" {

// px: [nblocks, 16, 4] uint8, 16-byte aligned; modes: [n, 24] int32 on the
// device (the rows above); winner: [nblocks] uint8; q0, q1: [nblocks, 4]
// uint8 and wmain, walpha: [nblocks, 16] uint8, all 4-byte aligned; err:
// [nblocks] float32.
int uvt_uastc_device_fit(const void* px, const void* modes, int n, int64_t nblocks, void* winner,
                         void* q0, void* q1, void* wmain, void* walpha, void* err, void* stream) {
  if (n < 1 || n > kMaxModes || nblocks < 0 || ((uintptr_t)px & 15) || ((uintptr_t)q0 & 3) ||
      ((uintptr_t)q1 & 3) || ((uintptr_t)wmain & 3) || ((uintptr_t)walpha & 3))
    return (int)cudaErrorInvalidValue;
  const int64_t grid = (nblocks * kLanes + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (grid > 0)
    uastc_device_fit_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)px, (const int*)modes, n, nblocks, (uint8_t*)winner, (uint32_t*)q0,
        (uint32_t*)q1, (uint32_t*)wmain, (uint32_t*)walpha, (float*)err);
  return (int)cudaGetLastError();
}

// w64: [n] float32, each in [0, 64]; table: [levels] int32 on the device (2 <= levels <= 16,
// entries round(k * 64 / (levels - 1))); out: [n] int32, the index U1 takes for each.
int uvt_uastc_weight_index(const void* w64, int64_t n, int levels, const void* table, void* out,
                           void* stream) {
  if (n < 0 || levels < 2 || levels > 16) return (int)cudaErrorInvalidValue;
  const int64_t ctas = (n + 255) / 256;
  if (n > 0)
    weight_index_kernel<<<(unsigned)(ctas < 65536 ? ctas : 65536), 256, 0,
                          (cudaStream_t)stream>>>((const float*)w64, n, levels,
                                                  (const int*)table, (int32_t*)out);
  return (int)cudaGetLastError();
}

int uvt_uastc_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {UVT_KERNEL(uastc_device_fit_kernel),
                                 UVT_KERNEL(weight_index_kernel)};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
