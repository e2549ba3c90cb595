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
// 1 / 64 for RGBA modes. The weight search keeps the first minimum of
// |w64 - table[k]| with strict `<`. Built with -fmad=false: nothing else
// is contracted.
//
// Design. One thread per block, 128 a CTA. A block's 64 bytes are four
// 16-byte loads into 16 registers (one RGBA pixel each); the mode table
// (per mode: channels, dual plane, endpoint bits, weight levels, the scale
// and the mean's reciprocal as float bits, and the 16-entry weight table)
// is staged in shared memory, where every lane of a warp reads the same
// word. Each channel count and plane layout is a template, so every loop
// over pixels and channels unrolls and no register array is indexed by a
// runtime value; weight indices live packed 4 bits each in a 64-bit word.
// The winner's fields leave as one byte each: the mode index, q0 and q1
// (4 bytes, one 4-byte store each) and both weight planes (16 bytes, one
// 16-byte store each), and the error as a float.
//
// Bound: operations. The function needs ~750 per block and RGB mode
// (chip_smoke.py, `uastc_fit_ops`: the nearest weight entry in closed
// form, every table being round(k * 64 / (L - 1))) against 64 bytes in and
// 45 out. This kernel scans the table instead, up to 16 entries a pixel:
// the first lever of a redesign. PERF.md section 6 has the measured times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "func_attrs.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxModes = 16;
// one mode's row of the table: nc, dual, ep_bits, levels, scale (float
// bits), 1/(16 nc) (float bits), 2 unused, then the weight table
constexpr int kRow = 24;
constexpr int kTable = 8;

__device__ __forceinline__ int ch(uint32_t p, int c) { return (p >> (8 * c)) & 0xFF; }

__device__ __forceinline__ int expand(int q, int bits) {
  return bits == 8 ? q : (q << (8 - bits)) | (q >> (2 * bits - 8));
}

// Plane fit over channels C0 .. C0 + CN - 1: endpoints into e0/e1, the
// weight indices packed 4 bits a pixel into w.
template <int C0, int CN>
__device__ __forceinline__ void fit_plane(const uint32_t (&p)[16], const int* row, int (&e0)[4],
                                          int (&e1)[4], uint64_t& w) {
#pragma unroll
  for (int c = C0; c < C0 + CN; ++c) {
    int lo = 255, hi = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      lo = min(lo, ch(p[j], c));
      hi = max(hi, ch(p[j], c));
    }
    e0[c] = lo;
    e1[c] = hi;
  }
  int denom = 0;
#pragma unroll
  for (int c = C0; c < C0 + CN; ++c) denom += (e1[c] - e0[c]) * (e1[c] - e0[c]);
  const float den = (float)denom;
  const int levels = row[3];
  const int* table = row + kTable;
  w = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int num = 0;
#pragma unroll
    for (int c = C0; c < C0 + CN; ++c) num += (ch(p[j], c) - e0[c]) * (e1[c] - e0[c]);
    const float t = denom > 0 ? __fdiv_rn((float)num, den) : 0.5f;
    const float w64 = __fmul_rn(fminf(fmaxf(t, 0.0f), 1.0f), 64.0f);
    int best = 0;
    float bd = fabsf(__fsub_rn(w64, (float)table[0]));
    for (int k = 1; k < levels; ++k) {
      const float dk = fabsf(__fsub_rn(w64, (float)table[k]));
      if (dk < bd) {
        bd = dk;
        best = k;
      }
    }
    w |= (uint64_t)best << (4 * j);
  }
}

// Sum over the pixels of channel c's squared reconstruction error, with
// the weight indices w.
__device__ __forceinline__ int channel_sq(const uint32_t (&p)[16], const int* table, uint64_t w,
                                          int c, int c0, int c1) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int wv = table[(w >> (4 * j)) & 0xF];
    const int rec = ((c0 * (64 - wv) + c1 * wv + 32) >> 6) >> 8;
    const int d = rec - ch(p[j], c);
    s += d * d;
  }
  return s;
}

// One mode: its quantized endpoints (a byte per channel), weight planes and
// error.
template <int NC, bool DUAL>
__device__ __forceinline__ void eval_mode(const uint32_t (&p)[16], const int* row, uint32_t& q0p,
                                          uint32_t& q1p, uint64_t& wm, uint64_t& wa, float& err) {
  int e0[4], e1[4];
  if (DUAL) {
    fit_plane<0, 3>(p, row, e0, e1, wm);
    fit_plane<3, 1>(p, row, e0, e1, wa);
  } else {
    fit_plane<0, NC>(p, row, e0, e1, wm);
    wa = 0;
  }
  const int bits = row[2];
  const int scale = (1 << bits) - 1;
  const float k = __int_as_float(row[4]);
  const int* table = row + kTable;
  q0p = q1p = 0;
  int sq = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int q0 = (int)fminf(fmaxf(rintf(__fmul_rn((float)e0[c], k)), 0.0f), (float)scale);
    const int q1 = (int)fminf(fmaxf(rintf(__fmul_rn((float)e1[c], k)), 0.0f), (float)scale);
    q0p |= (uint32_t)q0 << (8 * c);
    q1p |= (uint32_t)q1 << (8 * c);
    const int x0 = expand(q0, bits), x1 = expand(q1, bits);
    sq += channel_sq(p, table, DUAL && c == 3 ? wa : wm, c, (x0 << 8) | x0, (x1 << 8) | x1);
  }
  const float inv_n = __int_as_float(row[5]);
  if (NC == 3) {
    int sa = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) sa += (255 - ch(p[j], 3)) * (255 - ch(p[j], 3));
    err = __fmaf_rn((float)sq, inv_n, __fmul_rn((float)sa, 0.0625f));
  } else {
    err = __fmul_rn((float)sq, inv_n);
  }
}

// The 16 nibbles of w as 16 bytes.
__device__ __forceinline__ uint4 nibbles_to_bytes(uint64_t w) {
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = (uint32_t)(w >> (16 * i));
    o[i] = (x & 0xF) | ((x >> 4) & 0xF) << 8 | ((x >> 8) & 0xF) << 16 | ((x >> 12) & 0xF) << 24;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(kThreads)
    uastc_device_fit_kernel(const uint4* __restrict__ px, const int* __restrict__ modes, int n,
                            int64_t nblocks, uint8_t* __restrict__ winner,
                            uint32_t* __restrict__ q0_out, uint32_t* __restrict__ q1_out,
                            uint4* __restrict__ wm_out, uint4* __restrict__ wa_out,
                            float* __restrict__ err_out) {
  __shared__ int s_modes[kMaxModes * kRow];
  for (int i = threadIdx.x; i < n * kRow; i += kThreads) s_modes[i] = modes[i];
  __syncthreads();
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= nblocks) return;
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 v = px[4 * b + i];
    p[4 * i] = v.x;
    p[4 * i + 1] = v.y;
    p[4 * i + 2] = v.z;
    p[4 * i + 3] = v.w;
  }
  int best_i = 0;
  uint32_t best_q0 = 0, best_q1 = 0;
  uint64_t best_wm = 0, best_wa = 0;
  float best_err = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int* row = s_modes + i * kRow;
    uint32_t q0, q1;
    uint64_t wm, wa;
    float err;
    if (row[1])
      eval_mode<4, true>(p, row, q0, q1, wm, wa, err);
    else if (row[0] == 4)
      eval_mode<4, false>(p, row, q0, q1, wm, wa, err);
    else
      eval_mode<3, false>(p, row, q0, q1, wm, wa, err);
    if (i == 0 || err < best_err) {
      best_i = i;
      best_q0 = q0;
      best_q1 = q1;
      best_wm = wm;
      best_wa = wa;
      best_err = err;
    }
  }
  winner[b] = (uint8_t)best_i;
  q0_out[b] = best_q0;
  q1_out[b] = best_q1;
  wm_out[b] = nibbles_to_bytes(best_wm);
  wa_out[b] = nibbles_to_bytes(best_wa);
  err_out[b] = best_err;
}

}  // namespace

extern "C" {

// px: [nblocks, 16, 4] uint8, 16-byte aligned; modes: [n, 24] int32 on the
// device (the rows above); winner: [nblocks] uint8; q0, q1: [nblocks, 4]
// uint8 and wmain, walpha: [nblocks, 16] uint8, all 16-byte aligned; err:
// [nblocks] float32.
int uvt_uastc_device_fit(const void* px, const void* modes, int n, int64_t nblocks, void* winner,
                         void* q0, void* q1, void* wmain, void* walpha, void* err, void* stream) {
  if (n < 1 || n > kMaxModes || nblocks < 0 || ((uintptr_t)px & 15) || ((uintptr_t)q0 & 3) ||
      ((uintptr_t)q1 & 3) || ((uintptr_t)wmain & 15) || ((uintptr_t)walpha & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t grid = (nblocks + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (grid > 0)
    uastc_device_fit_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)px, (const int*)modes, n, nblocks, (uint8_t*)winner, (uint32_t*)q0,
        (uint32_t*)q1, (uint4*)wmain, (uint4*)walpha, (float*)err);
  return (int)cudaGetLastError();
}

int uvt_uastc_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {UVT_KERNEL(uastc_device_fit_kernel)};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
