// The real-.drc decode's device stage for Hopper (sm_90a): K8, one launch per
// window of frames, from the packed uint8 window to every float attribute.
//
//   drc_fused_batch_kernel   replaces the XLA program of
//       uvol_tpu/models/drc_device.py, `_fused_batch_fn` (not a Pallas site:
//       the reference leaves the stage to XLA as one jitted program). For each
//       attribute of the window's spec table (at most kMaxSpecs, passed by
//       value): unpack its values from 8, 10, 12, 16 or 32 bits each, then
//       either dequantize them (kind 1: min + float(q) * scale, per frame and
//       component) or decode octahedral normals (kind 2: two ints per vertex
//       to a unit vector). The float32 metadata (mins and scales, or each
//       frame's maxv) rides the window's tail, 4-byte aligned.
//
// Packing, as the reference's `_pack_host` / `uvt_pack_bits` lay it out: mode
// 8 is one byte a value; mode 16 two bytes, little-endian, sign-extended;
// mode 32 four bytes as an int32; mode 12 two values in 3 bytes (12 bits
// each, low byte first); mode 10 four values in 5 bytes. A run of n values
// takes ceil(n / group) whole groups.
//
// Design. The grid is one-dimensional: each attribute gets ceil(n / 1024)
// CTAs of 256 threads, n = f * nmax * nc its values, and a CTA finds its
// attribute from the table's CTA prefix sums. A CTA's 1,024 values start on
// a group boundary (1,024 is a multiple of every group's 1, 2 or 4 values),
// so its bytes are one contiguous run of at most 4,096, which the CTA stages
// in shared memory with consecutive threads on consecutive bytes. Then a
// thread takes values j, j + 256, ... (kind 1: stores of consecutive threads
// are consecutive floats) or vertices k, k + 256 (kind 2: 2 values in, 3
// floats out), reading its bytes from shared memory. The metadata is read
// from global memory (a few floats per frame, L1-resident).
//
// Arithmetic (-fmad=false, no fast math; every rounding is written out):
//   kind 1   __fmaf_rn(float(q), scale, min): one rounding, for every
//            component. XLA's CPU code fuses some components and not others;
//            the port follows one rule (the plain twin: _device.fma_f32).
//   kind 2   u = q / maxv * 2 - 1 (IEEE division), z = (1 - |u|) - |v|; where
//            z < 0, u2 = (1 - |v|) * sign(u) and v2 = (1 - |u|) * sign(v), the
//            sign of -0.0 taken as +1; nrm = sqrt((u2*u2 + v2*v2) + z*z),
//            every product and sum rounded, IEEE sqrt; dn = max(nrm, 1e-30)
//            propagating NaN as jnp.maximum and torch.maximum do (fmaxf does
//            not); (u2, v2, z) / dn by IEEE division, (0, 0, 1) where nrm == 0.
//            A degenerate maxv (0, or -1) gives what the reference gives.
//
// Bound: bytes. At a liam-scale window of 8 frames (26,145 vertices bucketed
// to nmax 28,672; positions at 12-bit mode, texcoords at 10, normals at 8) K8
// reads 2.06 MB and writes 7.34 MB of float32: 9.40 MB, 2.8 us at 3.35 TB/s.
// Its ~20 operations per value are far below the bytes. PERF.md section 6
// has the measured times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "func_attrs.cuh"

namespace {

constexpr int kMaxSpecs = 4;
constexpr int kThreads = 256;
constexpr int kValues = 1024;  // values per CTA: a multiple of every group
constexpr int kMaxBytes = kValues * 4;

// One attribute (models/drc_device.py `_Spec`): its kind (1 dequantize, 2
// normals), packing mode, frames, padded vertices, components (2 for
// normals), byte offset in the window, first metadata float, first output
// float.
struct DrcSpec {
  int32_t kind, mode, f, nmax, nc, pad;
  int64_t off, moff, out_off;
};

struct DrcTable {
  DrcSpec s[kMaxSpecs];
  int64_t cta_start[kMaxSpecs + 1];  // prefix sums of each spec's CTAs
  int n;
};

__host__ __device__ inline int group_values(int mode) {
  return mode == 10 ? 4 : mode == 12 ? 2 : 1;
}
__host__ __device__ inline int group_bytes(int mode) {
  return mode == 8 ? 1 : mode == 10 ? 5 : mode == 12 ? 3 : mode == 16 ? 2 : 4;
}

// Value j of a run of groups staged at b (j counted from a group boundary).
__device__ inline int32_t unpack(const uint8_t* b, int mode, int j) {
  switch (mode) {
    case 8:
      return b[j];
    case 16:
      return (int32_t)(int16_t)(uint16_t)(b[2 * j] | (b[2 * j + 1] << 8));
    case 32:
      return (int32_t)((uint32_t)b[4 * j] | ((uint32_t)b[4 * j + 1] << 8) |
                       ((uint32_t)b[4 * j + 2] << 16) | ((uint32_t)b[4 * j + 3] << 24));
    case 12: {
      const uint8_t* g = b + 3 * (j >> 1);
      return (j & 1) ? (g[1] >> 4) | (g[2] << 4) : g[0] | ((g[1] & 0xF) << 8);
    }
    default: {  // 10
      const uint8_t* g = b + 5 * (j >> 2);
      switch (j & 3) {
        case 0: return g[0] | ((g[1] & 0x3) << 8);
        case 1: return (g[1] >> 2) | ((g[2] & 0xF) << 6);
        case 2: return (g[2] >> 4) | ((g[3] & 0x3F) << 4);
        default: return (g[3] >> 6) | (g[4] << 2);
      }
    }
  }
}

__device__ inline float oct_coord(int32_t q, float maxv) {
  return __fsub_rn(__fmul_rn(__fdiv_rn(__int2float_rn(q), maxv), 2.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
    drc_fused_batch_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ meta,
                           float* __restrict__ out, const DrcTable t) {
  __shared__ uint8_t buf[kMaxBytes];
  const int64_t cta = blockIdx.x;
  int si = 0;
  while (si + 1 < t.n && cta >= t.cta_start[si + 1]) ++si;
  const DrcSpec s = t.s[si];
  const int64_t n = (int64_t)s.f * s.nmax * s.nc;
  const int64_t v0 = (cta - t.cta_start[si]) * kValues;
  const int nv = n - v0 < kValues ? (int)(n - v0) : kValues;
  const int gv = group_values(s.mode), gb = group_bytes(s.mode);
  const int nbytes = (nv + gv - 1) / gv * gb;
  const uint8_t* src = packed + s.off + v0 / gv * gb;
  for (int i = threadIdx.x; i < nbytes; i += kThreads) buf[i] = src[i];
  __syncthreads();

  const float* m = meta + s.moff;
  if (s.kind == 1) {
    const int64_t frame_vals = (int64_t)s.nmax * s.nc;
    float* o = out + s.out_off + v0;
    for (int j = threadIdx.x; j < nv; j += kThreads) {
      const int64_t v = v0 + j;
      const int64_t fi = v / frame_vals;
      const int c = (int)(v % s.nc);
      const float mn = m[fi * s.nc + c];
      const float scale = m[(int64_t)s.f * s.nc + fi];
      o[j] = __fmaf_rn(__int2float_rn(unpack(buf, s.mode, j)), scale, mn);
    }
  } else {
    const int64_t vt0 = v0 / 2;
    for (int k = threadIdx.x; k < nv / 2; k += kThreads) {
      const int64_t vt = vt0 + k;
      const float maxv = m[vt / s.nmax];
      const float u = oct_coord(unpack(buf, s.mode, 2 * k), maxv);
      const float v = oct_coord(unpack(buf, s.mode, 2 * k + 1), maxv);
      const float au = fabsf(u), av = fabsf(v);
      const float z = __fsub_rn(__fsub_rn(1.0f, au), av);
      const bool neg = z < 0.0f;
      const float u2 = neg ? __fmul_rn(__fsub_rn(1.0f, av), u >= 0.0f ? 1.0f : -1.0f) : u;
      const float v2 = neg ? __fmul_rn(__fsub_rn(1.0f, au), v >= 0.0f ? 1.0f : -1.0f) : v;
      const float nrm = __fsqrt_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(u2, u2), __fmul_rn(v2, v2)), __fmul_rn(z, z)));
      const float dn = nrm != nrm ? nrm : fmaxf(nrm, 1e-30f);
      float* o = out + s.out_off + vt * 3;
      if (nrm == 0.0f) {
        o[0] = 0.0f;
        o[1] = 0.0f;
        o[2] = 1.0f;
      } else {
        o[0] = __fdiv_rn(u2, dn);
        o[1] = __fdiv_rn(v2, dn);
        o[2] = __fdiv_rn(z, dn);
      }
    }
  }
}

}  // namespace

extern "C" {

// packed: the window on the device; specs: a HOST array of nspec DrcSpec
// rows; meta_off: the metadata's byte offset in the window (packed +
// meta_off 4-byte aligned); out: the float32 outputs, each spec's at its
// out_off.
int uvt_drc_fused_batch(const void* packed, const void* specs, int nspec, int64_t meta_off,
                        void* out, void* stream) {
  if (nspec < 1 || nspec > kMaxSpecs || ((uintptr_t)packed + (uint64_t)meta_off) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  DrcTable t = {};
  t.n = nspec;
  for (int i = 0; i < nspec; ++i) {
    const DrcSpec s = ((const DrcSpec*)specs)[i];
    if ((s.kind != 1 && s.kind != 2) || (s.kind == 2 && s.nc != 2) || s.f < 0 || s.nmax < 0 ||
        s.nc < 1 || (s.mode != 8 && s.mode != 10 && s.mode != 12 && s.mode != 16 && s.mode != 32))
      return (int)cudaErrorInvalidValue;
    t.s[i] = s;
    const int64_t n = (int64_t)s.f * s.nmax * s.nc;
    t.cta_start[i + 1] = t.cta_start[i] + (n + kValues - 1) / kValues;
  }
  const int64_t ctas = t.cta_start[nspec];
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (ctas > 0)
    drc_fused_batch_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const float*)((const uint8_t*)packed + meta_off), (float*)out,
        t);
  return (int)cudaGetLastError();
}

int uvt_drc_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {UVT_KERNEL(drc_fused_batch_kernel)};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
