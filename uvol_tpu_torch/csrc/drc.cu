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
// each, low byte first); mode 10 four values in 5 bytes. Every mode is thus
// one little-endian bit stream of `mode` bits a value, and a run of n values
// takes ceil(n / group) whole groups.
//
// Bound: bytes. At a liam-scale window of 8 frames (26,145 vertices bucketed
// to nmax 28,672; positions at 12-bit mode, texcoords at 10, normals at 8) K8
// reads 2.06 MB and writes 7.34 MB of float32: 9.40 MB, 2.8 us at 3.35 TB/s
// (64 frames: 75.2 MB, 22.5 us). Its ~20 operations per value are far below
// the bytes. PERF.md section 6 has the measured times.
//
// Design: a memory-bound unpack-and-convert pass that reads its input once in
// 16-byte loads and writes its output once in 16-byte stores.
//   - Grid: one-dimensional, 256 threads a CTA, kValues values a CTA; each
//     attribute gets ceil(n / kValues) CTAs (n = f * nmax * nc), and a CTA
//     finds its attribute from the table's CTA prefix sums.
//   - Once per CTA, warp 0 computes the CTA's first frame, its offset in that
//     frame and whether the CTA lies in one frame (always on the main path:
//     nmax is a multiple of 4,096, so nmax * nc is a multiple of kValues), in
//     32 bits: an attribute holds fewer than kMaxValues values, so no index
//     of the kernel needs 64 bits. Warp 0 also stages the metadata of the
//     frames the CTA touches (mins and scales, or maxv) in shared memory, or,
//     past kMetaCap floats, leaves them in global memory.
//   - The CTA's bytes are one contiguous run: staged into shared memory in
//     16-byte loads from the 16-byte boundary at or below its first byte (the
//     head shift carried); a 16-byte piece that is not wholly inside the
//     window [packed, packed + size) is read byte by byte, only its bytes of
//     the run: K8 reads nothing outside the window, and `packed` need not be
//     aligned.
//   - A thread owns runs of whole groups: kind 1 four values (one float4
//     out), kind 2 eight values (four vertices, three float4s out). It reads
//     its bytes from shared memory as 32-bit words realigned by funnel shifts
//     and cuts its values out of the bit stream at constant offsets (the mode
//     is a template parameter). A run that reaches past the CTA's last value
//     stores only its valid values, one float at a time.
//   - Index arithmetic per value is 32-bit adds and compares: the component
//     (and, where the CTA crosses frames, the vertex and the frame) carried
//     forward from the run's first value. The run's start costs at most two
//     32-bit divisions in the general body (frame, then vertex) and one
//     modulo in the one-frame body; the kernel has no 64-bit division.
//   - The wrapper places every attribute's output at a multiple of 4 floats,
//     so each run's float4s are 16-byte aligned; the launcher refuses other
//     tables.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "func_attrs.cuh"

namespace {

constexpr int kMaxSpecs = 4;
constexpr int kThreads = 256;
// values per CTA: a multiple of every run (4, 8) and a divisor of 4,096, so
// that a bucketed frame (nmax * nc, nmax a multiple of 4,096) is whole CTAs
constexpr int kValues = 2048;
constexpr int kMaxBytes = kValues * 4;  // mode 32
constexpr int kMetaCap = 1024;          // metadata floats a CTA stages
// values an attribute may hold: every index of the kernel is 32-bit (16 GiB
// of float32 output an attribute; the wrapper refuses more)
constexpr uint32_t kMaxValues = 0xFFFFF000u;

// One attribute (models/drc_device.py `_Spec`): its kind (1 dequantize, 2
// normals), packing mode, frames, padded vertices, components (2 for
// normals), byte offset in the window, first metadata float, first output
// float (a multiple of 4).
struct DrcSpec {
  int32_t kind, mode, f, nmax, nc, pad;
  int64_t off, moff, out_off;
};

struct DrcTable {
  DrcSpec s[kMaxSpecs];
  int64_t cta_start[kMaxSpecs + 1];  // prefix sums of each spec's CTAs
  int n;
};

// What warp 0 works out once per CTA for the others.
struct CtaStart {
  const float* lo;  // kind 1: the mins of the CTA's first frame; kind 2: its maxv
  const float* hi;  // kind 1: the scale of that frame
  uint32_t r0;      // the CTA's first value (kind 2: vertex) within that frame
  int one_frame;    // every value of the CTA lies in that frame
};

template <typename T>
__host__ __device__ inline T packed_bytes(T n, int mode) {
  const int lg = mode == 10 ? 2 : mode == 12 ? 1 : 0;  // values a group: 1 << lg
  const int gb = mode == 8 ? 1 : mode == 10 ? 5 : mode == 12 ? 3 : mode == 16 ? 2 : 4;
  return ((n + (1 << lg) - 1) >> lg) * gb;
}

// The RUN values whose bits start at byte sb of the staged words w.
template <int MODE, int RUN>
__device__ __forceinline__ void unpack_run(const uint32_t* w, int sb, int32_t (&q)[RUN]) {
  constexpr int kWords = (RUN * MODE / 8 + 3) / 4;
  constexpr uint32_t kMask = MODE == 32 ? 0xFFFFFFFFu : (1u << (MODE & 31)) - 1;
  const uint32_t* p = w + (sb >> 2);
  const int sh = (sb & 3) * 8;
  uint32_t raw[kWords + 1], a[kWords + 1];
#pragma unroll
  for (int i = 0; i <= kWords; ++i) raw[i] = p[i];
#pragma unroll
  for (int i = 0; i < kWords; ++i) a[i] = __funnelshift_r(raw[i], raw[i + 1], sh);
  a[kWords] = 0;  // never reached: a value's bits end inside the run's words
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int bit = j * MODE, wi = bit >> 5, bo = bit & 31;
    const uint32_t v = bo + MODE <= 32 ? a[wi] >> bo : __funnelshift_r(a[wi], a[wi + 1], bo);
    q[j] = MODE == 32   ? (int32_t)v
           : MODE == 16 ? (int32_t)(int16_t)(uint16_t)v
                        : (int32_t)(v & kMask);
  }
}

__device__ inline float oct_coord(int32_t q, float maxv) {
  return __fsub_rn(__fmul_rn(__fdiv_rn(__int2float_rn(q), maxv), 2.0f), 1.0f);
}

// (u2, v2, z) / max(nrm, 1e-30), or (0, 0, 1) where nrm == 0.
__device__ __forceinline__ void oct_normal(int32_t qu, int32_t qv, float maxv, float* o) {
  const float u = oct_coord(qu, maxv), v = oct_coord(qv, maxv);
  const float au = fabsf(u), av = fabsf(v);
  const float z = __fsub_rn(__fsub_rn(1.0f, au), av);
  const bool neg = z < 0.0f;
  const float u2 = neg ? __fmul_rn(__fsub_rn(1.0f, av), u >= 0.0f ? 1.0f : -1.0f) : u;
  const float v2 = neg ? __fmul_rn(__fsub_rn(1.0f, au), v >= 0.0f ? 1.0f : -1.0f) : v;
  const float nrm =
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(u2, u2), __fmul_rn(v2, v2)), __fmul_rn(z, z)));
  const float dn = nrm != nrm ? nrm : fmaxf(nrm, 1e-30f);
  const bool up = nrm == 0.0f;
  o[0] = up ? 0.0f : __fdiv_rn(u2, dn);
  o[1] = up ? 0.0f : __fdiv_rn(v2, dn);
  o[2] = up ? 1.0f : __fdiv_rn(z, dn);
}

// Kind 1, runs of 4 values: float(q) * scale + min, one float4 a run.
template <int MODE, bool ONE>
__device__ __forceinline__ void dequantize_runs(const uint32_t* w, int head, const DrcSpec& s,
                                                const CtaStart& cs, int nv, float* o) {
  const uint32_t nc = s.nc, nmax = s.nmax, fv = nmax * nc;
  for (int r = threadIdx.x; r * 4 < nv; r += kThreads) {
    const int lv = r * 4, valid = min(4, nv - lv);
    int32_t q[4];
    unpack_run<MODE, 4>(w, head + lv * MODE / 8, q);
    uint32_t rr = cs.r0 + lv, fl = 0;  // offset in the frame, frames past the first
    if (!ONE) {
      fl = rr / fv;
      rr -= fl * fv;
    }
    uint32_t vert = rr / nc, c = rr - vert * nc, mi = fl * nc + c;
    float scale = cs.hi[fl];
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < valid) {
        if (j > 0) {  // carry to the next value: component, vertex, frame
          ++mi;
          if (++c == nc) {
            c = 0;
            mi -= nc;
            if (!ONE && ++vert == nmax) {
              vert = 0;
              mi += nc;
              scale = cs.hi[++fl];
            }
          }
        }
        x[j] = __fmaf_rn(__int2float_rn(q[j]), scale, cs.lo[mi]);
      }
    }
    if (valid == 4) {
      *reinterpret_cast<float4*>(o + lv) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (j < valid) o[lv + j] = x[j];
    }
  }
}

// Kind 2, runs of 8 values (4 vertices): unit normals, three float4s a run.
template <int MODE, bool ONE>
__device__ __forceinline__ void normal_runs(const uint32_t* w, int head, const DrcSpec& s,
                                            const CtaStart& cs, int nv, float* o) {
  const uint32_t nmax = s.nmax;
  const int nk = nv / 2;
  for (int r = threadIdx.x; r * 4 < nk; r += kThreads) {
    const int lk = r * 4, valid = min(4, nk - lk);
    int32_t q[8];
    unpack_run<MODE, 8>(w, head + lk * 2 * MODE / 8, q);
    uint32_t vert = cs.r0 + lk, fl = 0;
    if (!ONE) {
      fl = vert / nmax;
      vert -= fl * nmax;
    }
    float maxv = cs.lo[fl];
    float x[12];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < valid) {
        if (!ONE && j > 0 && ++vert == nmax) {
          vert = 0;
          maxv = cs.lo[++fl];
        }
        oct_normal(q[2 * j], q[2 * j + 1], maxv, x + 3 * j);
      }
    }
    float* d = o + 3 * lk;
    if (valid == 4) {
      float4* d4 = reinterpret_cast<float4*>(d);
      d4[0] = make_float4(x[0], x[1], x[2], x[3]);
      d4[1] = make_float4(x[4], x[5], x[6], x[7]);
      d4[2] = make_float4(x[8], x[9], x[10], x[11]);
    } else {
#pragma unroll
      for (int j = 0; j < 9; ++j)
        if (j < 3 * valid) d[j] = x[j];
    }
  }
}

template <int MODE>
__device__ __forceinline__ void convert(const uint32_t* w, int head, const DrcSpec& s,
                                        const CtaStart& cs, int nv, float* o) {
  if (s.kind == 1) {
    if (cs.one_frame) dequantize_runs<MODE, true>(w, head, s, cs, nv, o);
    else dequantize_runs<MODE, false>(w, head, s, cs, nv, o);
  } else {
    if (cs.one_frame) normal_runs<MODE, true>(w, head, s, cs, nv, o);
    else normal_runs<MODE, false>(w, head, s, cs, nv, o);
  }
}

__global__ void __launch_bounds__(kThreads)
    drc_fused_batch_kernel(const uint8_t* __restrict__ packed, int64_t size,
                           const float* __restrict__ meta, float* __restrict__ out,
                           const DrcTable t) {
  __shared__ uint4 buf[kMaxBytes / 16 + 2];
  __shared__ float smeta[kMetaCap];
  __shared__ CtaStart start;
  const int64_t cta = blockIdx.x;
  int si = 0;
  while (si + 1 < t.n && cta >= t.cta_start[si + 1]) ++si;
  const DrcSpec s = t.s[si];
  const uint32_t n = (uint32_t)s.f * s.nmax * s.nc;  // < kMaxValues: no index needs 64 bits
  const uint32_t v0 = (uint32_t)(cta - t.cta_start[si]) * kValues;
  const int nv = n - v0 < kValues ? (int)(n - v0) : kValues;

  if (threadIdx.x < 32) {  // warp 0: the CTA's frames and their metadata
    const int lane = threadIdx.x;
    const uint32_t per = s.kind == 1 ? (uint32_t)s.nmax * s.nc : s.nmax;  // a frame's units
    const uint32_t u0 = s.kind == 1 ? v0 : v0 / 2, nu = s.kind == 1 ? nv : nv / 2;
    const uint32_t fi0 = u0 / per, fi1 = (u0 + nu - 1) / per, nf = fi1 - fi0 + 1;
    const float* m = meta + s.moff;
    const float* lo = s.kind == 1 ? m + fi0 * s.nc : m + fi0;
    const float* hi = m + (uint32_t)s.f * s.nc + fi0;  // kind 1's scales
    const uint32_t nlo = s.kind == 1 ? nf * s.nc : nf, nhi = s.kind == 1 ? nf : 0;
    const bool stage = nlo + nhi <= kMetaCap;
    if (stage) {
      for (int i = lane; i < nlo; i += 32) smeta[i] = lo[i];
      for (int i = lane; i < nhi; i += 32) smeta[nlo + i] = hi[i];
    }
    if (lane == 0) {
      start.lo = stage ? smeta : lo;
      start.hi = stage ? smeta + nlo : hi;
      start.r0 = (uint32_t)(u0 - fi0 * per);
      start.one_frame = fi1 == fi0;
    }
  }

  // the CTA's bytes [b0, b0 + span) of the window, from the 16-byte boundary
  // at or below b0; a piece not wholly inside the window is read bytewise
  const int64_t b0 = s.off + ((int64_t)v0 * s.mode >> 3);
  const int span = packed_bytes(nv, s.mode);  // v0 is a multiple of every group
  const uintptr_t first = (uintptr_t)(packed + b0);
  const uintptr_t base = first & ~(uintptr_t)15;
  const uintptr_t wbeg = (uintptr_t)packed, wend = wbeg + (uintptr_t)size;
  const int head = (int)(first - base);
  const int pieces = (int)((head + span + 15) >> 4);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(buf);
  for (int k = threadIdx.x; k < pieces; k += kThreads) {
    const uintptr_t a = base + 16 * (uintptr_t)k;
    if (a >= wbeg && a + 16 <= wend) {
      buf[k] = __ldg(reinterpret_cast<const uint4*>(a));
    } else {
      for (int b = 0; b < 16; ++b)
        if (a + b >= first && a + b < first + (uintptr_t)span)
          bytes[16 * k + b] = *reinterpret_cast<const uint8_t*>(a + b);
    }
  }
  __syncthreads();

  const CtaStart cs = start;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf);
  float* o = out + s.out_off + (s.kind == 1 ? v0 : v0 / 2 * 3);
  switch (s.mode) {
    case 8: convert<8>(w, head, s, cs, nv, o); break;
    case 10: convert<10>(w, head, s, cs, nv, o); break;
    case 12: convert<12>(w, head, s, cs, nv, o); break;
    case 16: convert<16>(w, head, s, cs, nv, o); break;
    default: convert<32>(w, head, s, cs, nv, o); break;
  }
}

}  // namespace

extern "C" {

// packed: the window on the device, size bytes; specs: a HOST array of nspec
// DrcSpec rows; meta_off: the metadata's byte offset in the window (packed +
// meta_off 4-byte aligned); out: the float32 outputs (16-byte aligned), each
// spec's at its out_off (a multiple of 4). Refuses a table whose attributes or
// metadata lie outside the window.
int uvt_drc_fused_batch(const void* packed, int64_t size, const void* specs, int nspec,
                        int64_t meta_off, void* out, void* stream) {
  if (nspec < 1 || nspec > kMaxSpecs || size < 0 || meta_off < 0 || meta_off > size ||
      ((uintptr_t)packed + (uint64_t)meta_off) % 4 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t meta_floats = (size - meta_off) / 4;
  DrcTable t = {};
  t.n = nspec;
  for (int i = 0; i < nspec; ++i) {
    const DrcSpec s = ((const DrcSpec*)specs)[i];
    if ((s.kind != 1 && s.kind != 2) || (s.kind == 2 && s.nc != 2) || s.f < 0 || s.nmax < 0 ||
        s.nc < 1 || (s.mode != 8 && s.mode != 10 && s.mode != 12 && s.mode != 16 && s.mode != 32))
      return (int)cudaErrorInvalidValue;
    const int64_t n = (int64_t)s.f * s.nmax * s.nc;
    const int64_t mneed = s.kind == 1 ? (int64_t)s.f * s.nc + s.f : s.f;
    if (n > kMaxValues || s.off < 0 || s.off + packed_bytes(n, s.mode) > size ||
        s.moff < 0 || s.moff + mneed > meta_floats || s.out_off < 0 || s.out_off % 4 != 0)
      return (int)cudaErrorInvalidValue;
    t.s[i] = s;
    t.cta_start[i + 1] = t.cta_start[i] + (n + kValues - 1) / kValues;
  }
  const int64_t ctas = t.cta_start[nspec];  // at most 4 * kMaxValues / kValues
  if (ctas > 0)
    drc_fused_batch_kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, size, (const float*)((const uint8_t*)packed + meta_off),
        (float*)out, t);
  return (int)cudaGetLastError();
}

int uvt_drc_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {UVT_KERNEL(drc_fused_batch_kernel)};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
