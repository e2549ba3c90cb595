// ETC1 block encode (K1) and decode (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of uvol_tpu/codecs/basis/etc_pallas.py:
//   K1  `_kernel` (encode_etc1_blocks_pallas) and `_enc_strip_kernel`
//       (encode_etc1_strips_pallas) -- one function in two TPU layouts;
//   K2  `_dec_kernel` (decode_etc1_blocks_pallas) and `_dec_strip_kernel`
//       (decode_etc1_strips_pallas).
// Both read and write the [L, H, W, 3] uint8 image tensor directly, so the
// TPU's relayouts (image_to_blocks, _prepare_layout, images_to_strips and
// their inverses) have no counterpart here. Words are [L*nb, 2] int32
// holding the uint32 bit patterns, blocks frame-major in raster order.
//
// Arithmetic is that of the plain twins in codecs/basis/etc.py (and of the
// reference's encode_etc1_blocks / decode_etc1_blocks): int32 throughout,
// first-minimum argmins, strict `<` ties. Floats appear only in the 5-bit
// mean, in the reference's order (sum*0.125, *31, /255, round half to
// even) with explicitly rounded intrinsics; the library is built with
// -fmad=false and without --use_fast_math so nothing is contracted.
//
// K1 -- one thread per 4x4 block. It reads 4 rows of 12 bytes at a stride
// of 3W and searches both flips x both subblocks x 8 tables in two passes
// (~3k integer ops per block against 56 bytes moved), so it is bound by
// integer ALU work, not memory. The 12-byte row loads of neighbouring
// threads are 12 bytes apart and not coalesced into full sectors; staging
// a tile of image rows through shared memory is the first optimisation to
// make later.
//
// K2 -- one thread per output pixel (16 per block). Each thread decodes
// its block's word pair and writes its 3 bytes, so neighbouring threads
// write neighbouring bytes. The kernel is memory-bound: 8 bytes in and 48
// out per block, ~16 MB in and ~100 MB out for 32 layers of 1024^2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int kModSmall[8] = {2, 5, 9, 13, 18, 24, 33, 47};
__constant__ int kModLarge[8] = {8, 17, 29, 42, 60, 80, 106, 183};

constexpr int kRankMask = 1 << 30;  // above any pass-1 ranking total

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }
__device__ __forceinline__ int extend5(int c) { return (c << 3) | (c >> 2); }
__device__ __forceinline__ int extend4(int c) { return (c << 4) | c; }

// modifier value of `code` (0:+small 1:+large 2:-small 3:-large) in `tab`
__device__ __forceinline__ int mod_value(int tab, int code) {
  int mag = (code & 1) ? kModLarge[tab] : kModSmall[tab];
  return (code & 2) ? -mag : mag;
}

// 5-bit mean of one channel from its 8-pixel integer sum:
// rint(((sum * 0.125) * 31) / 255) clipped to 0..31, each step rounded
// to nearest as in the float32 reference.
__device__ __forceinline__ int mean_quant5(int sum) {
  float mean = __fmul_rn((float)sum, 0.125f);
  float v = rintf(__fdiv_rn(__fmul_rn(mean, 31.0f), 255.0f));
  v = fminf(fmaxf(v, 0.0f), 31.0f);
  return (int)v;
}

// Pixel k (0..7) of subblock `sb` under `flip`, as (y, x) in the block,
// in the order the reference flattens subblocks.
__device__ __forceinline__ void sub_pixel(int flip, int sb, int k, int* y, int* x) {
  if (flip) {  // two 2-row halves: k = y'*4 + x
    *y = 2 * sb + (k >> 2);
    *x = k & 3;
  } else {  // two 2-column halves: k = y*2 + x'
    *y = k >> 1;
    *x = 2 * sb + (k & 1);
  }
}

struct SubResult {
  int table;
  int err;
  uint32_t lsb, msb;  // code bit planes at wire positions j = x*4 + y
};

// Two-pass table search for one subblock with extended base color b[3].
__device__ __forceinline__ SubResult encode_subblock(const int (&px)[16][3], int flip, int sb,
                                     const int (&b)[3]) {
  int p[8][3];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int y, x;
    sub_pixel(flip, sb, k, &y, &x);
#pragma unroll
    for (int c = 0; c < 3; ++c) p[k][c] = px[y * 4 + x][c];
  }
  // ---- pass 1: rank tables by the unclipped linear model
  // q = sb2 + 2*m*sum(b) + 3*m^2 - 2*m*g_k, min over the 4 signed mods
  const int s = b[0] + b[1] + b[2];
  const int s2 = b[0] * b[0] + b[1] * b[1] + b[2] * b[2];
  int g[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) g[k] = p[k][0] + p[k][1] + p[k][2];
  int tot[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int best = 0;
#pragma unroll
      for (int code = 0; code < 4; ++code) {
        const int m = mod_value(t, code);
        const int q = s2 + 2 * m * s + 3 * m * m - 2 * m * g[k];
        best = (code == 0 || q < best) ? q : best;
      }
      acc += best;
    }
    tot[t] = acc;
  }
  int first = 0;
#pragma unroll
  for (int t = 1; t < 8; ++t) first = tot[t] < tot[first] ? t : first;
  int second = -1, second_tot = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int v = (t == first) ? kRankMask : tot[t];
    if (second < 0 || v < second_tot) {
      second = t;
      second_tot = v;
    }
  }
  // ---- pass 2: exact clipped error of the two ranked tables
  SubResult r[2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int tab = pass ? second : first;
    int cand[4][3];
#pragma unroll
    for (int code = 0; code < 4; ++code)
#pragma unroll
      for (int c = 0; c < 3; ++c) cand[code][c] = clamp255(b[c] + mod_value(tab, code));
    int err = 0;
    uint32_t lsb = 0, msb = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int best = 0, best_code = 0;
#pragma unroll
      for (int code = 0; code < 4; ++code) {
        int e = 0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int dd = cand[code][c] - p[k][c];
          e += dd * dd;
        }
        if (code == 0 || e < best) {  // first minimum wins
          best = e;
          best_code = code;
        }
      }
      err += best;
      int y, x;
      sub_pixel(flip, sb, k, &y, &x);
      const int j = x * 4 + y;
      lsb |= (uint32_t)(best_code & 1) << j;
      msb |= (uint32_t)(best_code >> 1) << j;
    }
    r[pass] = SubResult{tab, err, lsb, msb};
  }
  return r[1].err < r[0].err ? r[1] : r[0];  // strict: pass-1 winner keeps ties
}

__global__ void etc1_encode_kernel(const uint8_t* __restrict__ img,
                                   int32_t* __restrict__ out, int l, int h, int w) {
  const int nbx = w >> 2, nby = h >> 2;
  const int64_t nblocks = (int64_t)l * nby * nbx;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nblocks) return;
  const int bx = (int)(i % nbx);
  const int by = (int)((i / nbx) % nby);
  const int64_t layer = i / ((int64_t)nbx * nby);

  int px[16][3];  // [y*4 + x][channel]
  const uint8_t* base = img + ((layer * h + (int64_t)by * 4) * w + (int64_t)bx * 4) * 3;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const uint8_t* row = base + (int64_t)y * w * 3;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int c = 0; c < 3; ++c) px[y * 4 + x][c] = row[x * 3 + c];
  }

  uint32_t word1[2], word2[2];
  int err[2];
#pragma unroll
  for (int flip = 0; flip < 2; ++flip) {
    int m0[3], d[3], b0[3], b1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      int s0 = 0, s1 = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        int y, x;
        sub_pixel(flip, 0, k, &y, &x);
        s0 += px[y * 4 + x][c];
        sub_pixel(flip, 1, k, &y, &x);
        s1 += px[y * 4 + x][c];
      }
      m0[c] = mean_quant5(s0);
      const int m1 = mean_quant5(s1);
      d[c] = min(max(m1 - m0[c], -4), 3);  // differential: 3-bit delta
      b0[c] = extend5(m0[c]);
      b1[c] = extend5(m0[c] + d[c]);
    }
    const SubResult r0 = encode_subblock(px, flip, 0, b0);
    const SubResult r1 = encode_subblock(px, flip, 1, b1);
    err[flip] = r0.err + r1.err;
    word1[flip] = ((uint32_t)m0[0] << 27) | ((uint32_t)(d[0] & 7) << 24) |
                  ((uint32_t)m0[1] << 19) | ((uint32_t)(d[1] & 7) << 16) |
                  ((uint32_t)m0[2] << 11) | ((uint32_t)(d[2] & 7) << 8) |
                  ((uint32_t)r0.table << 5) | ((uint32_t)r1.table << 2) | 2u |
                  (uint32_t)flip;
    word2[flip] = (r0.lsb | r1.lsb) | ((r0.msb | r1.msb) << 16);
  }
  const int f = err[1] < err[0] ? 1 : 0;  // strict: flip 0 keeps ties
  out[2 * i] = (int32_t)word1[f];
  out[2 * i + 1] = (int32_t)word2[f];
}

__global__ void etc1_decode_kernel(const int32_t* __restrict__ words,
                                   uint8_t* __restrict__ img, int l, int h, int w) {
  const int64_t npix = (int64_t)l * h * w;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const int xi = (int)(i % w);
  const int yi = (int)((i / w) % h);
  const int64_t layer = i / ((int64_t)h * w);
  const int nbx = w >> 2, nby = h >> 2;
  const int64_t blk = (layer * nby + (yi >> 2)) * nbx + (xi >> 2);
  const uint32_t w1 = (uint32_t)words[2 * blk];
  const uint32_t w2 = (uint32_t)words[2 * blk + 1];

  const int x = xi & 3, y = yi & 3;
  const int j = x * 4 + y;
  const bool in_sub1 = (w1 & 1u) ? (y >= 2) : (x >= 2);
  const int table = in_sub1 ? (int)((w1 >> 2) & 7u) : (int)((w1 >> 5) & 7u);
  const int lsb = (int)((w2 >> j) & 1u);
  const int msb = (int)((w2 >> (j + 16)) & 1u);
  const int mag = lsb ? kModLarge[table] : kModSmall[table];
  const int mod = (1 - 2 * msb) * mag;  // code msb = sign
  const bool diff = (w1 >> 1) & 1u;

  uint8_t* o = img + i * 3;
  const int sh5[3] = {27, 19, 11}, sh3[3] = {24, 16, 8};
  const int sh4a[3] = {28, 20, 12}, sh4b[3] = {24, 16, 8};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int base;
    if (diff) {
      const int m0 = (int)((w1 >> sh5[c]) & 31u);
      const int draw = (int)((w1 >> sh3[c]) & 7u);
      const int dd = draw >= 4 ? draw - 8 : draw;
      base = in_sub1 ? extend5(min(max(m0 + dd, 0), 31)) : extend5(m0);
    } else {
      base = extend4((int)((w1 >> (in_sub1 ? sh4b[c] : sh4a[c])) & 15u));
    }
    o[c] = (uint8_t)clamp255(base + mod);
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// img: [l, h, w, 3] uint8 (h, w multiples of 4); out: [l*(h/4)*(w/4), 2] int32.
int uvt_etc1_encode(const void* img, void* out, int l, int h, int w, void* stream) {
  const int64_t n = (int64_t)l * (h / 4) * (w / 4);
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    etc1_encode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img, (int32_t*)out, l, h, w);
  }
  return (int)cudaGetLastError();
}

// words: [l*(h/4)*(w/4), 2] int32; img: [l, h, w, 3] uint8.
int uvt_etc1_decode(const void* words, void* img, int l, int h, int w, void* stream) {
  const int64_t n = (int64_t)l * h * w;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    etc1_decode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, (uint8_t*)img, l, h, w);
  }
  return (int)cudaGetLastError();
}

const char* uvt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
