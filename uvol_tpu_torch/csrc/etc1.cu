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
// K1 -- one thread per 4x4 block, one CTA per run of 256 blocks of a
// block row. The run's 4 image rows are staged in shared memory with
// coalesced 16-byte loads (byte loads where W is not a multiple of 16),
// and each thread keeps its 16 pixels packed, one 32-bit register each.
// It searches both flips x both subblocks x 8 tables in two passes, bound
// by integer ALU work (2.8k-4.2k instructions per block against 56 bytes
// moved), so the design cuts instructions:
//   - pass 1 ranks the tables by the unclipped linear model in closed
//     form: with u = g - S (pixel channel sum less the base's), the least
//     of the 4 codes is s2 + min(3s^2 - 2s|u|, 3l^2 - 2l|u|), exact in
//     integers: 2 multiply-adds per (table, pixel) instead of 4 codes;
//   - pass 2 in a table with no clipped channel is closed form too
//     (e = |b - p|^2 + 3m^2 - 2m*u): the subblock's error is the sum of
//     |b - p|^2 plus pass 1's total less 8*s2, each pixel's code the sign
//     of u and whether 2|u| > 3(s + l); a clipping table scores its codes through the
//     clip-aware modifiers me_c = clamp(b_c + m) - b_c,
//     e = |b - p|^2 + |me|^2 + 2 me.(b - p), the code the low two bits of
//     the least key 4e + code (the first minimum). A warp takes the
//     closed form only when all its blocks may, so no lane diverges;
//   - no register array is indexed by a runtime value (the table's
//     modifiers are bytes of a 64-bit constant), so nothing spills.

// K2 -- one thread per 4x4 block on K1's grid (a CTA per run of up to 256
// blocks of a block row), bound by bytes: 8 in and 48 out per block, ~16 MB
// in and ~100 MB out for 32 layers of 1024^2. A thread reads its word pair
// with one 8-byte load and decodes the header once. Each channel of a
// subblock has only four values (base +-small, +-large, clamped), so the
// thread forms those 24 bytes once, four to a register in code order, and a
// pixel is a byte select: per image row one selector (the row's 2-bit codes,
// which the wire keeps column-major, gathered from the two halves of word
// 2) picks the row's 4 reds, 4 greens and 4 blues with one byte permute
// each, and six more interleave them into the row's 12 bytes as three
// little-endian words. The run's 4 image rows are staged in shared memory
// and leave with 16-byte stores where W is a multiple of 16 (every row is
// then 16-byte aligned), 4-byte stores otherwise (a row's start is always a
// multiple of 12 bytes); neighbouring threads write neighbouring addresses
// either way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "func_attrs.cuh"

namespace {

constexpr int kRankMask = 1 << 30;  // above any pass-1 ranking total
constexpr int kThreads = 256;

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }
__device__ __forceinline__ int extend5(int c) { return (c << 3) | (c >> 2); }
__device__ __forceinline__ int extend4(int c) { return (c << 4) | c; }

// 5-bit mean of one channel from its 8-pixel integer sum:
// rint(((sum * 0.125) * 31) / 255) clipped to 0..31, each step rounded
// to nearest as in the float32 reference.
__device__ __forceinline__ int mean_quant5(int sum) {
  float mean = __fmul_rn((float)sum, 0.125f);
  float v = rintf(__fdiv_rn(__fmul_rn(mean, 31.0f), 255.0f));
  v = fminf(fmaxf(v, 0.0f), 31.0f);
  return (int)v;
}

// The modifier magnitudes of table t as bytes of one 64-bit constant, so a
// table index held in a register selects them with a shift, not a load.
constexpr unsigned long long kSmallBytes = 0x2F2118120D090502ull;  // 2 5 9 13 18 24 33 47
constexpr unsigned long long kLargeBytes = 0xB76A503C2A1D1108ull;  // 8 17 29 42 60 80 106 183

__device__ __forceinline__ int small_mod(int t) { return (int)((kSmallBytes >> (8 * t)) & 0xff); }
__device__ __forceinline__ int large_mod(int t) { return (int)((kLargeBytes >> (8 * t)) & 0xff); }

// channel c of a pixel packed as r | g << 8 | b << 16
__device__ __forceinline__ int chan(uint32_t p, int c) { return (int)((p >> (8 * c)) & 0xffu); }
__device__ __forceinline__ int chan_sum(uint32_t p) { return chan(p, 0) + chan(p, 1) + chan(p, 2); }

// Pixel k (0..7) of subblock `sb` under `flip`, as y*4 + x in the block,
// in the order the reference flattens subblocks.
__device__ __forceinline__ int sub_pixel(int flip, int sb, int k) {
  return flip ? (2 * sb + (k >> 2)) * 4 + (k & 3)   // two 2-row halves: k = y'*4 + x
              : (k >> 1) * 4 + 2 * sb + (k & 1);    // two 2-column halves: k = y*2 + x'
}

// wire bit j = x*4 + y of pixel k of the subblock
__device__ __forceinline__ int wire_bit(int flip, int sb, int k) {
  const int p = sub_pixel(flip, sb, k);
  return (p & 3) * 4 + (p >> 2);
}

struct SubResult {
  int table;
  int err;
  uint32_t codes;  // pixel code at bits 2j (lsb) and 2j+1 (msb), j = x*4 + y
};

// the bits of x at even positions, packed into the low 16 bits
__device__ __forceinline__ uint32_t even_bits(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0f0f0f0fu;
  x = (x | (x >> 4)) & 0x00ff00ffu;
  return (x | (x >> 8)) & 0x0000ffffu;
}

// The least of four keys 4*e + code: the first minimum of e (strict <)
// with its code in the low two bits. Adds e to *err and the code at wire
// bit j to *codes.
__device__ __forceinline__ void take_min4(int k0, int k1, int k2, int k3, int j, int* err,
                                          uint32_t* codes) {
  const int key = min(min(k0, k1), min(k2, k3));
  *err += key >> 2;  // arithmetic: floor(key / 4) = e
  *codes |= (uint32_t)(key & 3) << (2 * j);
}

// Two-pass table search for one subblock with extended base color b[3].
// Errors are exact integers, so any grouping of the sums gives the twin's
// values; the argmins keep the twin's order (first minimum, strict <).
__device__ __forceinline__ SubResult encode_subblock(const uint32_t (&px)[16], int flip, int sb,
                                                    const int (&b)[3]) {
  const int bs = b[0] + b[1] + b[2];
  const int s2 = b[0] * b[0] + b[1] * b[1] + b[2] * b[2];
  // u = g - S (pixel channel sum less the base's); |b - p|^2 summed over
  // the subblock is common to every table and code
  int u[8];
  int d2 = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t p = px[sub_pixel(flip, sb, k)];
    u[k] = chan_sum(p) - bs;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int dd = b[c] - chan(p, c);
      d2 += dd * dd;
    }
  }
  // ---- pass 1: rank tables by the unclipped linear model. For m = +-a,
  // q = s2 + 3a^2 - 2a*(+-u), so the least of the 4 codes is
  // s2 + min(3s^2 - 2s|u|, 3l^2 - 2l|u|), in exact integers.
  int tot[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int sm = small_mod(t), lg = large_mod(t);
    int acc = 8 * s2;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int au = abs(u[k]);
      acc += min(3 * sm * sm - 2 * sm * au, 3 * lg * lg - 2 * lg * au);
    }
    tot[t] = acc;
  }
  int first = 0, first_tot = tot[0];
#pragma unroll
  for (int t = 1; t < 8; ++t)
    if (tot[t] < first_tot) {
      first_tot = tot[t];
      first = t;
    }
  int second = -1, second_tot = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int v = (t == first) ? kRankMask : tot[t];
    if (second < 0 || v < second_tot) {
      second = t;
      second_tot = v;
    }
  }
  // ---- pass 2: exact clipped error of the two ranked tables. Per code,
  // e = |b - p|^2 + e', with e' = 3m^2 + 2m*sum(b - p) = 3m^2 - 2m*u when
  // no channel clips (b_c +- l within 0..255), in closed form; else
  // e' = |me|^2 + 2 me.(b - p), me_c = clamp(b_c + m) - b_c, the code
  // taken from keys 4*e' + code, one multiply-add per code and channel.
  // A warp takes the closed form only when all its blocks may.
  const int bmin = min(min(b[0], b[1]), b[2]), bmax = max(max(b[0], b[1]), b[2]);
  SubResult r0, r1;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int tab = pass ? second : first;
    const int sm = small_mod(tab), lg = large_mod(tab);
    const int mods[4] = {sm, lg, -sm, -lg};
    int err = d2;
    uint32_t codes = 0;
    if (__all_sync(__activemask(), bmin >= lg && bmax <= 255 - lg)) {
      // no channel clips: e' = 3m^2 - 2m*u, least at m = +-a with the
      // sign of u (+ at u = 0, the first code), a = s unless 2|u| > 3(s + l)
      // (the small code first on a tie), and its least is pass 1's term:
      // the subblock's total is tot[tab] - 8*s2
      err += (pass ? second_tot : first_tot) - 8 * s2;
      const int thr = 3 * (sm + lg);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t code = (u[k] < 0 ? 2u : 0u) | (2 * abs(u[k]) > thr ? 1u : 0u);
        codes |= code << (2 * wire_bit(flip, sb, k));
      }
    } else {
      int kq[4], kw[4][3];
#pragma unroll
      for (int code = 0; code < 4; ++code) {
        kq[code] = code;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int me = clamp255(b[c] + mods[code]) - b[c];
          kq[code] += 4 * me * me;
          kw[code][c] = 8 * me;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t p = px[sub_pixel(flip, sb, k)];
        const int d0 = b[0] - chan(p, 0), d1 = b[1] - chan(p, 1), dd2 = b[2] - chan(p, 2);
        int key[4];
#pragma unroll
        for (int code = 0; code < 4; ++code)
          key[code] = kq[code] + kw[code][0] * d0 + kw[code][1] * d1 + kw[code][2] * dd2;
        take_min4(key[0], key[1], key[2], key[3], wire_bit(flip, sb, k), &err, &codes);
      }
    }
    (pass ? r1 : r0) = SubResult{tab, err, codes};
  }
  return r1.err < r0.err ? r1 : r0;  // strict: pass-1 winner keeps ties
}

// One CTA per run of up to kThreads blocks of one block row (grid: runs x
// block rows), one thread per block. The run's 4 image rows are staged in
// shared memory with 16-byte loads where a row's bytes are 16-byte
// aligned (W a multiple of 16), byte loads otherwise; neighbouring
// threads read neighbouring addresses either way.
__global__ void etc1_encode_kernel(const uint8_t* __restrict__ img,
                                   int32_t* __restrict__ out, int l, int h, int w) {
  __shared__ __align__(16) uint32_t s_rows[4][kThreads * 3];
  const int nbx = w >> 2;
  const int runs = (nbx + kThreads - 1) / kThreads;
  const int64_t brow = blockIdx.x / runs;  // layer * nby + by
  const int x0 = (int)(blockIdx.x % runs) * kThreads;
  const int nbw = min(kThreads, nbx - x0);
  const int nbytes = nbw * 12;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const uint8_t* src = img + ((brow * 4 + y) * w + (int64_t)x0 * 4) * 3;
    uint8_t* dst = (uint8_t*)s_rows[y];
    int done = 0;
    if (((uintptr_t)src & 15) == 0) {
      done = nbytes & ~15;
      for (int i = threadIdx.x; i < done / 16; i += blockDim.x)
        ((uint4*)dst)[i] = ((const uint4*)src)[i];
    }
    for (int i = done + threadIdx.x; i < nbytes; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= nbw) return;

  uint32_t px[16];  // [y*4 + x], r | g << 8 | b << 16
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const uint32_t w0 = s_rows[y][3 * t], w1 = s_rows[y][3 * t + 1], w2 = s_rows[y][3 * t + 2];
    px[y * 4 + 0] = w0 & 0xffffffu;
    px[y * 4 + 1] = __byte_perm(w0, w1, 0x0543) & 0xffffffu;
    px[y * 4 + 2] = __byte_perm(w1, w2, 0x0432) & 0xffffffu;
    px[y * 4 + 3] = w2 >> 8;
  }
  // channel sums of the 2x2 quadrants (r and b in the 16-bit halves)
  uint32_t rb[2][2] = {{0, 0}, {0, 0}};
  int gq[2][2] = {{0, 0}, {0, 0}};
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    rb[(p >> 2) >> 1][(p & 3) >> 1] += px[p] & 0xff00ffu;
    gq[(p >> 2) >> 1][(p & 3) >> 1] += chan(px[p], 1);
  }

  uint32_t word1[2], word2[2];
  int err[2];
#pragma unroll
  for (int flip = 0; flip < 2; ++flip) {
    // flip 0: left/right 2-column halves; flip 1: top/bottom 2-row halves
    const uint32_t rb0 = flip ? rb[0][0] + rb[0][1] : rb[0][0] + rb[1][0];
    const uint32_t rb1 = flip ? rb[1][0] + rb[1][1] : rb[0][1] + rb[1][1];
    const int g0 = flip ? gq[0][0] + gq[0][1] : gq[0][0] + gq[1][0];
    const int g1 = flip ? gq[1][0] + gq[1][1] : gq[0][1] + gq[1][1];
    const int s0[3] = {(int)(rb0 & 0xffffu), g0, (int)(rb0 >> 16)};
    const int s1[3] = {(int)(rb1 & 0xffffu), g1, (int)(rb1 >> 16)};
    int m0[3], d[3], b0[3], b1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      m0[c] = mean_quant5(s0[c]);
      const int m1 = mean_quant5(s1[c]);
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
    const uint32_t codes = r0.codes | r1.codes;
    word2[flip] = even_bits(codes) | (even_bits(codes >> 1) << 16);
  }
  const bool f = err[1] < err[0];  // strict: flip 0 keeps ties
  const int64_t i = brow * nbx + x0 + t;
  ((int2*)out)[i] = make_int2((int32_t)(f ? word1[1] : word1[0]), (int32_t)(f ? word2[1] : word2[0]));
}

// ---- K2 ------------------------------------------------------------------

// byte t (0..7) of the 8-byte table hi:lo
__device__ __forceinline__ int table_byte(uint32_t lo, uint32_t hi, uint32_t t) {
  return (int)(__byte_perm(lo, hi, t) & 0xffu);
}

// The four values one channel of a subblock can take, one per byte in code
// order (code = msb << 1 | lsb: +small, +large, -small, -large).
__device__ __forceinline__ uint32_t channel_values(int base, int sm, int lg) {
  return (uint32_t)__viaddmin_s32_relu(base, sm, 255) |
         (uint32_t)__viaddmin_s32_relu(base, lg, 255) << 8 |
         (uint32_t)__viaddmin_s32_relu(base, -sm, 255) << 16 |
         (uint32_t)__viaddmin_s32_relu(base, -lg, 255) << 24;
}

// One CTA per run of up to kThreads blocks of one block row (K1's grid),
// one thread per block. words must be 8-byte aligned and img 4-byte
// aligned; the 16-byte stores are taken when img is 16-byte aligned and W
// a multiple of 16.
__global__ void __launch_bounds__(kThreads)
etc1_decode_kernel(const int32_t* __restrict__ words, uint8_t* __restrict__ img, int l, int h,
                   int w) {
  __shared__ __align__(16) uint32_t s_rows[4][kThreads * 3];
  const int nbx = w >> 2;
  const int runs = (nbx + kThreads - 1) / kThreads;
  const int64_t brow = blockIdx.x / runs;  // layer * nby + by
  const int x0 = (int)(blockIdx.x % runs) * kThreads;
  const int nbw = min(kThreads, nbx - x0);
  const int t = threadIdx.x;
  if (t < nbw) {
    const int2 pair = ((const int2*)words)[brow * nbx + x0 + t];
    const uint32_t w1 = (uint32_t)pair.x, w2 = (uint32_t)pair.y;
    const bool flip = w1 & 1u, diff = w1 & 2u;
    const uint32_t t0 = (w1 >> 5) & 7u, t1 = (w1 >> 2) & 7u;
    const int sm0 = table_byte(0x0D090502u, 0x2F211812u, t0);
    const int lg0 = table_byte(0x2A1D1108u, 0xB76A503Cu, t0);
    const int sm1 = table_byte(0x0D090502u, 0x2F211812u, t1);
    const int lg1 = table_byte(0x2A1D1108u, 0xB76A503Cu, t1);
    // per channel: the values of the subblock left of / above the split in
    // `a`, right of / below it in `b`, for the top and the bottom two rows
    uint32_t a_top[3], b_top[3], a_bot[3], b_bot[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int byte = (int)((w1 >> (24 - 8 * c)) & 0xffu);
      int base0, base1;
      if (diff) {  // 5-bit color and a signed 3-bit delta, the sum clipped to 0..31
        const int m0 = byte >> 3;
        const int dd = ((byte & 7) ^ 4) - 4;
        base0 = extend5(m0);
        base1 = extend5(min(max(m0 + dd, 0), 31));
      } else {  // two 4-bit colors
        base0 = extend4(byte >> 4);
        base1 = extend4(byte & 15);
      }
      const uint32_t v0 = channel_values(base0, sm0, lg0);
      const uint32_t v1 = channel_values(base1, sm1, lg1);
      // flip 0: left/right 2-column halves; flip 1: top/bottom 2-row halves
      a_top[c] = v0;
      b_top[c] = flip ? v0 : v1;
      a_bot[c] = flip ? v1 : v0;
      b_bot[c] = v1;
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      // pixel (x, y) has its code's lsb at bit x*4 + y of word 2 and its
      // msb 16 above: nibble x of the selector is the code, +4 for x >= 2
      // (the second operand of the permute)
      const uint32_t sel = ((w2 >> y) & 0x1111u) | ((w2 >> (15 + y)) & 0x2222u) | 0x4400u;
      const uint32_t* a = y < 2 ? a_top : a_bot;
      const uint32_t* b = y < 2 ? b_top : b_bot;
      const uint32_t r4 = __byte_perm(a[0], b[0], sel);  // r0 r1 r2 r3
      const uint32_t g4 = __byte_perm(a[1], b[1], sel);
      const uint32_t b4 = __byte_perm(a[2], b[2], sel);
      // r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3, little-endian
      s_rows[y][3 * t + 0] = __byte_perm(__byte_perm(r4, g4, 0x1040), b4, 0x3410);
      s_rows[y][3 * t + 1] = __byte_perm(__byte_perm(g4, b4, 0x2051), r4, 0x3610);
      s_rows[y][3 * t + 2] = __byte_perm(__byte_perm(b4, r4, 0x3072), g4, 0x3710);
    }
  }
  __syncthreads();
  uint8_t* dst = img + (brow * 4 * w + (int64_t)x0 * 4) * 3;  // row 0 of the run
  const int64_t pitch = (int64_t)w * 3;
  if ((w & 15) == 0 && ((uintptr_t)img & 15) == 0) {
    // nbw is a multiple of 4 here: whole 16-byte pieces, 64 threads a row
    const int y = t >> 6;
    uint4* d4 = (uint4*)(dst + y * pitch);
    const uint4* s4 = (const uint4*)s_rows[y];
    for (int i = t & 63; i < nbw * 3 / 4; i += kThreads / 4) d4[i] = s4[i];
  } else {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      uint32_t* d1 = (uint32_t*)(dst + y * pitch);
      for (int i = t; i < nbw * 3; i += kThreads) d1[i] = s_rows[y][i];
    }
  }
}

}  // namespace

extern "C" {

// img: [l, h, w, 3] uint8 (h, w multiples of 4); out: [l*(h/4)*(w/4), 2] int32.
int uvt_etc1_encode(const void* img, void* out, int l, int h, int w, void* stream) {
  const int64_t runs = (w / 4 + kThreads - 1) / kThreads;
  const int64_t grid = runs * l * (h / 4);
  if (grid > 0)
    etc1_encode_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)img, (int32_t*)out, l, h, w);
  return (int)cudaGetLastError();
}

// words: [l*(h/4)*(w/4), 2] int32, 8-byte aligned; img: [l, h, w, 3] uint8,
// 4-byte aligned.
int uvt_etc1_decode(const void* words, void* img, int l, int h, int w, void* stream) {
  if (((uintptr_t)words & 7) || ((uintptr_t)img & 3)) return (int)cudaErrorMisalignedAddress;
  const int64_t runs = (w / 4 + kThreads - 1) / kThreads;
  const int64_t grid = runs * l * (h / 4);
  if (grid > 0)
    etc1_decode_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, (uint8_t*)img, l, h, w);
  return (int)cudaGetLastError();
}

const char* uvt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int uvt_etc1_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {UVT_KERNEL(etc1_encode_kernel), UVT_KERNEL(etc1_decode_kernel)};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
