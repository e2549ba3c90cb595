// ETC1S palette-build kernels K4, K5 and K6, and the rate sweep's frame
// stage K7, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of uvol_tpu/codecs/basis/etc1s_pallas.py:
//   K4  `_assign_kernel` (assign_endpoints_pallas): per block, the exact
//       clip-aware error against every endpoint, argmin over endpoints;
//   K5  `_inten_kernel` (inten_errors_pallas): per block, the error of its
//       base color under each of the 8 intensity tables;
//   K6  the k-means `_kernel` (kmeans_iter_pallas): one fused Lloyd step,
//       nearest centroid plus per-cluster sums and counts;
// and the fixed-order segment sum that the palette build takes where the
// reference's `_seg_reduce` (uvol_tpu/codecs/basis/etc1s_encode.py:103)
// multiplies one-hot matrices on the MXU (XLA, not a Pallas site).
// K4 and K5 read the [N, 16, 3] uint8 blocks of the segment upload
// directly; the TPU's [N*16, 3] rows, [48, N] lane-major relayout and
// 128-lane endpoint padding have no counterpart here.
//
// K4 and K5 are exact integer arithmetic, as the TPU kernels are by
// construction (every f32 term there is an integer below 2^24): K4 in
// int32, argmin ties to the first minimum with a strict `<`; K5, like the
// TPU kernel, in float32 on those integers.
//
// K4 -- one thread per block, 48 pixel values in registers. The endpoint
// table ([E, 20] int32: per code j the row (-2*me_r, -2*me_g, -2*me_b, q),
// then (-2*base_r, -2*base_g, -2*base_b, 16*|base|^2)) is staged through
// shared memory in chunks of kEpChunk endpoints, so any E fits; every
// thread of a warp reads the same entry (a broadcast). ~450 integer ops
// per (block, endpoint): ~37 G ops for 327,680 blocks x 256 endpoints,
// bound by integer ALU work.
//
// K5 -- one thread per block, float32 where every value is an integer below
// 2^24 (|term| <= 3*255^2 + 6*255^2, a block's sum 16 times that), so the
// arithmetic is exact and an FFMA does the work of an IMAD at twice the
// rate. A CTA stages a tile of 128 blocks (48 bytes each) and their
// bases in shared memory with coalesced 16-byte copies; a thread takes its
// block from there with three conflict-free 16-byte reads and keeps, per pixel,
// D = 2*(base - pixel) per channel, S = D_r + D_g + D_b and A = |S|. A code
// m that clips no channel of the base (base_c + m within 0..255) has
// me = (m, m, m) and the error 3m^2 + m*S: one FFMA where the per-channel
// form |me|^2 + me.D, me_c = clamp(base_c + m) - base_c, takes three; a
// pair +-m with both open has the least 3m^2 - m*A, one FFMA and no
// minimum. Whether a code is open depends on the base only, so it is
// decided once per table and code, and a warp takes a code's short form
// only when all its blocks may (no lane diverges): 4 instructions per
// (pixel, table) with all four codes open, 16 with none, tables 6 and 7
// (l = 106 and 183) clipping for nearly every base. The loop over the
// tables stays rolled (the four forms of a pair, twice, are its body), and
// the block's 8 sums leave as two 16-byte stores. The CTAs are persistent
// (4 per SM) and copy the next tile asynchronously while they work on this
// one: with loads started only between tiles, inputs that the L2 cache does
// not hold (between the calls of a palette build, or any N above ~500,000
// blocks) arrived far below the memory rate. Bound: operations on
// bases near 0 or 255, bytes (92 per block) on mid-range ones.
//
// K6 -- f32, mirroring the TPU kernel's op order: dist = c2[k], then
// + f[j] * (-2*cb[k,j]) for j = 0..3, each step rounded (__fadd_rn /
// __fmul_rn; the library is built with -fmad=false as well), first-minimum
// argmin. Without an FMA each step is two instructions, so K6 cannot pass
// half of its float32 FLOP bound (which counts 8 FLOP per row and
// centroid as 4 FMAs) while it keeps the reference's rounding. One CTA per
// chunk of 1,024 rows, 4 rows per thread; the centroids sit in dynamic
// shared memory sized to k, one 16-byte broadcast load per centroid's
// weights, c2 beside them; the kernel forms both from cb in the order of
// etc1s_cuda.centroid_rows.
//
// The per-cluster sums are DETERMINISTIC (no float atomics) in the fixed
// order of `segment_sum_plain` in codecs/basis/etc1s_cuda.py: rows in
// order within consecutive tiles of kSegTile rows (from 0.0), then tiles
// added pairwise, level by level (adjacent pairs; an odd last tile is
// added to 0.0). That is a complete binary tree over the tiles padded
// with 0.0 to a power of two, which splits into two passes, a chunk of 16
// tiles (1,024 rows) being a level-4 subtree. A sum that starts from +0.0
// is never -0.0 (round to nearest gives -0.0 only for -0.0 + -0.0), so no
// node of the tree is -0.0 and a 0.0 added beside it is an identity:
// every add of the twin is made, and where a segment is absent from a
// chunk, pass 2 adds the twin's 0.0 without reading a root. Counts are
// sums of 1.0, exact below 2^24.
//
// K6's pass 1 (the segment sum's former design, kept: K6 is bound by its
// distances) is
// fused into its assignment kernel: the chunk staged, its keys segment <<
// 10 | row sorted by a bitonic sort over the CTA, and a thread per
// (segment, 4 columns) walks its run through the 16 tiles (each tile's
// sum from 0.0, levels 0..3 as a binary counter); one [k, 5] partial per
// chunk.
//
// The segment sum (`segment_sum`) is bound by bytes: each row's index and
// values read once, the sums written once (85 MB at sel_update's 327,680 x
// 64). Its former pass 1 ran one CTA per (chunk, 16 columns), each sorting the
// chunk's 1,024 keys again, and one thread per (segment, 4 columns)
// walked its run through all 16 tiles serially: up to 1,024 dependent
// adds on a hot segment, 3 threads of 256 busy at k = 1. This pass 1
// (seg_sum_chunk_kernel) takes one CTA of kSegThreads per chunk, every
// column. The copies of the first two column groups (at most 16 columns,
// 4-byte or 16-byte cp.async) start at once; meanwhile each warp sorts one
// tile's 64 keys in registers (no CTA barrier) and lists the tile's runs;
// one warp scans the present segments' bits (a slot each) and the tiles'
// run counts, and each run goes to the chunk's run list and under its
// (slot, tile). Then per group, double buffered (group g + 2 is copied
// while g + 1 is summed): a thread per (run, 4 columns) adds the run's
// rows in order from 0.0 (at most 64 dependent adds) and writes the sum
// over the run's first row; a thread per (segment, 4 columns) takes
// levels 0..3 over the 16 tiles, an absent tile adding 0.0, and writes
// the chunk's [k, d] partial (0.0 for an absent segment). At D = 64 two
// buffers of 64 KB leave one CTA an SM; groups of 8 columns and 256 or
// 1,024 threads measured no faster overall
// (examples/torch_segsum_variants.py), and roots written only for the
// segments a chunk holds made pass 2 slower than the dense reads it
// saved (PERF.md section 6).
//
// Wider sums than kSegMaxK segments (K6: centroids) go by windows of
// kSegMaxK segments, two launches a window: a window's pass 1 drops the
// rows of other segments, and a segment's partials depend only on its own
// rows in tile order, so the bits are those of one launch; each window
// reads the rows again. K6's window 0 assigns every row (the centroids
// staged kKmChunk at a time, the first minimum carried across chunks) and
// writes the assignment; its later windows read it back.
//
// Pass 2 (seg_sum_tree_kernel, K6's and the segment sum's): the levels
// above, over the chunk partials of each element: a CTA reduces 32
// consecutive elements (coalesced reads) in pieces of 256 leaves in
// shared memory, then the piece roots; 32 threads an element below
// kTreeSmallE elements, where a call is latency-bound, else 8. Two
// launches per call whatever n, and a scratch of ceil(n/1024) x k x d
// floats. PERF.md section 6 has the measured times.
//
// K7 -- the delta-aware stage's rate sweep, one frame per launch: the
// reference's `_rate_sweep_fn` frame body (uvol_tpu/codecs/basis/
// etc1s_encode.py:1211-1330, an XLA product and lax.scan, not a Pallas site).
// Each block prices every palette entry e under its own selector codes:
// cost = fma(lam, bits[dm], err(b, e)) with dm = (e - left) mod E (a floor
// modulo), left the FINAL choice of the block to its left (column 0: its own
// incoming entry), bits[dm] at most 1.4 for the incoming entry of the block
// above (row 0: its own); the first minimum wins unless conditional
// replenishment costs no more (e_prev + lam / 2 where the frame has a
// previous one). Then a CR block takes the previous selector, and each
// patterned block (incoming selector not the uniform row) the previous pair
// where e_prev <= fma(lam_cr, e_new, 64). Columns depend on each other, rows
// do not: one CTA per block row, 32 * ceil(E / 128) threads, thread t
// pricing entries t + j * blockDim.x, j < 4.
//   - errors: err = |p|^2 + sum_c n_c |col(e, c)|^2 - 2 sum_v S_v col_v(e),
//     S_v the block's per-code, per-channel pixel sums (v = 3c + ch, at most
//     16 * 255: 16 bits) and col the entry's clipped decoded colors (8 bits).
//     A thread keeps its 4 entries in registers (3 words of color bytes and
//     4 squares each), a block's features come as 16-bit pairs, and the 12
//     color products are 6 __dp2a: 11 integer instructions a (block, entry).
//     Exact in int32; the reference's float32 [nb, 16] x [16, E] product
//     holds the same integers (every partial sum below 2^24 in magnitude), so
//     the float32 conversion of the int32 result is its value bit for bit,
//     and no [nb, E] tile is written or read;
//   - a pass over up to 256 columns of the row first stages, a thread per
//     block, each block's features, its above and previous entries, e_prev
//     (the exact pair error of the previous pair) and its CR cost in shared
//     memory: the column loop then makes no global load;
//   - one barrier per column: each warp's first minimum of (cost, entry) --
//     the least of the costs' bits in float order, then the least entry that
//     holds it, two redux.sync reductions -- goes to a double-buffered shared
//     array, and after the barrier every warp reduces the warps' minima the
//     same way and makes the CR decision itself, so the new left entry needs
//     no second barrier; the next column's errors, which do not depend on
//     it, are computed before the barrier; left is an entry, so dm needs no
//     division;
//   - the epilogue, a thread per block, computes e_new and the snap.
// Shared memory (static): bits 8 KB, 256 blocks' features 12 KB, 5 per-block
// words 5 KB, CR flags and keys 0.5 KB. Above kSweepMaxE = 2,048 entries the
// palette does not fit a CTA's registers (7 words an entry): the wide path
// (kWide) takes 512 threads, each pricing every 512th entry per column, reads
// the entries from a table of 32 bytes an entry that sweep_table_kernel
// writes first (L1/L2 resident: 128 KB at 4,096 entries), and stages the
// bits in 4 * E bytes of dynamic shared memory; the per-column first minimum
// of (cost bits, entry) is unchanged. The FMAs are
// __fmaf_rn, as XLA contracts them on the CPU. Bound: operations, 21 a
// (block, entry) (the 11 above, the table index and its load, the ABOVE
// test, the FMA, the running minimum); its bytes (blocks, palette,
// assignments) are ~5 MB a 1024^2 frame.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "func_attrs.cuh"

namespace {

// uvol_tpu.codecs.basis.transcoder.INTEN_TABLES: table t is (-l, -s, s, l)
__constant__ float kIntenSmall[8] = {2.f, 5.f, 9.f, 13.f, 18.f, 24.f, 33.f, 47.f};
__constant__ float kIntenLarge[8] = {8.f, 17.f, 29.f, 42.f, 60.f, 80.f, 106.f, 183.f};

constexpr int kThreads = 256;
constexpr int kIntenThreads = 128;  // K5: blocks (threads) per tile
constexpr int kIntenCtasPerSm = 4;  // K5: resident CTAs per SM (up to 128 registers a thread)
constexpr int kEpChunk = 256;   // endpoints per shared-memory chunk: 20 KB
constexpr int kSegTile = 64;    // rows per fixed-order partial sum
constexpr int kSegMaxK = 2048;  // segments one pass-1 launch sums: wider sums go by windows
constexpr int kKmCols = 5;      // K6's 4 features ++ 1.0 (the count)
constexpr int kKmChunk = 2048;  // K6: centroids staged in shared memory at a time

// ---- K5 ---------------------------------------------------------------

// The error of a code that clips: k + a.D with a_c = clamp(base_c + m) -
// base_c (lo = -base, hi = 255 - base) and k = |a|^2.
struct ClippedCode {
  float k, a[3];
};

__device__ __forceinline__ ClippedCode clipped_code(float m, const float (&lo)[3],
                                                    const float (&hi)[3]) {
  ClippedCode f;
#pragma unroll
  for (int c = 0; c < 3; ++c) f.a[c] = fminf(fmaxf(m, lo[c]), hi[c]);
  f.k = __fmaf_rn(f.a[2], f.a[2], __fmaf_rn(f.a[1], f.a[1], __fmul_rn(f.a[0], f.a[0])));
  return f;
}

// How a pair of codes +-m is scored: by which of the two clips no channel
// of any base of the warp.
enum PairForm { kBothOpen, kPlusOpen, kMinusOpen, kNoneOpen };

// least[p] = the least of the errors of codes +m and -m at pixel p. D, S, A
// as in the kernel's note.
template <PairForm kForm>
__device__ __forceinline__ void pair_least(float m, const float (&D)[16][3],
                                           const float (&S)[16], const float (&A)[16],
                                           const float (&lo)[3], const float (&hi)[3],
                                           float (&least)[16]) {
  const float q = __fmul_rn(__fmul_rn(3.f, m), m);
  if (kForm == kBothOpen) {
#pragma unroll
    for (int p = 0; p < 16; ++p) least[p] = __fmaf_rn(A[p], -m, q);
    return;
  }
  ClippedCode plus, minus;
  if (kForm != kPlusOpen) plus = clipped_code(m, lo, hi);
  if (kForm != kMinusOpen) minus = clipped_code(-m, lo, hi);
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const float ep =
        kForm == kPlusOpen
            ? __fmaf_rn(S[p], m, q)
            : __fmaf_rn(plus.a[2], D[p][2],
                        __fmaf_rn(plus.a[1], D[p][1], __fmaf_rn(plus.a[0], D[p][0], plus.k)));
    const float em =
        kForm == kMinusOpen
            ? __fmaf_rn(S[p], -m, q)
            : __fmaf_rn(minus.a[2], D[p][2],
                        __fmaf_rn(minus.a[1], D[p][1], __fmaf_rn(minus.a[0], D[p][0], minus.k)));
    least[p] = fminf(ep, em);
  }
}

// pair_least in the form the warp's bases allow: +m is open for a block
// when bmax <= 255 - m, -m when bmin >= m.
__device__ __forceinline__ void pair_least_any(float m, float bmin, float bmax,
                                               const float (&D)[16][3], const float (&S)[16],
                                               const float (&A)[16], const float (&lo)[3],
                                               const float (&hi)[3], float (&least)[16]) {
  const bool plus = __all_sync(0xffffffffu, bmax <= 255.f - m);
  const bool minus = __all_sync(0xffffffffu, bmin >= m);
  if (plus && minus)
    pair_least<kBothOpen>(m, D, S, A, lo, hi, least);
  else if (plus)
    pair_least<kPlusOpen>(m, D, S, A, lo, hi, least);
  else if (minus)
    pair_least<kMinusOpen>(m, D, S, A, lo, hi, least);
  else
    pair_least<kNoneOpen>(m, D, S, A, lo, hi, least);
}

// Starts the copy of tile `tile` (kIntenThreads blocks and their bases)
// into shared memory: asynchronous 16-byte pieces where the tile's bytes
// are 16-byte aligned, plain byte loads otherwise.
__device__ __forceinline__ void stage_inten_tile(const uint8_t* __restrict__ blocks,
                                                 const int32_t* __restrict__ base, int n,
                                                 int tile, uint32_t* s_px, int32_t* s_base) {
  const int64_t blk0 = (int64_t)tile * kIntenThreads;
  const int cnt = (int)min((int64_t)kIntenThreads, n - blk0);
  const int tid = threadIdx.x;
  const uint8_t* src = blocks + blk0 * 48;
  if (((uintptr_t)src & 15) == 0) {
    for (int i = tid; i < cnt * 3; i += kIntenThreads)
      __pipeline_memcpy_async((uint4*)s_px + i, (const uint4*)src + i, 16);
  } else {
    for (int i = tid; i < cnt * 48; i += kIntenThreads) ((uint8_t*)s_px)[i] = src[i];
  }
  for (int i = tid; i < cnt * 3; i += kIntenThreads)
    __pipeline_memcpy_async(s_base + i, base + blk0 * 3 + i, 4);
}

// One thread per block, a tile of kIntenThreads blocks at a time; a CTA
// walks the tiles blockIdx.x, + gridDim.x, ... and copies the next tile into
// the other half of its shared memory while it works on this one, so the
// loads of a tile hide behind the arithmetic of the one before. base holds
// 8-bit colors (0..255): the float32 arithmetic is exact there. out must
// be 16-byte aligned.
__global__ void __launch_bounds__(kIntenThreads, kIntenCtasPerSm)
inten_errors_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ base,
                    int32_t* __restrict__ out, int n) {
  __shared__ __align__(16) uint32_t s_px[2][kIntenThreads * 12];
  __shared__ __align__(16) int32_t s_base[2][kIntenThreads * 3];
  __shared__ __align__(16) int32_t s_sums[kIntenThreads * 8];
  const int tiles = (n + kIntenThreads - 1) / kIntenThreads;
  const int tid = threadIdx.x;
  int32_t* sums = s_sums + 8 * tid;  // this thread's own: no barrier guards it
  stage_inten_tile(blocks, base, n, blockIdx.x, s_px[0], s_base[0]);
  __pipeline_commit();
  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + (int)gridDim.x < tiles)
      stage_inten_tile(blocks, base, n, tile + gridDim.x, s_px[buf ^ 1], s_base[buf ^ 1]);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // all but the copy just started: this tile has landed
    __syncthreads();
    const int64_t blk0 = (int64_t)tile * kIntenThreads;
    // a lane past n works on black pixels under a mid-gray base (every code
    // but +-183 open) and writes nothing: every lane of a warp must reach
    // the votes
    const bool live = blk0 + tid < n;
    float b[3], lo[3], hi[3], b2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = live ? (float)s_base[buf][3 * tid + c] : 128.f;
      lo[c] = -b[c];
      hi[c] = 255.f - b[c];
      b2[c] = __fadd_rn(__fmul_rn(2.f, b[c]), 16777216.f);
    }
    uint32_t wd[12];  // the block's 48 bytes: pixel k / 3, channel k % 3 at byte k
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint4 q = live ? ((const uint4*)s_px[buf])[3 * tid + j] : make_uint4(0u, 0u, 0u, 0u);
      wd[4 * j + 0] = q.x;
      wd[4 * j + 1] = q.y;
      wd[4 * j + 2] = q.z;
      wd[4 * j + 3] = q.w;
    }
    __syncthreads();  // this half is read: the next pass copies into it
    // a byte v becomes the float 2^23 + v by a byte permute into 2^23's low
    // mantissa byte (no integer conversion); D = 2*base + 2^24 - 2*(2^23 + v),
    // every step exact (even integers below 2^25)
    float D[16][3], S[16], A[16];
#pragma unroll
    for (int k = 0; k < 48; ++k) {
      const float v = __uint_as_float(__byte_perm(wd[k >> 2], 0x4B000000u, 0x7440u | (k & 3)));
      D[k / 3][k % 3] = __fmaf_rn(v, -2.f, b2[k % 3]);
    }
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      S[p] = __fadd_rn(__fadd_rn(D[p][0], D[p][1]), D[p][2]);
      A[p] = fabsf(S[p]);
    }
    const float bmin = fminf(fminf(b[0], b[1]), b[2]), bmax = fmaxf(fmaxf(b[0], b[1]), b[2]);
#pragma unroll 1
    for (int t = 0; t < 8; ++t) {
      float small[16], large[16];
      pair_least_any(kIntenSmall[t], bmin, bmax, D, S, A, lo, hi, small);
      pair_least_any(kIntenLarge[t], bmin, bmax, D, S, A, lo, hi, large);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: the adds need not wait on each other
#pragma unroll
      for (int p = 0; p < 16; ++p) acc[p & 3] = __fadd_rn(acc[p & 3], fminf(small[p], large[p]));
      sums[t] = __float2int_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])));
    }
    if (live) {
      int4* o = (int4*)out + (blk0 + tid) * 2;
      o[0] = ((const int4*)sums)[0];
      o[1] = ((const int4*)sums)[1];
    }
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

// ---- fixed-order segment sum, and K6 on top of it ----------------------

constexpr int kChunkTiles = 16;                     // tiles per pass-1 chunk (2^4)
constexpr int kChunkLevels = 4;                     // log2(kChunkTiles)
constexpr int kChunkRows = kChunkTiles * kSegTile;  // 1,024 rows
constexpr int kTreeCols = 32;                       // pass-2 elements per CTA
constexpr int kTreeRows = 8;                        // pass-2 threads per element
constexpr int kTreeRowsSmall = 32;                  // ... where e < kTreeSmallE: latency-bound
constexpr int kTreeSmallE = 1 << 14;
constexpr int kTreePiece = 256;                     // pass-2 leaves per round in shared memory
constexpr int kTreeMaxPieces = 64;                  // rounds: n <= 2^24 rows
constexpr int kSegMaxRows = kChunkRows * kTreePiece * kTreeMaxPieces;

// Shared memory of one pass-1 chunk of K6: `pitch` is a power of two >=
// the columns held, `k` the segment count.
struct ChunkSmem {
  float* x;      // [kChunkRows][pitch] the chunk's values
  int* key;      // [kChunkRows] segment << 10 | row (kNoSegment for none), then sorted
  short* start;  // [k] first position of each segment in the sorted keys, -1 where absent
};

constexpr int kRowBits = 10;  // kChunkRows = 2^10
constexpr int kNoSegment = kSegMaxK << kRowBits;  // sorts after every segment of a window

__host__ __device__ inline size_t chunk_smem_bytes(int pitch, int k) {
  return (size_t)kChunkRows * (pitch * 4 + 4) + (size_t)k * 2;
}

__device__ inline ChunkSmem chunk_smem(unsigned char* base, int pitch, int k) {
  ChunkSmem s;
  s.x = (float*)base;
  s.key = (int*)(s.x + kChunkRows * pitch);
  s.start = (short*)(s.key + kChunkRows);
  for (int i = threadIdx.x; i < k; i += blockDim.x) s.start[i] = -1;
  return s;
}

// Bitonic sort of the chunk's kChunkRows keys, ascending. Thread t holds
// keys t + kThreads*j (j = 0..3) in registers: a stride of kThreads or more
// pairs two keys of one thread, strides of 32..kThreads/2 go through
// shared memory, strides below 32 through warp shuffles.
__device__ void sort_keys(int* key) {
  constexpr int kPer = kChunkRows / kThreads;
  const int tid = threadIdx.x;
  int v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = key[tid + kThreads * j];
#pragma unroll
  for (int size = 2; size <= kChunkRows; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      int w[kPer];
      if (stride >= 32 && stride < kThreads) {
        __syncthreads();  // the last exchange's reads are done
#pragma unroll
        for (int j = 0; j < kPer; ++j) key[tid + kThreads * j] = v[j];
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + kThreads * j;
        const int b = stride >= kThreads ? v[j ^ (stride / kThreads)]
                      : stride >= 32     ? key[i ^ stride]
                                         : __shfl_xor_sync(0xffffffffu, v[j], stride);
        // the lower index of an ascending pair keeps the smaller key
        const bool keep_min = ((i & stride) == 0) == ((i & size) == 0);
        w[j] = keep_min ? min(v[j], b) : max(v[j], b);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] = w[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) key[tid + kThreads * j] = v[j];
  __syncthreads();
}

// Pass 1 of the fixed-order sum over one chunk whose keys and values are
// staged: per segment and column, each tile's in-order sum from 0.0, then
// the twin's pairwise levels 0..3 over the chunk's 16 tiles (a tile
// without the segment is 0.0). Writes the chunk's [k][cols] partial to
// out (row stride ld). pitch = 2^lp >= 4.
__device__ void chunk_sums(const ChunkSmem& s, int lp, int cols, int k,
                           float* __restrict__ out, int ld) {
  // 1. sort the keys: each segment's rows become one run, in row order;
  //    the run's first position goes to start[]
  sort_keys(s.key);
  for (int p = threadIdx.x; p < kChunkRows; p += blockDim.x) {
    const int seg = s.key[p] >> kRowBits;
    if (seg < k && (p == 0 || (s.key[p - 1] >> kRowBits) != seg)) s.start[seg] = (short)p;
  }
  __syncthreads();
  // 2. per (segment, 4 columns): walk the segment's run, tile by tile, and
  //    carry the tile sums through a binary counter (pend[l] waits for its
  //    right sibling); t = 15 carries to the chunk's root
  const int lq = lp - 2;
  const float4* x4 = (const float4*)s.x;
  for (int i = threadIdx.x; i < k << lq; i += blockDim.x) {
    const int seg = i >> lq, q = i & ((1 << lq) - 1);
    if (4 * q >= cols) continue;
    int p = s.start[seg];
    float node[4] = {0.f, 0.f, 0.f, 0.f};
    if (p >= 0) {
      int key = s.key[p];
      const int end = (seg + 1) << kRowBits;  // the keys of this segment are below
      float pend[kChunkLevels][4];
#pragma unroll
      for (int t = 0; t < kChunkTiles; ++t) {
#pragma unroll
        for (int c = 0; c < 4; ++c) node[c] = 0.f;
        const int lim = min(end, (seg << kRowBits) + (t + 1) * kSegTile);
        while (key < lim) {  // the next key is read ahead of the add
          const float4 v = x4[((key & (kChunkRows - 1)) << lq) + q];
          key = ++p < kChunkRows ? s.key[p] : kNoSegment;
          node[0] = __fadd_rn(node[0], v.x);
          node[1] = __fadd_rn(node[1], v.y);
          node[2] = __fadd_rn(node[2], v.z);
          node[3] = __fadd_rn(node[3], v.w);
        }
#pragma unroll
        for (int l = 0; l < kChunkLevels; ++l) {
          if (!((t >> l) & 1)) {
#pragma unroll
            for (int c = 0; c < 4; ++c) pend[l][c] = node[c];
            break;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) node[c] = __fadd_rn(pend[l][c], node[c]);
        }
      }
    }
    float* o = out + (int64_t)seg * ld + 4 * q;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * q + c < cols) o[c] = node[c];
  }
}

// Pass 2 (K6 and the segment sum): the twin's remaining levels over the m
// chunk partials of each of e elements (part: [m, e]; out: [e]) -- a
// complete binary tree over p = 2^ceil(log2 m) leaves, leaves >= m being
// 0.0. A CTA takes kTreeCols consecutive elements (coalesced reads) with
// kRows threads each and reduces aligned pieces of up to kTreePiece
// leaves in shared memory, then the piece roots.
template <int kRows>  // at most 32 registers: 2,048 threads an SM, as with 8 rows untemplated
__global__ void __launch_bounds__(kTreeCols * kRows, 2048 / (kTreeCols * kRows))
    seg_sum_tree_kernel(const float* __restrict__ part, int m, int64_t e,
                        float* __restrict__ out) {
  __shared__ float s_leaf[kTreePiece][kTreeCols];
  __shared__ float s_root[kTreeMaxPieces][kTreeCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t el = (int64_t)blockIdx.x * kTreeCols + tx;
  int p = 1;
  while (p < m) p <<= 1;
  const int piece = min(p, kTreePiece), pieces = p / piece;
  for (int pc = 0; pc < pieces; ++pc) {
    const int leaf0 = pc * piece;
    if (leaf0 >= m) {  // a piece of absent chunks: its root is 0.0
      if (ty == 0) s_root[pc][tx] = 0.f;
      continue;
    }
    for (int j = ty; j < piece; j += kRows) {
      const int leaf = leaf0 + j;
      s_leaf[j][tx] = (leaf < m && el < e) ? part[(int64_t)leaf * e + el] : 0.f;
    }
    __syncthreads();
    for (int w = 1; w < piece; w *= 2) {  // level by level, in place
      for (int j = ty * 2 * w; j < piece; j += kRows * 2 * w)
        s_leaf[j][tx] = __fadd_rn(s_leaf[j][tx], s_leaf[j + w][tx]);
      __syncthreads();
    }
    if (ty == 0) s_root[pc][tx] = s_leaf[0][tx];
    __syncthreads();  // s_leaf is refilled by the next piece
  }
  __syncthreads();
  for (int w = 1; w < pieces; w *= 2) {  // the levels above the pieces
    for (int j = ty * 2 * w; j < pieces; j += kRows * 2 * w)
      s_root[j][tx] = __fadd_rn(s_root[j][tx], s_root[j + w][tx]);
    __syncthreads();
  }
  if (ty == 0 && el < e) out[el] = s_root[0][tx];
}

// -- the segment sum's pass 1: each tile's keys sorted in one warp, the
// chunk's present segments found once, the column groups streamed through
// two shared-memory buffers.

constexpr int kSegThreads = 512;          // pass-1 threads per CTA
constexpr int kSegGroupCols = 16;         // most columns of a staged group
constexpr int kSegWords = kSegMaxK / 32;  // presence words of a chunk, at most
constexpr int kSegMaxSlots = kChunkRows;  // present segments of a chunk, at most
constexpr int kRunLenShift = 10;          // a run: first position | length << 10

// Shared memory of a pass-1 CTA, for `slots` = min(k, kSegMaxSlots)
// present segments at most, in this order (each size a multiple of 16
// bytes): the keys, sorted within each tile; each tile's runs (first
// position | length << 10, in tile order, tile t's from [64 t]); the same
// runs as one list; the presence bits, and the slots before each word; the
// runs a tile holds and those before it; per slot (a present segment, in
// segment order) the tiles that hold it and the first row of its run in
// each; then one or two staged column groups of kChunkRows rows at `pitch`
// floats.
struct SegSmem {
  int* key;        // [kChunkRows] segment << 10 | row (kNoSegment for none)
  int* tile_run;   // [kChunkRows]
  int* run;        // [kChunkRows]
  unsigned* bits;  // [kSegWords]
  int* base;       // [kSegWords]
  int* tiles;      // [2 * kChunkTiles]: the runs of each tile, then the runs before it
  int* mask;       // [slots] a bit per tile
  short* run_row;  // [slots][kChunkTiles], valid where mask has the tile's bit
  float* x;        // [nbuf][kChunkRows][pitch]
};

__host__ __device__ inline size_t seg_meta_bytes(int slots) {
  const size_t s8 = (size_t)((slots + 7) & ~7);
  return kChunkRows * 12 + kSegWords * 8 + kChunkTiles * 8 + s8 * 4 + s8 * 2 * kChunkTiles;
}

__device__ inline SegSmem seg_smem(unsigned char* base, int slots) {
  SegSmem s;
  s.key = (int*)base;
  s.tile_run = s.key + kChunkRows;
  s.run = s.tile_run + kChunkRows;
  s.bits = (unsigned*)(s.run + kChunkRows);
  s.base = (int*)(s.bits + kSegWords);
  s.tiles = s.base + kSegWords;
  s.mask = s.tiles + 2 * kChunkTiles;
  s.run_row = (short*)(s.mask + ((slots + 7) & ~7));
  s.x = (float*)(base + seg_meta_bytes(slots));
  return s;
}

// Starts the copies of rows [row0, row0 + rows) x columns [c0, c0 + cols)
// of x ([*, d] f32) into dst ([kChunkRows][pitch]): 16-byte copies where
// `vec` (d, c0 and cols multiples of 4, x 16-byte aligned), else 4-byte
// ones; a row's copies go by a power of two 2^lc >= their count. Nothing
// else is written: the walks read only rows with a key, and a column past
// cols only into a result that is not stored.
__device__ __forceinline__ void stage_group(const float* __restrict__ x, int d, int64_t row0,
                                            int rows, int c0, int cols, int pitch, int lc,
                                            bool vec, float* dst) {
  const int per = vec ? cols >> 2 : cols, width = vec ? 4 : 1, mask = (1 << lc) - 1;
  for (int i = threadIdx.x; i < rows << lc; i += kSegThreads) {
    const int r = i >> lc, c = (i & mask) * width;
    if ((i & mask) >= per) continue;
    if (vec)
      __pipeline_memcpy_async(dst + r * pitch + c, x + (row0 + r) * d + c0 + c, 16);
    else
      __pipeline_memcpy_async(dst + r * pitch + c, x + (row0 + r) * d + c0 + c, 4);
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// Bitonic sort of one tile's 64 keys by one warp, ascending: lane l holds
// keys l (v0) and l + 32 (v1); the stride 32 pairs a lane's two keys, the
// others go through shuffles.
__device__ __forceinline__ void sort_tile(int& v0, int& v1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64: ascending
        const int lo = min(v0, v1);
        v1 = max(v0, v1);
        v0 = lo;
        continue;
      }
      const int b0 = __shfl_xor_sync(0xffffffffu, v0, stride);
      const int b1 = __shfl_xor_sync(0xffffffffu, v1, stride);
      // the lower index of an ascending pair keeps the smaller key
      const bool min0 = ((lane & stride) == 0) == ((lane & size) == 0);
      const bool min1 = ((lane & stride) == 0) == (((lane + 32) & size) == 0);
      v0 = min0 ? min(v0, b0) : max(v0, b0);
      v1 = min1 ? min(v1, b1) : max(v1, b1);
    }
  }
}

// Pass 1 of `segment_sum`: one CTA per chunk of kChunkRows rows, every
// column, over the window of k <= kSegMaxK segments from seg0: segment
// seg0 + s is the window's s. idx: [n] int32 (rows outside the window are
// dropped); x: [n, d] f32,
// read in `groups` groups of dc columns (the last may hold fewer), each
// staged at a pitch of 4 * ceil(dc / 4) floats; lq = log2 of a power of two
// >= dc / 4 (the quads a walk item takes), lc that of the copies a staged
// row takes; part: [m, k, d] chunk partials (0.0 for a segment the chunk
// does not hold).
__global__ void __launch_bounds__(kSegThreads)
    seg_sum_chunk_kernel(const int32_t* __restrict__ idx, const float* __restrict__ x, int n,
                         int d, int k, int seg0, int dc, int groups, int pitch, int lq, int lc,
                         bool vec, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slots = min(k, kSegMaxSlots);
  const SegSmem s = seg_smem(smem, slots);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * kChunkRows;
  const int rows = (int)min((int64_t)kChunkRows, (int64_t)n - row0);
  const int kw = (k + 31) >> 5, nq = 1 << lq, buf = kChunkRows * pitch;
  // 1. the copies of the first two column groups start now and land while
  //    the keys are sorted; one commit per group, an empty one past the last
  stage_group(x, d, row0, rows, 0, min(dc, d), pitch, lc, vec, s.x);
  __pipeline_commit();
  if (groups > 1) stage_group(x, d, row0, rows, dc, min(dc, d - dc), pitch, lc, vec, s.x + buf);
  __pipeline_commit();
  for (int i = tid; i < kw; i += kSegThreads) s.bits[i] = 0u;
  for (int i = tid; i < slots; i += kSegThreads) s.mask[i] = 0;
  __syncthreads();
  // 2. per tile, one warp: the keys segment << 10 | row sorted, so that each
  //    segment's rows of the tile are one run in row order; the tile's runs
  //    in order, and the present segments' bits
  for (int t = warp; t < kChunkTiles; t += kSegThreads / 32) {
    int v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = t * kSegTile + 32 * j + lane;
      const unsigned sg = r < rows ? (unsigned)idx[row0 + r] - (unsigned)seg0 : ~0u;
      v[j] = sg < (unsigned)k ? ((int)sg << kRowBits | r) : kNoSegment;
    }
    sort_tile(v[0], v[1]);
    // a run starts where the segment changes (no segment counts as one)
    const int up0 = __shfl_up_sync(0xffffffffu, v[0], 1);
    const int up1 = __shfl_up_sync(0xffffffffu, v[1], 1);
    const int last0 = __shfl_sync(0xffffffffu, v[0], 31);
    const int prev[2] = {lane ? up0 : -1, lane ? up1 : last0};
    bool start[2], live[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      start[j] = (prev[j] >> kRowBits) != (v[j] >> kRowBits);
      live[j] = start[j] && v[j] < kNoSegment;
    }
    const uint64_t starts = (uint64_t)__ballot_sync(0xffffffffu, start[0]) |
                            (uint64_t)__ballot_sync(0xffffffffu, start[1]) << 32;
    const uint64_t runs = (uint64_t)__ballot_sync(0xffffffffu, live[0]) |
                          (uint64_t)__ballot_sync(0xffffffffu, live[1]) << 32;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = 32 * j + lane, p = t * kSegTile + i;
      s.key[p] = v[j];
      if (live[j]) {
        const uint64_t after = (starts >> i) >> 1;  // the starts past i
        const int len = after ? __ffsll((long long)after) : kSegTile - i;
        const int rank = __popcll(runs & ((1ull << i) - 1));
        s.tile_run[t * kSegTile + rank] = p | len << kRunLenShift;
        atomicOr(s.bits + (v[j] >> (kRowBits + 5)), 1u << ((v[j] >> kRowBits) & 31));
      }
    }
    if (lane == 0) s.tiles[t] = __popcll(runs);
  }
  __syncthreads();
  // 3. one warp: the slots before each presence word (a present segment's
  //    slot is its rank among them) and the runs before each tile; then each
  //    run goes to the chunk's run list and under its (slot, tile)
  if (warp == 0) {
    int total = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int w = 32 * j + lane, c = w < kw ? __popc(s.bits[w]) : 0;
      int inc = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      if (w < kw) s.base[w] = total + inc - c;
      total += __shfl_sync(0xffffffffu, inc, 31);
    }
    const int c = lane < kChunkTiles ? s.tiles[lane] : 0;
    int inc = c;
#pragma unroll
    for (int o = 1; o < kChunkTiles; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane < kChunkTiles) s.tiles[kChunkTiles + lane] = inc - c;
  }
  __syncthreads();
  const int nruns = s.tiles[2 * kChunkTiles - 1] + s.tiles[kChunkTiles - 1];
  for (int i = tid; i < kChunkRows; i += kSegThreads) {
    const int t = i / kSegTile, r = i % kSegTile;
    if (r >= s.tiles[t]) continue;
    const int rp = s.tile_run[i], kp = s.key[rp & (kChunkRows - 1)];
    const int seg = kp >> kRowBits, w = seg >> 5;
    const int slot = s.base[w] + __popc(s.bits[w] & ((1u << (seg & 31)) - 1));
    s.run[s.tiles[kChunkTiles + t] + r] = rp;
    s.run_row[slot * kChunkTiles + t] = (short)(kp & (kChunkRows - 1));
    atomicOr(s.mask + slot, 1 << t);
  }
  // 4. per column group: each run's in-order sum from 0.0 (a thread per
  //    (run, 4 columns): at most 64 dependent adds), written over its first
  //    row; then per (segment, 4 columns) the twin's levels 0..3 over the 16
  //    tiles, an absent tile adding 0.0, written as the chunk's partial (0.0
  //    for a segment the chunk does not hold); then the copies of the group
  //    two ahead into the buffer just read
  for (int g = 0; g < groups; ++g) {
    __pipeline_wait_prior(1);  // all but the last commit: group g has landed
    __syncthreads();
    float* xb = s.x + (g & 1) * buf;
    const int c0 = g * dc, cols = min(dc, d - c0);
    for (int i = tid; i < nruns << lq; i += kSegThreads) {
      const int q = i & (nq - 1), rp = s.run[i >> lq];
      if (4 * q >= cols) continue;
      const int p = rp & (kChunkRows - 1), len = rp >> kRunLenShift;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < len; ++j)
        acc = add4(acc, *(const float4*)(xb + (s.key[p + j] & (kChunkRows - 1)) * pitch + 4 * q));
      *(float4*)(xb + (s.key[p] & (kChunkRows - 1)) * pitch + 4 * q) = acc;
    }
    __syncthreads();
    for (int i = tid; i < k << lq; i += kSegThreads) {
      const int seg = i >> lq, q = i & (nq - 1), w = seg >> 5;
      if (4 * q >= cols) continue;
      const unsigned bw = s.bits[w], bit = 1u << (seg & 31);
      float4 node = make_float4(0.f, 0.f, 0.f, 0.f);
      if (bw & bit) {
        const int slot = s.base[w] + __popc(bw & (bit - 1)), tiles = s.mask[slot];
        const short* rr = s.run_row + slot * kChunkTiles;
        float4 pend[kChunkLevels];
#pragma unroll
        for (int t = 0; t < kChunkTiles; ++t) {
          node = make_float4(0.f, 0.f, 0.f, 0.f);
          if ((tiles >> t) & 1) node = *(const float4*)(xb + rr[t] * pitch + 4 * q);
#pragma unroll
          for (int l = 0; l < kChunkLevels; ++l) {
            if (!((t >> l) & 1)) {
              pend[l] = node;
              break;
            }
            node = add4(pend[l], node);
          }
        }
      }
      float* o = part + ((int64_t)blockIdx.x * k + seg) * d + c0 + 4 * q;
      if (vec) {
        *(float4*)o = node;
      } else {
        const float v[4] = {node.x, node.y, node.z, node.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * q + c < cols) o[c] = v[c];
      }
    }
    __syncthreads();  // the buffer is read: the group two ahead may land there
    if (g + 2 < groups)
      stage_group(x, d, row0, rows, (g + 2) * dc, min(dc, d - (g + 2) * dc), pitch, lc, vec,
                  s.x + (g & 1) * buf);
    __pipeline_commit();
  }
}

// K6: one CTA per chunk of kChunkRows rows. The nearest centroid of each
// row (4 rows per thread, each centroid's weights one 16-byte shared
// load, c2 beside them; the centroids staged kKmChunk at a time, the first
// minimum carried from chunk to chunk), then pass 1 of the fixed-order sum
// of [feats, 1.0] by assignment over the window of kw <= kSegMaxK segments
// from seg0. The launch of window 0 computes the assignment and writes
// `assign`; those of later windows (k > kSegMaxK) read it back. cb: [k]
// float4 centroids; part: [m, kw, 5].
__global__ void kmeans_chunk_kernel(const float4* __restrict__ feats,
                                    const float4* __restrict__ cb, int n, int k, int seg0,
                                    int kw, float* __restrict__ part, int32_t* __restrict__ assign) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc_max = min(k, kKmChunk);
  float4* s_w = (float4*)smem;
  float* s_c2 = (float*)(s_w + kc_max);
  constexpr int kPitchLog = 3;  // kKmCols = 5 columns in a pitch of 8
  const ChunkSmem s = chunk_smem((unsigned char*)(s_c2 + ((kc_max + 3) & ~3)), 1 << kPitchLog, kw);

  constexpr int kRows = kChunkRows / kThreads;
  const int64_t row0 = (int64_t)blockIdx.x * kChunkRows;
  float4 f[kRows];
  float best[kRows];
  int bi[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int64_t g = row0 + q * kThreads + threadIdx.x;
    f[q] = g < n ? feats[g] : make_float4(0.f, 0.f, 0.f, 0.f);
    best[q] = 0.f;
    bi[q] = g < n && seg0 > 0 ? assign[g] : 0;
  }
  for (int c0 = 0; seg0 == 0 && c0 < k; c0 += kKmChunk) {
    const int kc = min(kKmChunk, k - c0);
    if (c0) __syncthreads();  // the last chunk's centroids are read
    // the rows of etc1s_cuda.centroid_rows: -2*cb, and c2 summed in order
    for (int j = threadIdx.x; j < kc; j += blockDim.x) {
      const float4 c = cb[c0 + j];
      s_w[j] = make_float4(__fmul_rn(-2.f, c.x), __fmul_rn(-2.f, c.y), __fmul_rn(-2.f, c.z),
                           __fmul_rn(-2.f, c.w));
      s_c2[j] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.x, c.x), __fmul_rn(c.y, c.y)),
                                    __fmul_rn(c.z, c.z)), __fmul_rn(c.w, c.w));
    }
    __syncthreads();
    // dist = c2 + f0*w0 + f1*w1 + f2*w2 + f3*w3, every step rounded; the
    // first minimum wins (strict <)
    for (int kk = 0; kk < kc; ++kk) {
      const float4 w = s_w[kk];
      const float c2 = s_c2[kk];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        float d = __fadd_rn(c2, __fmul_rn(f[q].x, w.x));
        d = __fadd_rn(d, __fmul_rn(f[q].y, w.y));
        d = __fadd_rn(d, __fmul_rn(f[q].z, w.z));
        d = __fadd_rn(d, __fmul_rn(f[q].w, w.w));
        if (c0 + kk == 0 || d < best[q]) {
          best[q] = d;
          bi[q] = c0 + kk;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = q * kThreads + threadIdx.x;
    const bool live = row0 + r < n;
    if (live && seg0 == 0) assign[row0 + r] = bi[q];
    const unsigned sg = (unsigned)(bi[q] - seg0);
    s.key[r] = live && sg < (unsigned)kw ? ((int)sg << kRowBits | r) : kNoSegment;
    float* xr = s.x + (r << kPitchLog);
    xr[0] = f[q].x;
    xr[1] = f[q].y;
    xr[2] = f[q].z;
    xr[3] = f[q].w;
    xr[4] = 1.f;
  }
  __syncthreads();
  chunk_sums(s, kPitchLog, kKmCols, kw, part + (int64_t)blockIdx.x * kw * kKmCols, kKmCols);
}

// ---- K7 -------------------------------------------------------------------

constexpr int kSweepPer = 4;                            // entries a thread keeps in registers
constexpr int kSweepMaxThreads = kSegMaxK / kSweepPer;  // 512 at 2,048 entries
constexpr int kSweepMaxE = kSegMaxK;                    // most entries of the register path
constexpr int kSweepMaxWarps = kSweepMaxThreads / 32;
constexpr int kSweepCols = 256;          // block columns one pass of a row stages
constexpr float kSweepAboveBits = 1.4f;  // the price of matching the block above
constexpr float kSweepNoCr = 3.0e38f;    // the CR cost of a block without a previous frame
constexpr float kSweepSlack = 64.f;      // the CR snap's absolute headroom

// A float's bits as an unsigned integer in the float's order (no NaN), and back.
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The first minimum over the warp of (key, entry), key a cost's ordered
// bits: the least key, then the least entry among the lanes that hold it
// (two redux.sync reductions). Every lane gets both.
__device__ __forceinline__ void warp_first_min(unsigned& key, unsigned& entry) {
  const unsigned least = __reduce_min_sync(0xffffffffu, key);
  entry = __reduce_min_sync(0xffffffffu, key == least ? entry : 0xffffffffu);
  key = least;
}

__device__ __forceinline__ int pick4(const int (&m)[4], int code) {
  return code == 0 ? m[0] : code == 1 ? m[1] : code == 2 ? m[2] : m[3];
}

// The exact error of coding the block's 48 pixel bytes px with palette entry
// e and selector row s.
__device__ int pair_error(const uint8_t* __restrict__ px, const int32_t* __restrict__ base,
                          const int32_t* __restrict__ mods, const int32_t* __restrict__ sel_cb,
                          int e, int s) {
  int b[3], m[4];
#pragma unroll
  for (int c = 0; c < 3; ++c) b[c] = base[e * 3 + c];
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = mods[e * 4 + j];
  int err = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int mod = pick4(m, sel_cb[s * 16 + p]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int d = (int)px[p * 3 + c] - min(max(b[c] + mod, 0), 255);
      err += d * d;
    }
  }
  return err;
}

// One palette entry as a thread holds it: col(k, c)[ch] as bytes, v = 3c + ch
// at byte v % 4 of word v / 4, and |col(k, c)|^2.
struct SweepEntry {
  unsigned col[3];
  int sq[4];
};

// A block's features as the scan reads them: the per-code pixel sums
// S_c[ch] (at most 16 * 255) as unsigned 16-bit pairs, v = 3c + ch at half
// v % 2 of word v / 2, the per-code pixel counts n_c, and |p|^2.
struct __align__(16) SweepBlock {
  unsigned s[6];
  int n[4];
  int p_sq;
};

// The error of one block against one entry,
// err = |p|^2 + sum_c n_c |col_c|^2 - 2 sum_v S_v col_v: 4 multiply-adds,
// 6 two-way 16 x 8-bit dot products (__dp2a) and one multiply-add, exact in
// int32; the same integer as the reference's float32 product, whose every
// partial sum is an integer below 2^24. Then converted (exactly) to float32.
__device__ __forceinline__ float entry_error(const SweepBlock& f, const SweepEntry& t) {
  const int acc = f.p_sq + f.n[0] * t.sq[0] + f.n[1] * t.sq[1] + f.n[2] * t.sq[2] +
                  f.n[3] * t.sq[3];
  unsigned dot = 0;
#pragma unroll
  for (int q = 0; q < 6; ++q)
    dot = (q & 1) ? __dp2a_hi(f.s[q], t.col[q >> 1], dot) : __dp2a_lo(f.s[q], t.col[q >> 1], dot);
  return __int2float_rn(acc - 2 * (int)dot);
}

// The errors of one block against the thread's kSweepPer entries.
__device__ __forceinline__ void column_errors(const SweepBlock& f,
                                              const SweepEntry (&tab)[kSweepPer],
                                              float (&errs)[kSweepPer]) {
#pragma unroll
  for (int j = 0; j < kSweepPer; ++j) errs[j] = entry_error(f, tab[j]);
}

// Entry k of the palette as the scan reads it (all zero where !live).
__device__ __forceinline__ SweepEntry make_entry(const int32_t* __restrict__ base,
                                                 const int32_t* __restrict__ mods, int k,
                                                 bool live) {
  SweepEntry t;
  int b[3], m[4];
#pragma unroll
  for (int c = 0; c < 3; ++c) b[c] = live ? base[k * 3 + c] : 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) m[c] = live ? mods[k * 4 + c] : 0;
#pragma unroll
  for (int w = 0; w < 3; ++w) t.col[w] = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int sq = 0;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int v = live ? min(max(b[ch] + m[c], 0), 255) : 0;
      t.col[(3 * c + ch) >> 2] |= (unsigned)v << (8 * ((3 * c + ch) & 3));
      sq += v * v;
    }
    t.sq[c] = sq;
  }
  return t;
}

// Above kSweepMaxE entries the palette does not fit the registers of one
// CTA: the wide path reads each entry from a table in device memory (L1 and
// L2 hold it), 32 bytes an entry, written once per call by this kernel.
__global__ void sweep_table_kernel(const int32_t* __restrict__ base,
                                   const int32_t* __restrict__ mods, int e,
                                   int4* __restrict__ table) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= e) return;
  const SweepEntry t = make_entry(base, mods, k, true);
  table[2 * k] = make_int4((int)t.col[0], (int)t.col[1], (int)t.col[2], t.sq[0]);
  table[2 * k + 1] = make_int4(t.sq[1], t.sq[2], t.sq[3], 0);
}

__device__ __forceinline__ SweepEntry load_entry(const int4* __restrict__ table, int k) {
  const int4 a = table[2 * k], b = table[2 * k + 1];
  SweepEntry t;
  t.col[0] = (unsigned)a.x;
  t.col[1] = (unsigned)a.y;
  t.col[2] = (unsigned)a.z;
  t.sq[0] = a.w;
  t.sq[1] = b.x;
  t.sq[2] = b.y;
  t.sq[3] = b.z;
  return t;
}

// One CTA per block row, 32 * ceil(e / 128) threads (kWide: kSweepMaxThreads):
// thread t prices entries t + j * blockDim.x (j < kSweepPer; kWide: every j
// with an entry, read from `table`). blocks: the frame's [nby * nbx, 16, 3]
// uint8; base [e, 3], mods [e, 4] int32 (8-bit colors, intensity modifiers);
// sel_cb [S, 16] int32 codes; bits [e] f32 (kWide: staged in e floats of
// dynamic shared memory); ep, sel, prev_ep, prev_sel [nby * nbx] int32 (the
// previous pair read only with has_prev); table: kWide's [e] entries of
// sweep_table_kernel. Writes the frame's new ep and sel.
template <bool kWide>
__global__ void __launch_bounds__(kSweepMaxThreads)
rate_sweep_frame_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ base,
                        const int32_t* __restrict__ mods, const int32_t* __restrict__ sel_cb,
                        const float* __restrict__ bits, const int32_t* __restrict__ ep,
                        const int32_t* __restrict__ sel, const int32_t* __restrict__ prev_ep,
                        const int32_t* __restrict__ prev_sel, bool has_prev, int s0_index,
                        float lam, float lam_cr, int nbx, int e, const int4* __restrict__ table,
                        int32_t* __restrict__ out_ep, int32_t* __restrict__ out_sel) {
  __shared__ float s_bits_regs[kWide ? 1 : kSweepMaxE];
  extern __shared__ float s_bits_wide[];
  float* s_bits = kWide ? s_bits_wide : s_bits_regs;
  __shared__ SweepBlock s_feat[kSweepCols];
  __shared__ int s_above[kSweepCols], s_prev_ep[kSweepCols], s_choice[kSweepCols];
  __shared__ float s_cost_cr[kSweepCols], s_e_prev[kSweepCols];
  __shared__ bool s_cr[kSweepCols];
  __shared__ unsigned s_key[2][kSweepMaxWarps], s_entry[2][kSweepMaxWarps];  // per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * nbx;             // the row's first block
  const int64_t above0 = blockIdx.x > 0 ? row0 - nbx : row0;  // row 0 is its own above
  const float half_lam = __fmul_rn(lam, 0.5f);
  for (int k = tid; k < e; k += nthreads) s_bits[k] = bits[k];
  // the thread's entries: col(k, c) per code and channel, then |col(k, c)|^2
  SweepEntry tab[kSweepPer];
  if constexpr (!kWide) {
#pragma unroll
    for (int j = 0; j < kSweepPer; ++j) {
      const int k = tid + j * nthreads;
      tab[j] = make_entry(base, mods, k, k < e);
    }
  }
  int left = ep[row0];  // column 0 prices against its own incoming entry
  for (int c0 = 0; c0 < nbx; c0 += kSweepCols) {
    const int cols = min(kSweepCols, nbx - c0);
    // prologue: a thread per block of this pass's columns
    for (int i = tid; i < cols; i += nthreads) {
      const int64_t blk = row0 + c0 + i;
      const uint8_t* px = blocks + blk * 48;
      const int s = sel[blk];
      int sums[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, n[4] = {0, 0, 0, 0}, p_sq = 0;
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const int code = sel_cb[s * 16 + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) n[j] += code == j;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const int v = px[p * 3 + ch];
          p_sq += v * v;
#pragma unroll
          for (int j = 0; j < 4; ++j) sums[j * 3 + ch] += code == j ? v : 0;
        }
      }
      SweepBlock& f = s_feat[i];
#pragma unroll
      for (int q = 0; q < 6; ++q) f.s[q] = (unsigned)sums[2 * q] | (unsigned)sums[2 * q + 1] << 16;
#pragma unroll
      for (int j = 0; j < 4; ++j) f.n[j] = n[j];
      f.p_sq = p_sq;
      s_above[i] = ep[above0 + c0 + i];
      const float e_prev =
          has_prev ? __int2float_rn(pair_error(px, base, mods, sel_cb, prev_ep[blk], prev_sel[blk]))
                   : 0.f;
      s_e_prev[i] = e_prev;
      s_prev_ep[i] = has_prev ? prev_ep[blk] : 0;
      s_cost_cr[i] = has_prev ? __fadd_rn(e_prev, half_lam) : kSweepNoCr;
    }
    __syncthreads();
    // the column scan: one barrier per column
    float errs[kSweepPer];
    if constexpr (!kWide) column_errors(s_feat[0], tab, errs);
    for (int c = 0; c < cols; ++c) {
      int origin = left;  // dm = (k - left) mod e, the floor modulo
      if ((unsigned)origin >= (unsigned)e) {  // an incoming entry out of range
        origin %= e;
        if (origin < 0) origin += e;
      }
      const int above = s_above[c];
      float best = INFINITY;
      int best_e = 0x7fffffff;
      if constexpr (kWide) {
        const SweepBlock& f = s_feat[c];
        for (int k = tid; k < e; k += nthreads) {
          int dm = k - origin;
          if (dm < 0) dm += e;
          float b = s_bits[dm];
          if (k == above) b = fminf(b, kSweepAboveBits);
          const float cost = __fmaf_rn(lam, b, entry_error(f, load_entry(table, k)));
          if (cost < best) {  // entries ascend: the thread's first minimum
            best = cost;
            best_e = k;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kSweepPer; ++j) {
          const int k = tid + j * nthreads;
          if (k < e) {
            int dm = k - origin;
            if (dm < 0) dm += e;
            float b = s_bits[dm];
            if (k == above) b = fminf(b, kSweepAboveBits);
            const float cost = __fmaf_rn(lam, b, errs[j]);
            if (cost < best) {  // entries ascend: the thread's first minimum
              best = cost;
              best_e = k;
            }
          }
        }
      }
      unsigned key = ordered_bits(best), entry = (unsigned)best_e;
      warp_first_min(key, entry);
      if (lane == 0) {
        s_key[c & 1][warp] = key;
        s_entry[c & 1][warp] = entry;
      }
      if constexpr (!kWide) {
        if (c + 1 < cols) column_errors(s_feat[c + 1], tab, errs);  // before the wait
      }
      __syncthreads();
      // every warp reduces the warps' minima and decides CR itself: the new
      // left entry needs no second barrier (the minima are double-buffered)
      key = lane < nwarps ? s_key[c & 1][lane] : 0xffffffffu;
      entry = lane < nwarps ? s_entry[c & 1][lane] : 0xffffffffu;
      warp_first_min(key, entry);
      const bool cr = s_cost_cr[c] <= from_ordered(key);  // CR wins ties
      left = cr ? s_prev_ep[c] : (int)entry;
      if (tid == 0) {
        s_choice[c] = left;
        s_cr[c] = cr;
      }
    }
    __syncthreads();
    // epilogue: CR takes the previous selector; patterned blocks get the CR snap
    for (int i = tid; i < cols; i += nthreads) {
      const int64_t blk = row0 + c0 + i;
      const int s_in = sel[blk];
      const int ps = has_prev ? prev_sel[blk] : 0;
      int ep_new = s_choice[i], sel_new = s_cr[i] ? ps : s_in;
      if (has_prev && s_in != s0_index) {
        const float e_new =
            __int2float_rn(pair_error(blocks + blk * 48, base, mods, sel_cb, ep_new, sel_new));
        if (s_e_prev[i] <= __fmaf_rn(lam_cr, e_new, kSweepSlack)) {
          ep_new = s_prev_ep[i];
          sel_new = ps;
        }
      }
      out_ep[blk] = ep_new;
      out_sel[blk] = sel_new;
    }
    __syncthreads();  // the next pass restages the shared arrays
  }
}

unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

int chunks_for(int n) { return n > 0 ? (n + kChunkRows - 1) / kChunkRows : 1; }

// A launch of more than 48 KB of dynamic shared memory needs the kernel's
// limit raised first: both pass-1 kernels set it to the launch's bytes.
constexpr cudaFuncAttribute kSmemLimit = cudaFuncAttributeMaxDynamicSharedMemorySize;

cudaError_t launch_tree(const float* part, int m, int64_t e, float* out, cudaStream_t s) {
  const unsigned grid = (unsigned)((e + kTreeCols - 1) / kTreeCols);
  if (e < kTreeSmallE)
    seg_sum_tree_kernel<kTreeRowsSmall><<<grid, dim3(kTreeCols, kTreeRowsSmall), 0, s>>>(
        part, m, e, out);
  else
    seg_sum_tree_kernel<kTreeRows><<<grid, dim3(kTreeCols, kTreeRows), 0, s>>>(part, m, e, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks: [n, 16, 3] uint8; base: [n, 3] int32 (8-bit colors); out: [n, 8] int32,
// 16-byte aligned.
int uvt_etc1s_inten_errors(const void* blocks, const void* base, void* out, int n,
                           void* stream) {
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;
  if (n > 0) {
    int device = 0, sms = 0;  // of the current device, asked on each call: it caps the grid
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (n + kIntenThreads - 1) / kIntenThreads;
    inten_errors_kernel<<<min(tiles, kIntenCtasPerSm * sms), kIntenThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int32_t*)base, (int32_t*)out, n);
  }
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

// idx: [n] int32 (n <= 2^24); x: [n, d] f32; part: scratch of ceil(n/1024) *
// min(k, kSegMaxK) * d f32 (min(k, kSegMaxK) * d for n = 0); out: [k, d] f32.
// Two launches per window of kSegMaxK segments, whatever n: each window's
// pass 1 drops the rows outside it, so a segment's partials are those of its
// own rows in tile order, as in one launch; windows reuse `part` in stream
// order.
int uvt_etc1s_segment_sum(const void* idx, const void* x, int n, int d, int k, void* part,
                          void* out, void* stream) {
  if (n < 0 || n > kSegMaxRows || d <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int m = chunks_for(n);
  const int groups = (d + kSegGroupCols - 1) / kSegGroupCols;
  const int dc = (d + groups - 1) / groups, quads = (dc + 3) / 4;
  const bool vec = d % 4 == 0 && dc % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)part & 15) == 0;
  int lq = 0, lc = 0;  // powers of two >= the quads and the copies of a row
  while ((1 << lq) < quads) ++lq;
  while ((1 << lc) < (vec ? quads : dc)) ++lc;
  const size_t stage = (size_t)min(groups, 2) * kChunkRows * quads * 16;
  // the first window is the widest: its bytes are the limit of every launch
  cudaError_t err = cudaFuncSetAttribute(
      seg_sum_chunk_kernel, kSmemLimit, (int)(seg_meta_bytes(min(k, kSegMaxSlots)) + stage));
  if (err != cudaSuccess) return (int)err;
  for (int seg0 = 0; seg0 < k; seg0 += kSegMaxK) {
    const int kw = min(kSegMaxK, k - seg0);
    seg_sum_chunk_kernel<<<(unsigned)m, kSegThreads, seg_meta_bytes(min(kw, kSegMaxSlots)) + stage,
                           s>>>((const int32_t*)idx, (const float*)x, n, d, kw, seg0, dc, groups,
                                4 * quads, lq, lc, vec, (float*)part);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = launch_tree((const float*)part, m, (int64_t)kw * d, (float*)out + (int64_t)seg0 * d, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// feats: [n, 4] f32 and cb: [k, 4] f32, both 16-byte aligned; part: scratch of
// ceil(n/1024) * min(k, kSegMaxK) * 5 f32; sums: [k, 5] f32 (features ++
// count); assign: [n] int32. Two launches per window of kSegMaxK centroids:
// window 0's pass 1 assigns every row, later ones read `assign` back.
int uvt_etc1s_kmeans_iter(const void* feats, const void* cb, int n, int k, void* part,
                          void* sums, void* assign, void* stream) {
  if (n <= 0 || n > kSegMaxRows || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int m = chunks_for(n), kc = min(k, kKmChunk), kw_max = min(k, kSegMaxK);
  const size_t smem =
      (size_t)kc * 16 + (size_t)((kc + 3) & ~3) * 4 + chunk_smem_bytes(8, kw_max);
  cudaError_t err = cudaFuncSetAttribute(kmeans_chunk_kernel, kSmemLimit, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int seg0 = 0; seg0 < k; seg0 += kSegMaxK) {
    const int kw = min(kSegMaxK, k - seg0);
    kmeans_chunk_kernel<<<(unsigned)m, kThreads, smem, s>>>(
        (const float4*)feats, (const float4*)cb, n, k, seg0, kw, (float*)part, (int32_t*)assign);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = launch_tree((const float*)part, m, (int64_t)kw * kKmCols,
                        (float*)sums + (int64_t)seg0 * kKmCols, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// K7 on one frame. blocks: [nby * nbx, 16, 3] uint8; base: [e, 3], mods: [e, 4] int32;
// sel_cb: [S, 16] int32; bits: [e] f32; ep, sel, prev_ep, prev_sel, out_ep, out_sel:
// [nby * nbx] int32 (prev_ep and prev_sel are read only with has_prev); table: scratch
// of e * 8 int32, 16-byte aligned, used above kSweepMaxE entries. One launch of nby
// CTAs (above kSweepMaxE: the entry table's launch first).
int uvt_etc1s_rate_sweep(const void* blocks, const void* base, const void* mods,
                         const void* sel_cb, const void* bits, const void* ep, const void* sel,
                         const void* prev_ep, const void* prev_sel, int has_prev, int s0_index,
                         float lam, float lam_cr, int nby, int nbx, int e, void* table,
                         void* out_ep, void* out_sel, void* stream) {
  if (nby < 0 || nbx < 0 || e <= 0) return (int)cudaErrorInvalidValue;
  if (nby == 0 || nbx == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (e <= kSweepMaxE) {
    const int threads = 32 * ((e + 32 * kSweepPer - 1) / (32 * kSweepPer));
    rate_sweep_frame_kernel<false><<<(unsigned)nby, threads, 0, s>>>(
        (const uint8_t*)blocks, (const int32_t*)base, (const int32_t*)mods,
        (const int32_t*)sel_cb, (const float*)bits, (const int32_t*)ep, (const int32_t*)sel,
        (const int32_t*)prev_ep, (const int32_t*)prev_sel, has_prev != 0, s0_index, lam, lam_cr,
        nbx, e, nullptr, (int32_t*)out_ep, (int32_t*)out_sel);
    return (int)cudaGetLastError();
  }
  if ((uintptr_t)table & 15) return (int)cudaErrorMisalignedAddress;
  const size_t smem = (size_t)e * 4;
  cudaError_t err = cudaFuncSetAttribute(rate_sweep_frame_kernel<true>, kSmemLimit, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_table_kernel<<<(unsigned)((e + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const int32_t*)base, (const int32_t*)mods, e, (int4*)table);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rate_sweep_frame_kernel<true><<<(unsigned)nby, kSweepMaxThreads, smem, s>>>(
      (const uint8_t*)blocks, (const int32_t*)base, (const int32_t*)mods, (const int32_t*)sel_cb,
      (const float*)bits, (const int32_t*)ep, (const int32_t*)sel, (const int32_t*)prev_ep,
      (const int32_t*)prev_sel, has_prev != 0, s0_index, lam, lam_cr, nbx, e,
      (const int4*)table, (int32_t*)out_ep, (int32_t*)out_sel);
  return (int)cudaGetLastError();
}

int uvt_etc1s_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {
      UVT_KERNEL(inten_errors_kernel), UVT_KERNEL(assign_endpoints_kernel),
      UVT_KERNEL(kmeans_chunk_kernel), UVT_KERNEL(seg_sum_chunk_kernel),
      KernelRef{(const void*)seg_sum_tree_kernel<kTreeRows>, "seg_sum_tree_kernel"},
      KernelRef{(const void*)seg_sum_tree_kernel<kTreeRowsSmall>, "seg_sum_tree_kernel_small"},
      KernelRef{(const void*)rate_sweep_frame_kernel<false>, "rate_sweep_frame_kernel"},
      KernelRef{(const void*)rate_sweep_frame_kernel<true>, "rate_sweep_frame_kernel_wide"},
      UVT_KERNEL(sweep_table_kernel)};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
