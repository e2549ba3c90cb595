// The mesh and point-cloud ops' device programs for Hopper (sm_90a). The
// reference leaves each of them to XLA (no Pallas site); they are written by
// hand here so that the port's ops run on the card with the reference's
// exact arithmetic and order:
//
//   normals_count_kernel,        U3, uvol_tpu/ops/normals.py:66-84
//   normals_fill_kernel,             (`estimate_normals`): per face
//   estimate_normals_kernel          cross(p1 - p0, p2 - p0), zero for a
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
//   dependent_add_probe_kernel   no reference: times a chain of dependent
//       integer adds with clock64, the step of U5's bound.
//
// U3. The reference adds the face normals with three scatters, one per
// corner k, each over the faces in order; XLA runs them one after another
// on the CPU, so a vertex's sum is 0.0 + n_0 + n_1 + ... over its corners
// in (k, face) order. Atomics keep no order, so each vertex's corners are
// gathered into a CSR row and sorted before they are added. The CSR is
// built on the card in two launches, the normals are a third:
//   1. count (normals_count_kernel): a cluster of 8 CTAs of 1,024 threads
//      owns a range of kRangeVertices = 51,200 vertices. Each CTA counts an
//      eighth of the corners of max(faces, 0) into its own int32 histogram
//      of the range in shared memory (shared atomics: one CTA alone took
//      18.7 us on an H100 for a 26,145-vertex frame, reading all 618 KB of
//      faces on one SM); after a cluster barrier each sums the 8
//      histograms over its eighth of the range through distributed shared
//      memory (16-byte loads, all in flight) and scans them, writes its
//      eighth's total into the later CTAs, and after a second barrier (no
//      remote access follows it) adds the totals before its own:
//      range-local offsets (`local`) and the range's total. Up to
//      51,200 vertices (the smoke's frames: 26,145) this is one cluster;
//      past it each range's cluster reads every corner again (ranges x 12 M
//      bytes), at most kMaxRanges ranges.
//   2. fill (normals_fill_kernel): a thread a corner; each CTA scans the
//      ranges' totals into their bases, and a corner naming vertex v < n
//      takes the slot base + atomicAdd(&local[v], 1) and stores its key
//      k << 30 | face there, so a row's keys land in any order and `local`
//      ends as each row's end. Corners naming a vertex >= n are dropped.
//   3. normals (estimate_normals_kernel): a thread a vertex loads its row's
//      keys into registers, sorts them (a bitonic network of 8 or of 32:
//      constant indices, no stack), which restores the (k, face) order,
//      and adds each face's normal, computed from the face's three indices
//      (each face three times, once per corner: no face-normal buffer). A
//      row of more than 32 keys is left to a warp of the CTA after its
//      short rows: the warp sorts a row of up to kLongRowKeys keys in a
//      shared window (bitonic), a longer one by a stable LSD radix sort
//      between its slots and as many slots of scratch (8 bits a pass over
//      the face bits in use, then the corner: time linear in the row's
//      length), computes 32 face normals at a time in its lanes and adds
//      them in key order through shuffles.
// An index >= N is clamped for the gathers, as XLA's gather does. Float
// rules, from what XLA compiles the reference into on the CPU: the
// differences are rounded, each cross component is one FMA,
// fma(a_i, b_j, -(a_j * b_i)), with the second product rounded; the product
// by the validity; the sums from 0.0; the norm's squares are x * x, then
// fma(y, y, .), fma(z, z, .), and its sqrt and the divisions are IEEE.
// Bound: bytes: the positions, faces and normals once, and the CSR's own
// traffic (`local` written and read, every key written and read).
//
// U4. One thread per point: three 4-byte loads, (x - min) * inv + 0.5
// rounded at each step (what the port's ops/quantize.quantize computes,
// no FMA), floor, clamp to [0, 2^bits - 1], then the interleave, and one
// 8-byte store. Bound: bytes (12 in, 8 out per point).
//
// U5. out[i][d] = res[i][d] + pred, pred = out[a] + out[b] - out[c] (the
// prefix decoded so far), or out[i - 1] where a < 0. Indices: b and c below
// 0 read out[0], every index >= N is clamped to N - 1 (XLA's gather), and a
// read of out[k] with k >= i reads 0 (the scan's zero-filled carry). Sums
// wrap in uint32 (int32 overflow is undefined in C++). Each frame is a
// chain; its components step in lanes 0..DG-1 of warp 0 of one CTA (DG <=
// kChainGroup = 4; a larger D takes groups of 4 and one launch for the
// rest), so one instruction stream and one index triple serve all of them,
// and (frame, group) folds into gridDim.x. The chain is cut into tiles of
// kChainTile = 128 steps. While warp 0 steps tile t, warps 1-4 stage tile
// t + 1 (a step each) and store tile t - 1 to `out`; a CTA barrier a tile
// joins them. The stepping lanes read and write only shared memory:
//   - ring: the outputs of tiles t - 1 and t (slot i & 255), and one slot
//     of zeros;
//   - per step of tile t + 1 (staged): g = res + every reference that was
//     final before tile t began (read from the ring for tile t - 1, from
//     `out` before it), m1 and m2: the counts of references to i - 1 and
//     i - 2 (+1 for a and b, -1 for c; m1 = 1 where a < 0), and a record of
//     three ring offsets for the other references, into tiles t and t + 1
//     (the zero slot where there is none).
// A step is then out_i = g + r_a + r_b - r_c + m2 * out_{i-2} + m1 *
// out_{i-1}, the last two outputs kept in registers: its only dependence
// on the step before is one IMAD. A tile whose steps reference no ring
// slot (marked by the staging warps; every tile of a grid whose rows are
// longer than two tiles) loads one 8-byte (g, m1 | m2 << 16) a step, 6
// steps ahead, and is unrolled whole; any other tile also loads the
// record and three ring values, 3 steps ahead (a ring reference is at
// least 3 steps back, so it is stored by then). No loop waits on a branch
// or a load: a branch on a predicate just computed, or a use of a shared
// load just issued, stalls the only warp that steps for longer than the
// step's own instructions take. Bound: the
// longest path through the chain's own dependence graph (edges a, b, c and
// i - 1 where a < 0; reads of 0 dropped) times one dependent integer add,
// timed on the card by dependent_add_probe_kernel; bytes: 8 a value and 12
// a vertex.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "func_attrs.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // U3's normals and U4: threads per CTA
constexpr int kMaxGridY = 65535;     // U4: frames of one launch (more go in slices)
constexpr int kMaxSharedBytes = 232448;  // what one CTA may take on sm_90

// U3
constexpr int kCountThreads = 1024;         // a count CTA
constexpr int kCountCluster = 8;            // the count CTAs of a range
constexpr int kRangeVertices = 51200;       // vertices a count cluster owns
constexpr int kMaxRanges = 4096;            // ranges the fill's CTAs scan in shared memory
constexpr int kFillThreads = 256;           // the fill: a thread a corner
constexpr int kMaxFaces = 1 << 29;          // keys and slots stay below 2^31
constexpr int kFaceBits = 30;               // key = k << 30 | face
constexpr uint32_t kFaceMask = (1u << kFaceBits) - 1u;
constexpr int kShortRow = 32;               // rows sorted in registers
constexpr int kLongRowKeys = 512;           // a warp's shared window: rows up to it
constexpr int kRadixBits = 8;               // longer rows: bits of a radix pass's digit
constexpr int kRadixBins = 1 << kRadixBits;
constexpr int kRowAhead = 4;                // a long row's chunks of 32 loaded together
__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
// The vertices of a range each count CTA scans: an eighth, a multiple of 4.
__host__ __device__ constexpr int count_part(int len) {
  return round4((len + kCountCluster - 1) / kCountCluster);
}
// A count CTA's dynamic shared bytes: its histogram of the range, the
// offsets of its part, the scan's warp sums and the parts' totals.
__host__ __device__ constexpr int count_smem_bytes(int len) {
  return (round4(len) + count_part(len) + 32 + kCountCluster) * 4;
}
static_assert(count_smem_bytes(kRangeVertices) <= kMaxSharedBytes,
              "a range's counts fit one CTA");
static_assert(kLongRowKeys >= 32 && (kLongRowKeys & (kLongRowKeys - 1)) == 0,
              "a long row's window is a power of two of at least a warp");
static_assert(kRadixBins <= kLongRowKeys && kRadixBins % 32 == 0 && kFaceBits + 2 <= 32,
              "a radix pass's counts fit the window; a corner's digit fits a pass");

// U5
constexpr int kChainTile = 128;              // steps of a tile
constexpr int kChainThreads = 32 + kChainTile;  // warp 0 steps; warps 1-4 stage and store
constexpr int kChainHelpers = kChainTile;    // a step each
constexpr int kChainGroup = 4;               // components a chain CTA steps, a lane each
constexpr int kChainAhead = 3;               // steps a ring value is loaded ahead
constexpr int kChainAheadFree = 6;           // steps g and ctl are loaded ahead, ring-free
constexpr int64_t kChainsPerLaunch = 1 << 30;  // gridDim.x of one launch, at most

// the probe
constexpr int kProbeAdds = 4096;

// An exclusive scan of one int a thread over a CTA of kN threads (a multiple
// of 32): returns the thread's exclusive prefix, *total the CTA's sum.
template <int kN>
__device__ __forceinline__ int block_exclusive_scan(int own, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kN / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kN / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[kN / 32 - 1];
  __syncthreads();  // warp_sums may be used again
  return before + incl - own;
}

// ---------------------------------------------------------------------------
// U3: area-weighted vertex normals in the reference's sum order
// ---------------------------------------------------------------------------

// faces: [m, 3] int32, read as `corners` = 3m flat int32; local: [n] int32,
// each vertex's offset in its range's rows; total: [ranges] int32. Cluster
// j (kCountCluster CTAs) owns vertices [j * kRangeVertices, ...). CTA `rank`
// counts its share of the corners (16-byte loads) into its own histogram
// of the whole range (shared atomics). After a cluster barrier each thread
// takes 4 vertices of the CTA's part of the range: one 16-byte load from
// each CTA's histogram (distributed shared memory, all in flight), their
// sum, a CTA scan; each CTA writes its part's total into the later CTAs'
// shared memory, and after a second barrier (the last remote access
// precedes it) adds the totals before its own. Dynamic shared memory:
// count_smem_bytes(len).
__global__ void __cluster_dims__(kCountCluster, 1, 1) __launch_bounds__(kCountThreads)
    normals_count_kernel(const int32_t* __restrict__ faces, uint32_t corners, int n,
                         int32_t* __restrict__ local, int32_t* __restrict__ total) {
  extern __shared__ int4 count_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int v0 = (int)(blockIdx.x / kCountCluster) * kRangeVertices;
  const int len = min(kRangeVertices, n - v0), len4 = round4(len);
  const int sub = count_part(len);  // a multiple of 4
  const int s_lo = min(len, rank * sub), s_len = min(len, s_lo + sub) - s_lo;
  int32_t* hist = (int32_t*)count_smem;  // [len4]: this CTA's corners, the whole range
  int32_t* mine = hist + len4;           // [sub]: the offsets of this CTA's part
  int32_t* warp_sums = mine + sub;       // [32]
  int32_t* before = warp_sums + 32;      // [kCountCluster]: the parts' totals, by rank
  for (int i = threadIdx.x; i < len4; i += kCountThreads) hist[i] = 0;
  __syncthreads();
  auto add = [&](int32_t x) {
    const int v = max(x, 0) - v0;
    if ((unsigned)v < (unsigned)len) atomicAdd(&hist[v], 1);
  };
  // the corners from the first 16-byte boundary on, 4 a load, split among
  // the cluster's CTAs; the first CTA takes the head, the last the tail
  const uint32_t head =
      min(corners, (uint32_t)(((16u - ((uintptr_t)faces & 15u)) & 15u) >> 2));
  const uint32_t nvec = (corners - head) >> 2;
  const int4* vec = (const int4*)(faces + head);
  const uint32_t per = (nvec + kCountCluster - 1) / kCountCluster;
  const uint32_t q_lo = min(nvec, (uint32_t)rank * per), q_hi = min(nvec, q_lo + per);
  if (rank == 0 && threadIdx.x < head) add(faces[threadIdx.x]);
  if (rank == kCountCluster - 1)
    for (uint32_t e = head + 4 * nvec + threadIdx.x; e < corners; e += kCountThreads)
      add(faces[e]);
  for (uint32_t i = q_lo + threadIdx.x; i < q_hi; i += 2 * kCountThreads) {
    const bool second = i + kCountThreads < q_hi;
    const int4 a = vec[i];
    const int4 b = second ? vec[i + kCountThreads] : make_int4(-1, -1, -1, -1);
    add(a.x);
    add(a.y);
    add(a.z);
    add(a.w);
    if (second) {
      add(b.x);
      add(b.y);
      add(b.z);
      add(b.w);
    }
  }
  cluster.sync();  // every histogram is complete
  int carry = 0;
  for (int i0 = 0; i0 < s_len; i0 += 4 * kCountThreads) {
    const int i = i0 + 4 * (int)threadIdx.x;  // this thread's 4 vertices of the part
    int4 c = make_int4(0, 0, 0, 0);
    if (i < s_len) {
      int4 h[kCountCluster];
#pragma unroll
      for (int q = 0; q < kCountCluster; ++q)
        h[q] = *(const int4*)(cluster.map_shared_rank(hist, q) + s_lo + i);
#pragma unroll
      for (int q = 0; q < kCountCluster; ++q) {
        c.x += h[q].x;
        c.y += h[q].y;
        c.z += h[q].z;
        c.w += h[q].w;
      }
    }
    int part;
    const int run = carry + block_exclusive_scan<kCountThreads>(c.x + c.y + c.z + c.w,
                                                                warp_sums, &part);
    if (i < s_len)
      *(int4*)(mine + i) = make_int4(run, run + c.x, run + c.x + c.y, run + c.x + c.y + c.z);
    carry += part;
  }
  if (threadIdx.x > (unsigned)rank && threadIdx.x < kCountCluster)
    cluster.map_shared_rank(before, threadIdx.x)[rank] = carry;
  cluster.sync();  // the parts' totals are in place; nothing remote is read after this
  int base = 0;
  for (int q = 0; q < rank; ++q) base += before[q];
  if (rank == kCountCluster - 1 && threadIdx.x == 0)
    total[blockIdx.x / kCountCluster] = base + carry;
  for (int i = threadIdx.x; i < s_len; i += kCountThreads) local[v0 + s_lo + i] = base + mine[i];
}

// faces as above; local: [n] int32, each row's next slot in its range (the
// row's end when every fill is done); total: [ranges]; base_out: [ranges],
// each range's first slot (written by CTA 0); keys: [3m] uint32.
__global__ void __launch_bounds__(kFillThreads)
    normals_fill_kernel(const int32_t* __restrict__ faces, uint32_t corners, int n, int ranges,
                        int32_t* __restrict__ local, const int32_t* __restrict__ total,
                        int32_t* __restrict__ base_out, uint32_t* __restrict__ keys) {
  constexpr int kPer = kMaxRanges / kFillThreads;
  __shared__ int32_t base[kMaxRanges];
  __shared__ int32_t warp_sums[32];
  const int lo = threadIdx.x * kPer, hi = min(ranges, lo + kPer);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += total[i];
  int all;
  int run = block_exclusive_scan<kFillThreads>(own, warp_sums, &all);
  for (int i = lo; i < hi; ++i) {
    base[i] = run;
    run += total[i];
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < ranges; i += kFillThreads) base_out[i] = base[i];
  const uint32_t e = blockIdx.x * kFillThreads + threadIdx.x;
  if (e >= corners) return;
  const int v = max(faces[e], 0);
  if (v >= n) return;  // XLA's scatter drops it
  const uint32_t f = e / 3u, k = e - 3u * f;
  const int slot = base[v / kRangeVertices] + atomicAdd(&local[v], 1);
  keys[slot] = k << kFaceBits | f;
}

// Row v of the CSR: [start, start + len) of `keys`.
__device__ __forceinline__ void row_of(int v, const int32_t* __restrict__ local,
                                       const int32_t* __restrict__ base, int& start, int& len) {
  const int j = v / kRangeVertices;
  const int b = base[j];
  start = v == j * kRangeVertices ? b : b + local[v - 1];
  len = b + local[v] - start;
}

// The normal of the face of `key`, times its validity (U3's float rules).
__device__ __forceinline__ void face_normal(uint32_t key, const int32_t* __restrict__ faces,
                                            const float* __restrict__ pos, int last, float& nx,
                                            float& ny, float& nz) {
  const int32_t* f = faces + 3 * (int64_t)(key & kFaceMask);
  const int i0 = f[0], i1 = f[1], i2 = f[2];
  const float valid = i0 >= 0 ? 1.0f : 0.0f;
  const float* p0 = pos + 3 * (int64_t)min(max(i0, 0), last);
  const float* p1 = pos + 3 * (int64_t)min(max(i1, 0), last);
  const float* p2 = pos + 3 * (int64_t)min(max(i2, 0), last);
  const float ax = __fsub_rn(p1[0], p0[0]), ay = __fsub_rn(p1[1], p0[1]),
              az = __fsub_rn(p1[2], p0[2]);
  const float bx = __fsub_rn(p2[0], p0[0]), by = __fsub_rn(p2[1], p0[1]),
              bz = __fsub_rn(p2[2], p0[2]);
  nx = __fmul_rn(__fmaf_rn(ay, bz, -__fmul_rn(az, by)), valid);
  ny = __fmul_rn(__fmaf_rn(az, bx, -__fmul_rn(ax, bz)), valid);
  nz = __fmul_rn(__fmaf_rn(ax, by, -__fmul_rn(ay, bx)), valid);
}

// Ascending bitonic sort of C registers (C a power of two): every index a
// constant once unrolled.
template <int C>
__device__ __forceinline__ void sort_keys(uint32_t (&k)[C]) {
#pragma unroll
  for (int size = 2; size <= C; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int l = i ^ stride;
        if (l > i) {
          const uint32_t a = k[i], b = k[l];
          const bool up = (i & size) == 0;
          k[i] = up ? min(a, b) : max(a, b);
          k[l] = up ? max(a, b) : min(a, b);
        }
      }
    }
  }
}

// A row of at most C keys: loaded, sorted, added in order onto (sx, sy, sz).
template <int C>
__device__ __forceinline__ void add_short_row(const uint32_t* __restrict__ keys, int start,
                                              int len, const int32_t* __restrict__ faces,
                                              const float* __restrict__ pos, int last,
                                              float& sx, float& sy, float& sz) {
  uint32_t k[C];
#pragma unroll
  for (int i = 0; i < C; ++i) k[i] = i < len ? keys[start + i] : 0xFFFFFFFFu;
  sort_keys<C>(k);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (i < len) {
      float nx, ny, nz;
      face_normal(k[i], faces, pos, last, nx, ny, nz);
      sx = __fadd_rn(sx, nx);
      sy = __fadd_rn(sy, ny);
      sz = __fadd_rn(sz, nz);
    }
  }
}

// The keys src[0 .. cnt) (ascending; in device memory, read through L2,
// where kGlobal; cnt >= 1) added in order by one warp, kRowAhead chunks of
// 32 at a time: the chunks' face normals computed in the lanes with no
// branch (a lane past cnt reads the last key and adds 0), so that their
// loads are all in flight together, then added in order through shuffles.
// Every lane ends with the same sums.
template <bool kGlobal>
__device__ __forceinline__ void add_sorted(const uint32_t* src, int cnt,
                                           const int32_t* __restrict__ faces,
                                           const float* __restrict__ pos, int last, float& sx,
                                           float& sy, float& sz) {
  const int lane = threadIdx.x & 31;
  for (int g0 = 0; g0 < cnt; g0 += 32 * kRowAhead) {
    float nx[kRowAhead], ny[kRowAhead], nz[kRowAhead];
#pragma unroll
    for (int u = 0; u < kRowAhead; ++u) {
      const int i = g0 + 32 * u + lane, at = min(i, cnt - 1);
      const uint32_t key = kGlobal ? __ldcg(src + at) : src[at];
      face_normal(key, faces, pos, last, nx[u], ny[u], nz[u]);
      const bool in = i < cnt;
      nx[u] = in ? nx[u] : 0.0f;
      ny[u] = in ? ny[u] : 0.0f;
      nz[u] = in ? nz[u] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kRowAhead; ++u) {
      const int c = min(32, cnt - (g0 + 32 * u));
      for (int q = 0; q < c; ++q) {
        sx = __fadd_rn(sx, __shfl_sync(0xffffffffu, nx[u], q));
        sy = __fadd_rn(sy, __shfl_sync(0xffffffffu, ny[u], q));
        sz = __fadd_rn(sz, __shfl_sync(0xffffffffu, nz[u], q));
      }
    }
  }
}

// A row of kShortRow < len <= kLongRowKeys keys by one warp: copied into
// `win`, padded with 0xFFFFFFFF to a power of two, sorted there (bitonic)
// and added in order.
__device__ __forceinline__ void add_window_row(uint32_t* win, const uint32_t* keys, int len,
                                               const int32_t* __restrict__ faces,
                                               const float* __restrict__ pos, int last,
                                               float& sx, float& sy, float& sz) {
  const int lane = threadIdx.x & 31;
  int p2 = 32;
  while (p2 < len) p2 <<= 1;
  for (int i = lane; i < p2; i += 32) win[i] = i < len ? keys[i] : 0xFFFFFFFFu;
  __syncwarp();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < p2; i += 32) {
        const int l = i ^ stride;
        if (l > i) {
          const uint32_t a = win[i], b = win[l];
          if ((a > b) == ((i & size) == 0)) {
            win[i] = b;
            win[l] = a;
          }
        }
      }
      __syncwarp();
    }
  }
  add_sorted<false>(win, len, faces, pos, last, sx, sy, sz);
  __syncwarp();  // the window is free
}

// A row of more than kLongRowKeys keys by one warp, in time linear in its
// length: a stable LSD radix sort of its keys between its slots in `keys`
// and the same slots in `tmp`, kRadixBits a pass over the face bits in use
// (`face_bits`: those of m - 1), then one pass over the corner (bits 30-31),
// then added in order. A pass counts its digits into `hist` (shared
// atomics), scans them, and moves the keys 32 at a time in row order, each
// to its digit's next slot plus its rank among the lower lanes of the same
// digit (__match_any_sync): stable. The row's slots are this warp's alone;
// they are read through L2 (__ldcg), written a pass earlier by other lanes.
__device__ __forceinline__ void add_radix_row(uint32_t* hist, uint32_t* keys, uint32_t* tmp,
                                              int len, int face_bits,
                                              const int32_t* __restrict__ faces,
                                              const float* __restrict__ pos, int last,
                                              float& sx, float& sy, float& sz) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int face_passes = (face_bits + kRadixBits - 1) / kRadixBits;
  uint32_t* src = keys;
  uint32_t* dst = tmp;
  for (int p = 0; p <= face_passes; ++p) {
    const int shift = p < face_passes ? kRadixBits * p : kFaceBits;
    for (int b = lane; b < kRadixBins; b += 32) hist[b] = 0u;
    __syncwarp();
#pragma unroll 4
    for (int i = lane; i < len; i += 32)
      atomicAdd(&hist[(__ldcg(src + i) >> shift) & (kRadixBins - 1)], 1u);
    __syncwarp();
    // exclusive scan: lane l owns bins [8 l, 8 l + 8)
    constexpr int kPer = kRadixBins / 32;
    uint32_t c[kPer], sum = 0u;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      c[j] = hist[kPer * lane + j];
      sum += c[j];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
      if ((int)lane >= o) incl += y;
    }
    uint32_t run = incl - sum;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      hist[kPer * lane + j] = run;
      run += c[j];
    }
    __syncwarp();
    for (int g0 = 0; g0 < len; g0 += 32 * kRowAhead) {
      uint32_t xs[kRowAhead];  // kRowAhead chunks' loads in flight together
#pragma unroll
      for (int u = 0; u < kRowAhead; ++u) {
        const int i = g0 + 32 * u + (int)lane;
        xs[u] = i < len ? __ldcg(src + i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kRowAhead; ++u) {
        const bool ok = g0 + 32 * u + (int)lane < len;
        const uint32_t x = xs[u];
        const uint32_t d = ok ? (x >> shift) & (kRadixBins - 1) : (uint32_t)kRadixBins;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const unsigned rank = __popc(peers & below);
        if (ok) dst[hist[d] + rank] = x;
        __syncwarp();
        if (ok && rank == 0) hist[d] += __popc(peers);
        __syncwarp();
      }
    }
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  __syncwarp();
  add_sorted<true>(src, len, faces, pos, last, sx, sy, sz);
  __syncwarp();  // hist is free
}

__device__ __forceinline__ void store_normal(float* __restrict__ out, int v, float sx, float sy,
                                             float sz) {
  const float ss = __fmaf_rn(sz, sz, __fmaf_rn(sy, sy, __fmul_rn(sx, sx)));
  const float norm = __fsqrt_rn(ss);
  const float d = norm > 0.0f ? norm : 1.0f;  // NaN > 0 is false: NaN stays
  float* o = out + 3 * (int64_t)v;
  o[0] = __fdiv_rn(sx, d);
  o[1] = __fdiv_rn(sy, d);
  o[2] = __fdiv_rn(sz, d);
}

// pos: [n, 3] float32; faces: [m, 3] int32; local, base, keys: the CSR of
// the count and fill (a long row's slots are sorted in place, through the
// same slots of tmp: [3 m] uint32); out: [n, 3] float32.
__global__ void __launch_bounds__(kThreads, 1)
    estimate_normals_kernel(const float* __restrict__ pos, const int32_t* __restrict__ faces,
                            const int32_t* __restrict__ local, const int32_t* __restrict__ base,
                            uint32_t* keys, uint32_t* tmp, float* __restrict__ out, int n,
                            int m) {
  __shared__ uint32_t win[kThreads / 32][kLongRowKeys];
  __shared__ int long_rows[kThreads];
  __shared__ int n_long;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  const int last = n - 1;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v < n) {
    int start, len;
    row_of(v, local, base, start, len);
    if (len > kShortRow) {
      long_rows[atomicAdd(&n_long, 1)] = v;
    } else {
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      if (len <= 8)
        add_short_row<8>(keys, start, len, faces, pos, last, sx, sy, sz);
      else
        add_short_row<kShortRow>(keys, start, len, faces, pos, last, sx, sy, sz);
      store_normal(out, v, sx, sy, sz);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int face_bits = m <= 1 ? 1 : 32 - __clz(m - 1);
  for (int r = warp; r < n_long; r += kThreads / 32) {
    const int u = long_rows[r];
    int start, len;
    row_of(u, local, base, start, len);
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    if (len <= kLongRowKeys)
      add_window_row(win[warp], keys + start, len, faces, pos, last, sx, sy, sz);
    else
      add_radix_row(win[warp], keys + start, tmp + start, len, face_bits, faces, pos, last, sx,
                    sy, sz);
    if ((threadIdx.x & 31) == 0) store_normal(out, u, sx, sy, sz);
  }
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

// Dynamic shared bytes of a chain CTA: the records (2 tiles x 16 bytes),
// g and ctl (2 tiles x DG x 8 bytes) and the ring (2 tiles and the zero
// slot, DG words a step).
__host__ __device__ constexpr int chain_smem_bytes(int dg) {
  return 2 * kChainTile * 16 + 2 * kChainTile * dg * 8 + (2 * kChainTile + 1) * dg * 4;
}

__device__ __forceinline__ uint32_t ring_at(const char* col, int off) {
  return *(const uint32_t*)(col + off);
}

// One step: out = g + r_a + r_b - r_c + m2 * out_{i-2} + m1 * out_{i-1}
// (ctl = m2 << 16 | m1, two int16; r_* the ring values, 0 in a ring-free
// tile); its only dependence on the step before is the last IMAD.
__device__ __forceinline__ uint32_t chain_out(uint32_t g, int ctl, uint32_t prev1,
                                              uint32_t prev2) {
  const uint32_t m1 = (uint32_t)(int)(int16_t)ctl, m2 = (uint32_t)(ctl >> 16);
  return m1 * prev1 + (m2 * prev2 + g);
}

// Warps 1-4: the records, g and ctl of tile tau (steps s0 .. s0 + len - 1),
// staged while warp 0 steps tile tau - 1. A reference x (clamped) of step s
// reads 0 where x >= s; x = s - 1 and x = s - 2 go into m1 and m2 (the
// lanes keep those outputs in registers); x < s0 - kChainTile was final
// before tile tau - 1 began and goes into g (from the ring for tile
// tau - 2, from `o` for older tiles, which the helpers stored a tile
// earlier); any other x lies in tiles tau - 1 or tau, at least kChainAhead
// steps back: its ring offset goes into the record, and ringy[buf] = tau +
// 1 marks the tile as one that reads the ring.
template <int DG>
__device__ __forceinline__ void stage_tile(int tau, const int32_t* __restrict__ ix,
                                           const int32_t* __restrict__ r, const int32_t* o,
                                           int4* rec, uint2* gc, const uint32_t* ring,
                                           int* ringy, int n, int d) {
  constexpr int T = kChainTile, kZero = 2 * T * DG * 4;
  const int s0 = tau * T, len = min(T, n - s0), buf = tau & 1;
  const int young = s0 - T, ringed = s0 - 2 * T, last = n - 1;
  const int j = threadIdx.x - 32;
  if (j >= len) return;
  const int64_t s = s0 + j;
  const int a = ix[3 * s], b = ix[3 * s + 1], c = ix[3 * s + 2];
  uint32_t acc[DG];
#pragma unroll
  for (int q = 0; q < DG; ++q) acc[q] = (uint32_t)r[s * d + q];
  int m1 = 1, m2 = 0, off[3] = {kZero, kZero, kZero};
  bool ringed_ref = false;
  if (a >= 0) {
    m1 = 0;
    const int xs[3] = {min(a, last), min(max(b, 0), last), min(max(c, 0), last)};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int x = xs[k], sign = k == 2 ? -1 : 1;
      if (x >= s) continue;  // not decoded yet: 0
      if (x == s - 1) {
        m1 += sign;
      } else if (x == s - 2) {
        m2 += sign;
      } else if (x < young) {
#pragma unroll
        for (int q = 0; q < DG; ++q) {
          const uint32_t v = x >= ringed ? ring[(x & (2 * T - 1)) * DG + q]
                                         : (uint32_t)o[(int64_t)x * d + q];
          acc[q] = k == 2 ? acc[q] - v : acc[q] + v;
        }
      } else {
        off[k] = (x & (2 * T - 1)) * DG * 4;
        ringed_ref = true;
      }
    }
  }
  const int ctl = (m2 << 16) | (m1 & 0xFFFF);
#pragma unroll
  for (int q = 0; q < DG; ++q) gc[(buf * T + j) * DG + q] = make_uint2(acc[q], (uint32_t)ctl);
  rec[buf * T + j] = make_int4(off[0], off[1], off[2], 0);
  if (ringed_ref) ringy[buf] = tau + 1;  // every writer writes the same value
}

// Lane `lane` < DG of warp 0, a tile that reads no ring value: each step's
// g and ctl (one 8-byte load) kChainAheadFree steps ahead. A whole tile is
// unrolled (no branch, no loop back-edge waiting on loads).
template <int DG, bool kWhole>
__device__ __forceinline__ void step_free(int len, uint32_t& prev1, uint32_t& prev2,
                                          const uint2* GC, uint32_t* W) {
  constexpr int Q = kChainAheadFree, T = kChainTile;
  uint2 v[Q];
#pragma unroll
  for (int u = 0; u < Q; ++u) v[u] = (kWhole || u < len) ? GC[u * DG] : make_uint2(0u, 0u);
  const int end = kWhole ? T : len;
#pragma unroll(kWhole ? (T + Q - 1) / Q : 1)
  for (int j0 = 0; j0 < end; j0 += Q) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int j = j0 + u;
      if (j < end) {
        const uint32_t y = chain_out(v[u].x, (int)v[u].y, prev1, prev2);
        prev2 = prev1;
        prev1 = y;
        W[j * DG] = y;
        if (j + Q < end) v[u] = GC[(j + Q) * DG];
      }
    }
  }
}

// The same for a tile that reads the ring: step j + kChainAhead's ring
// values, g and ctl are loaded once step j is stored (a ring reference is
// at least kChainAhead steps back), its record kChainAhead steps before.
template <int DG, bool kWhole>
__device__ __forceinline__ void step_ringed(int len, uint32_t& prev1, uint32_t& prev2,
                                            const int4* R, const uint2* GC, const char* col,
                                            uint32_t* W) {
  constexpr int P = kChainAhead, T = kChainTile;
  int4 nx[P];
  uint32_t va[P], vb[P], vc[P];
  uint2 gcv[P];
#pragma unroll
  for (int u = 0; u < P; ++u) {
    va[u] = vb[u] = vc[u] = 0u;
    gcv[u] = make_uint2(0u, 0u);
    nx[u] = make_int4(0, 0, 0, 0);
    if (kWhole || u < len) {
      const int4 q = R[u];
      va[u] = ring_at(col, q.x);
      vb[u] = ring_at(col, q.y);
      vc[u] = ring_at(col, q.z);
      gcv[u] = GC[u * DG];
    }
    if (kWhole || P + u < len) nx[u] = R[P + u];
  }
  const int end = kWhole ? T : len;
#pragma unroll(kWhole ? (T + P - 1) / P : 1)
  for (int j0 = 0; j0 < end; j0 += P) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int j = j0 + u;
      if (j < end) {
        const uint32_t y =
            chain_out(gcv[u].x + va[u] + vb[u] - vc[u], (int)gcv[u].y, prev1, prev2);
        prev2 = prev1;
        prev1 = y;
        W[j * DG] = y;
        if (j + P < end) {
          const int4 q = nx[u];
          va[u] = ring_at(col, q.x);
          vb[u] = ring_at(col, q.y);
          vc[u] = ring_at(col, q.z);
          gcv[u] = GC[(j + P) * DG];
          if (j + 2 * P < end) nx[u] = R[j + 2 * P];
        }
      }
    }
  }
}

// Threads [first, first + count): tile tau's outputs, ring to `o`.
template <int DG>
__device__ __forceinline__ void store_tile(int tau, const uint32_t* ring, int32_t* o, int n,
                                           int d, int first, int count) {
  constexpr int T = kChainTile;
  const int s0 = tau * T, len = min(T, n - s0);
  const uint32_t* src = ring + (tau & 1) * T * DG;
  for (int e = (int)threadIdx.x - first; e < len * DG; e += count) {
    const int j = e / DG, q = e - j * DG;
    o[(int64_t)(s0 + j) * d + q] = (int32_t)src[e];
  }
}

// res: [f, n, d] int32; idx: [f, n, 3] int32; out: [f, n, d] int32. Chain
// chain0 + blockIdx.x is (frame, group) = divmod(chain, groups), its
// components comp0 + group * DG + [0, DG).
template <int DG>
__global__ void __launch_bounds__(kChainThreads)
    parallelogram_decode_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ idx,
                                int32_t* out, int n, int d, int comp0, int groups,
                                int64_t chain0) {
  constexpr int T = kChainTile;
  extern __shared__ int4 smem4[];
  __shared__ int ringy[2];
  int4* rec = smem4;
  uint2* gc = (uint2*)(rec + 2 * T);
  uint32_t* ring = (uint32_t*)(gc + 2 * T * DG);
  const int64_t chain = chain0 + blockIdx.x, frame = chain / groups;
  const int comp = comp0 + (int)(chain % groups) * DG;
  const int32_t* r = res + frame * n * d + comp;
  const int32_t* ix = idx + frame * n * 3;
  int32_t* o = out + frame * n * d + comp;
  const int tiles = (n + T - 1) / T;
  if (threadIdx.x < DG) ring[2 * T * DG + threadIdx.x] = 0u;  // the zero slot
  if (threadIdx.x < 2) ringy[threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x >= 32) stage_tile<DG>(0, ix, r, o, rec, gc, ring, ringy, n, d);
  __syncthreads();
  uint32_t prev1 = 0u, prev2 = 0u;  // the last two outputs: lanes < DG of warp 0
  for (int t = 0; t < tiles; ++t) {
    if (threadIdx.x < 32) {
      if (threadIdx.x < DG) {
        const int lane = threadIdx.x, buf = t & 1, len = min(T, n - t * T);
        const uint2* GC = gc + buf * T * DG + lane;
        uint32_t* W = ring + buf * T * DG + lane;  // step t * T + j's slot: W[j * DG]
        if (ringy[buf] != t + 1) {
          if (len == T)
            step_free<DG, true>(len, prev1, prev2, GC, W);
          else
            step_free<DG, false>(len, prev1, prev2, GC, W);
        } else {
          const int4* R = rec + buf * T;
          const char* col = (const char*)(ring + lane);
          if (len == T)
            step_ringed<DG, true>(len, prev1, prev2, R, GC, col, W);
          else
            step_ringed<DG, false>(len, prev1, prev2, R, GC, col, W);
        }
      }
    } else {
      if (t + 1 < tiles) stage_tile<DG>(t + 1, ix, r, o, rec, gc, ring, ringy, n, d);
      if (t >= 1) store_tile<DG>(t - 1, ring, o, n, d, 32, kChainHelpers);
    }
    __syncthreads();
  }
  store_tile<DG>(tiles - 1, ring, o, n, d, 0, kChainThreads);
}

// ---------------------------------------------------------------------------
// The probe: cycles of a chain of dependent integer adds
// ---------------------------------------------------------------------------

// in: 3 uint32 (unknown to the compiler); out: [4] int64: the clock64
// cycles of kProbeAdds dependent add.u32, of kProbeAdds dependent
// mad.lo.u32 (U5's step), and the two results (kept live). The chains run
// in a rolled loop of 64 at a time, twice: the second pass, from a warm
// instruction cache, is the one recorded.
__global__ void dependent_add_probe_kernel(const uint32_t* __restrict__ in,
                                           long long* __restrict__ out) {
  uint32_t x = in[0], w = in[0];
  const uint32_t y = in[1], z = in[2];
  for (int pass = 0; pass < 2; ++pass) {
    const long long t0 = clock64();
#pragma unroll 1
    for (int o = 0; o < kProbeAdds / 64; ++o) {
#pragma unroll
      for (int i = 0; i < 64; ++i) asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
    }
    const long long t1 = clock64();
#pragma unroll 1
    for (int o = 0; o < kProbeAdds / 64; ++o) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        asm volatile("mad.lo.u32 %0, %1, %0, %2;" : "+r"(w) : "r"(z), "r"(y));
    }
    const long long t2 = clock64();
    out[0] = t1 - t0;
    out[1] = t2 - t1;
  }
  out[2] = x;
  out[3] = w;
}

// DG components a chain: one launch per kChainsPerLaunch chains.
template <int DG>
int launch_chains(const int32_t* res, const int32_t* idx, int32_t* out, int f, int n, int d,
                  int comp0, int groups, cudaStream_t stream) {
  const int64_t chains = (int64_t)f * groups;
  for (int64_t c0 = 0; c0 < chains; c0 += kChainsPerLaunch) {
    const unsigned grid = (unsigned)min(kChainsPerLaunch, chains - c0);
    parallelogram_decode_kernel<DG><<<grid, kChainThreads, chain_smem_bytes(DG), stream>>>(
        res, idx, out, n, d, comp0, groups, c0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The count kernel's dynamic shared limit raised to its most, once per
// device: cudaFuncSetAttribute on every call costs host time.
constexpr int kMaxDevices = 64;
cudaError_t allow_count_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(normals_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             count_smem_bytes(kRangeVertices));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

int launch_group(int dg, const int32_t* res, const int32_t* idx, int32_t* out, int f, int n, int d,
                 int comp0, int groups, cudaStream_t stream) {
  switch (dg) {
    case 1: return launch_chains<1>(res, idx, out, f, n, d, comp0, groups, stream);
    case 2: return launch_chains<2>(res, idx, out, f, n, d, comp0, groups, stream);
    case 3: return launch_chains<3>(res, idx, out, f, n, d, comp0, groups, stream);
    case 4: return launch_chains<4>(res, idx, out, f, n, d, comp0, groups, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// pos: [n, 3] float32; faces: [m, 3] int32; work: [n + 2 * ranges + 6 * m]
// int32 scratch (ranges = ceil(n / kRangeVertices); the keys, then as many
// words for the radix sorts of long rows); out: [n, 3] float32.
// Three launches: count, fill, normals.
int uvt_estimate_normals(const void* pos, const void* faces, void* work, void* out, int n, int m,
                         void* stream) {
  if (n <= 0 || m < 0 || m > kMaxFaces) return (int)cudaErrorInvalidValue;
  const int ranges = (n + kRangeVertices - 1) / kRangeVertices;
  if (ranges > kMaxRanges) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* local = (int32_t*)work;
  int32_t* total = local + n;
  int32_t* base = total + ranges;
  uint32_t* keys = (uint32_t*)(base + ranges);
  const uint32_t corners = 3u * (uint32_t)m;
  const int count_bytes = count_smem_bytes(min(n, kRangeVertices));
  cudaError_t err = allow_count_smem();
  if (err != cudaSuccess) return (int)err;
  normals_count_kernel<<<(unsigned)(ranges * kCountCluster), kCountThreads, count_bytes, s>>>(
      (const int32_t*)faces, corners, n, local, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned fill_ctas = corners == 0 ? 1u : (corners + kFillThreads - 1) / kFillThreads;
  normals_fill_kernel<<<fill_ctas, kFillThreads, 0, s>>>((const int32_t*)faces, corners, n, ranges,
                                                         local, total, base, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  estimate_normals_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const float*)pos, (const int32_t*)faces, local, base, keys, keys + corners, (float*)out, n,
      m);
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


// res: [f, n, d] int32; idx: [f, n, 3] int32; out: [f, n, d] int32. A CTA
// a (frame, group of kChainGroup components); d > kChainGroup takes a
// launch for its whole groups and one for the rest.
int uvt_parallelogram_decode(const void* res, const void* idx, void* out, int f, int n, int d,
                             void* stream) {
  if (f <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int32_t* r = (const int32_t*)res;
  const int32_t* ix = (const int32_t*)idx;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= kChainGroup) return launch_group(d, r, ix, o, f, n, d, 0, 1, s);
  const int whole = d / kChainGroup, rest = d - whole * kChainGroup;
  const int err = launch_group(kChainGroup, r, ix, o, f, n, d, 0, whole, s);
  if (err != 0 || rest == 0) return err;
  return launch_group(rest, r, ix, o, f, n, d, whole * kChainGroup, 1, s);
}

// in: [3] uint32; out: [4] int64 (dependent_add_probe_kernel). One launch
// of one thread.
int uvt_dependent_add_cycles(const void* in, void* out, void* stream) {
  dependent_add_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const uint32_t*)in,
                                                              (long long*)out);
  return (int)cudaGetLastError();
}

int uvt_mesh_func_attrs(int which, int* out, const char** name) {
  static const KernelRef ks[] = {
      UVT_KERNEL(normals_count_kernel),
      UVT_KERNEL(normals_fill_kernel),
      UVT_KERNEL(estimate_normals_kernel),
      UVT_KERNEL(morton_keys_kernel),
      KernelRef{(const void*)parallelogram_decode_kernel<1>, "parallelogram_decode_kernel<1>"},
      KernelRef{(const void*)parallelogram_decode_kernel<2>, "parallelogram_decode_kernel<2>"},
      KernelRef{(const void*)parallelogram_decode_kernel<3>, "parallelogram_decode_kernel<3>"},
      KernelRef{(const void*)parallelogram_decode_kernel<4>, "parallelogram_decode_kernel<4>"},
      UVT_KERNEL(dependent_add_probe_kernel)};
  return fill_func_attrs(ks, which, out, name);
}

}  // extern "C"
