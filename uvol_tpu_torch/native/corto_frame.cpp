// uvol-tpu whole-frame Corto `.crt` decoder (C ABI, ctypes-bound).
//
// One C call per frame: container parse -> entropy blocks -> CLER front
// machine -> value unpack -> delta integration -> normal/color post passes
// -> dequantize.  Bit-exact contract with the staged Python pipeline in
// uvol_tpu/codecs/corto/decoder.py (decode_crt), which itself mirrors the
// reference decoder (src/lib/corto.ts:142-297, 828-927) and the canonical
// C++ encoder's wire format (deprecated/encoder/dev/src/cstream.h,
// decoder.cpp).  The staged path stays as the oracle + fallback: any
// unsupported branch returns rc<0 and Python decodes the frame instead.
//
// Builds into libuvt_corto.so together with corto_native.cpp (the CLER
// machine + value unpackers + Tunstall tables this file calls) and
// entropy.cpp (uvt_tunstall_expand).  Needs -lz for the ZLIB entropy mode
// (cstream.cpp:124-143).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

// ---------------------------------------------------------------------------
// Sibling translation units (same .so)
// ---------------------------------------------------------------------------
extern "C" {
int uvt_corto_unpack_values(const uint32_t* words, int64_t nwords,
                            const uint8_t* logs, int64_t size, int n,
                            int32_t* out);
int uvt_corto_unpack_tuples(const uint32_t* words, int64_t nwords,
                            const uint8_t* logs, int64_t size, int n,
                            int32_t* out);
int uvt_corto_decode_faces(const uint8_t* clers, int64_t nclers,
                           const uint32_t* words, int64_t nwords,
                           const int64_t* group_ends, int ngroups,
                           int splitbits, int64_t nvert, int32_t* faces,
                           int32_t* prediction);
int uvt_corto_delta_decode(int32_t* values, int64_t nvert, int n,
                           const int32_t* prediction, int mode);
int uvt_tunstall_tables(const uint8_t* syms_in, const uint8_t* probs_in,
                        int n_symbols, uint8_t* words_out,
                        int64_t words_capacity, int32_t* index_out,
                        int32_t* lengths_out);
int uvt_tunstall_expand(const uint8_t* words, const int32_t* index,
                        const int32_t* lengths, const uint8_t* comp,
                        int comp_len, uint8_t* out, int out_size);
int uvt_corto_normals_dequant(const int32_t* st, int64_t n, float unit,
                              float* out);
}

namespace {

// fallback codes (rc<0 => Python staged path decodes the frame)
enum {
  CFB_OK = 0,
  CFB_TRUNCATED = -1,
  CFB_BAD_MAGIC = -2,
  CFB_ENTROPY = -3,     // unknown entropy id / HUFFMAN (reference throws too)
  CFB_MALFORMED = -4,   // stream decodes but violates invariants
  CFB_UNSUPPORTED = -5, // legal wire we don't orchestrate (Python handles)
  CFB_INTERNAL = -6,
};

constexpr uint32_t kMagic = 0x787A6300u;  // decoder.py:19
enum { ENT_NONE = 0, ENT_TUNSTALL = 1, ENT_HUFFMAN = 2, ENT_ZLIB = 3,
       ENT_LZ4 = 4 };
enum { CODEC_GENERIC = 1, CODEC_NORMAL = 2, CODEC_COLOR = 3 };
enum { STRAT_PARALLEL = 0x1, STRAT_CORRELATED = 0x2 };
enum { FMT_UINT32 = 0, FMT_INT32, FMT_UINT16, FMT_INT16, FMT_UINT8,
       FMT_INT8, FMT_FLOAT, FMT_DOUBLE };
enum { PRED_DIFF = 0, PRED_ESTIMATED = 1, PRED_BORDER = 2 };

inline int ilog2i(uint32_t p) {
  int k = 0;
  while (p > 1) { p >>= 1; k++; }
  return k;
}

// Bounds-checked little-endian reader over the frame buffer
// (CortoInStream in stream.py).
struct CBuf {
  const uint8_t* d;
  int64_t len;
  int64_t pos = 0;
  bool fail = false;

  bool need(int64_t n) {
    if (fail || pos + n > len) { fail = true; return false; }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return d[pos++];
  }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v = (uint16_t)(d[pos] | (d[pos + 1] << 8));
    pos += 2;
    return v;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v;
    memcpy(&v, d + pos, 4);
    pos += 4;
    return v;
  }
  float f32() {
    if (!need(4)) return 0.f;
    float v;
    memcpy(&v, d + pos, 4);
    pos += 4;
    return v;
  }
  // u16 length (incl. NUL) + bytes + NUL (cstream string framing)
  bool string(std::string* out) {
    uint16_t n = u16();
    if (fail || n == 0 || !need(n)) { fail = true; return false; }
    out->assign((const char*)(d + pos), n - 1);
    pos += n;
    return true;
  }
};

// decompress_block (stream.py:273): one entropy-framed byte block.
int decompress_block(CBuf& b, int entropy, std::vector<uint8_t>& out) {
  if (entropy == ENT_NONE) {
    uint32_t size = b.u32();
    if (!b.need(size)) return CFB_TRUNCATED;
    out.assign(b.d + b.pos, b.d + b.pos + size);
    b.pos += size;
    return CFB_OK;
  }
  if (entropy == ENT_ZLIB || entropy == ENT_LZ4) {
    uint32_t size = b.u32();
    uint32_t csize = b.u32();
    if (b.fail || !b.need(csize)) return CFB_TRUNCATED;
    const uint8_t* payload = b.d + b.pos;
    b.pos += csize;
    out.assign(size, 0);
    if (size == 0) return CFB_OK;
    if (entropy == ENT_ZLIB) {
      uLongf dlen = size;
      if (uncompress(out.data(), &dlen, payload, csize) != Z_OK ||
          dlen != size)
        return CFB_MALFORMED;
      return CFB_OK;
    }
    // LZ4 block format (codecs/corto/lz4.py decompress, bounds-checked)
    int64_t i = 0, n = csize, op = 0;
    while (i < n) {
      uint32_t token = payload[i++];
      int64_t lit = token >> 4;
      if (lit == 15) {
        while (true) {
          if (i >= n) return CFB_MALFORMED;
          uint8_t x = payload[i++];
          lit += x;
          if (x != 255) break;
        }
      }
      if (i + lit > n || op + lit > (int64_t)size) return CFB_MALFORMED;
      memcpy(out.data() + op, payload + i, lit);
      i += lit;
      op += lit;
      if (i >= n) break;  // last sequence: literals only
      if (i + 2 > n) return CFB_MALFORMED;
      int64_t offset = payload[i] | ((int64_t)payload[i + 1] << 8);
      i += 2;
      if (offset == 0 || offset > op) return CFB_MALFORMED;
      int64_t mlen = (token & 0xF) + 4;
      if ((token & 0xF) == 15) {
        while (true) {
          if (i >= n) return CFB_MALFORMED;
          uint8_t x = payload[i++];
          mlen += x;
          if (x != 255) break;
        }
      }
      if (op + mlen > (int64_t)size) return CFB_MALFORMED;
      for (int64_t k = 0; k < mlen; k++) {  // overlapping matches replicate
        out[op] = out[op - offset];
        op++;
      }
    }
    if (op != (int64_t)size) return CFB_MALFORMED;
    return CFB_OK;
  }
  if (entropy != ENT_TUNSTALL) return CFB_ENTROPY;  // incl. HUFFMAN
  int nsymbols = b.u8();
  if (b.fail || !b.need(2 * nsymbols)) return CFB_TRUNCATED;
  const uint8_t* pairs = b.d + b.pos;
  b.pos += 2 * nsymbols;
  uint32_t size = b.u32();
  uint32_t csize = b.u32();
  if (b.fail || !b.need(csize)) return CFB_TRUNCATED;
  const uint8_t* payload = b.d + b.pos;
  b.pos += csize;
  out.assign(size, 0);
  if (size == 0) return CFB_OK;
  if (nsymbols == 0) return CFB_MALFORMED;
  if (nsymbols == 1) {  // tunstall.py decompress: single-symbol fill
    memset(out.data(), pairs[0], size);
    return CFB_OK;
  }
  uint8_t syms[256], probs[256];
  for (int i = 0; i < nsymbols; i++) {
    syms[i] = pairs[i * 2];
    probs[i] = pairs[i * 2 + 1];
  }
  std::vector<uint8_t> words(256 * 260);
  int32_t index[256], lengths[256];
  int nw = uvt_tunstall_tables(syms, probs, nsymbols, words.data(),
                               (int64_t)words.size(), index, lengths);
  if (nw < 0) return CFB_MALFORMED;
  if (uvt_tunstall_expand(words.data(), index, lengths, payload, (int)csize,
                          out.data(), (int)size) != 0)
    return CFB_MALFORMED;
  return CFB_OK;
}

// read_bitstream (stream.py:264): i32 word count, 4-byte align, words.
int read_bitstream(CBuf& b, const uint32_t** words, int64_t* nwords) {
  int64_t n = (int32_t)b.u32();
  if (b.fail || n < 0) return CFB_TRUNCATED;
  int64_t pad = b.pos & 3;
  if (pad) b.pos += 4 - pad;
  if (!b.need(n * 4)) return CFB_TRUNCATED;
  *words = (const uint32_t*)(b.d + b.pos);  // frame buffers are 4-aligned
  b.pos += n * 4;
  *nwords = n;
  return CFB_OK;
}

struct CrtAttr {
  std::string name;
  int codec = CODEC_GENERIC;
  float q = 1.f;
  int components = 0;
  int format = FMT_FLOAT;
  int strategy = 0;
  int prediction = PRED_DIFF;  // normals only
  uint8_t qc[4] = {1, 1, 1, 1};  // colors only
  std::vector<int32_t> ivals;  // decoded ints [nvert * wire_components]

  // materialized output
  int out_dtype = 0;  // 0=float32 1=int64 2=uint8
  int out_components = 0;
  std::vector<float> out_f;
  std::vector<int64_t> out_i;
  std::vector<uint8_t> out_u8;
};

struct CrtFrame {
  int64_t nvert = 0, nface = 0;
  std::vector<int32_t> faces;  // [3*nface]
  std::vector<CrtAttr> attrs;
};

// decode one value block for an attribute (decoder.py _attr_decode)
int attr_decode(CBuf& b, int entropy, CrtAttr& a, int64_t nvert) {
  if (a.codec == CODEC_NORMAL) {
    a.prediction = b.u8();
    if (b.fail) return CFB_TRUNCATED;
    const uint32_t* w;
    int64_t nw;
    int rc = read_bitstream(b, &w, &nw);
    if (rc) return rc;
    std::vector<uint8_t> logs;
    rc = decompress_block(b, entropy, logs);
    if (rc) return rc;
    if ((int64_t)logs.size() < nvert) return CFB_MALFORMED;
    a.ivals.assign(nvert * 2, 0);
    if (uvt_corto_unpack_tuples(w, nw, logs.data(), nvert, 2,
                                a.ivals.data()) != 0)
      return CFB_MALFORMED;
    return CFB_OK;
  }
  if (a.codec == CODEC_COLOR) {
    for (int k = 0; k < 4; k++) a.qc[k] = b.u8();
    if (b.fail) return CFB_TRUNCATED;
  }
  int n = a.components;
  if (n <= 0 || n > 8) return CFB_UNSUPPORTED;
  const uint32_t* w;
  int64_t nw;
  int rc = read_bitstream(b, &w, &nw);
  if (rc) return rc;
  a.ivals.assign(nvert * n, 0);
  if (a.strategy & STRAT_CORRELATED) {
    std::vector<uint8_t> logs;
    rc = decompress_block(b, entropy, logs);
    if (rc) return rc;
    if ((int64_t)logs.size() < nvert) return CFB_MALFORMED;
    if (uvt_corto_unpack_tuples(w, nw, logs.data(), nvert, n,
                                a.ivals.data()) != 0)
      return CFB_MALFORMED;
  } else {
    // decode_values: one log block per component, read in component order
    std::vector<uint8_t> logs(nvert * n);
    std::vector<uint8_t> block;
    for (int c = 0; c < n; c++) {
      rc = decompress_block(b, entropy, block);
      if (rc) return rc;
      if ((int64_t)block.size() < nvert) return CFB_MALFORMED;
      memcpy(logs.data() + (int64_t)c * nvert, block.data(), nvert);
    }
    if (uvt_corto_unpack_values(w, nw, logs.data(), nvert, n,
                                a.ivals.data()) != 0)
      return CFB_MALFORMED;
  }
  return CFB_OK;
}

// _to_octa_float (decoder.py:426) for one normal
inline void to_octa(double x, double y, double z, double* o0, double* o1) {
  double length = std::fabs(x) + std::fabs(y) + std::fabs(z);
  if (length == 0) { *o0 = 0; *o1 = 0; return; }
  double p0 = x / length, p1 = y / length;
  if (z < 0) {
    double ap0 = std::fabs(p0), ap1 = std::fabs(p1);
    double n0 = (x >= 0) ? 1.0 - ap1 : ap1 - 1.0;
    double n1 = (y >= 0) ? 1.0 - ap0 : ap0 - 1.0;
    p0 = n0;
    p1 = n1;
  }
  *o0 = p0;
  *o1 = p1;
}

// _to_sphere (decoder.py:442) over int64 (s,t) with sign tests on the ints
inline void to_sphere_i64(int64_t si, int64_t ti, double unit, float* out3) {
  double x = (double)si, y = (double)ti;
  double z = unit - std::fabs(x) - std::fabs(y);
  if (z < 0) {
    double ax = std::fabs(x), ay = std::fabs(y);
    double nx = (si > 0) ? unit - ay : ay - unit;
    double ny = (ti > 0) ? unit - ax : ax - unit;
    x = nx;
    y = ny;
  }
  double norm = std::sqrt(x * x + y * y + z * z);
  if (norm > 0) {
    out3[0] = (float)(x / norm);
    out3[1] = (float)(y / norm);
    out3[2] = (float)(z / norm);
  } else {
    out3[0] = 0; out3[1] = 0; out3[2] = 1;
  }
}

// NORMAL_CODEC ESTIMATED/BORDER post pass (decoder.py _attr_post_delta):
// face-normal accumulation over the *quantized* position ints, octahedral
// correction in mask order, JS Int32Array truncation semantics.
int normals_post_delta(CrtAttr& a, const CrtAttr* pos, int64_t nvert,
                       const std::vector<int32_t>& faces) {
  if (!pos || pos->ivals.empty() || pos->components < 3)
    return CFB_UNSUPPORTED;
  int pc = pos->components;
  int64_t nf = (int64_t)faces.size() / 3;
  // face normals first, then three corner passes — the accumulation order
  // must match decoder.py _estimate_normals (np.add.at per corner column)
  // bit-for-bit: float64 addition is order-sensitive and a ULP flip can
  // move a trunc() below
  std::vector<double> fn(nf * 3);
  for (int64_t f = 0; f < nf; f++) {
    int64_t va = faces[f * 3], vb = faces[f * 3 + 1], vc = faces[f * 3 + 2];
    if (va >= nvert || vb >= nvert || vc >= nvert) return CFB_MALFORMED;
    double ax = pos->ivals[va * pc], ay = pos->ivals[va * pc + 1],
           az = pos->ivals[va * pc + 2];
    double e1x = pos->ivals[vb * pc] - ax, e1y = pos->ivals[vb * pc + 1] - ay,
           e1z = pos->ivals[vb * pc + 2] - az;
    double e2x = pos->ivals[vc * pc] - ax, e2y = pos->ivals[vc * pc + 1] - ay,
           e2z = pos->ivals[vc * pc + 2] - az;
    fn[f * 3] = e1y * e2z - e1z * e2y;
    fn[f * 3 + 1] = e1z * e2x - e1x * e2z;
    fn[f * 3 + 2] = e1x * e2y - e1y * e2x;
  }
  std::vector<double> est(nvert * 3, 0.0);
  for (int corner = 0; corner < 3; corner++) {
    for (int64_t f = 0; f < nf; f++) {
      int64_t v = faces[f * 3 + corner];
      est[v * 3] += fn[f * 3];
      est[v * 3 + 1] += fn[f * 3 + 1];
      est[v * 3 + 2] += fn[f * 3 + 2];
    }
  }
  std::vector<uint8_t> mask(nvert, 1);
  if (a.prediction == PRED_BORDER) {
    // boundary via the commutative XOR trick (decoder.py:357)
    std::vector<int64_t> boundary(nvert, 0);
    for (int64_t f = 0; f < nf; f++) {
      int64_t va = faces[f * 3], vb = faces[f * 3 + 1], vc = faces[f * 3 + 2];
      boundary[va] ^= vb ^ vc;
      boundary[vb] ^= vc ^ va;
      boundary[vc] ^= va ^ vb;
    }
    for (int64_t v = 0; v < nvert; v++) mask[v] = boundary[v] != 0;
  }
  a.out_dtype = 0;
  a.out_components = 3;
  a.out_f.assign(nvert * 3, 0.f);
  double q = a.q;
  int64_t j = 0;  // corrections are stored in mask order
  for (int64_t v = 0; v < nvert; v++) {
    if (mask[v]) {
      double o0, o1;
      to_octa(est[v * 3], est[v * 3 + 1], est[v * 3 + 2], &o0, &o1);
      if (j * 2 + 1 >= (int64_t)a.ivals.size()) return CFB_MALFORMED;
      int64_t s = (int64_t)std::trunc((double)a.ivals[j * 2] + o0 * q);
      int64_t t = (int64_t)std::trunc((double)a.ivals[j * 2 + 1] + o1 * q);
      j++;
      to_sphere_i64(s, t, q, a.out_f.data() + v * 3);
    } else {
      double nx = est[v * 3], ny = est[v * 3 + 1], nz = est[v * 3 + 2];
      double norm = std::sqrt(nx * nx + ny * ny + nz * nz);
      if (norm > 0) {
        a.out_f[v * 3] = (float)(nx / norm);
        a.out_f[v * 3 + 1] = (float)(ny / norm);
        a.out_f[v * 3 + 2] = (float)(nz / norm);
      } else {
        a.out_f[v * 3 + 2] = 1.f;
      }
    }
  }
  return CFB_OK;
}

int decode_frame(const uint8_t* data, int64_t len, CrtFrame& out) {
  CBuf b{data, len};
  if (b.u32() != kMagic) return CFB_BAD_MAGIC;
  (void)b.u32();  // version
  int entropy = b.u8();
  if (b.fail) return CFB_TRUNCATED;
  if (entropy == ENT_HUFFMAN || entropy > ENT_LZ4) return CFB_ENTROPY;

  uint32_t n_exif = b.u32();
  if (n_exif > 1u << 20) return CFB_MALFORMED;
  std::string k, v;
  for (uint32_t i = 0; i < n_exif; i++) {
    if (!b.string(&k) || !b.string(&v)) return CFB_TRUNCATED;
  }

  uint32_t n_attrs = b.u32();
  if (b.fail || n_attrs > 256) return CFB_MALFORMED;
  out.attrs.resize(n_attrs);
  for (uint32_t i = 0; i < n_attrs; i++) {
    CrtAttr& a = out.attrs[i];
    if (!b.string(&a.name)) return CFB_TRUNCATED;
    a.codec = (int)b.u32();
    a.q = b.f32();
    a.components = b.u8();
    a.format = b.u8();
    a.strategy = b.u8();
    if (b.fail) return CFB_TRUNCATED;
    if (a.codec == CODEC_COLOR && a.components != 4) return CFB_UNSUPPORTED;
  }

  out.nvert = b.u32();
  out.nface = b.u32();
  if (b.fail || out.nvert < 0 || out.nvert > (int64_t)1 << 31 ||
      out.nface > (int64_t)1 << 31)
    return CFB_MALFORMED;

  uint32_t n_groups = b.u32();
  if (b.fail || n_groups > 1u << 20) return CFB_MALFORMED;
  std::vector<int64_t> group_ends(n_groups);
  for (uint32_t g = 0; g < n_groups; g++) {
    group_ends[g] = b.u32();
    int nprops = b.u8();
    if (b.fail) return CFB_TRUNCATED;
    for (int p = 0; p < nprops; p++) {
      if (!b.string(&k) || !b.string(&v)) return CFB_TRUNCATED;
    }
  }

  std::vector<int32_t> prediction;
  if (out.nface > 0) {
    (void)b.u32();  // max_front
    std::vector<uint8_t> clers;
    int rc = decompress_block(b, entropy, clers);
    if (rc) return rc;
    const uint32_t* words;
    int64_t nwords;
    rc = read_bitstream(b, &words, &nwords);
    if (rc) return rc;
    // exact invariants before the big allocations: every decoded face
    // consumes one CLER symbol and every new vertex comes from one symbol
    // (the initial face's 1 symbol mints <=3) — a corrupt header cannot
    // demand buffers the symbol stream could never fill
    if (out.nface > (int64_t)clers.size() ||
        out.nvert > 3 * (int64_t)clers.size())
      return CFB_MALFORMED;
    int splitbits = ilog2i((uint32_t)out.nvert) + 1;
    out.faces.assign(out.nface * 3, 0);
    prediction.assign(out.nvert * 3, 0);
    int vc = uvt_corto_decode_faces(clers.data(), (int64_t)clers.size(),
                                    words, nwords, group_ends.data(),
                                    (int)n_groups, splitbits, out.nvert,
                                    out.faces.data(), prediction.data());
    if (vc < 0) return CFB_MALFORMED;
  }

  // stream decode in name-sorted order (decoder.py:122; Python sorted()
  // on ASCII names == byte-wise std::string <)
  std::vector<int> order(n_attrs);
  for (uint32_t i = 0; i < n_attrs; i++) order[i] = (int)i;
  std::sort(order.begin(), order.end(), [&](int x, int y) {
    return out.attrs[x].name < out.attrs[y].name;
  });
  for (int idx : order) {
    int rc = attr_decode(b, entropy, out.attrs[idx], out.nvert);
    if (rc) return rc;
  }

  // delta integration (decoder.py _attr_delta_decode)
  for (auto& a : out.attrs) {
    if (a.codec == CODEC_NORMAL && a.prediction != PRED_DIFF) continue;
    int n = (a.codec == CODEC_NORMAL) ? 2 : a.components;
    int mode;
    if (out.nface == 0)
      mode = 2;
    else if (a.codec != CODEC_NORMAL && (a.strategy & STRAT_PARALLEL))
      mode = 0;
    else
      mode = 1;
    if (uvt_corto_delta_decode(a.ivals.data(), out.nvert, n,
                               mode == 2 ? nullptr : prediction.data(),
                               mode) != 0)
      return CFB_MALFORMED;
  }

  // post-delta (estimated/border normals) + dequantize
  const CrtAttr* pos = nullptr;
  for (auto& a : out.attrs)
    if (a.name == "position") pos = &a;
  for (auto& a : out.attrs) {
    if (a.codec == CODEC_NORMAL) {
      if (a.prediction != PRED_DIFF) {
        if (out.nface == 0) return CFB_UNSUPPORTED;
        int rc = normals_post_delta(a, pos, out.nvert, out.faces);
        if (rc) return rc;
      } else {
        a.out_dtype = 0;
        a.out_components = 3;
        a.out_f.assign(out.nvert * 3, 0.f);
        uvt_corto_normals_dequant(a.ivals.data(), out.nvert, a.q,
                                  a.out_f.data());
      }
    } else if (a.codec == CODEC_COLOR) {
      // decoder.py _attr_dequantize color branch (&0xFF after the scale)
      a.out_dtype = 2;
      a.out_components = 4;
      a.out_u8.assign(out.nvert * 4, 0);
      for (int64_t i = 0; i < out.nvert; i++) {
        int64_t e0 = a.ivals[i * 4], e1 = a.ivals[i * 4 + 1],
                e2 = a.ivals[i * 4 + 2], e3 = a.ivals[i * 4 + 3];
        a.out_u8[i * 4] = (uint8_t)(((e2 + e0) * a.qc[0]) & 0xFF);
        a.out_u8[i * 4 + 1] = (uint8_t)((e0 * a.qc[1]) & 0xFF);
        a.out_u8[i * 4 + 2] = (uint8_t)(((e1 + e0) * a.qc[2]) & 0xFF);
        a.out_u8[i * 4 + 3] = (uint8_t)((e3 * a.qc[3]) & 0xFF);
      }
    } else if (a.format == FMT_FLOAT || a.format == FMT_DOUBLE) {
      a.out_dtype = 0;
      a.out_components = a.components;
      a.out_f.resize(out.nvert * a.components);
      double q = a.q;
      for (size_t i = 0; i < a.out_f.size(); i++)
        a.out_f[i] = (float)((double)a.ivals[i] * q);
    } else {
      // integer formats: (values * q).astype(int64) — float64 multiply,
      // truncation toward zero (decoder.py:413)
      a.out_dtype = 1;
      a.out_components = a.components;
      a.out_i.resize(out.nvert * a.components);
      double q = a.q;
      for (size_t i = 0; i < a.out_i.size(); i++)
        a.out_i[i] = (int64_t)((double)a.ivals[i] * q);
    }
    a.ivals.clear();
    a.ivals.shrink_to_fit();
  }
  return CFB_OK;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI (mirrors the uvt_drc_* handle surface in draco_frame.cpp)
// ---------------------------------------------------------------------------

extern "C" {

// out_info: [0]=rc (0 ok; <0 => Python fallback), [1]=num_attrs,
// [2]=nvert, [3]=nface.  Returns a handle for uvt_crt_free (NULL on rc<0).
void* uvt_crt_decode(const uint8_t* data, int64_t len, int64_t* out_info) {
  CrtFrame* f = new CrtFrame();
  int rc;
  try {
    rc = decode_frame(data, len, *f);
  } catch (...) {
    rc = CFB_INTERNAL;
  }
  out_info[0] = rc;
  if (rc != CFB_OK) {
    delete f;
    out_info[1] = out_info[2] = out_info[3] = 0;
    return nullptr;
  }
  out_info[1] = (int64_t)f->attrs.size();
  out_info[2] = f->nvert;
  out_info[3] = f->nface;
  return f;
}

// info4: [codec, out_components, out_dtype (0=f32 1=i64 2=u8), name_len]
int uvt_crt_attr_info(void* h, int idx, int64_t* info4) {
  CrtFrame* f = (CrtFrame*)h;
  if (!f || idx < 0 || idx >= (int)f->attrs.size()) return -1;
  const CrtAttr& a = f->attrs[idx];
  info4[0] = a.codec;
  info4[1] = a.out_components;
  info4[2] = a.out_dtype;
  info4[3] = (int64_t)a.name.size();
  return 0;
}

int uvt_crt_attr_name(void* h, int idx, char* out) {
  CrtFrame* f = (CrtFrame*)h;
  if (!f || idx < 0 || idx >= (int)f->attrs.size()) return -1;
  const CrtAttr& a = f->attrs[idx];
  memcpy(out, a.name.data(), a.name.size());
  return 0;
}

// values_out sized nvert*out_components of the declared dtype
int uvt_crt_attr_fetch(void* h, int idx, void* values_out) {
  CrtFrame* f = (CrtFrame*)h;
  if (!f || idx < 0 || idx >= (int)f->attrs.size()) return -1;
  const CrtAttr& a = f->attrs[idx];
  if (a.out_dtype == 0)
    memcpy(values_out, a.out_f.data(), a.out_f.size() * 4);
  else if (a.out_dtype == 1)
    memcpy(values_out, a.out_i.data(), a.out_i.size() * 8);
  else
    memcpy(values_out, a.out_u8.data(), a.out_u8.size());
  return 0;
}

int uvt_crt_faces_fetch(void* h, int32_t* out) {
  CrtFrame* f = (CrtFrame*)h;
  if (!f) return -1;
  memcpy(out, f->faces.data(), f->faces.size() * 4);
  return 0;
}

void uvt_crt_free(void* h) { delete (CrtFrame*)h; }

}  // extern "C"
