// Whole-frame Draco ENCODE orchestrator: one C call per .drc frame.
//
// Mirrors uvol_tpu/codecs/draco/encoder.py encode_drc() step by step —
// encoder corner table -> edgebreaker traversal -> decoder replay ->
// dec<->enc maps + seams -> connectivity serialization (valence rANS or
// standard bit-coded) -> per-attribute DFS / quantize / predict /
// symbol-encode. Every heavy stage calls the same component functions
// (draco_native.cpp, entropy.cpp) the staged Python pipeline uses; this
// file adds the orchestration, the byte serialization (EncoderBuffer /
// RansBitEncoder semantics from codecs/buffer.py + codecs/rans.py), and
// the float quantization math (float64, matching numpy op-for-op; all
// native builds use -ffp-contract=off for exactly this reason).
//
// Byte-identity contract: output is bit-exact with encoder.py, which
// stays in the tree as oracle and fallback (tests/test_native_draco.py
// locks equality across the liam corpus and the synthetic fixtures).
// Unsupported corners (symbols needing the TAGGED scheme, meshes the
// component calls reject) return a negative code and the caller falls
// back to the staged path.
//
// Reference scope: scripts/Encoder.py drives an external draco_encoder
// binary per frame (SURVEY §2); this is the repo's own encoder, made
// GIL-free and single-call so multi-core hosts scale it like the decode
// orchestrator (draco_frame.cpp).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <memory>
#include <vector>

namespace {
constexpr int32_t INVALID = -1;
inline int32_t next_c(int32_t c) { return (c % 3 == 2) ? c - 2 : c + 1; }
inline int32_t prev_c(int32_t c) { return (c % 3 == 0) ? c + 2 : c - 1; }
inline int64_t next_c64(int64_t c) { return (c % 3 == 2) ? c - 2 : c + 1; }
inline int64_t prev_c64(int64_t c) { return (c % 3 == 0) ? c + 2 : c - 1; }

inline int rans_precision_bits(int l) {
  int p = (3 * l) / 2;
  if (p < 12) p = 12;
  if (p > 20) p = 20;
  return p;
}
}  // namespace

// ---------------------------------------------------------------------------
// Component functions from draco_native.cpp / entropy.cpp (same .so)
// ---------------------------------------------------------------------------
extern "C" {
int64_t uvt_encoder_corner_table(const int64_t* faces, int64_t num_faces,
                                 int64_t num_positions, int32_t* opposite,
                                 int32_t* corner_vertex,
                                 int32_t* vertex_corner);
int uvt_eb_traverse(const int32_t* vertex, const int32_t* opposite,
                    const int64_t* hole_of, int64_t num_faces,
                    int64_t num_vertices, int64_t num_holes, uint8_t* symbols,
                    int32_t* symbol_corners, uint8_t* start_face_bits,
                    int64_t* split_src, int64_t* split_id, uint8_t* split_edge,
                    int32_t* init_face_corners,
                    int32_t* interior_start_corners, int64_t* counts);
int uvt_eb_replay_machine(const uint8_t* symbols_decode_order,
                          int64_t num_symbols, int64_t num_faces,
                          int64_t max_vertices, const int64_t* split_source,
                          const int64_t* split_id, const uint8_t* split_edge,
                          int64_t num_splits, const uint8_t* sf_bits,
                          int64_t n_sf_bits, int32_t* opposite,
                          int32_t* vertex, int32_t* vertex_corner,
                          int32_t* processed_corners, int32_t* out_contexts,
                          int64_t* out_counts);
int uvt_eb_encode_maps(int64_t num_faces, int64_t num_symbols,
                       int64_t num_vertex_slots,
                       const int64_t* symbol_corners_rev, const int32_t* dvert,
                       const int32_t* enc_vertex, const int32_t* enc_opposite,
                       const int32_t* opp_d,
                       const int64_t* interior_start_corners,
                       int64_t num_attrs, const int64_t* c2v_all,
                       int64_t* dec2enc_corner, int64_t* cs_out,
                       uint8_t* bits_out, int64_t* pairs_out,
                       int64_t* boundary_out, int64_t* counts_out);
int uvt_attr_corner_table(const int32_t* opposite, const int32_t* vertex,
                          const int32_t* vertex_corner, int64_t num_vertices,
                          int64_t num_corners, const uint8_t* seam_mask,
                          const uint8_t* vertex_on_seam,
                          int32_t* corner_to_vertex, int32_t* vertex_to_corner,
                          uint8_t* fan_open_out,
                          int64_t* out_num_attr_vertices);
int uvt_traverse_depth_first(const int32_t* opposite,
                             const int32_t* view_vertex,
                             const uint8_t* seam_mask, int64_t num_faces,
                             int64_t num_view_vertices,
                             const int32_t* corner_order, int64_t n_order,
                             const uint8_t* fan_open_in,
                             int32_t* vertex_to_data, int32_t* data_to_corner,
                             int64_t* out_num_values);
int uvt_parallelogram_encode(const int64_t* values, int64_t n, int nc,
                             int64_t mn, int64_t mx, const int32_t* opposite,
                             const int32_t* view_vertex,
                             const uint8_t* seam_mask,
                             const int32_t* vertex_to_data,
                             const int32_t* data_to_corner, int64_t* corr_out);
int64_t uvt_texcoords_encode(const int64_t* values, int64_t n, int64_t mn,
                             int64_t mx, const int32_t* view_vertex,
                             const int32_t* vertex_to_data,
                             const int32_t* data_to_corner,
                             const int64_t* positions,
                             const int32_t* pos_data_of_corner,
                             int64_t* corr_out, uint8_t* orientations);
int uvt_normals_encode(const int64_t* oct_coords, int64_t n,
                       int64_t max_quantized_value, const int32_t* opposite,
                       const int32_t* view_vertex, const uint8_t* seam_mask,
                       const int32_t* data_to_corner, const int64_t* positions,
                       const int32_t* pos_data_of_corner, int64_t* corr_out,
                       uint8_t* flip_bits, int64_t num_faces,
                       const int32_t* vertex_to_data);
int uvt_quantize_normals(const double* normals, int64_t n, int bits,
                         int64_t* out_st);
int64_t uvt_rans_symbol_encode(const uint32_t* symbols, int64_t n,
                               int64_t alphabet, int precision_bits,
                               uint8_t* out, int64_t cap);
int64_t uvt_rabs_encode_bits(const uint8_t* bits, int64_t n,
                             uint32_t prob_zero, uint8_t* out,
                             int64_t out_cap);
}

namespace {

// ---------------------------------------------------------------------------
// EncoderBuffer (codecs/buffer.py semantics)
// ---------------------------------------------------------------------------
struct EncBuf {
  std::vector<uint8_t> d;
  // LSB-first bit section state (put_bits / end_bit_encoding)
  std::vector<uint8_t> bits_bytes;
  int bit_count = -1;

  void u8(uint8_t v) { d.push_back(v); }
  void u16(uint16_t v) {
    d.push_back(v & 0xFF);
    d.push_back(v >> 8);
  }
  void i32(int32_t v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    for (int i = 0; i < 4; ++i) d.push_back((u >> (8 * i)) & 0xFF);
  }
  void f32(float v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    for (int i = 0; i < 4; ++i) d.push_back((u >> (8 * i)) & 0xFF);
  }
  void raw(const uint8_t* p, int64_t n) { d.insert(d.end(), p, p + n); }
  void varint(uint64_t v) {
    while (true) {
      uint8_t b = v & 0x7F;
      v >>= 7;
      if (v) {
        d.push_back(b | 0x80);
      } else {
        d.push_back(b);
        return;
      }
    }
  }
  void start_bits() {
    bits_bytes.clear();
    bit_count = 0;
  }
  void put_bits(uint32_t value, int nbits) {
    // little-endian bit accumulation, byte i holds bits 8i..8i+7
    for (int k = 0; k < nbits; ++k) {
      int64_t bit_idx = bit_count + k;
      size_t byte_idx = (size_t)(bit_idx >> 3);
      if (byte_idx >= bits_bytes.size()) bits_bytes.push_back(0);
      if ((value >> k) & 1) bits_bytes[byte_idx] |= (uint8_t)(1 << (bit_idx & 7));
    }
    bit_count += nbits;
  }
  void end_bits(bool encode_size) {
    int64_t nbytes = (bit_count + 7) >> 3;
    if (encode_size) varint((uint64_t)nbytes);
    d.insert(d.end(), bits_bytes.begin(), bits_bytes.begin() + nbytes);
    bit_count = -1;
  }
};

// Uninitialized POD buffer: the big per-frame scratch arrays are all
// callee-filled caps; std::vector's value-init memsets ~15 MB per frame
// (measured several ms on slow hosts)
template <typename T>
struct UBuf {
  std::unique_ptr<T[]> p;
  explicit UBuf(size_t n) : p(new T[n ? n : 1]) {}
  T* data() { return p.get(); }
  T& operator[](size_t i) { return p[i]; }
  const T& operator[](size_t i) const { return p[i]; }
};

// RansBitEncoder.flush (codecs/rans.py): prob_zero + varint(len) + payload
int rabs_flush(const uint8_t* bits, int64_t n, EncBuf& out) {
  int64_t zeros = 0;
  for (int64_t i = 0; i < n; ++i)
    if (!bits[i]) zeros++;
  uint32_t prob_zero;
  if (n == 0) {
    prob_zero = 128;
  } else {
    int64_t p = (zeros * 256 + n / 2) / n;
    if (p < 1) p = 1;
    if (p > 255) p = 255;
    prob_zero = (uint32_t)p;
  }
  out.u8((uint8_t)prob_zero);
  UBuf<uint8_t> payload((size_t)(n + 1024));
  int64_t len = uvt_rabs_encode_bits(bits, n, prob_zero, payload.data(),
                                     n + 1024);
  if (len < 0) return -1;
  out.varint((uint64_t)len);
  out.raw(payload.data(), len);
  return 0;
}

// symbol_coding.encode_symbols, RAW scheme only (TAGGED -> caller falls
// back to Python; never hit by the streams this pipeline emits)
int encode_symbols_raw(const uint32_t* syms, int64_t n, EncBuf& out) {
  if (n == 0) return 0;  // Draco EncodeSymbols: nothing for zero values
  uint32_t max_value = 0;
  for (int64_t i = 0; i < n; ++i)
    if (syms[i] > max_value) max_value = syms[i];
  int bl = 0;
  {
    uint32_t v = max_value;
    while (v) {
      bl++;
      v >>= 1;
    }
  }
  if (bl > 18) return -1;  // MAX_RAW_ENCODING_BIT_LENGTH -> TAGGED needed
  int max_bit_length = bl > 1 ? bl : 1;
  out.u8(1);  // scheme RAW
  out.u8((uint8_t)max_bit_length);
  const int64_t cap = 4 * n + 4 * ((int64_t)max_value + 1) + 1024;
  UBuf<uint8_t> payload((size_t)cap);
  int64_t len = uvt_rans_symbol_encode(syms, n, (int64_t)max_value + 1,
                                       rans_precision_bits(max_bit_length),
                                       payload.data(), cap);
  if (len < 0) return -1;
  out.raw(payload.data(), len);
  return 0;
}

inline uint32_t zigzag64(int64_t v) {
  return (uint32_t)(v >= 0 ? (v << 1) : ((-v << 1) - 1));
}

// WrapEncoder bounds (encoder.py)
struct WrapBounds {
  int64_t mn = 0, mx = 0;
  void from(const int64_t* vals, int64_t count) {
    if (count == 0) return;
    mn = mx = vals[0];
    for (int64_t i = 1; i < count; ++i) {
      if (vals[i] < mn) mn = vals[i];
      if (vals[i] > mx) mx = vals[i];
    }
  }
};

struct AttrDesc {
  int32_t att_type;       // K.ATT_*
  uint8_t is_integer;     // SEQ_INTEGER
  int32_t dtype;          // wire dtype (DT_*) for integer attrs
  int32_t qbits;
  int32_t ncomp;
  int64_t nvals;
  const double* fvalues;  // float attrs ([nvals, ncomp] float64)
  const int64_t* ivalues; // integer attrs
  const int64_t* c2v;     // [3F]
};

// Draco topology constants
constexpr uint8_t TOP_C = 0x0, TOP_S = 0x1, TOP_L = 0x3, TOP_R = 0x5,
                  TOP_E = 0x7;
constexpr int ATT_POSITION = 0, ATT_NORMAL = 1, ATT_TEX_COORD = 3;
constexpr int SEQ_INTEGER = 1, SEQ_QUANTIZATION = 2, SEQ_NORMALS = 3;
constexpr int DT_FLOAT32 = 9;

}  // namespace

extern "C" int64_t uvt_drc_encode(
    const int64_t* faces, int64_t num_faces, int64_t num_positions,
    int64_t num_attrs, const int32_t* att_type, const uint8_t* att_integer,
    const int32_t* att_dtype, const int32_t* att_qbits,
    const int32_t* att_ncomp, const int64_t* att_nvals,
    const double* fvalues_all, const int64_t* fvalues_off,
    const int64_t* ivalues_all, const int64_t* ivalues_off,
    const int64_t* c2v_all, int standard_traversal, uint8_t* out_buf,
    int64_t out_cap) {
  if (num_faces <= 0 || num_attrs <= 0) return -2;
  if (att_type[0] != ATT_POSITION) return -3;
  const int64_t n = 3 * num_faces;

  // env-gated stage timing (UVT_ENC_TIMING=1): prints ms per stage
  const bool timing = [] {
    const char* e = std::getenv("UVT_ENC_TIMING");
    return e && e[0] == '1';
  }();
  struct timespec ts_prev;
  clock_gettime(CLOCK_MONOTONIC, &ts_prev);
  auto stamp = [&](const char* name) {
    if (!timing) return;
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    double ms = (now.tv_sec - ts_prev.tv_sec) * 1e3 +
                (now.tv_nsec - ts_prev.tv_nsec) * 1e-6;
    fprintf(stderr, "[enc] %-22s %6.2f ms\n", name, ms);
    ts_prev = now;
  };

  std::vector<AttrDesc> attrs((size_t)num_attrs);
  for (int64_t a = 0; a < num_attrs; ++a) {
    AttrDesc& ad = attrs[a];
    ad.att_type = att_type[a];
    ad.is_integer = att_integer[a];
    ad.dtype = att_dtype[a];
    ad.qbits = att_qbits[a];
    ad.ncomp = att_ncomp[a];
    ad.nvals = att_nvals[a];
    ad.fvalues = fvalues_all + fvalues_off[a];
    ad.ivalues = ivalues_all + ivalues_off[a];
    ad.c2v = c2v_all + a * n;
  }

  // ---- encoder corner table (fan vertices) --------------------------------
  UBuf<int32_t> e_opp((size_t)n), e_vert((size_t)n),
      e_vcorner((size_t)std::max<int64_t>(n, 1));
  int64_t e_nv = uvt_encoder_corner_table(faces, num_faces, num_positions,
                                          e_opp.data(), e_vert.data(),
                                          e_vcorner.data());
  if (e_nv < 0) return -4;

  stamp("corner_table");

  // ---- boundary holes (EncoderCornerTable.__init__ hole chaining) ---------
  // out_edge: ascending-corner last-writer-wins; iteration order = first
  // insertion order (python dict semantics)
  std::vector<int64_t> hole_of((size_t)e_nv, -1);
  std::vector<int32_t> out_edge((size_t)e_nv, INVALID);
  std::vector<int32_t> first_order;
  first_order.reserve(64);
  for (int64_t c = 0; c < n; ++c) {
    if (e_opp[c] != INVALID) continue;
    int32_t v = e_vert[prev_c((int32_t)c)];
    if (out_edge[v] == INVALID) first_order.push_back(v);
    out_edge[v] = (int32_t)c;
  }
  int64_t num_holes = 0;
  for (int32_t v0 : first_order) {
    if (hole_of[v0] != -1) continue;
    int64_t hid = num_holes++;
    int32_t v = v0;
    while (v >= 0 && hole_of[v] == -1) {
      hole_of[v] = hid;
      int32_t c = out_edge[v];
      if (c == INVALID) return -5;  // open chain: matches python KeyError
      v = e_vert[next_c(c)];
    }
  }

  stamp("holes");

  // ---- edgebreaker traversal ----------------------------------------------
  UBuf<uint8_t> symbols((size_t)num_faces);
  UBuf<int32_t> symbol_corners((size_t)num_faces);
  UBuf<uint8_t> start_face_bits((size_t)num_faces);
  UBuf<int64_t> split_src((size_t)num_faces), split_id((size_t)num_faces);
  UBuf<uint8_t> split_edge((size_t)num_faces);
  UBuf<int32_t> init_face_corners((size_t)num_faces),
      interior_start_corners((size_t)num_faces);
  int64_t tcounts[5] = {0, 0, 0, 0, 0};
  if (uvt_eb_traverse(e_vert.data(), e_opp.data(), hole_of.data(), num_faces,
                      e_nv, num_holes, symbols.data(), symbol_corners.data(),
                      start_face_bits.data(), split_src.data(),
                      split_id.data(), split_edge.data(),
                      init_face_corners.data(),
                      interior_start_corners.data(), tcounts) != 0)
    return -6;
  const int64_t num_symbols = tcounts[0];
  const int64_t n_start_bits = tcounts[1];
  const int64_t n_splits = tcounts[2];
  const int64_t num_split_symbols = tcounts[4];

  stamp("eb_traverse");

  // ---- decoder replay -----------------------------------------------------
  UBuf<uint8_t> syms_dec((size_t)std::max<int64_t>(num_symbols, 1));
  for (int64_t i = 0; i < num_symbols; ++i)
    syms_dec[i] = symbols[num_symbols - 1 - i];
  const int64_t max_nv = e_nv + num_split_symbols + 3 * num_faces / 2 + 3;
  UBuf<int32_t> d_opp((size_t)n), d_vert((size_t)n),
      d_vcorner((size_t)std::max<int64_t>(max_nv, 1));
  const int64_t d_vcorner_size = std::max<int64_t>(max_nv, 1);
  UBuf<int32_t> processed((size_t)num_faces);
  UBuf<int32_t> contexts((size_t)std::max<int64_t>(num_symbols, 1));
  int64_t rcounts[4] = {0, 0, 0, 0};
  {
    std::vector<int64_t> ssrc((size_t)std::max<int64_t>(n_splits, 1), 0),
        sid((size_t)std::max<int64_t>(n_splits, 1), 0);
    std::vector<uint8_t> sedge((size_t)std::max<int64_t>(n_splits, 1), 0);
    for (int64_t i = 0; i < n_splits; ++i) {
      ssrc[i] = split_src[i];
      sid[i] = split_id[i];
      sedge[i] = split_edge[i];
    }
    std::vector<uint8_t> sfb(
        (size_t)std::max<int64_t>(n_start_bits, 1), 0);
    for (int64_t i = 0; i < n_start_bits; ++i) sfb[i] = start_face_bits[i];
    if (uvt_eb_replay_machine(syms_dec.data(), num_symbols, num_faces, max_nv,
                              ssrc.data(), sid.data(), sedge.data(), n_splits,
                              sfb.data(), n_start_bits, d_opp.data(),
                              d_vert.data(), d_vcorner.data(),
                              processed.data(), contexts.data(),
                              rcounts) != 0)
      return -7;
  }
  const int64_t n_processed = rcounts[0] + rcounts[1];
  const int64_t d_num_vertices = rcounts[2];

  stamp("replay");

  // ---- dec<->enc maps + per-attribute seams -------------------------------
  const int64_t num_attribute_data = num_attrs - 1;
  UBuf<int64_t> sc_rev((size_t)std::max<int64_t>(num_symbols, 1));
  for (int64_t i = 0; i < num_symbols; ++i)
    sc_rev[i] = symbol_corners[num_symbols - 1 - i];
  UBuf<int64_t> isc64((size_t)std::max<int64_t>(num_faces - num_symbols, 1));
  for (int64_t i = 0; i < num_faces - num_symbols; ++i)
    isc64[i] = interior_start_corners[i];
  // non-position c2v tables are contiguous in the caller's c2v_all
  const int64_t* c2v_nonpos = c2v_all + n;
  UBuf<int64_t> dec2enc((size_t)n);
  UBuf<int64_t> cs_out((size_t)n);
  UBuf<uint8_t> seam_bits((size_t)std::max<int64_t>(num_attribute_data * n, 1));
  UBuf<int64_t> seam_pairs((size_t)std::max<int64_t>(num_attribute_data * 2 * n, 1));
  UBuf<int64_t> boundary((size_t)n);
  std::vector<int64_t> mcounts((size_t)(2 + std::max<int64_t>(num_attribute_data, 0)), 0);
  if (uvt_eb_encode_maps(num_faces, num_symbols, d_vcorner_size,
                         sc_rev.data(), d_vert.data(), e_vert.data(),
                         e_opp.data(), d_opp.data(), isc64.data(),
                         num_attribute_data, c2v_nonpos, dec2enc.data(),
                         cs_out.data(), seam_bits.data(), seam_pairs.data(),
                         boundary.data(), mcounts.data()) != 0)
    return -8;
  const int64_t n_cs = mcounts[0];
  const int64_t n_boundary = mcounts[1];

  stamp("maps");

  // ---- header + connectivity ----------------------------------------------
  EncBuf out;
  out.d.reserve((size_t)(n * 2 + 4096));
  out.raw((const uint8_t*)"DRACO", 5);
  out.u8(2);
  out.u8(2);
  out.u8(1);  // TRIANGULAR_MESH
  out.u8(1);  // MESH_EDGEBREAKER_ENCODING
  out.u16(0); // flags
  out.u8(standard_traversal ? 0 : 2);  // STANDARD / VALENCE
  out.varint((uint64_t)e_nv);
  out.varint((uint64_t)num_faces);
  out.u8((uint8_t)num_attribute_data);
  out.varint((uint64_t)num_symbols);
  out.varint((uint64_t)num_split_symbols);

  // topology splits, sorted by (source, split), delta-coded
  {
    std::vector<int64_t> order((size_t)std::max<int64_t>(n_splits, 1));
    for (int64_t i = 0; i < n_splits; ++i) order[i] = i;
    std::sort(order.begin(), order.begin() + n_splits,
              [&](int64_t a, int64_t b) {
                if (split_src[a] != split_src[b])
                  return split_src[a] < split_src[b];
                return split_id[a] < split_id[b];
              });
    out.varint((uint64_t)n_splits);
    int64_t last_source = 0;
    for (int64_t i = 0; i < n_splits; ++i) {
      int64_t s = order[i];
      out.varint((uint64_t)(split_src[s] - last_source));
      out.varint((uint64_t)(split_src[s] - split_id[s]));
      last_source = split_src[s];
    }
    if (n_splits) {
      out.start_bits();
      for (int64_t i = 0; i < n_splits; ++i)
        out.put_bits(split_edge[order[i]], 1);
      out.end_bits(false);
    }
  }

  auto write_start_face_and_seams = [&]() -> int {
    if (rabs_flush(start_face_bits.data(), n_start_bits, out) != 0) return -1;
    for (int64_t a = 0; a < num_attribute_data; ++a) {
      if (rabs_flush(seam_bits.data() + a * n, n_cs, out) != 0) return -1;
    }
    return 0;
  };

  if (standard_traversal) {
    // bit-coded CLER in decode order: C='0', else '1' + 2-bit suffix
    out.start_bits();
    for (int64_t i = num_symbols - 1; i >= 0; --i) {
      uint8_t sym = symbols[i];
      if (sym == TOP_C) {
        out.put_bits(0, 1);
      } else {
        out.put_bits(1, 1);
        out.put_bits(sym >> 1, 2);
      }
    }
    out.end_bits(true);
    if (write_start_face_and_seams() != 0) return -9;
  } else {
    if (write_start_face_and_seams() != 0) return -9;
    // valence contexts: bucket decode-order symbols by replay context;
    // each bucket stored in reverse decode order
    uint8_t top2idx[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    top2idx[TOP_C] = 0;
    top2idx[TOP_S] = 1;
    top2idx[TOP_L] = 2;
    top2idx[TOP_R] = 3;
    top2idx[TOP_E] = 4;
    const int NUM_CTX = 6;
    std::vector<uint32_t> buckets[NUM_CTX];
    for (int k = 0; k < NUM_CTX; ++k)
      buckets[k].reserve((size_t)num_symbols / 4 + 4);
    for (int64_t i = num_symbols - 1; i >= 0; --i) {
      int32_t k = contexts[i];
      if (k >= 0 && k < NUM_CTX) buckets[k].push_back(top2idx[syms_dec[i]]);
    }
    for (int k = 0; k < NUM_CTX; ++k) {
      out.varint((uint64_t)buckets[k].size());
      if (!buckets[k].empty()) {
        if (encode_symbols_raw(buckets[k].data(), (int64_t)buckets[k].size(),
                               out) != 0)
          return -10;
      }
    }
  }

  stamp("connectivity_ser");

  // ---- attribute decoder headers ------------------------------------------
  out.u8((uint8_t)num_attrs);
  // plan: position -> vertex decoder (att_data_id -1); others: own id
  for (int64_t a = 0; a < num_attrs; ++a) {
    int att_data_id = (a == 0) ? -1 : (int)(a - 1);
    int dec_type = (a == 0 || attrs[a].is_integer) ? 0 : 1;  // VERTEX/CORNER
    out.u8((uint8_t)(att_data_id & 0xFF));
    out.u8((uint8_t)dec_type);
    out.u8(0);  // MESH_TRAVERSAL_DEPTH_FIRST
  }
  int uid = 0;
  std::vector<int> seq_types((size_t)num_attrs);
  for (int64_t a = 0; a < num_attrs; ++a) {
    out.varint(1);
    int dtype, seq_type;
    if (attrs[a].is_integer) {
      dtype = attrs[a].dtype;
      seq_type = SEQ_INTEGER;
    } else if (attrs[a].att_type == ATT_NORMAL) {
      dtype = DT_FLOAT32;
      seq_type = SEQ_NORMALS;
    } else {
      dtype = DT_FLOAT32;
      seq_type = SEQ_QUANTIZATION;
    }
    seq_types[a] = seq_type;
    out.u8((uint8_t)attrs[a].att_type);
    out.u8((uint8_t)dtype);
    out.u8((uint8_t)attrs[a].ncomp);
    out.u8(0);  // normalized
    out.varint((uint64_t)uid++);
    out.u8((uint8_t)seq_type);
  }

  stamp("attr_headers");

  // ---- payload pass -------------------------------------------------------
  // shared DFS over ct_d for position + integer attrs
  std::vector<int32_t> v2d_vertex, d2c_vertex;
  int64_t nvals_vertex = -1;

  std::vector<int64_t> pos_values;     // [n_pos_values * 3] quantized ints
  std::vector<int32_t> pos_v2d;        // pos vertex_to_data
  std::vector<int32_t> pos_corner_map; // pos_data_of_corner [3F]

  for (int64_t a = 0; a < num_attrs; ++a) {
    const AttrDesc& ad = attrs[a];
    const int seq_type = seq_types[a];
    const bool corner_mapped = !(a == 0 || ad.is_integer);

    // view over the connectivity this attribute traverses
    const int32_t* view_vertex;
    const uint8_t* view_seam = nullptr;  // is_edge_on_seam or null
    int64_t view_nv;
    std::vector<int32_t> att_c2v_table, att_v2c;
    std::vector<uint8_t> att_fan_open;
    std::vector<uint8_t> edge_on_seam, vertex_on_seam;
    std::vector<int32_t> v2d_l, d2c_l;  // callee-filled; sized per attr
    const int32_t* v2d;
    const int32_t* d2c;
    int64_t num_values;

    if (corner_mapped) {
      // final seams = maps pairs + boundary corners
      const int64_t att_idx = a - 1;
      const int64_t n_pairs2 = mcounts[2 + att_idx];  // total pair entries
      edge_on_seam.assign((size_t)n, 0);
      const int64_t* pairs = seam_pairs.data() + att_idx * 2 * n;
      for (int64_t i = 0; i < n_pairs2; ++i) {
        int64_t c = pairs[i];
        if (c >= 0 && c < n) edge_on_seam[c] = 1;
        // MeshAttributeCornerTable also marks the opposite corner
        if (c >= 0 && c < n && d_opp[c] != INVALID) edge_on_seam[d_opp[c]] = 1;
      }
      for (int64_t i = 0; i < n_boundary; ++i) {
        int64_t c = boundary[i];
        if (c >= 0 && c < n) {
          edge_on_seam[c] = 1;
          if (d_opp[c] != INVALID) edge_on_seam[d_opp[c]] = 1;
        }
      }
      vertex_on_seam.assign((size_t)d_vcorner_size, 0);
      for (int64_t c = 0; c < n; ++c) {
        if (!edge_on_seam[c]) continue;
        vertex_on_seam[d_vert[next_c((int32_t)c)]] = 1;
        vertex_on_seam[d_vert[prev_c((int32_t)c)]] = 1;
      }
      att_c2v_table.resize((size_t)n);
      att_v2c.resize((size_t)n);
      int64_t n_att_verts = 0;
      att_fan_open.resize((size_t)n);
      if (uvt_attr_corner_table(d_opp.data(), d_vert.data(), d_vcorner.data(),
                                d_num_vertices, n, edge_on_seam.data(),
                                vertex_on_seam.data(), att_c2v_table.data(),
                                att_v2c.data(), att_fan_open.data(),
                                &n_att_verts) != 0)
        return -11;
      view_vertex = att_c2v_table.data();
      view_seam = edge_on_seam.data();
      view_nv = n_att_verts;
      v2d_l.resize((size_t)std::max<int64_t>(view_nv, 1));
      d2c_l.resize((size_t)std::max<int64_t>(view_nv, 1));
      int64_t nv_out = 0;
      if (uvt_traverse_depth_first(d_opp.data(), view_vertex, view_seam,
                                   num_faces, view_nv, processed.data(),
                                   n_processed, att_fan_open.data(),
                                   v2d_l.data(), d2c_l.data(),
                                   &nv_out) != 0)
        return -12;
      v2d = v2d_l.data();
      d2c = d2c_l.data();
      num_values = nv_out;
      stamp("attr_table+dfs");
    } else {
      view_vertex = d_vert.data();
      view_nv = d_vcorner_size;
      if (nvals_vertex < 0) {
        v2d_vertex.resize((size_t)std::max<int64_t>(view_nv, 1));
        d2c_vertex.resize((size_t)std::max<int64_t>(view_nv, 1));
        int64_t nv_out = 0;
        if (uvt_traverse_depth_first(d_opp.data(), view_vertex, nullptr,
                                     num_faces, view_nv, processed.data(),
                                     n_processed, nullptr,
                                     v2d_vertex.data(),
                                     d2c_vertex.data(), &nv_out) != 0)
          return -12;
        nvals_vertex = nv_out;
      }
      v2d = v2d_vertex.data();
      d2c = d2c_vertex.data();
      num_values = nvals_vertex;
      stamp("vertex_dfs");
    }

    // values in decoder data order
    const int nc = ad.ncomp;
    UBuf<int64_t> ints((size_t)(num_values * (nc > 2 ? nc : 2)));
    double mins[8];
    double range_value = 1.0;
    if (seq_type == SEQ_INTEGER) {
      for (int64_t i = 0; i < num_values; ++i) {
        int64_t vi = ad.c2v[dec2enc[d2c[i]]];
        for (int k = 0; k < nc; ++k) ints[i * nc + k] = ad.ivalues[vi * nc + k];
      }
    } else {
      // gather float64 then quantize (encoder.py quantize_attribute /
      // quantize_normals numpy float64 math)
      UBuf<double> raw((size_t)(num_values * nc));
      for (int64_t i = 0; i < num_values; ++i) {
        int64_t vi = ad.c2v[dec2enc[d2c[i]]];
        for (int k = 0; k < nc; ++k) raw[i * nc + k] = ad.fvalues[vi * nc + k];
      }
      if (seq_type == SEQ_QUANTIZATION) {
        if (nc > 8) return -13;
        double maxs[8];
        for (int k = 0; k < nc; ++k) {
          mins[k] = raw[k];
          maxs[k] = raw[k];
        }
        for (int64_t i = 1; i < num_values; ++i)
          for (int k = 0; k < nc; ++k) {
            double v = raw[i * nc + k];
            if (v < mins[k]) mins[k] = v;
            if (v > maxs[k]) maxs[k] = v;
          }
        double rng = 0.0;
        for (int k = 0; k < nc; ++k)
          if (maxs[k] - mins[k] > rng) rng = maxs[k] - mins[k];
        if (!(rng > 0)) rng = 1.0;
        range_value = rng;
        const double delta = rng / (double)((1LL << ad.qbits) - 1);
        for (int64_t i = 0; i < num_values; ++i)
          for (int k = 0; k < nc; ++k)
            ints[i * nc + k] = (int64_t)std::floor(
                (raw[i * nc + k] - mins[k]) / delta + 0.5);
      } else {  // SEQ_NORMALS: quantized octahedral coords
        if (nc != 3) return -14;
        if (uvt_quantize_normals(raw.data(), num_values, ad.qbits,
                                 ints.data()) != 0)
          return -15;
      }
    }

    stamp("gather+quantize");
    if (seq_type == SEQ_INTEGER || seq_type == SEQ_QUANTIZATION) {
      const bool is_uv = ad.att_type == ATT_TEX_COORD;
      out.u8((uint8_t)(is_uv ? 5 : 1));  // TEX_COORDS_PORTABLE / PARALLELOGRAM
      out.u8(1);                         // PREDICTION_TRANSFORM_WRAP
      out.u8(1);                         // compressed
      WrapBounds wb;
      wb.from(ints.data(), num_values * (is_uv ? 2 : nc));
      if (is_uv) {
        if (pos_values.empty()) return -16;
        UBuf<int64_t> corr((size_t)(num_values * 2));
        UBuf<uint8_t> orients((size_t)std::max<int64_t>(num_values, 1));
        int64_t n_or = uvt_texcoords_encode(
            ints.data(), num_values, wb.mn, wb.mx, view_vertex, v2d, d2c,
            pos_values.data(), pos_corner_map.data(), corr.data(),
            orients.data());
        if (n_or < 0) return -17;
        UBuf<uint32_t> syms((size_t)(num_values * 2));
        for (int64_t i = 0; i < num_values * 2; ++i)
          syms[i] = (uint32_t)corr[i];
        if (encode_symbols_raw(syms.data(), num_values * 2, out) != 0)
          return -10;
        // write_orientations: drop trailing trues, store reversed
        // delta-coded-from-true
        int64_t keep = 0;
        for (int64_t i = 0; i < n_or; ++i)
          if (!orients[i]) keep = i + 1;
        out.i32((int32_t)keep);
        UBuf<uint8_t> obits((size_t)std::max<int64_t>(keep, 1));
        uint8_t prev = 1;
        for (int64_t i = 0; i < keep; ++i) {
          uint8_t cur = orients[keep - 1 - i] ? 1 : 0;
          obits[i] = (cur == prev) ? 1 : 0;
          prev = cur;
        }
        if (rabs_flush(obits.data(), keep, out) != 0) return -9;
        out.i32((int32_t)wb.mn);
        out.i32((int32_t)wb.mx);
      } else {
        UBuf<int64_t> corr((size_t)(num_values * nc));
        if (uvt_parallelogram_encode(ints.data(), num_values, nc, wb.mn,
                                     wb.mx, d_opp.data(), view_vertex,
                                     view_seam, v2d, d2c, corr.data()) != 0)
          return -18;
        UBuf<uint32_t> syms((size_t)(num_values * nc));
        for (int64_t i = 0; i < num_values * nc; ++i)
          syms[i] = zigzag64(corr[i]);
        if (encode_symbols_raw(syms.data(), num_values * nc, out) != 0)
          return -10;
        out.i32((int32_t)wb.mn);
        out.i32((int32_t)wb.mx);
      }
      if (seq_type == SEQ_QUANTIZATION) {
        for (int k = 0; k < nc; ++k) out.f32((float)mins[k]);
        out.f32((float)range_value);
        out.u8((uint8_t)ad.qbits);
      }
      stamp("predict+entropy");
      if (ad.att_type == ATT_POSITION) {
        pos_values.assign(ints.data(), ints.data() + num_values * nc);
        pos_v2d.assign(v2d, v2d + view_nv);
        pos_corner_map.resize((size_t)n);
        for (int64_t c = 0; c < n; ++c)
          pos_corner_map[c] = pos_v2d[d_vert[c]];
      }
    } else {  // SEQ_NORMALS
      out.u8(6);  // MESH_PREDICTION_GEOMETRIC_NORMAL
      out.u8(3);  // NORMAL_OCTAHEDRON_CANONICALIZED
      out.u8(1);  // compressed
      if (pos_values.empty()) return -16;
      const int64_t max_q = (1LL << ad.qbits) - 1;
      UBuf<int64_t> corr((size_t)(num_values * 2));
      UBuf<uint8_t> flips((size_t)std::max<int64_t>(num_values, 1));
      if (uvt_normals_encode(ints.data(), num_values, max_q, d_opp.data(),
                             view_vertex, view_seam, d2c, pos_values.data(),
                             pos_corner_map.data(), corr.data(),
                             flips.data(), n / 3, v2d) != 0)
        return -19;
      UBuf<uint32_t> syms((size_t)(num_values * 2));
      for (int64_t i = 0; i < num_values * 2; ++i)
        syms[i] = (uint32_t)corr[i];
      if (encode_symbols_raw(syms.data(), num_values * 2, out) != 0)
        return -10;
      // transform header: max_quantized_value, center_value (i4 each)
      const int64_t max_value = (1LL << ad.qbits) - 2;
      out.i32((int32_t)max_q);
      out.i32((int32_t)(max_value / 2));
      if (rabs_flush(flips.data(), num_values, out) != 0) return -9;
      out.u8((uint8_t)ad.qbits);
      stamp("normals_stage");
    }
  }

  if ((int64_t)out.d.size() > out_cap) return -20;
  std::memcpy(out_buf, out.d.data(), out.d.size());
  return (int64_t)out.d.size();
}
