// Whole-frame Draco `.drc` decode orchestrator (C ABI, ctypes).
//
// One native call decodes an entire edgebreaker frame: container parse,
// valence connectivity, seams, per-decoder traversal, prediction inverse,
// dequantize, and point assembly — eliminating the per-stage Python glue
// that dominated single-frame latency (~15 ms of ~50 ms on a liam frame).
// Every stage delegates to the golden-validated kernels in draco_native.cpp
// and entropy.cpp (same translation .so); the Python stage pipeline in
// codecs/draco/decoder.py remains the reference + fallback for anything
// this fast path does not support (standard coder, tagged symbols,
// sequential meshes, point clouds).
//
// Reference behavior being replaced: draco_decoder.wasm as invoked by the
// reference player (src/lib/DRACOLoader.js:483).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

// ---------------------------------------------------------------------------
// kernels from draco_native.cpp / entropy.cpp (linked into the same .so)
// ---------------------------------------------------------------------------
extern "C" {
int64_t uvt_rans_stream_decode(const uint8_t* data, int64_t end, int64_t pos,
                               int precision_bits, int64_t n, uint32_t* out);
int uvt_rabs_decode_bits(uint32_t prob_zero, const uint8_t* buf, int64_t len,
                         uint8_t* out, int64_t n);
int uvt_eb_valence_machine(const uint32_t* ctx_syms, const int64_t* ctx_off,
                           int64_t num_symbols, int64_t num_faces,
                           int64_t max_vertices, const int64_t* split_source,
                           const int64_t* split_id, const uint8_t* split_edge,
                           int64_t num_splits, uint32_t sf_prob_zero,
                           const uint8_t* sf_buf, int64_t sf_len,
                           int32_t* opposite, int32_t* vertex,
                           int32_t* vertex_corner, int32_t* processed_corners,
                           int64_t* out_counts);
int uvt_seam_pass(const int32_t* opposite, int64_t num_faces,
                  int64_t num_attribute_data, const uint32_t* prob_zeros,
                  const uint8_t* bufs, const int64_t* buf_off,
                  int32_t* out_corners, int64_t* out_counts);
int uvt_attr_corner_table(const int32_t* opposite, const int32_t* vertex,
                          const int32_t* vertex_corner, int64_t num_vertices,
                          int64_t num_corners, const uint8_t* seam_mask,
                          const uint8_t* vertex_on_seam,
                          int32_t* corner_to_vertex, int32_t* vertex_to_corner,
                          uint8_t* fan_open_out,
                          int64_t* out_num_attr_vertices);
int uvt_attr_corner_tables_multi(
    const int32_t* opposite, const int32_t* vertex,
    const int32_t* vertex_corner, int64_t num_vertices, int64_t num_corners,
    int n_attrs, const uint8_t* const* seam_masks,
    const uint8_t* const* vertex_on_seam,
    int32_t* const* corner_to_vertex, int32_t* const* vertex_to_corner,
    uint8_t* const* fan_open_out, int64_t* out_num_attr_vertices);
int uvt_traverse_depth_first(const int32_t* opposite,
                             const int32_t* view_vertex,
                             const uint8_t* seam_mask, int64_t num_faces,
                             int64_t num_view_vertices,
                             const int32_t* corner_order, int64_t n_order,
                             const uint8_t* fan_open_in,
                             int32_t* vertex_to_data, int32_t* data_to_corner,
                             int64_t* out_num_values);
int uvt_decode_parallelogram(const int64_t* corr, int64_t n, int nc,
                             int64_t mn, int64_t mx, const int32_t* opposite,
                             const int32_t* view_vertex,
                             const uint8_t* seam_mask,
                             const int32_t* vertex_to_data,
                             const int32_t* data_to_corner, int64_t* out);
int uvt_texcoords_predict(const int64_t* corr, int64_t n, int64_t mn,
                          int64_t mx, const int32_t* view_vertex,
                          const int32_t* vertex_to_data,
                          const int32_t* data_to_corner,
                          const int64_t* positions,
                          const int32_t* pos_data_of_corner,
                          const uint8_t* orientations, int64_t n_orients,
                          int64_t* out);
int uvt_normals_predict(const int64_t* corr, int64_t n,
                        int64_t max_quantized_value, int64_t center_value_wire,
                        const int32_t* opposite, const int32_t* view_vertex,
                        const uint8_t* seam_mask, const int32_t* data_to_corner,
                        const int64_t* positions,
                        const int32_t* pos_data_of_corner,
                        uint32_t flip_prob_zero, const uint8_t* flip_buf,
                        int64_t flip_len, int64_t num_faces,
                        const int32_t* vertex_to_data, int64_t* out);
int64_t uvt_point_assembly(const int32_t* keys, int64_t num_corners,
                           int num_attrs, const int32_t* widths_in,
                           int32_t* out);
}

namespace {

constexpr int32_t INVALID = -1;
inline int32_t next_c(int32_t c) { return (c % 3 == 2) ? c - 2 : c + 1; }
inline int32_t prev_c(int32_t c) { return (c % 3 == 0) ? c + 2 : c - 1; }

// fallback reason codes (negative => Python path takes over)
enum {
  FB_OK = 0,
  FB_TRUNCATED = -1,
  FB_NOT_DRACO = -2,
  FB_UNSUPPORTED = -3,  // feature outside the fast path (fallback, not error)
  FB_MALFORMED = -4,
  FB_INTERNAL = -5,
};

// wire constants (codecs/draco/constants.py)
constexpr int TRIANGULAR_MESH = 1;
constexpr int MESH_EDGEBREAKER_ENCODING = 1;
constexpr int METADATA_FLAG_MASK = 0x8000;
constexpr int MESH_EDGEBREAKER_VALENCE_ENCODING = 2;
constexpr int NUM_VALENCE_CONTEXTS = 6;
constexpr int MESH_CORNER_ATTRIBUTE = 1;
constexpr int MESH_TRAVERSAL_DEPTH_FIRST = 0;
constexpr int ATT_POSITION = 0;
constexpr int SEQ_INTEGER = 1;
constexpr int SEQ_QUANTIZATION = 2;
constexpr int SEQ_NORMALS = 3;
constexpr int PREDICTION_NONE = -2;
constexpr int PREDICTION_DIFFERENCE = 0;
constexpr int MESH_PREDICTION_PARALLELOGRAM = 1;
constexpr int MESH_PREDICTION_TEX_COORDS_PORTABLE = 5;
constexpr int MESH_PREDICTION_GEOMETRIC_NORMAL = 6;
constexpr int PREDICTION_TRANSFORM_WRAP = 1;
constexpr int PREDICTION_TRANSFORM_NORMAL_OCT_CANON = 3;
constexpr int SYMBOL_SCHEME_RAW = 1;

inline int rans_precision_bits(int l) {
  int p = (3 * l) / 2;
  if (p < 12) p = 12;
  if (p > 20) p = 20;
  return p;
}

struct Buf {
  const uint8_t* data;
  int64_t pos, end;
  bool ok = true;

  uint8_t u8() {
    if (pos >= end) { ok = false; return 0; }
    return data[pos++];
  }
  int i8() {
    int v = u8();
    return v >= 128 ? v - 256 : v;
  }
  uint16_t u16() {
    if (pos + 2 > end) { ok = false; return 0; }
    uint16_t v = (uint16_t)(data[pos] | (data[pos + 1] << 8));
    pos += 2;
    return v;
  }
  int32_t i32() {
    if (pos + 4 > end) { ok = false; return 0; }
    uint32_t v = (uint32_t)data[pos] | ((uint32_t)data[pos + 1] << 8) |
                 ((uint32_t)data[pos + 2] << 16) |
                 ((uint32_t)data[pos + 3] << 24);
    pos += 4;
    return (int32_t)v;
  }
  float f32() {
    int32_t v = i32();
    float f;
    std::memcpy(&f, &v, 4);
    return f;
  }
  uint64_t varint() {
    uint64_t result = 0;
    int shift = 0;
    while (pos < end) {
      if (shift > 63) {  // conforming readers fail after 10 bytes
        ok = false;
        return 0;
      }
      uint8_t b = data[pos++];
      result |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return result;
      shift += 7;
    }
    ok = false;
    return 0;
  }
  bool skip(int64_t n) {
    if (pos + n > end) { ok = false; return false; }
    pos += n;
    return true;
  }
};

// rANS bit-stream section: u8 prob_zero + varint size + payload bytes
struct RabsBuf {
  uint32_t prob_zero = 0;
  const uint8_t* buf = nullptr;
  int64_t len = 0;
  bool parse(Buf& b) {
    prob_zero = b.u8();
    len = (int64_t)b.varint();
    if (!b.ok || len < 0 || b.pos + len > b.end) {
      b.ok = false;
      return false;
    }
    buf = b.data + b.pos;
    b.pos += len;
    return true;
  }
};

// decode_symbols (codecs/symbol_coding.py) — RAW scheme only; TAGGED
// falls back to the Python path (never seen in draco_encoder geometry).
int decode_symbols_raw(Buf& b, int64_t n, std::vector<uint32_t>& out) {
  out.assign((size_t)n, 0);
  if (n == 0) return FB_OK;
  int scheme = b.u8();
  if (!b.ok) return FB_TRUNCATED;
  if (scheme != SYMBOL_SCHEME_RAW) return FB_UNSUPPORTED;
  int max_bit_length = b.u8();
  if (!b.ok) return FB_TRUNCATED;
  int64_t new_pos = uvt_rans_stream_decode(
      b.data, b.end, b.pos, rans_precision_bits(max_bit_length), n, out.data());
  if (new_pos < 0) return FB_MALFORMED;
  b.pos = new_pos;
  return FB_OK;
}

void skip_single_metadata(Buf& b, int depth = 0) {
  if (depth > 64) {  // bound the native stack on hostile nesting
    b.ok = false;
    return;
  }
  uint64_t num_entries = b.varint();
  for (uint64_t i = 0; i < num_entries && b.ok; ++i) {
    for (int k = 0; k < 2; ++k) b.skip(b.u8());
  }
  uint64_t num_sub = b.varint();
  for (uint64_t i = 0; i < num_sub && b.ok; ++i) {
    b.skip(b.u8());
    skip_single_metadata(b, depth + 1);
  }
}

struct FrameAttr {
  int att_type = 0, data_type = 0, num_components = 0, normalized = 0;
  int64_t unique_id = 0;
  int is_float = 0;  // 1: values_f [n, nc] float32; 0: values_i [n, nc] int64
  int64_t num_values = 0;
  std::vector<float> values_f;
  std::vector<int64_t> values_i;
  std::vector<int32_t> corner_to_value;  // [3F]
  // portable mode (uvt_drc_decode2 flags&1): integer stages only; the
  // dequantize / octahedral->float conversion runs batched on device
  // (models/drc_device.py). deq_kind: 0 none, 1 quantized (mins/range/
  // bits), 2 octahedral normals (max_quantized).
  int deq_kind = 0;
  double deq_min[8] = {0};
  double deq_range = 0;
  int deq_bits = 0;
  int64_t oct_max_quantized = 0;
};

struct Frame {
  int64_t num_faces = 0, num_points = 0;
  int portable = 0;  // set before decode_frame: keep integer stages
  std::vector<int32_t> point_of_corner;  // [3F]
  std::vector<FrameAttr> attrs;
};

int decode_frame(const uint8_t* data, int64_t len, Frame& out) {
  Buf b{data, 0, len};
  // ---- header (decoder.py _decode_drc) ------------------------------------
  if (len < 11 || std::memcmp(data, "DRACO", 5) != 0) return FB_NOT_DRACO;
  b.pos = 5;
  int major = b.u8(), minor = b.u8();
  if (major * 256 + minor < 2 * 256 + 2) return FB_UNSUPPORTED;
  int encoder_type = b.u8();
  int method = b.u8();
  int flags = b.u16();
  if (!b.ok) return FB_TRUNCATED;
  if (flags & METADATA_FLAG_MASK) {
    uint64_t num_att_md = b.varint();
    for (uint64_t i = 0; i < num_att_md && b.ok; ++i) {
      b.varint();
      skip_single_metadata(b);
    }
    skip_single_metadata(b);
    if (!b.ok) return FB_TRUNCATED;
  }
  if (encoder_type != TRIANGULAR_MESH || method != MESH_EDGEBREAKER_ENCODING)
    return FB_UNSUPPORTED;  // sequential / point clouds: Python path

  // ---- edgebreaker connectivity (edgebreaker.py) --------------------------
  int traversal_type = b.u8();
  int64_t num_encoded_vertices = (int64_t)b.varint();
  int64_t num_faces = (int64_t)b.varint();
  int num_attribute_data = b.u8();
  int64_t num_encoded_symbols = (int64_t)b.varint();
  int64_t num_encoded_split_symbols = (int64_t)b.varint();
  if (!b.ok) return FB_TRUNCATED;
  if (traversal_type != MESH_EDGEBREAKER_VALENCE_ENCODING)
    return FB_UNSUPPORTED;  // standard coder: Python path
  // corner ids are int32 (<= INT32_MAX/3 faces), and a frame cannot
  // plausibly encode more faces than ~1024x its byte size — tiny hostile
  // headers must not trigger multi-GB scratch allocations
  if (num_faces <= 0 || num_faces > (int64_t)0x7FFFFFFF / 3 ||
      num_faces > 1024 * len)
    return FB_MALFORMED;
  // bounds that the machine's output buffers depend on (corrupt streams
  // must fall back / error, never overflow)
  if (num_encoded_symbols < 0 || num_encoded_symbols > num_faces)
    return FB_MALFORMED;
  if (num_encoded_vertices < 0 || num_encoded_vertices > 3 * num_faces + 3)
    return FB_MALFORMED;
  if (num_encoded_split_symbols < 0 ||
      num_encoded_split_symbols > num_faces)
    return FB_MALFORMED;
  if (num_attribute_data < 0 || num_attribute_data > 64)
    return FB_MALFORMED;
  const int64_t n_corners = 3 * num_faces;

  // topology splits
  int64_t num_splits = (int64_t)b.varint();
  if (!b.ok || num_splits < 0 || num_splits > num_faces) return FB_MALFORMED;
  std::vector<int64_t> split_source(num_splits), split_id(num_splits);
  std::vector<uint8_t> split_edge(num_splits, 1 /*RIGHT_FACE_EDGE*/);
  {
    int64_t last_source = 0;
    for (int64_t i = 0; i < num_splits; ++i) {
      int64_t delta = (int64_t)b.varint();
      int64_t source = last_source + delta;
      int64_t delta2 = (int64_t)b.varint();
      split_source[i] = source;
      split_id[i] = source - delta2;
      last_source = source;
    }
    if (!b.ok) return FB_TRUNCATED;
    if (num_splits) {
      // bit section without a size prefix: one bit per split, LSB-first
      int64_t bit_pos = b.pos * 8;
      for (int64_t i = 0; i < num_splits; ++i) {
        if (bit_pos >= b.end * 8) return FB_TRUNCATED;
        split_edge[i] = (data[bit_pos >> 3] >> (bit_pos & 7)) & 1;
        bit_pos += 1;
      }
      b.pos = (bit_pos + 7) >> 3;
    }
  }

  // valence traversal sections: start-face bits, per-attribute seam bits,
  // then the six context symbol streams
  RabsBuf start_face;
  if (!start_face.parse(b)) return FB_TRUNCATED;
  std::vector<RabsBuf> seam_bufs(num_attribute_data);
  for (int i = 0; i < num_attribute_data; ++i)
    if (!seam_bufs[i].parse(b)) return FB_TRUNCATED;
  std::vector<uint32_t> ctx_syms;
  int64_t ctx_off[NUM_VALENCE_CONTEXTS + 1] = {0};
  {
    std::vector<uint32_t> tmp;
    for (int k = 0; k < NUM_VALENCE_CONTEXTS; ++k) {
      int64_t n = (int64_t)b.varint();
      if (!b.ok || n < 0) return FB_TRUNCATED;
      if (n > 0) {
        int rc = decode_symbols_raw(b, n, tmp);
        if (rc != FB_OK) return rc;
        ctx_syms.insert(ctx_syms.end(), tmp.begin(), tmp.end());
      }
      ctx_off[k + 1] = (int64_t)ctx_syms.size();
    }
  }

  // the spirale-reversi machine (same capacity rule as _run_machine_native)
  const int64_t max_vertices = num_encoded_vertices +
                               num_encoded_split_symbols +
                               3 * num_faces / 2 + 3;
  // uninitialized scratch: the machine writes every entry it reads
  std::unique_ptr<int32_t[]> opposite_buf(new int32_t[n_corners]);
  std::unique_ptr<int32_t[]> vertex_buf(new int32_t[n_corners]);
  std::unique_ptr<int32_t[]> vertex_corner_buf(new int32_t[max_vertices]);
  std::unique_ptr<int32_t[]> processed_buf(new int32_t[num_faces]);
  int32_t* opposite = opposite_buf.get();
  int32_t* vertex = vertex_buf.get();
  int32_t* vertex_corner = vertex_corner_buf.get();
  int32_t* processed = processed_buf.get();
  int64_t machine_counts[4] = {0, 0, 0, 0};
  {
    int rc = uvt_eb_valence_machine(
        ctx_syms.data(), ctx_off, num_encoded_symbols, num_faces, max_vertices,
        split_source.data(), split_id.data(), split_edge.data(), num_splits,
        start_face.prob_zero, start_face.buf, start_face.len, opposite,
        vertex, vertex_corner, processed, machine_counts);
    if (rc != 0) return FB_MALFORMED;
  }
  const int64_t n_processed = machine_counts[0] + machine_counts[1];
  const int64_t num_ct_vertices = machine_counts[2];

  // attribute seams (one rABS stream per attribute-data) + boundary edges
  std::vector<std::vector<int32_t>> seam_corners(num_attribute_data);
  if (num_attribute_data > 0) {
    std::vector<uint32_t> probs(num_attribute_data);
    std::vector<int64_t> offs(num_attribute_data + 1, 0);
    int64_t total = 0;
    for (int i = 0; i < num_attribute_data; ++i) total += seam_bufs[i].len;
    std::vector<uint8_t> concat(total ? total : 1);
    for (int i = 0; i < num_attribute_data; ++i) {
      probs[i] = seam_bufs[i].prob_zero;
      offs[i + 1] = offs[i] + seam_bufs[i].len;
      if (seam_bufs[i].len)
        std::memcpy(concat.data() + offs[i], seam_bufs[i].buf,
                    seam_bufs[i].len);
    }
    const int64_t cap = 6 * num_faces;
    std::vector<int32_t> out_corners((size_t)num_attribute_data * cap);
    std::vector<int64_t> out_counts(num_attribute_data);
    int rc = uvt_seam_pass(opposite, num_faces, num_attribute_data,
                           probs.data(), concat.data(), offs.data(),
                           out_corners.data(), out_counts.data());
    if (rc != 0) return FB_MALFORMED;
    for (int i = 0; i < num_attribute_data; ++i)
      seam_corners[i].assign(out_corners.begin() + i * cap,
                             out_corners.begin() + i * cap + out_counts[i]);
  }
  std::vector<int32_t> boundary;
  for (int64_t c = 0; c < n_corners; ++c)
    if (opposite[c] == INVALID) boundary.push_back((int32_t)c);
  for (int i = 0; i < num_attribute_data; ++i)
    seam_corners[i].insert(seam_corners[i].end(), boundary.begin(),
                           boundary.end());

  // ---- attribute decoder headers (decoder.py) ------------------------------
  int num_decoders = b.u8();
  if (!b.ok || num_decoders <= 0 || num_decoders > 127) return FB_MALFORMED;
  struct DecHeader {
    int att_data_id, decoder_type;
    std::vector<FrameAttr> attrs;
    std::vector<int> seq_types;
  };
  std::vector<DecHeader> decs(num_decoders);
  for (int d = 0; d < num_decoders; ++d) {
    decs[d].att_data_id = b.i8();
    decs[d].decoder_type = b.u8();
    int traversal = b.u8();
    if (!b.ok) return FB_TRUNCATED;
    if (traversal != MESH_TRAVERSAL_DEPTH_FIRST) return FB_UNSUPPORTED;
  }
  for (int d = 0; d < num_decoders; ++d) {
    int64_t n_att = (int64_t)b.varint();
    if (!b.ok || n_att <= 0 || n_att > 255) return FB_MALFORMED;
    decs[d].attrs.resize(n_att);
    for (int64_t a = 0; a < n_att; ++a) {
      FrameAttr& at = decs[d].attrs[a];
      at.att_type = b.u8();
      at.data_type = b.u8();
      at.num_components = b.u8();
      at.normalized = b.u8();
      at.unique_id = (int64_t)b.varint();
      if (at.num_components <= 0 || at.num_components > 8)
        return FB_MALFORMED;
    }
    decs[d].seq_types.resize(n_att);
    for (int64_t a = 0; a < n_att; ++a) decs[d].seq_types[a] = b.u8();
    if (!b.ok) return FB_TRUNCATED;
  }

  // ---- per-decoder attribute decode ----------------------------------------
  std::vector<int64_t> pos_values;      // [n_pos, 3] portable ints
  std::vector<int32_t> pos_vertex_to_data;
  std::vector<int32_t> pos_corner_map;  // corner -> position data index
  // identical traversals: every vertex decoder shares (ct, corner order)
  std::vector<int32_t> shared_v2d, shared_d2c;
  int64_t shared_num_values = -1;

  // pre-pass: every corner-attribute decoder's seam-split corner table,
  // built in ONE ring sweep (uvt_attr_corner_tables_multi) — typical
  // draco_encoder output has two such decoders (UV + normals) and the
  // per-decoder walks repeated the same dependent-load ring orbits.
  struct AttrTables {
    std::vector<uint8_t> seam_mask;  // is_edge_on_seam (u8)
    // uninitialized POD scratch: the table kernel fills c2v itself and
    // only the first n_attr_vertices entries of v2c/fan_open are read
    // (std::vector resize would memset ~3 x n_corners per decoder)
    std::unique_ptr<int32_t[]> c2v, v2c;
    std::unique_ptr<uint8_t[]> fan_open;
    int64_t n_attr_vertices = 0;
  };
  std::vector<AttrTables> att_tables(num_decoders);
  {
    std::vector<int> ids;
    for (int d = 0; d < num_decoders; ++d)
      if (decs[d].decoder_type == MESH_CORNER_ATTRIBUTE) ids.push_back(d);
    if (!ids.empty()) {
      const size_t na = ids.size();
      std::vector<std::vector<uint8_t>> von(na);
      std::vector<const uint8_t*> sm(na), vs(na);
      std::vector<int32_t*> c2v(na), v2c(na);
      std::vector<uint8_t*> fo(na);
      for (size_t k = 0; k < na; ++k) {
        DecHeader& dh = decs[ids[k]];
        if (dh.att_data_id < 0 || dh.att_data_id >= num_attribute_data)
          return FB_MALFORMED;
        AttrTables& t = att_tables[ids[k]];
        const std::vector<int32_t>& seams = seam_corners[dh.att_data_id];
        t.seam_mask.assign(n_corners, 0);
        von[k].assign(max_vertices, 0);
        for (int32_t c : seams) {
          t.seam_mask[c] = 1;
          int32_t o = opposite[c];
          if (o != INVALID) t.seam_mask[o] = 1;
        }
        for (int64_t c = 0; c < n_corners; ++c) {
          if (!t.seam_mask[c]) continue;
          von[k][vertex[next_c((int32_t)c)]] = 1;
          von[k][vertex[prev_c((int32_t)c)]] = 1;
        }
        t.c2v.reset(new int32_t[n_corners]);
        t.v2c.reset(new int32_t[n_corners]);
        t.fan_open.reset(new uint8_t[n_corners]);
        sm[k] = t.seam_mask.data();
        vs[k] = von[k].data();
        c2v[k] = t.c2v.get();
        v2c[k] = t.v2c.get();
        fo[k] = t.fan_open.get();
      }
      std::vector<int64_t> counts(na);
      int rc = uvt_attr_corner_tables_multi(
          opposite, vertex, vertex_corner, num_ct_vertices, n_corners,
          (int)na, sm.data(), vs.data(), c2v.data(), v2c.data(), fo.data(),
          counts.data());
      if (rc != 0) return FB_MALFORMED;
      for (size_t k = 0; k < na; ++k)
        att_tables[ids[k]].n_attr_vertices = counts[k];
    }
  }

  for (int d = 0; d < num_decoders; ++d) {
    DecHeader& dh = decs[d];
    const uint8_t* fan_open_ptr = nullptr;
    const int32_t* corner_vertex = vertex;
    const int32_t* view_vertex = vertex;
    const uint8_t* seam_ptr = nullptr;
    int64_t num_view_vertices = num_ct_vertices;

    if (dh.decoder_type == MESH_CORNER_ATTRIBUTE) {
      AttrTables& t = att_tables[d];
      fan_open_ptr = t.fan_open.get();
      corner_vertex = t.c2v.get();
      view_vertex = t.c2v.get();
      seam_ptr = t.seam_mask.data();
      num_view_vertices = t.n_attr_vertices;
    }

    // depth-first traversal (shared across vertex decoders: identical input)
    std::vector<int32_t> v2d_local, d2c_local;
    const int32_t* v2d;
    const int32_t* d2c;
    int64_t num_values;
    if (dh.decoder_type != MESH_CORNER_ATTRIBUTE && shared_num_values >= 0) {
      v2d = shared_v2d.data();
      d2c = shared_d2c.data();
      num_values = shared_num_values;
    } else {
      v2d_local.assign(num_view_vertices ? num_view_vertices : 1, INVALID);
      d2c_local.assign(num_view_vertices ? num_view_vertices : 1, 0);
      int rc = uvt_traverse_depth_first(
          opposite, view_vertex, seam_ptr, num_faces, num_view_vertices,
          processed, n_processed, fan_open_ptr,
          v2d_local.data(), d2c_local.data(), &num_values);
      if (rc != 0) return FB_MALFORMED;
      if (dh.decoder_type != MESH_CORNER_ATTRIBUTE) {
        shared_v2d = v2d_local;
        shared_d2c = d2c_local;
        shared_num_values = num_values;
        v2d = shared_v2d.data();
        d2c = shared_d2c.data();
      } else {
        v2d = v2d_local.data();
        d2c = d2c_local.data();
      }
    }

    // corner -> position-data map for the geometric predictors
    if (!pos_values.empty() && pos_corner_map.empty()) {
      pos_corner_map.resize(n_corners);
      for (int64_t c = 0; c < n_corners; ++c)
        pos_corner_map[c] = pos_vertex_to_data[vertex[c]];
    }

    for (size_t a = 0; a < dh.attrs.size(); ++a) {
      FrameAttr& attr = dh.attrs[a];
      const int seq_type = dh.seq_types[a];
      const int nc = attr.num_components;
      attr.num_values = num_values;

      if (seq_type == SEQ_INTEGER || seq_type == SEQ_QUANTIZATION) {
        int method = b.i8();
        if (!b.ok) return FB_TRUNCATED;
        if (method != PREDICTION_NONE) {
          int transform_type = b.i8();
          if (!b.ok) return FB_TRUNCATED;
          if (transform_type != PREDICTION_TRANSFORM_WRAP)
            return FB_UNSUPPORTED;
        }
        int compressed = b.u8();
        if (!b.ok) return FB_TRUNCATED;
        if (!compressed) return FB_UNSUPPORTED;
        std::vector<uint32_t> symbols;
        int rc = decode_symbols_raw(b, num_values * nc, symbols);
        if (rc != FB_OK) return rc;

        std::vector<int64_t> ints((size_t)num_values * nc);
        if (method == PREDICTION_NONE) {
          for (int64_t i = 0; i < num_values * nc; ++i) {
            uint32_t s = symbols[i];
            int64_t mag = (int64_t)(s >> 1);
            ints[i] = (s & 1) == 0 ? mag : -mag - 1;
          }
        } else if (method == PREDICTION_DIFFERENCE) {
          int64_t mn = b.i32(), mx = b.i32();
          if (!b.ok) return FB_TRUNCATED;
          const int64_t dif = 1 + mx - mn;
          int64_t prev[8] = {0};
          for (int64_t i = 0; i < num_values; ++i) {
            for (int k = 0; k < nc; ++k) {
              uint32_t s = symbols[i * nc + k];
              int64_t mag = (int64_t)(s >> 1);
              int64_t corr = (s & 1) == 0 ? mag : -mag - 1;
              int64_t p = prev[k];
              if (p < mn) p = mn;
              if (p > mx) p = mx;
              int64_t o = p + corr;
              if (o > mx) o -= dif;
              else if (o < mn) o += dif;
              ints[i * nc + k] = o;
              prev[k] = o;
            }
          }
        } else if (method == MESH_PREDICTION_PARALLELOGRAM) {
          std::vector<int64_t> signed_c((size_t)num_values * nc);
          for (int64_t i = 0; i < num_values * nc; ++i) {
            uint32_t s = symbols[i];
            int64_t mag = (int64_t)(s >> 1);
            signed_c[i] = (s & 1) == 0 ? mag : -mag - 1;
          }
          int64_t mn = b.i32(), mx = b.i32();
          if (!b.ok) return FB_TRUNCATED;
          int rc2 = uvt_decode_parallelogram(
              signed_c.data(), num_values, nc, mn, mx, opposite,
              view_vertex, seam_ptr, v2d, d2c, ints.data());
          if (rc2 != 0) return FB_MALFORMED;
        } else if (method == MESH_PREDICTION_TEX_COORDS_PORTABLE) {
          if (nc != 2 || pos_values.empty() || pos_corner_map.empty())
            return FB_UNSUPPORTED;
          // predictor wire data: i32 orientation count + rABS stream
          int64_t n_orient = b.i32();
          if (!b.ok || n_orient < 0) return FB_MALFORMED;
          RabsBuf ob;
          if (!ob.parse(b)) return FB_TRUNCATED;
          std::vector<uint8_t> bits(n_orient ? n_orient : 1);
          if (n_orient) {
            int rc2 = uvt_rabs_decode_bits(ob.prob_zero, ob.buf, ob.len,
                                           bits.data(), n_orient);
            if (rc2 != 0) return FB_MALFORMED;
          }
          // delta decode: last starts true; bit 0 flips
          std::vector<uint8_t> orients(n_orient ? n_orient : 1);
          int last = 1;
          for (int64_t i = 0; i < n_orient; ++i) {
            if (!bits[i]) last = !last;
            orients[i] = (uint8_t)last;
          }
          int64_t mn = b.i32(), mx = b.i32();
          if (!b.ok) return FB_TRUNCATED;
          std::vector<int64_t> corr((size_t)num_values * 2);
          for (int64_t i = 0; i < num_values * 2; ++i)
            corr[i] = (int64_t)symbols[i];  // positive modular
          int rc2 = uvt_texcoords_predict(
              corr.data(), num_values, mn, mx, view_vertex, v2d, d2c,
              pos_values.data(), pos_corner_map.data(), orients.data(),
              n_orient, ints.data());
          if (rc2 != 0) return FB_MALFORMED;
        } else {
          return FB_UNSUPPORTED;
        }

        if (seq_type == SEQ_QUANTIZATION) {
          double mins[8];
          for (int k = 0; k < nc; ++k) mins[k] = (double)b.f32();
          double rng = (double)b.f32();
          int qbits = b.u8();
          if (!b.ok) return FB_TRUNCATED;
          if (qbits <= 0 || qbits > 31) return FB_MALFORMED;
          if (out.portable) {
            attr.is_float = 0;
            attr.deq_kind = 1;
            for (int k = 0; k < nc; ++k) attr.deq_min[k] = mins[k];
            attr.deq_range = rng;
            attr.deq_bits = qbits;
            attr.values_i = ints;  // copy: POSITION still moves below
          } else {
            double delta = rng / (double)((1u << qbits) - 1);
            attr.is_float = 1;
            attr.values_f.resize((size_t)num_values * nc);
            for (int64_t i = 0; i < num_values; ++i)
              for (int k = 0; k < nc; ++k)
                attr.values_f[i * nc + k] =
                    (float)(mins[k] + (double)ints[i * nc + k] * delta);
          }
        } else {
          attr.is_float = 0;
          attr.values_i = ints;
        }
        if (attr.att_type == ATT_POSITION) {
          if (nc != 3) return FB_UNSUPPORTED;
          pos_values = std::move(ints);
          pos_vertex_to_data.assign(v2d, v2d + num_view_vertices);
          pos_corner_map.clear();  // recompute lazily for later decoders
        }

      } else if (seq_type == SEQ_NORMALS) {
        int method = b.i8();
        int transform_type = b.i8();
        if (!b.ok) return FB_TRUNCATED;
        if (method != MESH_PREDICTION_GEOMETRIC_NORMAL ||
            transform_type != PREDICTION_TRANSFORM_NORMAL_OCT_CANON)
          return FB_UNSUPPORTED;
        int compressed = b.u8();
        if (!b.ok) return FB_TRUNCATED;
        if (!compressed) return FB_UNSUPPORTED;
        std::vector<uint32_t> symbols;
        int rc = decode_symbols_raw(b, num_values * 2, symbols);
        if (rc != FB_OK) return rc;
        if (pos_values.empty() || pos_corner_map.empty())
          return FB_UNSUPPORTED;
        // octahedron transform wire data + flip stream
        int64_t max_quantized = b.i32();
        int64_t center_wire = b.i32();
        if (!b.ok) return FB_TRUNCATED;
        RabsBuf flip;
        if (!flip.parse(b)) return FB_TRUNCATED;
        std::vector<int64_t> corr((size_t)num_values * 2);
        for (int64_t i = 0; i < num_values * 2; ++i)
          corr[i] = (int64_t)symbols[i];
        std::vector<int64_t> st((size_t)num_values * 2);
        int rc2 = uvt_normals_predict(
            corr.data(), num_values, max_quantized, center_wire,
            opposite, view_vertex, seam_ptr, d2c, pos_values.data(),
            pos_corner_map.data(), flip.prob_zero, flip.buf, flip.len,
            num_faces, v2d, st.data());
        if (rc2 != 0) return FB_MALFORMED;
        b.u8();  // qbits (DecodeDataNeededByPortableTransform)
        if (!b.ok) return FB_TRUNCATED;
        if (out.portable) {
          // keep quantized octahedral ints; device does oct -> unit
          attr.is_float = 0;
          attr.deq_kind = 2;
          attr.oct_max_quantized = max_quantized;
          attr.values_i = std::move(st);
        } else {
          // octahedral -> unit vector (decoder.py vectorized math, float64)
          int q = 0;
          while ((1LL << q) <= max_quantized) q++;
          double max_value = (double)((1LL << q) - 2);
          attr.is_float = 1;
          attr.values_f.resize((size_t)num_values * 3);
          for (int64_t i = 0; i < num_values; ++i) {
            double u = (double)st[i * 2] / max_value * 2.0 - 1.0;
            double v = (double)st[i * 2 + 1] / max_value * 2.0 - 1.0;
            double z = 1.0 - std::fabs(u) - std::fabs(v);
            if (z < 0) {
              double su = u >= 0 ? 1.0 : -1.0;
              double sv = v >= 0 ? 1.0 : -1.0;
              double u2 = (1.0 - std::fabs(v)) * su;
              double v2 = (1.0 - std::fabs(u)) * sv;
              u = u2;
              v = v2;
            }
            double nrm = std::sqrt(u * u + v * v + z * z);
            if (nrm == 0) {
              attr.values_f[i * 3] = 0.0f;
              attr.values_f[i * 3 + 1] = 0.0f;
              attr.values_f[i * 3 + 2] = 1.0f;
            } else {
              double dn = nrm < 1e-30 ? 1e-30 : nrm;
              attr.values_f[i * 3] = (float)(u / dn);
              attr.values_f[i * 3 + 1] = (float)(v / dn);
              attr.values_f[i * 3 + 2] = (float)(z / dn);
            }
          }
        }
      } else {
        return FB_UNSUPPORTED;
      }

      attr.corner_to_value.resize(n_corners);
      for (int64_t c = 0; c < n_corners; ++c) {
        int32_t v = v2d[corner_vertex[c]];
        if (v < 0) return FB_MALFORMED;  // unvisited attribute vertex
        attr.corner_to_value[c] = v;
      }
    }

    for (auto& at : dh.attrs) out.attrs.push_back(std::move(at));
  }
  if (b.pos != b.end) return FB_MALFORMED;  // undecoded bytes at end

  // ---- point assembly -------------------------------------------------------
  // bucket by the first attribute's value index (corners of one point share
  // it, so it is a perfect coarse hash) and chain the remaining columns
  // packed into 64 bits; point ids are assigned by first appearance in
  // corner order (Draco's numbering, identical to uvt_point_assembly).
  const int num_attrs = (int)out.attrs.size();
  if (num_attrs == 0 || num_attrs > 16) return FB_UNSUPPORTED;
  {
    int rest_bits = 0;
    int widths[16];
    for (int a = 1; a < num_attrs; ++a) {
      int64_t nv = out.attrs[a].num_values;
      int w = 1;
      while ((int64_t(1) << w) < nv) w++;
      widths[a] = w;
      rest_bits += w;
    }
    if (rest_bits > 64) return FB_UNSUPPORTED;
    const int64_t nv0 = out.attrs[0].num_values ? out.attrs[0].num_values : 1;
    std::vector<int32_t> head(nv0, INVALID);
    std::vector<uint64_t> ent_rest;
    std::vector<int32_t> ent_next;
    ent_rest.reserve(nv0 + nv0 / 2);
    ent_next.reserve(nv0 + nv0 / 2);
    out.point_of_corner.resize(n_corners);
    const int32_t* m0 = out.attrs[0].corner_to_value.data();
    const int32_t* maps[16];
    for (int a = 1; a < num_attrs; ++a)
      maps[a] = out.attrs[a].corner_to_value.data();
    for (int64_t c = 0; c < n_corners; ++c) {
      uint64_t rest = 0;
      for (int a = 1; a < num_attrs; ++a)
        rest = (rest << widths[a]) | (uint64_t)(uint32_t)maps[a][c];
      int32_t bkt = m0[c];
      if (bkt < 0 || bkt >= nv0) return FB_MALFORMED;
      int32_t e = head[bkt];
      while (e != INVALID && ent_rest[e] != rest) e = ent_next[e];
      if (e == INVALID) {
        e = (int32_t)ent_rest.size();
        ent_rest.push_back(rest);
        ent_next.push_back(head[bkt]);
        head[bkt] = e;
      }
      out.point_of_corner[c] = e;
    }
    out.num_points = (int64_t)ent_rest.size();
  }
  out.num_faces = num_faces;
  return FB_OK;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI: opaque-handle decode + getters (ctypes-friendly)
// ---------------------------------------------------------------------------

extern "C" {

// out_info: [0]=rc (0 ok; <0 fallback to Python), [1]=num_attrs,
// [2]=num_faces, [3]=num_points. Returns a handle to free with uvt_drc_free
// (NULL when rc<0).
void* uvt_drc_decode2(const uint8_t* data, int64_t len, int64_t flags,
                      int64_t* out_info) {
  Frame* f = new Frame();
  f->portable = (int)(flags & 1);
  int rc;
  try {
    rc = decode_frame(data, len, *f);
  } catch (...) {
    rc = FB_INTERNAL;
  }
  out_info[0] = rc;
  if (rc != FB_OK) {
    delete f;
    out_info[1] = out_info[2] = out_info[3] = 0;
    return nullptr;
  }
  out_info[1] = (int64_t)f->attrs.size();
  out_info[2] = f->num_faces;
  out_info[3] = f->num_points;
  return f;
}

void* uvt_drc_decode(const uint8_t* data, int64_t len, int64_t* out_info) {
  return uvt_drc_decode2(data, len, 0, out_info);
}

// portable-mode dequantize parameters: out12 = [deq_kind, deq_bits,
// oct_max_quantized, deq_range, deq_min[0..7]]
int uvt_drc_attr_deq(void* h, int idx, double* out12) {
  Frame* f = (Frame*)h;
  if (!f || idx < 0 || idx >= (int)f->attrs.size()) return -1;
  const FrameAttr& a = f->attrs[idx];
  out12[0] = (double)a.deq_kind;
  out12[1] = (double)a.deq_bits;
  out12[2] = (double)a.oct_max_quantized;
  out12[3] = a.deq_range;
  for (int k = 0; k < 8; ++k) out12[4 + k] = a.deq_min[k];
  return 0;
}

// info8: att_type, data_type, num_components, normalized, unique_id,
// is_float, num_values, stored_components (normals store 3 floats even
// though the wire header declares the octahedral component count)
int uvt_drc_attr_info(void* h, int idx, int64_t* info8) {
  Frame* f = (Frame*)h;
  if (!f || idx < 0 || idx >= (int)f->attrs.size()) return -1;
  const FrameAttr& a = f->attrs[idx];
  info8[0] = a.att_type;
  info8[1] = a.data_type;
  info8[2] = a.num_components;
  info8[3] = a.normalized;
  info8[4] = a.unique_id;
  info8[5] = a.is_float;
  info8[6] = a.num_values;
  int64_t stored = a.is_float ? (int64_t)a.values_f.size()
                              : (int64_t)a.values_i.size();
  info8[7] = a.num_values ? stored / a.num_values : a.num_components;
  return 0;
}

// values_out: float32[n*nc] when is_float else int64[n*nc];
// corner_map_out: int32[3F]. Either pointer may be NULL to skip that
// payload (consumers that only need one side, e.g. examples/native_player.c).
int uvt_drc_attr_fetch(void* h, int idx, void* values_out,
                       int32_t* corner_map_out) {
  Frame* f = (Frame*)h;
  if (!f || idx < 0 || idx >= (int)f->attrs.size()) return -1;
  const FrameAttr& a = f->attrs[idx];
  if (values_out) {
    if (a.is_float)
      std::memcpy(values_out, a.values_f.data(), a.values_f.size() * 4);
    else
      std::memcpy(values_out, a.values_i.data(), a.values_i.size() * 8);
  }
  if (corner_map_out)
    std::memcpy(corner_map_out, a.corner_to_value.data(),
                a.corner_to_value.size() * 4);
  return 0;
}

int uvt_drc_points_fetch(void* h, int32_t* point_of_corner_out) {
  Frame* f = (Frame*)h;
  if (!f) return -1;
  std::memcpy(point_of_corner_out, f->point_of_corner.data(),
              f->point_of_corner.size() * 4);
  return 0;
}

void uvt_drc_free(void* h) { delete (Frame*)h; }

}  // extern "C"
