// Native hot loops for the Draco-format decode path (C ABI, ctypes).
//
// Each function is a 1:1 port of the corresponding Python reference in
// uvol_tpu/codecs/draco/ (the bit-exactness oracle, golden-validated on the
// liam corpus); Python keeps stream parsing and orchestration, C++ runs the
// O(N) inner loops. Build: g++ -O3 -shared -fPIC (see native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <memory>
#include <vector>

namespace {

constexpr int32_t INVALID = -1;

inline int32_t next_corner(int32_t c) { return (c % 3 == 2) ? c - 2 : c + 1; }
inline int32_t prev_corner(int32_t c) { return (c % 3 == 0) ? c + 2 : c - 1; }

// ---------------------------------------------------------------------------
// rABS binary decoder (codecs/rans.py RansBitDecoder)
// ---------------------------------------------------------------------------

struct RabsDecoder {
  const uint8_t* buf;
  int64_t offset;  // renorm bytes before the final-state marker
  uint64_t state;
  uint32_t prob_zero;

  static constexpr uint32_t IO_BASE = 256;
  static constexpr uint32_t L_BASE = 4096;
  static constexpr uint32_t P8 = 256;

  bool init(const uint8_t* data, int64_t len, uint32_t p0) {
    buf = data;
    prob_zero = p0;
    if (len <= 0) return false;
    // _read_final_state
    uint32_t x = data[len - 1] >> 6;
    if (x == 0) {
      state = (data[len - 1] & 0x3F) + L_BASE;
      offset = len - 1;
    } else if (x == 1) {
      uint32_t v = data[len - 2] | (uint32_t(data[len - 1]) << 8);
      state = (v & 0x3FFF) + L_BASE;
      offset = len - 2;
    } else if (x == 2) {
      uint32_t v = data[len - 3] | (uint32_t(data[len - 2]) << 8) |
                   (uint32_t(data[len - 1]) << 16);
      state = (v & 0x3FFFFF) + L_BASE;
      offset = len - 3;
    } else {
      uint32_t v = data[len - 4] | (uint32_t(data[len - 3]) << 8) |
                   (uint32_t(data[len - 2]) << 16) |
                   (uint32_t(data[len - 1]) << 24);
      state = (v & 0x3FFFFFFF) + L_BASE;
      offset = len - 4;
    }
    return true;
  }

  int decode_bit() {
    uint32_t p0 = prob_zero;
    uint32_t p = P8 - p0;
    while (state < L_BASE && offset > 0) {
      offset -= 1;
      state = state * IO_BASE + buf[offset];
    }
    uint64_t quot = state / P8;
    uint64_t rem = state % P8;
    uint64_t xn = quot * p;
    if (rem < p) {
      state = xn + rem;
      return 1;
    }
    state = state - xn - p;
    return 0;
  }
};

// ---------------------------------------------------------------------------
// Corner-table helpers over raw arrays
// ---------------------------------------------------------------------------

struct Table {
  int32_t* opposite;
  int32_t* vertex;
  int32_t* vertex_corner;  // leftmost corner per vertex

  int32_t swing_left(int32_t c) const {
    int32_t o = opposite[next_corner(c)];
    return o == INVALID ? INVALID : next_corner(o);
  }
  int32_t swing_right(int32_t c) const {
    int32_t o = opposite[prev_corner(c)];
    return o == INVALID ? INVALID : prev_corner(o);
  }
};

}  // namespace

extern "C" {

// decode n rABS bits FIFO; returns 0 on success
int uvt_rabs_decode_bits(uint32_t prob_zero, const uint8_t* buf, int64_t len,
                         uint8_t* out, int64_t n) {
  RabsDecoder d;
  if (!d.init(buf, len, prob_zero)) return -1;
  for (int64_t i = 0; i < n; ++i) out[i] = (uint8_t)d.decode_bit();
  return 0;
}

// ---------------------------------------------------------------------------
// Valence edgebreaker machine (edgebreaker.py run_connectivity_machine).
// Inputs: per-context symbol arrays (concatenated, ctx_off[6] offsets),
// topology splits, and the start-face rABS stream. Outputs: the corner
// table arrays, processed corner order, component info.
// Returns number of decoded faces, or negative error code.
// ---------------------------------------------------------------------------
int uvt_eb_valence_machine(
    const uint32_t* ctx_syms, const int64_t* ctx_off,  // [6] offsets
    int64_t num_symbols, int64_t num_faces, int64_t max_vertices,
    const int64_t* split_source, const int64_t* split_id,
    const uint8_t* split_edge, int64_t num_splits,
    uint32_t sf_prob_zero, const uint8_t* sf_buf, int64_t sf_len,
    // outputs
    int32_t* opposite, int32_t* vertex, int32_t* vertex_corner,
    int32_t* processed_corners,  // [num_faces]
    int64_t* out_counts  // [4]: n_processed, n_init_faces, num_vertices, n_components
) {
  const int64_t n_corners = 3 * num_faces;
  for (int64_t i = 0; i < n_corners; ++i) opposite[i] = INVALID;
  for (int64_t i = 0; i < n_corners; ++i) vertex[i] = INVALID;
  for (int64_t i = 0; i < max_vertices; ++i) vertex_corner[i] = INVALID;

  constexpr int NUM_CTX = 6;  // valences 2..7 (MIN_VALENCE..MAX_VALENCE)
  std::vector<int64_t> ctx_counter(NUM_CTX);
  for (int k = 0; k < NUM_CTX; ++k)
    ctx_counter[k] = ctx_off[k + 1] - ctx_off[k];
  // SYMBOL_TO_TOPOLOGY = (C, S, L, R, E) = (0, 1, 3, 5, 7)
  static const int SYM2TOP[5] = {0, 1, 3, 5, 7};

  std::vector<int64_t> valences(max_vertices, 0);
  std::vector<int32_t> stack;
  stack.reserve(64);
  // decoder-split-id -> saved corner
  std::vector<int32_t> split_corner_of;  // sparse map via sorted pairs
  std::vector<int64_t> split_key;
  split_corner_of.reserve(num_splits);
  split_key.reserve(num_splits);

  int64_t num_vertices = 0;
  int active_context = -1;
  int64_t n_processed = 0;

  auto find_split = [&](int64_t key) -> int32_t {
    for (size_t i = 0; i < split_key.size(); ++i)
      if (split_key[i] == key) {
        int32_t c = split_corner_of[i];
        split_key[i] = -1;
        return c;
      }
    return INVALID;
  };

  auto set_opp = [&](int32_t a, int32_t b) {
    opposite[a] = b;
    opposite[b] = a;
  };

  for (int64_t symbol_id = 0; symbol_id < num_symbols; ++symbol_id) {
    int symbol;
    if (active_context == -1) {
      symbol = 7;  // implicit TOPOLOGY_E
    } else {
      int ctx = active_context;
      ctx_counter[ctx] -= 1;
      if (ctx_counter[ctx] < 0) return -2;
      symbol = SYM2TOP[ctx_syms[ctx_off[ctx] + ctx_counter[ctx]]];
    }
    int32_t corner = (int32_t)(3 * symbol_id);
    processed_corners[n_processed++] = corner;
    bool check_split = false;

    if (symbol == 0) {  // C
      if (stack.empty()) return -3;
      int32_t corner_a = stack.back();
      int32_t vertex_x = vertex[next_corner(corner_a)];
      int32_t corner_b = next_corner(vertex_corner[vertex_x]);
      if (corner_a == corner_b) return -4;
      int32_t vert_b_next = vertex[next_corner(corner_b)];
      int32_t vert_a_prev = vertex[prev_corner(corner_a)];
      set_opp(corner_a, corner + 1);
      set_opp(corner_b, corner + 2);
      vertex[corner] = vertex_x;
      vertex[corner + 1] = vert_b_next;
      vertex[corner + 2] = vert_a_prev;
      vertex_corner[vert_a_prev] = corner + 2;
      stack.back() = corner;
    } else if (symbol == 5 || symbol == 3) {  // R or L
      if (stack.empty()) return -3;
      int32_t corner_a = stack.back();
      int32_t opp_corner, corner_l, corner_r;
      if (symbol == 5) {
        opp_corner = corner + 2;
        corner_l = corner + 1;
        corner_r = corner;
      } else {
        opp_corner = corner + 1;
        corner_l = corner;
        corner_r = corner + 2;
      }
      set_opp(corner_a, opp_corner);
      int32_t new_vert = (int32_t)num_vertices++;
      if (new_vert >= max_vertices) return -5;
      vertex[opp_corner] = new_vert;
      vertex_corner[new_vert] = opp_corner;
      int32_t vertex_r = vertex[prev_corner(corner_a)];
      vertex[corner_r] = vertex_r;
      vertex_corner[vertex_r] = corner_r;
      vertex[corner_l] = vertex[next_corner(corner_a)];
      stack.back() = corner;
      check_split = true;
    } else if (symbol == 7) {  // E
      if (num_vertices + 3 > max_vertices) return -5;
      int32_t v0 = (int32_t)num_vertices++;
      int32_t v1 = (int32_t)num_vertices++;
      int32_t v2 = (int32_t)num_vertices++;
      vertex[corner] = v0;
      vertex[corner + 1] = v1;
      vertex[corner + 2] = v2;
      vertex_corner[v0] = corner;
      vertex_corner[v1] = corner + 1;
      vertex_corner[v2] = corner + 2;
      stack.push_back(corner);
      check_split = true;
    } else if (symbol == 1) {  // S
      if (stack.empty()) return -3;
      int32_t corner_b = stack.back();
      stack.pop_back();
      int32_t saved = find_split(symbol_id);
      if (saved != INVALID) stack.push_back(saved);
      if (stack.empty()) return -6;
      int32_t corner_a = stack.back();
      if (opposite[corner_a] != INVALID || opposite[corner_b] != INVALID)
        return -7;
      int32_t vertex_p = vertex[prev_corner(corner_a)];
      int32_t vertex_q = vertex[next_corner(corner_b)];
      if (vertex_p == vertex_q) return -8;
      Table t{opposite, vertex, vertex_corner};
      int32_t first_q = vertex_corner[vertex_q];
      int32_t c = first_q;
      int64_t sweep_steps = 0;
      while (c != INVALID) {
        vertex[c] = vertex_p;
        c = t.swing_right(c);
        if (++sweep_steps > n_corners) return -15;  // closed-fan S ref
      }
      set_opp(corner_a, corner + 2);
      set_opp(corner_b, corner + 1);
      vertex[corner] = vertex_p;
      vertex[corner + 1] = vertex[next_corner(corner_a)];
      vertex[corner + 2] = vertex[prev_corner(corner_b)];
      vertex_corner[vertex_p] = first_q;
      vertex_corner[vertex_q] = INVALID;
      valences[vertex_p] += valences[vertex_q];
      stack.back() = corner;
    } else {
      return -9;
    }

    if (check_split) {
      int64_t encoder_symbol_id = num_symbols - symbol_id - 1;
      for (int64_t s = 0; s < num_splits; ++s) {
        if (split_source[s] != encoder_symbol_id) continue;
        int64_t decoder_split_id = num_symbols - split_id[s] - 1;
        int32_t c = split_edge[s] == 1 /*RIGHT_FACE_EDGE*/
                        ? next_corner(corner)
                        : prev_corner(corner);
        split_key.push_back(decoder_split_id);
        split_corner_of.push_back(c);
      }
    }

    // valence tracking (context for the next symbol)
    int32_t nxt = next_corner(corner), prv = prev_corner(corner);
    if (symbol == 0 || symbol == 1) {
      valences[vertex[nxt]] += 1;
      valences[vertex[prv]] += 1;
    } else if (symbol == 5) {
      valences[vertex[corner]] += 1;
      valences[vertex[nxt]] += 1;
      valences[vertex[prv]] += 2;
    } else if (symbol == 3) {
      valences[vertex[corner]] += 1;
      valences[vertex[nxt]] += 2;
      valences[vertex[prv]] += 1;
    } else {
      valences[vertex[corner]] += 2;
      valences[vertex[nxt]] += 2;
      valences[vertex[prv]] += 2;
    }
    int64_t av = valences[vertex[nxt]];
    if (av < 2) av = 2;
    if (av > 7) av = 7;
    active_context = (int)(av - 2);
  }
  for (int k = 0; k < NUM_CTX; ++k)
    if (ctx_counter[k] != 0) return -10;

  // ---- end of symbols: init faces / holes ---------------------------------
  RabsDecoder sf;
  if (!sf.init(sf_buf, sf_len, sf_prob_zero)) return -11;
  int64_t num_decoded_faces = num_symbols;
  int64_t n_init = 0;
  int64_t n_components = 0;
  while (!stack.empty()) {
    int32_t corner = stack.back();
    stack.pop_back();
    n_components += 1;
    int interior = sf.decode_bit();
    if (interior) {
      int32_t corner_a = corner;
      int32_t corner_b = prev_corner(corner_a);
      while (opposite[corner_b] != INVALID)
        corner_b = prev_corner(opposite[corner_b]);
      int32_t corner_c = next_corner(corner_a);
      while (opposite[corner_c] != INVALID)
        corner_c = next_corner(opposite[corner_c]);
      int32_t face_corner = (int32_t)(3 * num_decoded_faces);
      num_decoded_faces += 1;
      if (face_corner + 2 >= n_corners) return -12;
      int32_t vert_n_b = vertex[next_corner(corner_b)];
      int32_t vert_n_c = vertex[next_corner(corner_c)];
      int32_t vert_n_a = vertex[next_corner(corner_a)];
      set_opp(face_corner, corner_a);
      set_opp(face_corner + 1, corner_b);
      set_opp(face_corner + 2, corner_c);
      vertex[face_corner] = vert_n_b;
      vertex[face_corner + 1] = vert_n_c;
      vertex[face_corner + 2] = vert_n_a;
      for (int k = 0; k < 3; ++k) {
        int32_t x = face_corner + k;
        int32_t o = opposite[x];
        if (vertex[next_corner(x)] != vertex[prev_corner(o)] ||
            vertex[prev_corner(x)] != vertex[next_corner(o)])
          return -13;
      }
      processed_corners[n_processed + n_init] = face_corner;
      n_init += 1;
    }
  }
  if (num_decoded_faces != num_faces) return -14;

  out_counts[0] = n_processed;
  out_counts[1] = n_init;
  out_counts[2] = num_vertices;
  out_counts[3] = n_components;
  return 0;
}

// ---------------------------------------------------------------------------
// Attribute seam pass (edgebreaker.py tail): for each face-order interior
// edge whose opposite face has a larger index, decode one bit per attribute;
// bit 1 marks both corners as seam. Outputs per-attribute seam corner lists.
// ---------------------------------------------------------------------------
int uvt_seam_pass(const int32_t* opposite, int64_t num_faces,
                  int64_t num_attribute_data,
                  const uint32_t* prob_zeros, const uint8_t* bufs,
                  const int64_t* buf_off,  // [n+1] offsets into bufs
                  int32_t* out_corners,    // [num_attribute_data * 6*num_faces]
                  int64_t* out_counts) {
  std::vector<RabsDecoder> decs(num_attribute_data);
  for (int64_t i = 0; i < num_attribute_data; ++i) {
    if (!decs[i].init(bufs + buf_off[i], buf_off[i + 1] - buf_off[i],
                      prob_zeros[i]))
      return -1;
  }
  const int64_t cap = 6 * num_faces;
  for (int64_t i = 0; i < num_attribute_data; ++i) out_counts[i] = 0;
  for (int64_t f = 0; f < num_faces; ++f) {
    for (int k = 0; k < 3; ++k) {
      int32_t c = (int32_t)(3 * f + k);
      int32_t o = opposite[c];
      if (o != INVALID && o / 3 > f) {
        for (int64_t i = 0; i < num_attribute_data; ++i) {
          if (decs[i].decode_bit()) {
            int64_t n = out_counts[i];
            if (n + 2 > cap) return -2;
            out_corners[i * cap + n] = c;
            out_corners[i * cap + n + 1] = o;
            out_counts[i] = n + 2;
          }
        }
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// MeshAttributeCornerTable recompute (corner_table.py _recompute)
// seam_mask[c] = 1 when the edge opposite corner c is a seam.
// ---------------------------------------------------------------------------
int uvt_attr_corner_table(const int32_t* opposite, const int32_t* vertex,
                          const int32_t* vertex_corner, int64_t num_vertices,
                          int64_t num_corners, const uint8_t* seam_mask,
                          const uint8_t* vertex_on_seam,
                          int32_t* corner_to_vertex,  // [num_corners]
                          int32_t* vertex_to_corner,  // [num_corners] cap
                          uint8_t* fan_open_out,  // nullable [num_corners] cap
                          int64_t* out_num_attr_vertices) {
  for (int64_t i = 0; i < num_corners; ++i) corner_to_vertex[i] = INVALID;
  Table t{const_cast<int32_t*>(opposite), const_cast<int32_t*>(vertex),
          const_cast<int32_t*>(vertex_corner)};
  auto swing_left_seam = [&](int32_t c) -> int32_t {
    int32_t nc = next_corner(c);
    if (seam_mask[nc]) return INVALID;
    int32_t o = opposite[nc];
    return o == INVALID ? INVALID : next_corner(o);
  };
  int64_t n_attr = 0;
  for (int64_t vert = 0; vert < num_vertices; ++vert) {
    int32_t first_c = vertex_corner[vert];
    if (first_c == INVALID) continue;
    if (vertex_on_seam[vert]) {
      int32_t act = swing_left_seam(first_c);
      while (act != INVALID) {
        first_c = act;
        act = swing_left_seam(act);
      }
    }
    int64_t first_fan = n_attr;
    int64_t fan_vertex = n_attr;
    vertex_to_corner[n_attr++] = first_c;
    corner_to_vertex[first_c] = (int32_t)fan_vertex;
    int32_t c = t.swing_right(first_c);
    while (c != INVALID && c != first_c) {
      if (seam_mask[next_corner(c)]) {
        fan_vertex = n_attr;
        vertex_to_corner[n_attr++] = c;
      }
      corner_to_vertex[c] = (int32_t)fan_vertex;
      c = t.swing_right(c);
    }
    if (fan_open_out) {
      // a fan is open iff some corner of it has no seam-aware left
      // neighbor. Every seam-started sub-fan is open by construction;
      // the first fan of a seam vertex was left-walked to a seam end
      // (open); a non-seam vertex's single fan is open iff the ring
      // walk hit a boundary instead of wrapping (manifold tables keep
      // `opposite` symmetric, so mid-walk corners always have left
      // neighbors). This replaces the traverser's 3F-corner
      // boundary-precompute pass for attribute decoders.
      uint8_t first_open =
          (vertex_on_seam[vert] || c == INVALID) ? 1 : 0;
      fan_open_out[first_fan] = first_open;
      for (int64_t fv = first_fan + 1; fv < n_attr; ++fv)
        fan_open_out[fv] = 1;
    }
  }
  *out_num_attr_vertices = n_attr;
  return 0;
}

// ---------------------------------------------------------------------------
// Multi-attribute MeshAttributeCornerTable recompute: one ring sweep.
//
// uvt_attr_corner_table walks every vertex's corner ring once PER
// ATTRIBUTE; with two corner-attribute decoders per frame (UV + normals
// on typical draco_encoder output) that repeats ~n_corners dependent
// loads. The ring structure (swing_right orbit of the POSITION corner
// table) is attribute-independent — only the seam gating differs — so
// this builder collects each ring once into a scratch buffer and then
// assigns every attribute's fans with L1-hot scans. Outputs are
// value-identical to per-attribute uvt_attr_corner_table calls
// (parity-locked by the liam golden tests + test_native_draco).
//
// Divergence from the single-attribute walker, hostile input only: the
// seam-gated left walk is bounded by the ring length (the original can
// spin on a closed ring whose vertex_on_seam bit has no matching gate,
// which valid streams cannot produce — boundary corners are always
// seam corners and seam masks are symmetric).
// ---------------------------------------------------------------------------
int uvt_attr_corner_tables_multi(
    const int32_t* opposite, const int32_t* vertex,
    const int32_t* vertex_corner, int64_t num_vertices, int64_t num_corners,
    int n_attrs, const uint8_t* const* seam_masks,
    const uint8_t* const* vertex_on_seam,
    int32_t* const* corner_to_vertex,  // [a][num_corners]
    int32_t* const* vertex_to_corner,  // [a][num_corners] cap
    uint8_t* const* fan_open_out,      // [a][num_corners] cap, nullable
    int64_t* out_num_attr_vertices) {  // [a]
  (void)vertex;
  if (n_attrs <= 0 || n_attrs > 64) return -1;
  for (int a = 0; a < n_attrs; ++a) {
    for (int64_t i = 0; i < num_corners; ++i)
      corner_to_vertex[a][i] = INVALID;
    out_num_attr_vertices[a] = 0;
  }
  std::vector<int32_t> ring;
  ring.reserve(64);
  std::vector<int32_t> left;
  left.reserve(8);
  for (int64_t vert = 0; vert < num_vertices; ++vert) {
    const int32_t base_c = vertex_corner[vert];
    if (base_c == INVALID) continue;
    // ---- collect the ring: right orbit from base_c -----------------------
    ring.clear();
    ring.push_back(base_c);
    bool closed = false;
    {
      int32_t c = base_c;
      while (true) {
        int32_t o = opposite[prev_corner(c)];
        if (o == INVALID) break;
        c = prev_corner(o);
        if (c == base_c) {
          closed = true;
          break;
        }
        ring.push_back(c);
        if ((int64_t)ring.size() > num_corners) return -3;  // bad orbit
      }
    }
    // left extension: only reachable when vertex_corner[vert] is not the
    // leftmost corner of an open ring (our connectivity builder keeps the
    // leftmost invariant, so this stays empty on valid frames)
    left.clear();
    if (!closed) {
      int32_t c = base_c;
      while (true) {
        int32_t o = opposite[next_corner(c)];
        if (o == INVALID) break;
        c = next_corner(o);
        if (c == base_c) break;
        left.push_back(c);
        if ((int64_t)(left.size() + ring.size()) > num_corners) return -3;
      }
    }
    const int64_t nL = (int64_t)left.size();
    const int64_t len = nL + (int64_t)ring.size();
    auto at = [&](int64_t i) -> int32_t {
      return i < nL ? left[nL - 1 - i] : ring[i - nL];
    };
    const int64_t base_idx = nL;
    // ---- per-attribute fan assignment over the cached ring ---------------
    for (int a = 0; a < n_attrs; ++a) {
      const uint8_t* seam = seam_masks[a];
      int64_t& n_attr = out_num_attr_vertices[a];
      int64_t fi = base_idx;
      if (vertex_on_seam[a][vert]) {
        // swing_left_seam emulation: step left until a seam gates the
        // edge (seam[next(cur)]) or the boundary end of an open ring
        for (int64_t steps = 0; steps < len; ++steps) {
          if (seam[next_corner(at(fi))]) break;
          if (fi == 0) {
            if (!closed) break;  // swing_left hits the boundary
            fi = len - 1;
          } else {
            --fi;
          }
        }
      }
      const int64_t first_fan = n_attr;
      int64_t fan_vertex = n_attr;
      vertex_to_corner[a][n_attr++] = at(fi);
      corner_to_vertex[a][at(fi)] = (int32_t)fan_vertex;
      for (int64_t i = fi;;) {
        if (i == len - 1) {
          if (!closed) break;
          i = 0;
        } else {
          ++i;
        }
        if (i == fi) break;  // wrapped
        const int32_t cc = at(i);
        if (seam[next_corner(cc)]) {
          fan_vertex = n_attr;
          vertex_to_corner[a][n_attr++] = cc;
        }
        corner_to_vertex[a][cc] = (int32_t)fan_vertex;
      }
      if (fan_open_out[a]) {
        fan_open_out[a][first_fan] =
            (vertex_on_seam[a][vert] || !closed) ? 1 : 0;
        for (int64_t fv = first_fan + 1; fv < n_attr; ++fv)
          fan_open_out[a][fv] = 1;
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Depth-first traversal (traverser.py traverse_depth_first)
// view_vertex: corner -> (attribute) vertex; seam_mask nullable.
// ---------------------------------------------------------------------------
int uvt_traverse_depth_first(const int32_t* opposite, const int32_t* view_vertex,
                             const uint8_t* seam_mask /*nullable*/,
                             int64_t num_faces, int64_t num_view_vertices,
                             const int32_t* corner_order, int64_t n_order,
                             const uint8_t* fan_open_in /*nullable: skip the
                                 boundary precompute (uvt_attr_corner_table
                                 emits it during its ring walks)*/,
                             int32_t* vertex_to_data,  // [num_view_vertices]
                             int32_t* data_to_corner,  // [num_view_vertices]
                             int64_t* out_num_values) {
  for (int64_t i = 0; i < num_view_vertices; ++i) vertex_to_data[i] = INVALID;
  std::vector<uint8_t> face_visited(num_faces, 0);
  std::vector<uint8_t> vert_visited(num_view_vertices, 0);
  int64_t n_values = 0;

  auto opp = [&](int32_t c) -> int32_t {
    if (c == INVALID) return INVALID;
    if (seam_mask && seam_mask[c]) return INVALID;
    return opposite[c];
  };
  auto right_corner = [&](int32_t c) { return opp(next_corner(c)); };
  auto left_corner = [&](int32_t c) { return opp(prev_corner(c)); };
  auto swing_left = [&](int32_t c) -> int32_t {
    int32_t o = opp(next_corner(c));
    return o == INVALID ? INVALID : next_corner(o);
  };
  auto visit_vertex = [&](int32_t v, int32_t corner) {
    vert_visited[v] = 1;
    vertex_to_data[v] = (int32_t)n_values;
    data_to_corner[n_values++] = corner;
  };
  auto face_done = [&](int32_t face) {
    return face == INVALID || face_visited[face];
  };
  // precomputed boundary flags: a fan is open iff ANY of its corners has
  // no left neighbor, and a left-only walk from any corner of an open fan
  // reaches that end — so the per-visit fan walk the reference does
  // reduces to one sequential pass over all corners (the walks totalled
  // the same step count but as dependent random loads)
  std::vector<uint8_t> fan_open_local;
  const uint8_t* fan_open = fan_open_in;
  if (!fan_open) {
    fan_open_local.assign(num_view_vertices, 0);
    for (int64_t c = 0; c < 3 * num_faces; ++c) {
      if (opp(next_corner((int32_t)c)) == INVALID) {
        int32_t v = view_vertex[c];
        if (v >= 0 && v < num_view_vertices) fan_open_local[v] = 1;
      }
    }
    fan_open = fan_open_local.data();
  }
  auto is_on_boundary = [&](int32_t corner_hint) -> bool {
    return fan_open[view_vertex[corner_hint]] != 0;
  };

  std::vector<int32_t> stack;
  for (int64_t oi = 0; oi < n_order; ++oi) {
    int32_t corner_id = corner_order[oi];
    if (face_visited[corner_id / 3]) continue;
    stack.clear();
    stack.push_back(corner_id);
    int32_t nxt = next_corner(corner_id), prv = prev_corner(corner_id);
    int32_t nv = view_vertex[nxt], pv = view_vertex[prv];
    if (!vert_visited[nv]) visit_vertex(nv, nxt);
    if (!vert_visited[pv]) visit_vertex(pv, prv);

    while (!stack.empty()) {
      corner_id = stack.back();
      int32_t face_id = corner_id == INVALID ? INVALID : corner_id / 3;
      if (face_done(face_id)) {
        stack.pop_back();
        continue;
      }
      while (true) {
        face_visited[face_id] = 1;
        int32_t vert_id = view_vertex[corner_id];
        if (!vert_visited[vert_id]) {
          bool on_boundary = is_on_boundary(corner_id);
          visit_vertex(vert_id, corner_id);
          if (!on_boundary) {
            corner_id = right_corner(corner_id);
            face_id = corner_id == INVALID ? INVALID : corner_id / 3;
            continue;
          }
        }
        int32_t rc = right_corner(corner_id);
        int32_t lc = left_corner(corner_id);
        int32_t rf = rc == INVALID ? INVALID : rc / 3;
        int32_t lf = lc == INVALID ? INVALID : lc / 3;
        if (face_done(rf)) {
          if (face_done(lf)) {
            stack.pop_back();
            break;
          }
          corner_id = lc;
          face_id = lf;
        } else {
          if (face_done(lf)) {
            corner_id = rc;
            face_id = rf;
          } else {
            stack.back() = lc;
            stack.push_back(rc);
            break;
          }
        }
      }
    }
  }
  *out_num_values = n_values;
  return 0;
}

// ---------------------------------------------------------------------------
// Wrap transform + parallelogram prediction (attributes.py)
// ---------------------------------------------------------------------------

namespace {
inline void wrap_original(const int64_t* pred, const int64_t* corr, int nc,
                          int64_t mn, int64_t mx, int64_t dif, int64_t* out) {
  for (int k = 0; k < nc; ++k) {
    int64_t p = pred[k];
    if (p < mn) p = mn;
    if (p > mx) p = mx;
    int64_t o = p + corr[k];
    if (o > mx) o -= dif;
    else if (o < mn) o += dif;
    out[k] = o;
  }
}
}  // namespace

int uvt_decode_parallelogram(const int64_t* corr, int64_t n, int nc,
                             int64_t mn, int64_t mx,
                             const int32_t* opposite, const int32_t* view_vertex,
                             const uint8_t* seam_mask /*nullable*/,
                             const int32_t* vertex_to_data,
                             const int32_t* data_to_corner, int64_t* out) {
  const int64_t dif = 1 + mx - mn;
  int64_t zero[8] = {0};
  if (nc > 8) return -1;
  wrap_original(zero, corr, nc, mn, mx, dif, out);
  auto opp = [&](int32_t c) -> int32_t {
    if (c == INVALID) return INVALID;
    if (seam_mask && seam_mask[c]) return INVALID;
    return opposite[c];
  };
  int64_t pred[8];
  for (int64_t p = 1; p < n; ++p) {
    int32_t ci = data_to_corner[p];
    int32_t oci = opp(ci);
    bool have = false;
    if (oci != INVALID) {
      int64_t vo = vertex_to_data[view_vertex[oci]];
      int64_t vn = vertex_to_data[view_vertex[next_corner(oci)]];
      int64_t vp = vertex_to_data[view_vertex[prev_corner(oci)]];
      if (vo >= 0 && vo < p && vn >= 0 && vn < p && vp >= 0 && vp < p) {
        for (int k = 0; k < nc; ++k)
          pred[k] = out[vn * nc + k] + out[vp * nc + k] - out[vo * nc + k];
        have = true;
      }
    }
    if (!have)
      for (int k = 0; k < nc; ++k) pred[k] = out[(p - 1) * nc + k];
    wrap_original(pred, corr + p * nc, nc, mn, mx, dif, out + p * nc);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Portable tex-coords predictor (attributes.py TexCoordsPortablePredictor)
// corr are POSITIVE modular corrections. positions: int64 [n_pos_values, 3];
// pos_data_of_corner maps a corner to its position data index.
// orientations consumed from the END of the array (Python list.pop()).
// ---------------------------------------------------------------------------

namespace {
typedef __int128 i128;
typedef unsigned __int128 u128;

inline int64_t tdiv64(i128 a, i128 b) {
  // C++ integer division already truncates toward zero
  return (int64_t)(a / b);
}

// exact division by a per-vertex invariant divisor: one hardware divide
// builds M = floor((2^64-1)/p); then q_est = (x*M)>>64 <= x/p with a
// <=2-step fixup (error < x/2^64 * 2 for the magnitudes used here).
// rdivs truncates toward zero exactly like C++ '/'.
inline uint64_t rdivu64(uint64_t x, uint64_t p, uint64_t m) {
  uint64_t q = (uint64_t)(((u128)x * m) >> 64);
  uint64_t r = x - q * p;
  while (r >= p) { q++; r -= p; }
  return q;
}
inline int64_t rdivs64(int64_t x, int64_t p, uint64_t m) {
  return x >= 0 ? (int64_t)rdivu64((uint64_t)x, (uint64_t)p, m)
                : -(int64_t)rdivu64((uint64_t)(-x), (uint64_t)p, m);
}

inline uint64_t isqrt64(uint64_t x) {
  // exact floor sqrt for x < 2^62: double estimate + integer correction
  uint64_t s = (uint64_t)sqrt((double)x);
  while (s > 0 && s * s > x) s--;
  while ((s + 1) * (s + 1) <= x) s++;
  return s;
}

inline u128 isqrt128(u128 x) {
  // exact floor sqrt (matches Python math.isqrt): long-double estimate,
  // then integer correction — ~10x the digit-by-digit loop this replaces
  if (x == 0) return 0;
  const u128 U64MAX = (u128)0xFFFFFFFFFFFFFFFFull;
  long double xf =
      (long double)(uint64_t)(x >> 64) * 18446744073709551616.0L +
      (long double)(uint64_t)x;
  long double sf = sqrtl(xf);
  u128 s = sf >= 18446744073709551615.0L
               ? U64MAX
               : (u128)(unsigned long long)sf;
  // the estimate is within a few ulps; correct to exact floor
  while (s > 0 && s * s > x) s--;
  while (s < U64MAX && (s + 1) * (s + 1) <= x) s++;
  return s;
}
}  // namespace

int uvt_texcoords_predict(
    const int64_t* corr,  // [n, 2] positive modular
    int64_t n, int64_t mn, int64_t mx,
    const int32_t* view_vertex, const int32_t* vertex_to_data,
    const int32_t* data_to_corner,
    const int64_t* positions,  // [n_pos, 3] portable ints
    const int32_t* pos_data_of_corner,  // corner -> position data index
    const uint8_t* orientations, int64_t n_orients,
    int64_t* out  // [n, 2]
) {
  const int64_t dif = 1 + mx - mn;
  int64_t oi = n_orients;  // consume from the end
  auto posv = [&](int32_t c, int k) -> int64_t {
    return positions[(int64_t)pos_data_of_corner[c] * 3 + k];
  };
  for (int64_t p = 0; p < n; ++p) {
    int32_t ci = data_to_corner[p];
    int32_t nc_ = next_corner(ci), pc_ = prev_corner(ci);
    int64_t next_id = vertex_to_data[view_vertex[nc_]];
    int64_t prev_id = vertex_to_data[view_vertex[pc_]];
    int64_t pred[2];
    bool done = false;
    if (prev_id >= 0 && prev_id < p && next_id >= 0 && next_id < p) {
      const int64_t* n_uv = out + next_id * 2;
      const int64_t* p_uv = out + prev_id * 2;
      if (p_uv[0] == n_uv[0] && p_uv[1] == n_uv[1]) {
        pred[0] = p_uv[0];
        pred[1] = p_uv[1];
        done = true;
      } else {
        int64_t pn[3], cn[3];
        int64_t amax = 0;
        for (int k = 0; k < 3; ++k) {
          pn[k] = posv(pc_, k) - posv(nc_, k);
          cn[k] = posv(ci, k) - posv(nc_, k);
          int64_t a = pn[k] < 0 ? -pn[k] : pn[k];
          int64_t b2 = cn[k] < 0 ? -cn[k] : cn[k];
          if (a > amax) amax = a;
          if (b2 > amax) amax = b2;
        }
        int64_t pn_uv[2] = {p_uv[0] - n_uv[0], p_uv[1] - n_uv[1]};
        int64_t umax = 0;
        for (int64_t u : {n_uv[0], n_uv[1], pn_uv[0], pn_uv[1]}) {
          int64_t a = u < 0 ? -u : u;
          if (a > umax) umax = a;
        }
        if (pn[0] != 0 || pn[1] != 0 || pn[2] != 0) {
          int orientation = 1;
          if (oi > 0) {
            oi -= 1;
            orientation = orientations[oi];
          }
          int64_t sgn = orientation ? 1 : -1;
          if (amax < 16384 && umax < 16384) {
            // int64 fast path (qp/qt <= 13-bit content, e.g. qp11/qt10):
            // worst-case magnitudes — pn_norm2 < 2^30, cn_dot_pn < 2^30,
            // x_uv < 2^45, cx_norm2 < 2^32, prod < 2^62, norm_sq*perp
            // < 2^45 — all exact in int64; C++ '/' truncates toward zero
            // exactly like tdiv64, so results are bit-identical to the
            // i128 reference path below (~3x faster per value: the i128
            // multiplies and __divti3 calls dominated this loop)
            int64_t pn_norm2 =
                pn[0] * pn[0] + pn[1] * pn[1] + pn[2] * pn[2];
            // all 5 divisions share this vertex's divisor: one hardware
            // div builds the reciprocal, each use is a mul + fixup
            const uint64_t rm = ~0ull / (uint64_t)pn_norm2;
            int64_t cn_dot_pn =
                pn[0] * cn[0] + pn[1] * cn[1] + pn[2] * cn[2];
            int64_t x_uv0 = n_uv[0] * pn_norm2 + cn_dot_pn * pn_uv[0];
            int64_t x_uv1 = n_uv[1] * pn_norm2 + cn_dot_pn * pn_uv[1];
            int64_t cx_norm2 = 0;
            for (int k = 0; k < 3; ++k) {
              int64_t cx = cn[k] - rdivs64(cn_dot_pn * pn[k], pn_norm2, rm);
              cx_norm2 += cx * cx;
            }
            int64_t norm_sq =
                (int64_t)isqrt64((uint64_t)cx_norm2 * (uint64_t)pn_norm2);
            pred[0] = rdivs64(x_uv0 + sgn * pn_uv[1] * norm_sq, pn_norm2, rm);
            pred[1] = rdivs64(x_uv1 - sgn * pn_uv[0] * norm_sq, pn_norm2, rm);
          } else {
            i128 pn_norm2 = 0, cn_dot_pn = 0;
            for (int k = 0; k < 3; ++k) {
              pn_norm2 += (i128)pn[k] * pn[k];
              cn_dot_pn += (i128)pn[k] * cn[k];
            }
            i128 x_uv[2] = {
                (i128)n_uv[0] * pn_norm2 + cn_dot_pn * pn_uv[0],
                (i128)n_uv[1] * pn_norm2 + cn_dot_pn * pn_uv[1],
            };
            i128 cx_norm2 = 0;
            for (int k = 0; k < 3; ++k) {
              int64_t x_pos =
                  posv(nc_, k) + tdiv64(cn_dot_pn * pn[k], pn_norm2);
              int64_t cx = posv(ci, k) - x_pos;
              cx_norm2 += (i128)cx * cx;
            }
            u128 prod = (u128)cx_norm2 * (u128)pn_norm2;
            i128 norm_sq = (i128)isqrt128(prod);
            pred[0] =
                tdiv64(x_uv[0] + sgn * (i128)pn_uv[1] * norm_sq, pn_norm2);
            pred[1] =
                tdiv64(x_uv[1] - sgn * (i128)pn_uv[0] * norm_sq, pn_norm2);
          }
          done = true;
        }
      }
    }
    if (!done) {
      if (prev_id >= 0 && prev_id < p) {
        pred[0] = out[prev_id * 2];
        pred[1] = out[prev_id * 2 + 1];
      } else if (next_id >= 0 && next_id < p) {
        pred[0] = out[next_id * 2];
        pred[1] = out[next_id * 2 + 1];
      } else if (p > 0) {
        pred[0] = out[(p - 1) * 2];
        pred[1] = out[(p - 1) * 2 + 1];
      } else {
        pred[0] = 0;
        pred[1] = 0;
      }
    }
    wrap_original(pred, corr + p * 2, 2, mn, mx, dif, out + p * 2);
  }
  return oi == 0 ? 0 : -1;  // all orientations must be consumed
}

// ---------------------------------------------------------------------------
// Geometric normal predictor (attributes.py GeometricNormalPredictor +
// OctahedronCanonicalizedTransform). corr are positive mod max_quantized.
// ---------------------------------------------------------------------------

namespace {
struct OctTool {
  int64_t max_quantized_value;
  int64_t max_value;
  int64_t center_value;

  int64_t mod_max(int64_t x) const {
    if (x > center_value) return x - max_quantized_value;
    if (x < -center_value) return x + max_quantized_value;
    return x;
  }
  bool in_diamond(int64_t s, int64_t t) const {
    int64_t as = s < 0 ? -s : s, at = t < 0 ? -t : t;
    return as + at <= center_value;
  }
  void invert_diamond(int64_t* s, int64_t* t) const {
    int64_t sign_s, sign_t;
    if (*s >= 0 && *t >= 0) {
      sign_s = 1; sign_t = 1;
    } else if (*s <= 0 && *t <= 0) {
      sign_s = -1; sign_t = -1;
    } else {
      sign_s = *s > 0 ? 1 : -1;
      sign_t = *t > 0 ? 1 : -1;
    }
    int64_t cs = sign_s * center_value, ct = sign_t * center_value;
    int64_t ns = 2 * *s - cs, nt = 2 * *t - ct;
    if (sign_s * sign_t >= 0) {
      int64_t tmp = ns;
      ns = -nt;
      nt = -tmp;
    } else {
      int64_t tmp = ns;
      ns = nt;
      nt = tmp;
    }
    // Python floor-div by 2 (operands may be negative)
    auto fdiv2 = [](int64_t v) { return v >= 0 ? v / 2 : (v - 1) / 2; };
    *s = fdiv2(ns + cs);
    *t = fdiv2(nt + ct);
  }
  static bool in_bottom_left(int64_t s, int64_t t) {
    if (s == 0 && t == 0) return true;
    return s < 0 && t <= 0;
  }
  static int rotation_count(int64_t s, int64_t t) {
    if (s == 0) return t == 0 ? 0 : (t > 0 ? 3 : 1);
    if (s > 0) return t >= 0 ? 2 : 1;
    return t <= 0 ? 0 : 3;
  }
  static void rotate(int64_t* s, int64_t* t, int rc) {
    int64_t a = *s, b = *t;
    if (rc == 1) { *s = b; *t = -a; }
    else if (rc == 2) { *s = -a; *t = -b; }
    else if (rc == 3) { *s = -b; *t = a; }
  }
  void canonicalize(int64_t* v) const {
    const int64_t max_sum = (1LL << 30) - 1;
    i128 abs_sum = 0;
    for (int k = 0; k < 3; ++k) abs_sum += v[k] < 0 ? -(i128)v[k] : (i128)v[k];
    if (abs_sum == 0) {
      v[0] = max_sum; v[1] = 0; v[2] = 0;
      return;
    }
    if (abs_sum < ((i128)1 << 32)) {
      // |v[k]| <= abs_sum < 2^32, so v[k]*max_sum < 2^62: plain int64
      // division (truncates toward zero like tdiv64) — skips three
      // __divti3 calls per vertex on typical fan-normal magnitudes
      int64_t a = (int64_t)abs_sum;
      for (int k = 0; k < 3; ++k) v[k] = v[k] * max_sum / a;
      return;
    }
    for (int k = 0; k < 3; ++k) v[k] = tdiv64((i128)v[k] * max_sum, abs_sum);
  }
  void to_quantized(const int64_t* v, int64_t* qs, int64_t* qt) const {
    i128 abs_sum = 0;
    for (int k = 0; k < 3; ++k) abs_sum += v[k] < 0 ? -(i128)v[k] : (i128)v[k];
    int64_t s, t;
    if (abs_sum == 0) {
      *qs = center_value;
      *qt = center_value;
      return;
    }
    if (v[2] >= 0) {
      s = v[0];
      t = v[1];
    } else {
      int64_t a0 = v[0] < 0 ? -v[0] : v[0];
      int64_t a1 = v[1] < 0 ? -v[1] : v[1];
      s = (v[0] >= 0 ? 1 : -1) * ((int64_t)abs_sum - a1);
      t = (v[1] >= 0 ? 1 : -1) * ((int64_t)abs_sum - a0);
    }
    // floor division (operands positive after the shift below)
    if (abs_sum < ((i128)1 << 32) && max_value < (1LL << 20)) {
      // post-canonicalize |v| < 2^30 keeps every term in int64 here
      // (s+abs_sum <= 2*abs_sum < 2^33, * max_value < 2^53); positive
      // operands make '/' the same floor division as the i128 path
      int64_t a = (int64_t)abs_sum;
      *qs = ((s + a) * max_value + a) / (2 * a);
      *qt = ((t + a) * max_value + a) / (2 * a);
      return;
    }
    i128 num_s = ((i128)s + abs_sum) * max_value + abs_sum;
    i128 num_t = ((i128)t + abs_sum) * max_value + abs_sum;
    *qs = (int64_t)(num_s / (2 * abs_sum));
    *qt = (int64_t)(num_t / (2 * abs_sum));
  }
};
}  // namespace

int uvt_normals_predict(
    const int64_t* corr,  // [n, 2] positive mod max_quantized_value
    int64_t n, int64_t max_quantized_value, int64_t center_value_wire,
    const int32_t* opposite, const int32_t* view_vertex,
    const uint8_t* seam_mask /*nullable*/,
    const int32_t* data_to_corner,
    const int64_t* positions, const int32_t* pos_data_of_corner,
    uint32_t flip_prob_zero, const uint8_t* flip_buf, int64_t flip_len,
    int64_t num_faces,  // bounds the face-normal memo (fan walks reach
                        // faces beyond the data_to_corner entries)
    const int32_t* vertex_to_data /*nullable: enables the linear-pass
        accumulation — each data value's seam-aware fan is exactly the
        corner set mapped to its view vertex, so one sequential sweep
        over corners replaces the per-vertex dependent-load walks;
        int64 adds commute, so results are bit-identical*/,
    int64_t* out  // [n, 2]
) {
  (void)center_value_wire;
  OctTool tb;
  tb.max_quantized_value = max_quantized_value;
  // q = bit_length(max_quantized_value); max_value = 2^q - 2
  int q = 0;
  while ((1LL << q) <= max_quantized_value) q++;
  tb.max_value = (1LL << q) - 2;
  tb.center_value = tb.max_value / 2;

  RabsDecoder flip;
  if (!flip.init(flip_buf, flip_len, flip_prob_zero)) return -1;

  auto opp = [&](int32_t c) -> int32_t {
    if (c == INVALID) return INVALID;
    if (seam_mask && seam_mask[c]) return INVALID;
    return opposite[c];
  };
  auto swing_right = [&](int32_t c) -> int32_t {
    int32_t o = opp(prev_corner(c));
    return o == INVALID ? INVALID : prev_corner(o);
  };
  auto swing_left = [&](int32_t c) -> int32_t {
    int32_t o = opp(next_corner(c));
    return o == INVALID ? INVALID : next_corner(o);
  };
  auto posv = [&](int32_t c, int k) -> int64_t {
    return positions[(int64_t)pos_data_of_corner[c] * 3 + k];
  };
  // the integer cross product (B-A)x(C-A) is invariant under cyclic corner
  // rotation, so each face normal is computed once and the fan walk only
  // accumulates (saves the 3x per-corner cross recompute). Exact: int64 adds.
  const int64_t nf = num_faces;
  // face_normal is gated by face_done, so it can stay uninitialized
  // (value-init memset of ~24B/face measured in the decode hot path)
  std::unique_ptr<int64_t[]> face_normal(new int64_t[(size_t)nf * 3]);
  std::vector<uint8_t> face_done(nf, 0);
  auto add_face_normal = [&](int32_t corner, int64_t* normal) {
    int64_t f = corner / 3;
    if (!face_done[f]) {
      int64_t c0[3], d1[3], d2[3];
      int32_t base = (int32_t)(3 * f);
      int32_t nn = next_corner(base), pp = prev_corner(base);
      for (int k = 0; k < 3; ++k) {
        c0[k] = posv(base, k);
        d1[k] = posv(nn, k) - c0[k];
        d2[k] = posv(pp, k) - c0[k];
      }
      face_normal[f * 3] = d1[1] * d2[2] - d1[2] * d2[1];
      face_normal[f * 3 + 1] = d1[2] * d2[0] - d1[0] * d2[2];
      face_normal[f * 3 + 2] = d1[0] * d2[1] - d1[1] * d2[0];
      face_done[f] = 1;
    }
    normal[0] += face_normal[f * 3];
    normal[1] += face_normal[f * 3 + 1];
    normal[2] += face_normal[f * 3 + 2];
  };

  std::unique_ptr<int64_t[]> accum;
  if (vertex_to_data) {
    // linear-pass accumulation: a data value's seam-aware fan is the
    // exact corner set the attribute corner table mapped to its view
    // vertex, so per-corner scatter-adds of memoized face normals give
    // the same integer sums as the dependent-load ring walks
    const int64_t nc3 = 3 * num_faces;
    for (int64_t f = 0; f < num_faces; ++f) {
      int64_t c0[3], d1[3], d2[3];
      int32_t base = (int32_t)(3 * f);
      int32_t nn = next_corner(base), pp = prev_corner(base);
      // hostile streams can leave corners with no position data (-1);
      // such faces are unreachable from valid data corners — zero them
      if (pos_data_of_corner[base] < 0 || pos_data_of_corner[nn] < 0 ||
          pos_data_of_corner[pp] < 0) {
        face_normal[f * 3] = face_normal[f * 3 + 1] =
            face_normal[f * 3 + 2] = 0;
        continue;
      }
      for (int k = 0; k < 3; ++k) {
        c0[k] = posv(base, k);
        d1[k] = posv(nn, k) - c0[k];
        d2[k] = posv(pp, k) - c0[k];
      }
      face_normal[f * 3] = d1[1] * d2[2] - d1[2] * d2[1];
      face_normal[f * 3 + 1] = d1[2] * d2[0] - d1[0] * d2[2];
      face_normal[f * 3 + 2] = d1[0] * d2[1] - d1[1] * d2[0];
    }
    accum.reset(new int64_t[(size_t)n * 3]());
    for (int64_t c = 0; c < nc3; ++c) {
      int32_t v = view_vertex[c];
      if (v < 0) continue;
      int32_t p = vertex_to_data[v];
      if (p < 0 || (int64_t)p >= n) continue;
      const int64_t* fnp = &face_normal[(c / 3) * 3];
      int64_t* ap = &accum[(size_t)p * 3];
      ap[0] += fnp[0];
      ap[1] += fnp[1];
      ap[2] += fnp[2];
    }
  }

  for (int64_t p = 0; p < n; ++p) {
    int64_t normal[3] = {0, 0, 0};
    if (vertex_to_data) {
      normal[0] = accum[(size_t)p * 3];
      normal[1] = accum[(size_t)p * 3 + 1];
      normal[2] = accum[(size_t)p * 3 + 2];
    } else {
      int32_t ci = data_to_corner[p];
      int32_t start = ci, c = ci;
      bool wrapped = false;
      while (c != INVALID) {
        add_face_normal(c, normal);
        c = swing_right(c);
        if (c == start) {
          wrapped = true;
          break;
        }
      }
      if (!wrapped) {
        c = swing_left(start);
        while (c != INVALID && c != start) {
          add_face_normal(c, normal);
          c = swing_left(c);
        }
      }
    }
    tb.canonicalize(normal);
    if (flip.decode_bit()) {
      normal[0] = -normal[0];
      normal[1] = -normal[1];
      normal[2] = -normal[2];
    }
    int64_t ps, pt;
    tb.to_quantized(normal, &ps, &pt);
    // compute_original (OctahedronCanonicalizedTransform)
    int64_t cv = tb.center_value;
    int64_t s = ps - cv, t = pt - cv;
    bool ind = tb.in_diamond(s, t);
    if (!ind) tb.invert_diamond(&s, &t);
    bool ibl = OctTool::in_bottom_left(s, t);
    int rot = OctTool::rotation_count(s, t);
    if (!ibl) OctTool::rotate(&s, &t, rot);
    int64_t os = tb.mod_max(s + corr[p * 2]);
    int64_t ot = tb.mod_max(t + corr[p * 2 + 1]);
    if (!ibl) OctTool::rotate(&os, &ot, (4 - rot) % 4);
    if (!ind) tb.invert_diamond(&os, &ot);
    out[p * 2] = os + cv;
    out[p * 2 + 1] = ot + cv;
  }
  return 0;
}

}  // extern "C"

// ===========================================================================
// Encode-side counterparts (codecs/draco/encoder.py hot loops)
// ===========================================================================

extern "C" {

// half-edge corner-table build (encoder.py EncoderCornerTable.__init__):
// faces [F,3] position ids → opposite[3F], fan-vertex ids per corner,
// leftmost corner per fan vertex. Returns num fan vertices, or <0 on error.
int64_t uvt_encoder_corner_table(
    const int64_t* faces, int64_t num_faces, int64_t num_positions,
    int32_t* opposite,        // [3F]
    int32_t* corner_vertex,   // [3F] fan vertex id per corner
    int32_t* vertex_corner    // [3F] cap; leftmost corner per fan vertex
) {
  const int64_t n = 3 * num_faces;
  for (int64_t i = 0; i < n; ++i) opposite[i] = INVALID;
  for (int64_t i = 0; i < n; ++i) corner_vertex[i] = INVALID;

  // bucket half-edges by their LOW endpoint with a counting sort (the
  // corto buildTopology shape) — O(n) instead of the round-1 O(n log n)
  // comparator sort, ~4x faster on liam-scale frames. Within a bucket
  // (vertex degree ~6) an insertion sort by (hi, corner) orders the
  // edges; fwd/bwd pairing then matches k-th with k-th in ascending
  // corner order (deterministic; manifold edges pair identically to the
  // sorted version since each key holds at most one of each direction).
  // int32 working copies: the sort passes are memory-bound on this
  // class of host, and corner/position ids always fit in 31 bits
  if (num_positions > INT32_MAX || n > INT32_MAX) return -1;
  std::vector<int32_t> f32((size_t)n);
  for (int64_t c = 0; c < n; ++c) f32[c] = (int32_t)faces[c];
  auto pos_of = [&](int64_t c) { return f32[c]; };
  std::vector<int32_t> lo_of(n), hi_of(n);
  std::vector<int32_t> bstart(num_positions + 1, 0);
  for (int64_t c = 0; c < n; ++c) {
    int32_t a = pos_of(next_corner((int32_t)c));
    int32_t b = pos_of(prev_corner((int32_t)c));
    int32_t lo = a < b ? a : b, hi = a < b ? b : a;
    lo_of[c] = lo;
    hi_of[c] = hi;
    bstart[lo + 1]++;
  }
  for (int64_t v = 0; v < num_positions; ++v) bstart[v + 1] += bstart[v];
  std::vector<int32_t> bucket(n);
  {
    std::vector<int32_t> cur(bstart.begin(), bstart.end() - 1);
    for (int64_t c = 0; c < n; ++c) bucket[cur[lo_of[c]]++] = (int32_t)c;
  }
  std::vector<int32_t> fwd, bwd;
  for (int64_t v = 0; v < num_positions; ++v) {
    int32_t s = bstart[v], e = bstart[v + 1];
    if (e - s < 2) continue;
    // insertion sort by (hi, corner): buckets are tiny (vertex degree)
    for (int32_t i2 = s + 1; i2 < e; ++i2) {
      int32_t c = bucket[i2];
      int64_t h = hi_of[c];
      int32_t j2 = i2 - 1;
      while (j2 >= s &&
             (hi_of[bucket[j2]] > h ||
              (hi_of[bucket[j2]] == h && bucket[j2] > c))) {
        bucket[j2 + 1] = bucket[j2];
        --j2;
      }
      bucket[j2 + 1] = c;
    }
    int32_t i3 = s;
    while (i3 < e) {
      int32_t j3 = i3;
      fwd.clear();
      bwd.clear();
      while (j3 < e && hi_of[bucket[j3]] == hi_of[bucket[i3]]) {
        int32_t c = bucket[j3];
        if (pos_of(next_corner(c)) == lo_of[c]) fwd.push_back(c);
        else bwd.push_back(c);
        ++j3;
      }
      size_t m = fwd.size() < bwd.size() ? fwd.size() : bwd.size();
      for (size_t k = 0; k < m; ++k) {
        opposite[fwd[k]] = bwd[k];
        opposite[bwd[k]] = fwd[k];
      }
      i3 = j3;
    }
  }

  // fan-based vertex ids: group corners of one position into swing fans
  Table t{opposite, corner_vertex /*unused in swings*/, vertex_corner};
  auto swing_left = [&](int32_t c) -> int32_t {
    int32_t o = opposite[next_corner(c)];
    return o == INVALID ? INVALID : next_corner(o);
  };
  auto swing_right = [&](int32_t c) -> int32_t {
    int32_t o = opposite[prev_corner(c)];
    return o == INVALID ? INVALID : prev_corner(o);
  };
  int64_t num_vertices = 0;
  for (int64_t c0 = 0; c0 < n; ++c0) {
    if (corner_vertex[c0] != INVALID) continue;
    // sweep left to the fan start (or detect a closed fan)
    int32_t start = (int32_t)c0, cur = (int32_t)c0;
    int64_t steps = 0;
    while (true) {
      int32_t nxt = swing_left(cur);
      if (nxt == INVALID || nxt == start) break;
      cur = nxt;
      if (++steps > n) return -1;  // non-manifold cycle
    }
    int32_t first = (swing_left(cur) == INVALID) ? cur : start;
    int32_t vid = (int32_t)num_vertices++;
    vertex_corner[vid] = first;
    int32_t c = first;
    while (c != INVALID && corner_vertex[c] == INVALID) {
      corner_vertex[c] = vid;
      c = swing_right(c);
    }
  }
  return num_vertices;
}

// wrap-transform signed correction (encoder.py WrapEncoder.correction)
static inline int64_t wrap_correction(int64_t orig, int64_t pred, int64_t mn,
                                      int64_t mx, int64_t dif, int64_t min_c,
                                      int64_t max_c) {
  if (pred < mn) pred = mn;
  if (pred > mx) pred = mx;
  int64_t corr = orig - pred;
  if (corr < min_c) corr += dif;
  else if (corr > max_c) corr -= dif;
  return corr;
}

// parallelogram ENCODE (encoder.py _encode_parallelogram)
int uvt_parallelogram_encode(
    const int64_t* values, int64_t n, int nc, int64_t mn, int64_t mx,
    const int32_t* opposite, const int32_t* view_vertex,
    const uint8_t* seam_mask /*nullable*/,
    const int32_t* vertex_to_data, const int32_t* data_to_corner,
    int64_t* corr_out) {
  const int64_t dif = 1 + mx - mn;
  int64_t max_c = dif / 2;
  if ((dif % 2) == 0) max_c -= 1;
  const int64_t min_c = -(dif / 2);
  auto opp = [&](int32_t c) -> int32_t {
    if (c == INVALID) return INVALID;
    if (seam_mask && seam_mask[c]) return INVALID;
    return opposite[c];
  };
  for (int k = 0; k < nc; ++k)
    corr_out[k] = wrap_correction(values[k], 0, mn, mx, dif, min_c, max_c);
  int64_t pred[8];
  for (int64_t p = 1; p < n; ++p) {
    int32_t ci = data_to_corner[p];
    int32_t oci = opp(ci);
    bool have = false;
    if (oci != INVALID) {
      int64_t vo = vertex_to_data[view_vertex[oci]];
      int64_t vn = vertex_to_data[view_vertex[next_corner(oci)]];
      int64_t vp = vertex_to_data[view_vertex[prev_corner(oci)]];
      if (vo >= 0 && vo < p && vn >= 0 && vn < p && vp >= 0 && vp < p) {
        for (int k = 0; k < nc; ++k)
          pred[k] = values[vn * nc + k] + values[vp * nc + k] -
                    values[vo * nc + k];
        have = true;
      }
    }
    if (!have)
      for (int k = 0; k < nc; ++k) pred[k] = values[(p - 1) * nc + k];
    for (int k = 0; k < nc; ++k)
      corr_out[p * nc + k] = wrap_correction(values[p * nc + k], pred[k], mn,
                                             mx, dif, min_c, max_c);
  }
  return 0;
}

// tex-coords portable ENCODE (encoder.py _TexCoordsPortableEncoder):
// positive modular corrections + orientation choices (1 byte per geometric
// prediction, in prediction order). Returns number of orientations.
int64_t uvt_texcoords_encode(
    const int64_t* values,  // [n, 2] true UV ints (already decoded order)
    int64_t n, int64_t mn, int64_t mx,
    const int32_t* view_vertex, const int32_t* vertex_to_data,
    const int32_t* data_to_corner,
    const int64_t* positions, const int32_t* pos_data_of_corner,
    int64_t* corr_out,       // [n, 2]
    uint8_t* orientations    // [n] cap
) {
  const int64_t dif = 1 + mx - mn;
  int64_t n_orients = 0;
  auto posv = [&](int32_t c, int k) -> int64_t {
    return positions[(int64_t)pos_data_of_corner[c] * 3 + k];
  };
  auto pos_mod = [&](int64_t orig, int64_t pred) -> int64_t {
    if (pred < mn) pred = mn;
    if (pred > mx) pred = mx;
    // orig and the clamped pred are both in [mn, mx], so the difference
    // is already in (-dif, dif): the conditional add IS the mod
    int64_t c = orig - pred;
    if (c < 0) c += dif;
    return c;
  };
  for (int64_t p = 0; p < n; ++p) {
    int32_t ci = data_to_corner[p];
    int32_t nc_ = next_corner(ci), pc_ = prev_corner(ci);
    int64_t next_id = vertex_to_data[view_vertex[nc_]];
    int64_t prev_id = vertex_to_data[view_vertex[pc_]];
    int64_t pred[2];
    bool done = false;
    if (prev_id >= 0 && prev_id < p && next_id >= 0 && next_id < p) {
      const int64_t* n_uv = values + next_id * 2;
      const int64_t* p_uv = values + prev_id * 2;
      if (p_uv[0] == n_uv[0] && p_uv[1] == n_uv[1]) {
        pred[0] = p_uv[0];
        pred[1] = p_uv[1];
        done = true;
      } else {
        int64_t pn[3], cn[3];
        int64_t amax = 0;
        for (int k = 0; k < 3; ++k) {
          pn[k] = posv(pc_, k) - posv(nc_, k);
          cn[k] = posv(ci, k) - posv(nc_, k);
          int64_t a = pn[k] < 0 ? -pn[k] : pn[k];
          int64_t b2 = cn[k] < 0 ? -cn[k] : cn[k];
          if (a > amax) amax = a;
          if (b2 > amax) amax = b2;
        }
        if (pn[0] != 0 || pn[1] != 0 || pn[2] != 0) {
          int64_t pn_uv[2] = {p_uv[0] - n_uv[0], p_uv[1] - n_uv[1]};
          int64_t umax = 0;
          for (int64_t u : {n_uv[0], n_uv[1], pn_uv[0], pn_uv[1]}) {
            int64_t a = u < 0 ? -u : u;
            if (a > umax) umax = a;
          }
          int64_t pu_t, pv_t, pu_f, pv_f;
          if (amax < 16384 && umax < 16384) {
            // int64 fast path — same magnitude analysis as the decode-side
            // fast path in uvt_texcoords_predict (qp/qt <= 13-bit content);
            // C++ '/' truncates toward zero exactly like tdiv64, so both
            // orientation predictions are bit-identical to the i128 path
            int64_t pn_norm2 =
                pn[0] * pn[0] + pn[1] * pn[1] + pn[2] * pn[2];
            // 7 divisions share this vertex's divisor: one hardware div
            // builds the reciprocal, each use is a mul + fixup
            const uint64_t rm = ~0ull / (uint64_t)pn_norm2;
            int64_t cn_dot_pn =
                pn[0] * cn[0] + pn[1] * cn[1] + pn[2] * cn[2];
            int64_t x_uv0 = n_uv[0] * pn_norm2 + cn_dot_pn * pn_uv[0];
            int64_t x_uv1 = n_uv[1] * pn_norm2 + cn_dot_pn * pn_uv[1];
            int64_t cx_norm2 = 0;
            for (int k = 0; k < 3; ++k) {
              int64_t cx = cn[k] - rdivs64(cn_dot_pn * pn[k], pn_norm2, rm);
              cx_norm2 += cx * cx;
            }
            int64_t norm_sq =
                (int64_t)isqrt64((uint64_t)cx_norm2 * (uint64_t)pn_norm2);
            pu_t = rdivs64(x_uv0 + pn_uv[1] * norm_sq, pn_norm2, rm);
            pv_t = rdivs64(x_uv1 - pn_uv[0] * norm_sq, pn_norm2, rm);
            pu_f = rdivs64(x_uv0 - pn_uv[1] * norm_sq, pn_norm2, rm);
            pv_f = rdivs64(x_uv1 + pn_uv[0] * norm_sq, pn_norm2, rm);
          } else {
          i128 pn_norm2 = 0, cn_dot_pn = 0;
          for (int k = 0; k < 3; ++k) {
            pn_norm2 += (i128)pn[k] * pn[k];
            cn_dot_pn += (i128)pn[k] * cn[k];
          }
          i128 x_uv[2] = {
              (i128)n_uv[0] * pn_norm2 + cn_dot_pn * pn_uv[0],
              (i128)n_uv[1] * pn_norm2 + cn_dot_pn * pn_uv[1],
          };
          i128 cx_norm2 = 0;
          for (int k = 0; k < 3; ++k) {
            int64_t x_pos = posv(nc_, k) + tdiv64(cn_dot_pn * pn[k], pn_norm2);
            int64_t cx = posv(ci, k) - x_pos;
            cx_norm2 += (i128)cx * cx;
          }
          int64_t pn_uv_perp[2] = {pn_uv[1], -pn_uv[0]};
          i128 norm_sq = (i128)isqrt128((u128)cx_norm2 * (u128)pn_norm2);
          pu_t = tdiv64(x_uv[0] + (i128)pn_uv_perp[0] * norm_sq, pn_norm2);
          pv_t = tdiv64(x_uv[1] + (i128)pn_uv_perp[1] * norm_sq, pn_norm2);
          pu_f = tdiv64(x_uv[0] - (i128)pn_uv_perp[0] * norm_sq, pn_norm2);
          pv_f = tdiv64(x_uv[1] - (i128)pn_uv_perp[1] * norm_sq, pn_norm2);
          }
          const int64_t* tv = values + p * 2;
          // corrections are coded as POSITIVE MODULAR symbols, so a small
          // NEGATIVE error is an expensive near-`dif` symbol: compare the
          // bit cost of the modular symbols, not the absolute error (ties
          // favor orientation=true, which delta-codes to ~zero bits)
          auto sym_cost = [&](int64_t pu, int64_t pv) -> int64_t {
            int64_t su = pos_mod(tv[0], pu);
            int64_t sv = pos_mod(tv[1], pv);
            int64_t c = 0;
            while (su) { su >>= 1; c++; }
            while (sv) { sv >>= 1; c++; }
            return c;
          };
          int64_t err_t = sym_cost(pu_t, pv_t);
          int64_t err_f = sym_cost(pu_f, pv_f);
          // ties go to the minus branch: it is the one draco's own encoder
          // effectively uses (its streams decode with that prediction), so
          // the orientation bit stream stays near-constant
          int orientation = err_t < err_f ? 1 : 0;
          orientations[n_orients++] = (uint8_t)orientation;
          if (orientation) {
            pred[0] = pu_t;
            pred[1] = pv_t;
          } else {
            pred[0] = pu_f;
            pred[1] = pv_f;
          }
          done = true;
        }
      }
    }
    if (!done) {
      if (prev_id >= 0 && prev_id < p) {
        pred[0] = values[prev_id * 2];
        pred[1] = values[prev_id * 2 + 1];
      } else if (next_id >= 0 && next_id < p) {
        pred[0] = values[next_id * 2];
        pred[1] = values[next_id * 2 + 1];
      } else if (p > 0) {
        pred[0] = values[(p - 1) * 2];
        pred[1] = values[(p - 1) * 2 + 1];
      } else {
        pred[0] = 0;
        pred[1] = 0;
      }
    }
    corr_out[p * 2] = pos_mod(values[p * 2], pred[0]);
    corr_out[p * 2 + 1] = pos_mod(values[p * 2 + 1], pred[1]);
  }
  return n_orients;
}

// geometric-normal ENCODE (encoder.py _GeometricNormalEncoder.encode):
// positive modular corrections + flip bits.
int uvt_normals_encode(
    const int64_t* oct_coords,  // [n, 2] target quantized oct ints
    int64_t n, int64_t max_quantized_value,
    const int32_t* opposite, const int32_t* view_vertex,
    const uint8_t* seam_mask /*nullable*/,
    const int32_t* data_to_corner,
    const int64_t* positions, const int32_t* pos_data_of_corner,
    int64_t* corr_out,  // [n, 2] positive modular
    uint8_t* flip_bits,  // [n]
    int64_t num_faces /*0: fan-walk only*/,
    const int32_t* vertex_to_data /*nullable: enables the linear-pass
        accumulation — same invariant as the decode-side predictor: a
        data value's seam-aware fan is exactly the corner set the attr
        corner table mapped to its view vertex; int64 adds commute, so
        sums are bit-identical to the walk*/
) {
  OctTool tb;
  tb.max_quantized_value = max_quantized_value;
  int q = 0;
  while ((1LL << q) <= max_quantized_value) q++;
  tb.max_value = (1LL << q) - 2;
  tb.center_value = tb.max_value / 2;

  auto opp = [&](int32_t c) -> int32_t {
    if (c == INVALID) return INVALID;
    if (seam_mask && seam_mask[c]) return INVALID;
    return opposite[c];
  };
  auto swing_right = [&](int32_t c) -> int32_t {
    int32_t o = opp(prev_corner(c));
    return o == INVALID ? INVALID : prev_corner(o);
  };
  auto swing_left = [&](int32_t c) -> int32_t {
    int32_t o = opp(next_corner(c));
    return o == INVALID ? INVALID : next_corner(o);
  };
  auto posv = [&](int32_t c, int k) -> int64_t {
    return positions[(int64_t)pos_data_of_corner[c] * 3 + k];
  };
  auto add_face_normal = [&](int32_t corner, int64_t* normal) {
    int64_t c0[3], d1[3], d2[3];
    int32_t nn = next_corner(corner), pp = prev_corner(corner);
    for (int k = 0; k < 3; ++k) {
      c0[k] = posv(corner, k);
      d1[k] = posv(nn, k) - c0[k];
      d2[k] = posv(pp, k) - c0[k];
    }
    normal[0] += d1[1] * d2[2] - d1[2] * d2[1];
    normal[1] += d1[2] * d2[0] - d1[0] * d2[2];
    normal[2] += d1[0] * d2[1] - d1[1] * d2[0];
  };
  auto correction = [&](int64_t ps, int64_t pt, int64_t os_, int64_t ot_,
                        int64_t* cs, int64_t* ct) {
    int64_t cv = tb.center_value;
    int64_t s = ps - cv, t = pt - cv;
    bool ind = tb.in_diamond(s, t);
    if (!ind) tb.invert_diamond(&s, &t);
    bool ibl = OctTool::in_bottom_left(s, t);
    int rot = OctTool::rotation_count(s, t);
    if (!ibl) OctTool::rotate(&s, &t, rot);
    int64_t o_s = os_ - cv, o_t = ot_ - cv;
    if (!ind) tb.invert_diamond(&o_s, &o_t);
    if (!ibl) OctTool::rotate(&o_s, &o_t, rot);
    *cs = tb.mod_max(o_s - s);
    *ct = tb.mod_max(o_t - t);
  };

  std::unique_ptr<int64_t[]> accum;
  if (vertex_to_data && num_faces > 0) {
    // linear pass: memoize each face normal once, scatter-add into the
    // data value its view vertex maps to (mirrors uvt_normals_predict)
    std::unique_ptr<int64_t[]> face_normal(new int64_t[(size_t)num_faces * 3]);
    for (int64_t f = 0; f < num_faces; ++f) {
      int32_t base = (int32_t)(3 * f);
      int32_t nn = next_corner(base), pp = prev_corner(base);
      if (pos_data_of_corner[base] < 0 || pos_data_of_corner[nn] < 0 ||
          pos_data_of_corner[pp] < 0) {
        face_normal[f * 3] = face_normal[f * 3 + 1] =
            face_normal[f * 3 + 2] = 0;
        continue;
      }
      int64_t c0[3], d1[3], d2[3];
      for (int k = 0; k < 3; ++k) {
        c0[k] = posv(base, k);
        d1[k] = posv(nn, k) - c0[k];
        d2[k] = posv(pp, k) - c0[k];
      }
      face_normal[f * 3] = d1[1] * d2[2] - d1[2] * d2[1];
      face_normal[f * 3 + 1] = d1[2] * d2[0] - d1[0] * d2[2];
      face_normal[f * 3 + 2] = d1[0] * d2[1] - d1[1] * d2[0];
    }
    accum.reset(new int64_t[(size_t)n * 3]());
    const int64_t nc3 = 3 * num_faces;
    for (int64_t c = 0; c < nc3; ++c) {
      int32_t v = view_vertex[c];
      if (v < 0) continue;
      int32_t p = vertex_to_data[v];
      if (p < 0 || (int64_t)p >= n) continue;
      const int64_t* fnp = &face_normal[(c / 3) * 3];
      int64_t* ap = &accum[(size_t)p * 3];
      ap[0] += fnp[0];
      ap[1] += fnp[1];
      ap[2] += fnp[2];
    }
  }

  for (int64_t p = 0; p < n; ++p) {
    int64_t normal[3] = {0, 0, 0};
    if (accum) {
      normal[0] = accum[(size_t)p * 3];
      normal[1] = accum[(size_t)p * 3 + 1];
      normal[2] = accum[(size_t)p * 3 + 2];
    } else {
      int32_t ci = data_to_corner[p];
      int32_t start = ci, c = ci;
      bool wrapped = false;
      while (c != INVALID) {
        add_face_normal(c, normal);
        c = swing_right(c);
        if (c == start) {
          wrapped = true;
          break;
        }
      }
      if (!wrapped) {
        c = swing_left(start);
        while (c != INVALID && c != start) {
          add_face_normal(c, normal);
          c = swing_left(c);
        }
      }
    }
    tb.canonicalize(normal);
    int64_t ps, pt, fs, ft;
    tb.to_quantized(normal, &ps, &pt);
    int64_t neg[3] = {-normal[0], -normal[1], -normal[2]};
    tb.to_quantized(neg, &fs, &ft);
    int64_t os_ = oct_coords[p * 2], ot_ = oct_coords[p * 2 + 1];
    int64_t c0, c1, f0, f1;
    correction(ps, pt, os_, ot_, &c0, &c1);
    correction(fs, ft, os_, ot_, &f0, &f1);
    auto mag = [](int64_t a, int64_t b) {
      return (a < 0 ? -a : a) + (b < 0 ? -b : b);
    };
    int flip = mag(f0, f1) < mag(c0, c1) ? 1 : 0;
    flip_bits[p] = (uint8_t)flip;
    int64_t cs = flip ? f0 : c0, ct = flip ? f1 : c1;
    // mod_max outputs are already in (-m, m): conditional add IS the mod
    const int64_t m = max_quantized_value;
    if (cs < 0) cs += m;
    if (ct < 0) ct += m;
    corr_out[p * 2] = cs;
    corr_out[p * 2 + 1] = ct;
  }
  return 0;
}

// float normals [n,3] -> quantized octahedral ints (encoder.quantize_normals)
int uvt_quantize_normals(const double* normals, int64_t n, int bits,
                         int64_t* out_st) {
  OctTool tb;
  tb.max_quantized_value = (1LL << bits) - 1;
  tb.max_value = (1LL << bits) - 2;
  tb.center_value = tb.max_value / 2;
  const double scale = (double)(1LL << 29);
  for (int64_t i = 0; i < n; ++i) {
    int64_t v[3];
    for (int k = 0; k < 3; ++k) {
      double x = normals[i * 3 + k] * scale;
      v[k] = (int64_t)(x >= 0 ? x + 0.5 : x - 0.5);
    }
    tb.canonicalize(v);
    int64_t s, t;
    tb.to_quantized(v, &s, &t);
    out_st[i * 2] = s;
    out_st[i * 2 + 1] = t;
  }
  return 0;
}

}  // extern "C"

// ===========================================================================
// Replay machine (encoder side): same spirale-reversi body, but symbols come
// from an array (decode order) and the valence context used for each step is
// RECORDED (what the encoder must know to bucket symbols), start-face bits
// come from a scripted array. Outputs the decoder-side corner table.
// ===========================================================================

extern "C" {

int uvt_eb_replay_machine(
    const uint8_t* symbols_decode_order,  // topology values (0,1,3,5,7)
    int64_t num_symbols, int64_t num_faces, int64_t max_vertices,
    const int64_t* split_source, const int64_t* split_id,
    const uint8_t* split_edge, int64_t num_splits,
    const uint8_t* sf_bits, int64_t n_sf_bits,
    int32_t* opposite, int32_t* vertex, int32_t* vertex_corner,
    int32_t* processed_corners,
    int32_t* out_contexts,  // [num_symbols] context consumed per step (-1 first)
    int64_t* out_counts     // [4]
) {
  const int64_t n_corners = 3 * num_faces;
  for (int64_t i = 0; i < n_corners; ++i) opposite[i] = INVALID;
  for (int64_t i = 0; i < n_corners; ++i) vertex[i] = INVALID;
  for (int64_t i = 0; i < max_vertices; ++i) vertex_corner[i] = INVALID;

  std::vector<int64_t> valences(max_vertices, 0);
  std::vector<int32_t> stack;
  std::vector<int32_t> split_corner_of;
  std::vector<int64_t> split_key;
  int64_t num_vertices = 0;
  int active_context = -1;
  int64_t n_processed = 0;

  auto find_split = [&](int64_t key) -> int32_t {
    for (size_t i = 0; i < split_key.size(); ++i)
      if (split_key[i] == key) {
        int32_t c = split_corner_of[i];
        split_key[i] = -1;
        return c;
      }
    return INVALID;
  };
  auto set_opp = [&](int32_t a, int32_t b) {
    opposite[a] = b;
    opposite[b] = a;
  };

  for (int64_t symbol_id = 0; symbol_id < num_symbols; ++symbol_id) {
    int symbol = symbols_decode_order[symbol_id];
    out_contexts[symbol_id] = active_context;
    if (active_context == -1 && symbol != 7) return -20;
    int32_t corner = (int32_t)(3 * symbol_id);
    processed_corners[n_processed++] = corner;
    bool check_split = false;

    if (symbol == 0) {
      if (stack.empty()) return -3;
      int32_t corner_a = stack.back();
      int32_t vertex_x = vertex[next_corner(corner_a)];
      int32_t corner_b = next_corner(vertex_corner[vertex_x]);
      if (corner_a == corner_b) return -4;
      int32_t vert_b_next = vertex[next_corner(corner_b)];
      int32_t vert_a_prev = vertex[prev_corner(corner_a)];
      set_opp(corner_a, corner + 1);
      set_opp(corner_b, corner + 2);
      vertex[corner] = vertex_x;
      vertex[corner + 1] = vert_b_next;
      vertex[corner + 2] = vert_a_prev;
      vertex_corner[vert_a_prev] = corner + 2;
      stack.back() = corner;
    } else if (symbol == 5 || symbol == 3) {
      if (stack.empty()) return -3;
      int32_t corner_a = stack.back();
      int32_t opp_corner, corner_l, corner_r;
      if (symbol == 5) {
        opp_corner = corner + 2; corner_l = corner + 1; corner_r = corner;
      } else {
        opp_corner = corner + 1; corner_l = corner; corner_r = corner + 2;
      }
      set_opp(corner_a, opp_corner);
      int32_t new_vert = (int32_t)num_vertices++;
      if (new_vert >= max_vertices) return -5;
      vertex[opp_corner] = new_vert;
      vertex_corner[new_vert] = opp_corner;
      int32_t vertex_r = vertex[prev_corner(corner_a)];
      vertex[corner_r] = vertex_r;
      vertex_corner[vertex_r] = corner_r;
      vertex[corner_l] = vertex[next_corner(corner_a)];
      stack.back() = corner;
      check_split = true;
    } else if (symbol == 7) {
      if (num_vertices + 3 > max_vertices) return -5;
      int32_t v0 = (int32_t)num_vertices++;
      int32_t v1 = (int32_t)num_vertices++;
      int32_t v2 = (int32_t)num_vertices++;
      vertex[corner] = v0; vertex[corner + 1] = v1; vertex[corner + 2] = v2;
      vertex_corner[v0] = corner;
      vertex_corner[v1] = corner + 1;
      vertex_corner[v2] = corner + 2;
      stack.push_back(corner);
      check_split = true;
    } else if (symbol == 1) {
      if (stack.empty()) return -3;
      int32_t corner_b = stack.back();
      stack.pop_back();
      int32_t saved = find_split(symbol_id);
      if (saved != INVALID) stack.push_back(saved);
      if (stack.empty()) return -6;
      int32_t corner_a = stack.back();
      if (opposite[corner_a] != INVALID || opposite[corner_b] != INVALID)
        return -7;
      int32_t vertex_p = vertex[prev_corner(corner_a)];
      int32_t vertex_q = vertex[next_corner(corner_b)];
      if (vertex_p == vertex_q) return -8;
      Table t{opposite, vertex, vertex_corner};
      int32_t first_q = vertex_corner[vertex_q];
      int32_t c = first_q;
      int64_t sweep_steps = 0;
      while (c != INVALID) {
        vertex[c] = vertex_p;
        c = t.swing_right(c);
        if (++sweep_steps > n_corners) return -15;  // closed-fan S ref
      }
      set_opp(corner_a, corner + 2);
      set_opp(corner_b, corner + 1);
      vertex[corner] = vertex_p;
      vertex[corner + 1] = vertex[next_corner(corner_a)];
      vertex[corner + 2] = vertex[prev_corner(corner_b)];
      vertex_corner[vertex_p] = first_q;
      vertex_corner[vertex_q] = INVALID;
      valences[vertex_p] += valences[vertex_q];
      stack.back() = corner;
    } else {
      return -9;
    }

    if (check_split) {
      int64_t encoder_symbol_id = num_symbols - symbol_id - 1;
      for (int64_t s = 0; s < num_splits; ++s) {
        if (split_source[s] != encoder_symbol_id) continue;
        int64_t decoder_split_id = num_symbols - split_id[s] - 1;
        int32_t c = split_edge[s] == 1 ? next_corner(corner)
                                       : prev_corner(corner);
        split_key.push_back(decoder_split_id);
        split_corner_of.push_back(c);
      }
    }

    int32_t nxt = next_corner(corner), prv = prev_corner(corner);
    if (symbol == 0 || symbol == 1) {
      valences[vertex[nxt]] += 1;
      valences[vertex[prv]] += 1;
    } else if (symbol == 5) {
      valences[vertex[corner]] += 1;
      valences[vertex[nxt]] += 1;
      valences[vertex[prv]] += 2;
    } else if (symbol == 3) {
      valences[vertex[corner]] += 1;
      valences[vertex[nxt]] += 2;
      valences[vertex[prv]] += 1;
    } else {
      valences[vertex[corner]] += 2;
      valences[vertex[nxt]] += 2;
      valences[vertex[prv]] += 2;
    }
    int64_t av = valences[vertex[nxt]];
    if (av < 2) av = 2;
    if (av > 7) av = 7;
    active_context = (int)(av - 2);
  }

  // init faces from scripted start-face bits
  int64_t sfi = 0;
  int64_t num_decoded_faces = num_symbols;
  int64_t n_init = 0;
  int64_t n_components = 0;
  while (!stack.empty()) {
    int32_t corner = stack.back();
    stack.pop_back();
    n_components += 1;
    if (sfi >= n_sf_bits) return -21;
    int interior = sf_bits[sfi++];
    if (interior) {
      int32_t corner_a = corner;
      int32_t corner_b = prev_corner(corner_a);
      while (opposite[corner_b] != INVALID)
        corner_b = prev_corner(opposite[corner_b]);
      int32_t corner_c = next_corner(corner_a);
      while (opposite[corner_c] != INVALID)
        corner_c = next_corner(opposite[corner_c]);
      int32_t face_corner = (int32_t)(3 * num_decoded_faces);
      num_decoded_faces += 1;
      if (face_corner + 2 >= n_corners) return -12;
      int32_t vert_n_b = vertex[next_corner(corner_b)];
      int32_t vert_n_c = vertex[next_corner(corner_c)];
      int32_t vert_n_a = vertex[next_corner(corner_a)];
      set_opp(face_corner, corner_a);
      set_opp(face_corner + 1, corner_b);
      set_opp(face_corner + 2, corner_c);
      vertex[face_corner] = vert_n_b;
      vertex[face_corner + 1] = vert_n_c;
      vertex[face_corner + 2] = vert_n_a;
      for (int k = 0; k < 3; ++k) {
        int32_t x = face_corner + k;
        int32_t o = opposite[x];
        if (vertex[next_corner(x)] != vertex[prev_corner(o)] ||
            vertex[prev_corner(x)] != vertex[next_corner(o)])
          return -13;
      }
      processed_corners[n_processed + n_init] = face_corner;
      n_init += 1;
    }
  }
  if (num_decoded_faces != num_faces) return -14;
  out_counts[0] = n_processed;
  out_counts[1] = n_init;
  out_counts[2] = num_vertices;
  out_counts[3] = n_components;
  return 0;
}

// rABS bit ENCODE (rans.py RansBitEncoder.flush): bits in FIFO order in;
// returns payload length (prob byte handled by the caller), writes payload.
int64_t uvt_rabs_encode_bits(const uint8_t* bits, int64_t n,
                             uint32_t prob_zero, uint8_t* out,
                             int64_t out_cap) {
  const uint32_t IO_BASE = 256, L_BASE = 4096, P8 = 256;
  if (prob_zero < 1 || prob_zero > 255) return -1;  // both divisors >= 1
  uint32_t p = P8 - prob_zero;
  uint64_t state = L_BASE;
  // only two divisors exist (p / prob_zero): 32-bit reciprocals + a
  // <=2-step fixup replace the per-bit udiv (state < 4096*l_s < 2^20,
  // so the estimate product never overflows and q_est <= q exactly)
  const uint64_t recip1 = p ? (((uint64_t)1 << 32) / p) : 0;
  const uint64_t recip0 =
      prob_zero ? (((uint64_t)1 << 32) / prob_zero) : 0;
  std::vector<uint8_t> renorm;
  renorm.reserve((size_t)(n / 4 + 16));
  for (int64_t i = n - 1; i >= 0; --i) {
    uint32_t l_s = bits[i] ? p : prob_zero;
    uint64_t bound = (uint64_t)(L_BASE / P8) * IO_BASE * l_s;
    while (state >= bound) {
      renorm.push_back((uint8_t)(state & 0xFF));
      state >>= 8;
    }
    uint64_t quot = (state * (bits[i] ? recip1 : recip0)) >> 32;
    uint64_t rem = state - quot * l_s;
    while (rem >= l_s) { quot++; rem -= l_s; }
    state = quot * P8 + rem + (bits[i] ? 0 : p);
  }
  // final-state marker (rans.py _write_final_state)
  uint8_t marker[4];
  int mlen;
  uint64_t s = state - L_BASE;
  if (s < (1ULL << 6)) {
    marker[0] = (uint8_t)s;
    mlen = 1;
  } else if (s < (1ULL << 14)) {
    uint32_t v = (1u << 14) | (uint32_t)s;
    marker[0] = v & 0xFF; marker[1] = v >> 8;
    mlen = 2;
  } else if (s < (1ULL << 22)) {
    uint32_t v = (2u << 22) | (uint32_t)s;
    marker[0] = v & 0xFF; marker[1] = (v >> 8) & 0xFF; marker[2] = v >> 16;
    mlen = 3;
  } else {
    uint32_t v = (3u << 30) | (uint32_t)s;
    marker[0] = v & 0xFF; marker[1] = (v >> 8) & 0xFF;
    marker[2] = (v >> 16) & 0xFF; marker[3] = v >> 24;
    mlen = 4;
  }
  int64_t total = (int64_t)renorm.size() + mlen;
  if (total > out_cap) return -1;
  for (size_t i = 0; i < renorm.size(); ++i) out[i] = renorm[i];
  for (int i = 0; i < mlen; ++i) out[renorm.size() + i] = marker[i];
  return total;
}

}  // extern "C"

// ===========================================================================
// Point assembly (decoder.py _decode_drc tail): unify per-corner attribute
// value-index tuples into point ids, numbered by first appearance in corner
// order (Draco's point numbering). Replaces the numpy unique+argsort path.
// ===========================================================================

#include <unordered_map>

extern "C" {

// keys: [num_corners, num_attrs] int32 (row-major), each component >= 0.
// widths: packed bit width per column (from the caller's value counts).
// out:  point_of_corner int32 [num_corners]. Returns num_points, or -1 when
// the packed key would overflow 63 bits (caller falls back).
int64_t uvt_point_assembly(const int32_t* keys, int64_t num_corners,
                           int num_attrs, const int32_t* widths_in,
                           int32_t* out) {
  int widths[16];
  if (num_attrs > 16) return -1;
  int total_bits = 0;
  for (int a = 0; a < num_attrs; a++) {
    widths[a] = widths_in[a];
    total_bits += widths[a];
  }
  if (total_bits > 63) return -1;

  // open-addressing hash (keys fit in 63 bits, so ~0 is a safe empty
  // marker). Distinct points are typically ~corners/5 (one per attribute
  // value, not per corner), so the table starts small enough to stay in
  // cache and doubles at 70% load instead of being sized by corner count
  // (a 2x-corners table measured 6 MB of random probes per frame).
  const uint64_t EMPTY = ~0ull;
  size_t cap = 1 << 12;
  while (cap < (size_t)(num_corners / 4)) cap <<= 1;
  std::vector<uint64_t> slot_key(cap, EMPTY);
  std::vector<int32_t> slot_id(cap);
  size_t mask = cap - 1;
  size_t used = 0;
  int32_t next_id = 0;
  auto grow = [&]() {
    size_t ncap = cap * 2;
    std::vector<uint64_t> nk(ncap, EMPTY);
    std::vector<int32_t> nid(ncap);
    size_t nmask = ncap - 1;
    for (size_t s = 0; s < cap; ++s) {
      if (slot_key[s] == EMPTY) continue;
      size_t t = ((slot_key[s] * 0x9E3779B97F4A7C15ull) >> 1) & nmask;
      while (nk[t] != EMPTY) t = (t + 1) & nmask;
      nk[t] = slot_key[s];
      nid[t] = slot_id[s];
    }
    slot_key.swap(nk);
    slot_id.swap(nid);
    cap = ncap;
    mask = nmask;
  };
  for (int64_t i = 0; i < num_corners; i++) {
    uint64_t key = 0;
    for (int a = 0; a < num_attrs; a++)
      key = (key << widths[a]) | (uint64_t)keys[i * num_attrs + a];
    size_t h = (key * 0x9E3779B97F4A7C15ull) >> 1;
    size_t s = h & mask;
    while (true) {
      if (slot_key[s] == EMPTY) {
        if (used * 10 >= cap * 7) {  // 70% load: rehash, then re-probe
          grow();
          s = h & mask;
          continue;
        }
        slot_key[s] = key;
        slot_id[s] = next_id;
        used += 1;
        out[i] = next_id++;
        break;
      }
      if (slot_key[s] == key) {
        out[i] = slot_id[s];
        break;
      }
      s = (s + 1) & mask;
    }
  }
  return next_id;
}

}  // extern "C"

// ===========================================================================
// Encoder-side Edgebreaker traversal (encoder.py _edgebreaker_traverse):
// the spirale DFS emitting CLER symbols, topology splits, start-face bits
// and the per-symbol corner list. Mirrors the Python reference exactly.
// ===========================================================================

extern "C" int uvt_eb_traverse(
    const int32_t* vertex, const int32_t* opposite, const int64_t* hole_of,
    int64_t num_faces, int64_t num_vertices, int64_t num_holes,
    uint8_t* symbols, int32_t* symbol_corners,      // [num_faces] caps
    uint8_t* start_face_bits,                       // [num_faces] cap
    int64_t* split_src, int64_t* split_id, uint8_t* split_edge,  // caps F
    int32_t* init_face_corners, int32_t* interior_start_corners,  // caps F
    int64_t* counts  // [5]: n_symbols, n_start_bits, n_splits, n_init, n_split_syms
) {
  const uint8_t TOP_C = 0x0, TOP_S = 0x1, TOP_L = 0x3, TOP_R = 0x5,
                TOP_E = 0x7;
  const uint8_t LEFT_EDGE = 0, RIGHT_EDGE = 1;

  std::vector<uint8_t> visited_faces(num_faces, 0);
  std::vector<uint8_t> visited_verts(num_vertices, 0);
  std::vector<uint8_t> visited_holes(num_holes ? num_holes : 1, 0);
  std::vector<int64_t> face_to_split(num_faces, -1);

  // per-hole vertex lists (encode_hole marks the whole loop visited)
  std::vector<int64_t> hole_count(num_holes ? num_holes : 1, 0);
  for (int64_t v = 0; v < num_vertices; ++v)
    if (hole_of[v] >= 0) hole_count[hole_of[v]]++;
  std::vector<int64_t> hole_off(hole_count.size() + 1, 0);
  for (size_t h = 0; h < hole_count.size(); ++h)
    hole_off[h + 1] = hole_off[h] + hole_count[h];
  std::vector<int32_t> hole_verts(hole_off.back());
  {
    std::vector<int64_t> cur(hole_off.begin(), hole_off.end() - 1);
    for (int64_t v = 0; v < num_vertices; ++v)
      if (hole_of[v] >= 0) hole_verts[cur[hole_of[v]]++] = (int32_t)v;
  }

  int64_t n_symbols = 0, n_start = 0, n_splits = 0, n_init = 0,
          n_split_syms = 0, n_interior = 0;

  auto right_c = [&](int32_t c) { return opposite[next_corner(c)]; };
  auto left_c = [&](int32_t c) { return opposite[prev_corner(c)]; };

  auto encode_hole = [&](int32_t start_corner, bool first) {
    int32_t v = vertex[start_corner];
    int64_t hid = hole_of[v];
    visited_holes[hid] = 1;
    for (int64_t k = hole_off[hid]; k < hole_off[hid + 1]; ++k)
      visited_verts[hole_verts[k]] = 1;
    if (first) visited_verts[v] = 1;
  };

  auto check_split = [&](int64_t sym_id, uint8_t edge, int64_t nf) {
    int64_t sid = face_to_split[nf];
    if (sid >= 0) {
      face_to_split[nf] = -1;
      split_src[n_splits] = sym_id;
      split_id[n_splits] = sid;
      split_edge[n_splits] = edge;
      n_splits++;
    }
  };

  std::vector<int32_t> stack;
  auto encode_from_corner = [&](int32_t corner_id) -> int {
    stack.clear();
    stack.push_back(corner_id);
    while (!stack.empty()) {
      corner_id = stack.back();
      if (corner_id == INVALID || visited_faces[corner_id / 3]) {
        stack.pop_back();
        continue;
      }
      while (true) {
        int64_t face_id = corner_id / 3;
        visited_faces[face_id] = 1;
        int64_t symbol_id = n_symbols;
        symbol_corners[n_symbols] = corner_id;
        int32_t vert_id = vertex[corner_id];
        if (!visited_verts[vert_id]) {
          visited_verts[vert_id] = 1;
          if (hole_of[vert_id] == -1) {
            symbols[n_symbols++] = TOP_C;
            corner_id = right_c(corner_id);
            if (corner_id == INVALID || visited_faces[corner_id / 3])
              return -1;  // C into visited/invalid face
            continue;
          }
        }
        int32_t rc = right_c(corner_id);
        int32_t lc = left_c(corner_id);
        int64_t rf = rc == INVALID ? INVALID : rc / 3;
        int64_t lf = lc == INVALID ? INVALID : lc / 3;
        bool right_visited = rf == INVALID || visited_faces[rf];
        bool left_visited = lf == INVALID || visited_faces[lf];
        if (right_visited) {
          if (rf != INVALID) check_split(symbol_id, RIGHT_EDGE, rf);
          if (left_visited) {
            if (lf != INVALID) check_split(symbol_id, LEFT_EDGE, lf);
            symbols[n_symbols++] = TOP_E;
            stack.pop_back();
            break;
          }
          symbols[n_symbols++] = TOP_R;
          corner_id = lc;
        } else {
          if (left_visited) {
            if (lf != INVALID) check_split(symbol_id, LEFT_EDGE, lf);
            symbols[n_symbols++] = TOP_L;
            corner_id = rc;
          } else {
            int64_t hid = hole_of[vert_id];
            if (hid != -1 && !visited_holes[hid])
              encode_hole(corner_id, false);
            face_to_split[face_id] = symbol_id;
            symbols[n_symbols++] = TOP_S;
            n_split_syms++;
            stack.back() = lc;
            stack.push_back(rc);
            break;
          }
        }
      }
    }
    return 0;
  };

  auto swing_right = [&](int32_t c) -> int32_t {
    int32_t o = opposite[prev_corner(c)];
    return o == INVALID ? INVALID : prev_corner(o);
  };

  for (int64_t c_id = 0; c_id < 3 * num_faces; ++c_id) {
    int64_t face_id = c_id / 3;
    if (visited_faces[face_id]) continue;
    // find_init_face_configuration
    bool interior = true;
    int32_t start_corner = (int32_t)(3 * face_id);
    {
      int32_t corner = start_corner;
      bool found = false;
      for (int k = 0; k < 3; ++k) {
        if (opposite[corner] == INVALID) {
          interior = false;
          start_corner = corner;
          found = true;
          break;
        }
        if (hole_of[vertex[corner]] != -1) {
          int32_t right = corner;
          while (right != INVALID) {
            corner = right;
            right = swing_right(right);
          }
          interior = false;
          start_corner = prev_corner(corner);
          found = true;
          break;
        }
        corner = next_corner(corner);
      }
      if (!found) {
        interior = true;
        start_corner = corner;
      }
    }
    start_face_bits[n_start++] = interior ? 1 : 0;
    if (interior) {
      interior_start_corners[n_interior++] = start_corner;
      visited_verts[vertex[start_corner]] = 1;
      visited_verts[vertex[next_corner(start_corner)]] = 1;
      visited_verts[vertex[prev_corner(start_corner)]] = 1;
      visited_faces[face_id] = 1;
      init_face_corners[n_init++] = next_corner(start_corner);
      int32_t opp_id = opposite[next_corner(start_corner)];
      if (opp_id != INVALID && !visited_faces[opp_id / 3]) {
        if (encode_from_corner(opp_id) != 0) return -1;
      }
    } else {
      encode_hole(next_corner(start_corner), true);
      if (encode_from_corner(start_corner) != 0) return -1;
    }
  }

  counts[0] = n_symbols;
  counts[1] = n_start;
  counts[2] = n_splits;
  counts[3] = n_init;
  counts[4] = n_split_syms;
  // n_interior == n_init by construction
  return 0;
}

// ---------------------------------------------------------------------------
// encoder dec<->enc corner maps + attribute seam bits (encoder.py's
// "maps + seams" region, one C pass; byte-identical semantics incl. the
// consistency checks, which become negative return codes)
// ---------------------------------------------------------------------------
extern "C" int uvt_eb_encode_maps(
    int64_t num_faces, int64_t num_symbols, int64_t num_vertex_slots,
    const int64_t* symbol_corners_rev,   // [num_symbols] (decode order)
    const int32_t* dvert,                // ct_d.vertex [3F]
    const int32_t* enc_vertex,           // ct.vertex [3F]
    const int32_t* enc_opposite,         // ct.opposite [3F]
    const int32_t* opp_d,                // ct_d.opposite [3F]
    const int64_t* interior_start_corners,  // [num_faces - num_symbols]
    int64_t num_attrs,
    const int64_t* c2v_all,              // [num_attrs][3F] concatenated
    int64_t* dec2enc_corner,             // out [3F]
    int64_t* cs_out,                     // out [3F] seam-pass corners
    uint8_t* bits_out,                   // out [num_attrs][3F]
    int64_t* pairs_out,                  // out [num_attrs][2*3F]
    int64_t* boundary_out,               // out [3F]
    int64_t* counts_out                  // out [2+num_attrs]
) {
  const int64_t n = 3 * num_faces;
  std::vector<int64_t> enc_vert_of_dec(num_vertex_slots, INVALID);

  // one fused pass: write the symbol-face corner maps and check vertex
  // correspondence while the mapped corners are still in registers.
  // (No INVALID pre-fill / completeness post-check: symbol faces cover
  // corners [0, 3*num_symbols) here and the init-face loop below covers
  // the rest or returns an error, so every entry is written exactly once.)
  for (int64_t j = 0; j < num_symbols; ++j) {
    int64_t sc = symbol_corners_rev[j];
    int64_t nxt = (sc % 3 == 2) ? sc - 2 : sc + 1;
    int64_t prv = (sc % 3 == 0) ? sc + 2 : sc - 1;
    dec2enc_corner[3 * j] = sc;
    dec2enc_corner[3 * j + 1] = nxt;
    dec2enc_corner[3 * j + 2] = prv;
    const int64_t ecs[3] = {sc, nxt, prv};
    for (int k = 0; k < 3; ++k) {
      int64_t dv = dvert[3 * j + k];
      if (dv < 0 || dv >= num_vertex_slots) return -1;
      int64_t ev = enc_vertex[ecs[k]];
      if (enc_vert_of_dec[dv] != INVALID && enc_vert_of_dec[dv] != ev)
        return -2;  // inconsistent vertex correspondence
      enc_vert_of_dec[dv] = ev;
    }
  }
  // init faces: match by (already mapped) vertices
  for (int64_t i = 0, df = num_symbols; df < num_faces; ++df, ++i) {
    int64_t sc = interior_start_corners[i];
    int64_t ec[3] = {sc, (sc % 3 == 2) ? sc - 2 : sc + 1,
                     (sc % 3 == 0) ? sc + 2 : sc - 1};
    int64_t evs[3] = {enc_vertex[ec[0]], enc_vertex[ec[1]],
                      enc_vertex[ec[2]]};
    for (int k3 = 0; k3 < 3; ++k3) {
      int64_t dc = 3 * df + k3;
      int64_t ev = enc_vert_of_dec[dvert[dc]];
      if (ev == INVALID) return -3;  // init face vertex unmapped
      int found = -1;
      for (int k = 0; k < 3; ++k)
        if (evs[k] == ev) { found = k; break; }
      if (found < 0) return -4;
      dec2enc_corner[dc] = ec[found];
    }
  }

  // seam pass: ascending corner order, interior edges with opp face > face
  int64_t n_edges = 0, n_boundary = 0;
  for (int64_t c = 0; c < n; ++c) {
    int32_t o = opp_d[c];
    if (o == INVALID) {
      boundary_out[n_boundary++] = c;
      continue;
    }
    if (o / 3 > (int32_t)(c / 3)) cs_out[n_edges++] = c;
  }
  // one pass over edges: the corner geometry (dec2enc, next/prev of the
  // mapped corner and its opposite) is attribute-invariant, so compute it
  // once and test every attribute's c2v inside (same bits/pairs as the
  // per-attribute loops this fuses)
  std::vector<int64_t> n_pairs_a((size_t)std::max<int64_t>(num_attrs, 1), 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t c = cs_out[e];
    int64_t ce = dec2enc_corner[c];
    int32_t oe = enc_opposite[ce];
    int64_t nxt_ce = 0, prv_ce = 0, nxt_o = 0, prv_o = 0;
    if (oe != INVALID) {
      nxt_ce = (ce % 3 == 2) ? ce - 2 : ce + 1;
      prv_ce = (ce % 3 == 0) ? ce + 2 : ce - 1;
      nxt_o = (oe % 3 == 2) ? oe - 2 : oe + 1;
      prv_o = (oe % 3 == 0) ? oe + 2 : oe - 1;
    }
    for (int64_t a = 0; a < num_attrs; ++a) {
      const int64_t* c2v = c2v_all + a * n;
      uint8_t bit =
          (oe == INVALID) ||
          (c2v[nxt_ce] != c2v[prv_o]) || (c2v[prv_ce] != c2v[nxt_o]);
      bits_out[a * n + e] = bit;
      if (bit) {
        int64_t* pairs = pairs_out + a * 2 * n;
        pairs[n_pairs_a[a]++] = c;
        pairs[n_pairs_a[a]++] = opp_d[c];
      }
    }
  }
  for (int64_t a = 0; a < num_attrs; ++a) counts_out[2 + a] = n_pairs_a[a];
  counts_out[0] = n_edges;
  counts_out[1] = n_boundary;
  return 0;
}

// ---------------------------------------------------------------------------
// Upload bit-packer (models/drc_device.py _pack_host): flat non-negative
// int32 values -> uint8 wire at 8/10/12/16/32-bit granularity. One pass,
// no temporaries — replaces an int64 astype + ~8 full-array numpy ops per
// window in the wire->device pipeline (the packing ran on the uploader
// thread of a 1-core host, serializing against the wire decode).
// Little-endian byte order for 16/32 (matches numpy .view(uint8) on the
// hosts these .so files are built on; asserted in the Python binding).
// Tail groups (n not a multiple of the group size) pack as zero-padded.
// ---------------------------------------------------------------------------
extern "C" int uvt_pack_bits(const int32_t* v, int64_t n, int mode,
                             uint8_t* out) {
  if (mode == 8) {
    for (int64_t i = 0; i < n; ++i) out[i] = (uint8_t)v[i];
    return 0;
  }
  if (mode == 16) {
    for (int64_t i = 0; i < n; ++i) {
      const uint16_t x = (uint16_t)(int16_t)v[i];
      out[i * 2] = (uint8_t)x;
      out[i * 2 + 1] = (uint8_t)(x >> 8);
    }
    return 0;
  }
  if (mode == 32) {
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t x = (uint32_t)v[i];
      out[i * 4] = (uint8_t)x;
      out[i * 4 + 1] = (uint8_t)(x >> 8);
      out[i * 4 + 2] = (uint8_t)(x >> 16);
      out[i * 4 + 3] = (uint8_t)(x >> 24);
    }
    return 0;
  }
  if (mode == 12) {  // 2 values -> 3 bytes
    const int64_t ng = n / 2;
    for (int64_t g = 0; g < ng; ++g) {
      const uint32_t a = (uint32_t)v[g * 2], b = (uint32_t)v[g * 2 + 1];
      out[g * 3] = (uint8_t)a;
      out[g * 3 + 1] = (uint8_t)(((a >> 8) & 0xF) | ((b & 0xF) << 4));
      out[g * 3 + 2] = (uint8_t)((b >> 4) & 0xFF);
    }
    if (n & 1) {  // tail: one value, pad with 0
      const uint32_t a = (uint32_t)v[n - 1];
      out[ng * 3] = (uint8_t)a;
      out[ng * 3 + 1] = (uint8_t)((a >> 8) & 0xF);
      out[ng * 3 + 2] = 0;
    }
    return 0;
  }
  if (mode == 10) {  // 4 values -> 5 bytes
    const int64_t ng = n / 4;
    for (int64_t g = 0; g < ng; ++g) {
      const uint32_t a = (uint32_t)v[g * 4], b = (uint32_t)v[g * 4 + 1];
      const uint32_t c = (uint32_t)v[g * 4 + 2], d = (uint32_t)v[g * 4 + 3];
      out[g * 5] = (uint8_t)a;
      out[g * 5 + 1] = (uint8_t)(((a >> 8) & 0x3) | ((b & 0x3F) << 2));
      out[g * 5 + 2] = (uint8_t)(((b >> 6) & 0xF) | ((c & 0xF) << 4));
      out[g * 5 + 3] = (uint8_t)(((c >> 4) & 0x3F) | ((d & 0x3) << 6));
      out[g * 5 + 4] = (uint8_t)((d >> 2) & 0xFF);
    }
    const int64_t tail = n - ng * 4;
    if (tail) {
      uint32_t t[4] = {0, 0, 0, 0};
      for (int64_t i = 0; i < tail; ++i) t[i] = (uint32_t)v[ng * 4 + i];
      out[ng * 5] = (uint8_t)t[0];
      out[ng * 5 + 1] = (uint8_t)(((t[0] >> 8) & 0x3) | ((t[1] & 0x3F) << 2));
      out[ng * 5 + 2] = (uint8_t)(((t[1] >> 6) & 0xF) | ((t[2] & 0xF) << 4));
      out[ng * 5 + 3] = (uint8_t)(((t[2] >> 4) & 0x3F) | ((t[3] & 0x3) << 6));
      out[ng * 5 + 4] = (uint8_t)((t[3] >> 2) & 0xFF);
    }
    return 0;
  }
  return -1;
}

// Fused per-window batch packer (models/drc_device.py _build_batch): packs
// each frame's value array directly into its padded slot of the window's
// upload buffer and zero-fills the padding — replacing the [F, nmax, nc]
// int32 intermediate (zeroed, filled per frame, then re-read by the flat
// packer) that ran on the uploader thread of a 1-core host. Byte-identical
// to packing the zero-padded flat array because uvt_pack_bits zero-pads
// tail groups and the pad values are zeros.
//   vals:   F pointers to contiguous int32 value arrays
//   nvals:  per-frame value counts
//   stride: padded per-frame value count (nmax * nc); must be a multiple
//           of the mode's group size (callers bucket nmax to 4096)
// Returns 0, or -1 on an unknown mode.
extern "C" int uvt_pack_frames(const int32_t* const* vals,
                               const int64_t* nvals, int64_t f, int64_t stride,
                               int mode, uint8_t* out) {
  int64_t gv, gb;
  switch (mode) {
    case 8:  gv = 1; gb = 1; break;
    case 10: gv = 4; gb = 5; break;
    case 12: gv = 2; gb = 3; break;
    case 16: gv = 1; gb = 2; break;
    case 32: gv = 1; gb = 4; break;
    default: return -1;
  }
  if (stride % gv) return -1;
  const int64_t frame_bytes = stride / gv * gb;
  for (int64_t i = 0; i < f; ++i) {
    uint8_t* dst = out + i * frame_bytes;
    const int64_t n = nvals[i] <= stride ? nvals[i] : stride;
    if (uvt_pack_bits(vals[i], n, mode, dst) != 0) return -1;
    const int64_t used = (n + gv - 1) / gv * gb;
    if (used < frame_bytes) memset(dst + used, 0, frame_bytes - used);
  }
  return 0;
}
