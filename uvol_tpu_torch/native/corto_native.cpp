// uvol-tpu native Corto hot loops (C ABI, ctypes-bound).
//
// The Corto `.crt` codec (UVOL 1.0 geometry frames — reference semantics in
// uvol_tpu/codecs/corto/{decoder,encoder,stream,bitstream}.py, which mirror
// the reference's src/lib/corto.ts + deprecated/encoder/dev/src/) is
// dominated by inherently sequential per-vertex/per-face loops: the CLER
// front machine, the log/bit value streams and the delta integration. These
// are host serialization work, not TPU math, so they live here; the Python
// modules remain the bit-exact reference implementations and fall back
// automatically when no compiler is present.
//
// Build: g++ -O3 -shared -fPIC corto_native.cpp -o libuvt_corto.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Bitstream: MSB-first packing within little-endian uint32 words
// (uvol_tpu/codecs/corto/bitstream.py)
// ---------------------------------------------------------------------------

struct BitReader {
    const uint32_t* a;
    int64_t nwords;
    int64_t position = 0;
    uint32_t current = 0;
    int pending = 32;
    int64_t consumed = 0;  // exact bits-read accounting
    bool overflow = false;  // set when a malformed stream reads past the end

    BitReader(const uint32_t* words, int64_t n) : a(words), nwords(n) {
        current = n ? a[0] : 0;
    }

    uint32_t read(int bits) {
        if (bits == 0) return 0;
        consumed += bits;
        if (consumed > nwords * 32) overflow = true;  // zero-bit streams OK
        if (bits > pending) {
            int over = bits - pending;
            uint32_t result = (uint32_t)(((uint64_t)current << over) & 0xFFFFFFFFu);
            pending = 32 - over;
            position++;
            current = position < nwords ? a[position] : 0;
            result |= current >> pending;
            current &= (pending == 32) ? 0xFFFFFFFFu : ((1u << pending) - 1);
            return result;
        }
        pending -= bits;
        uint32_t result = current >> pending;
        current &= (pending == 32) ? 0xFFFFFFFFu : ((1u << pending) - 1);
        return result;
    }
};

struct BitWriter {
    std::vector<uint32_t> words;
    uint64_t buff = 0;
    int bits = 0;

    void write(uint32_t value, int n) {
        if (n == 0) return;
        value &= (n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1);
        int space = 32 - bits;
        if (n < space) {
            buff = (buff << n) | value;
            bits += n;
        } else {
            int hi = n - space;
            words.push_back((uint32_t)(((buff << space) | (value >> hi)) & 0xFFFFFFFFu));
            bits = hi;
            buff = hi ? (value & ((1u << hi) - 1)) : 0;
        }
    }

    void flush() {
        if (bits) {
            words.push_back((uint32_t)((buff << (32 - bits)) & 0xFFFFFFFFu));
            buff = 0;
            bits = 0;
        }
    }
};

inline int ilog2i(uint32_t p) {
    int k = 0;
    while (p > 1) { p >>= 1; k++; }
    return k;
}

// bits to store a signed diff (reference cstream.h `needed`)
inline int needed_bits(int64_t a) {
    if (a == 0) return 0;
    if (a == -1) return 1;
    if (a < 0) a = -a - 1;
    int n = 2;
    while (a > 1) { a >>= 1; n++; }
    return n;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Value stream unpackers (CortoInStream.decode_* in stream.py).
// `words` is the embedded bitstream; `logs` the Tunstall-expanded log bytes.
// ---------------------------------------------------------------------------

// decode_values: per-component logs (component-major logs[n*size]),
// out[size*n] row-major. Read order: for c in 0..n: for i in 0..size.
int uvt_corto_unpack_values(const uint32_t* words, int64_t nwords,
                            const uint8_t* logs, int64_t size, int n,
                            int32_t* out) {
    BitReader bs(words, nwords);
    for (int c = 0; c < n; c++) {
        const uint8_t* lg = logs + (int64_t)c * size;
        for (int64_t i = 0; i < size; i++) {
            int diff = lg[i];
            int32_t v = 0;
            if (diff) {
                if (diff > 32) return -1;  // malformed log byte
                uint32_t val = bs.read(diff);
                uint32_t middle = (1u << diff) >> 1;
                v = (val < middle) ? -(int32_t)val - (int32_t)middle : (int32_t)val;
            }
            out[i * n + c] = v;
        }
    }
    return bs.overflow ? -1 : 0;
}

// decode_array: shared log per tuple; logs[size], out[size*n].
int uvt_corto_unpack_tuples(const uint32_t* words, int64_t nwords,
                            const uint8_t* logs, int64_t size, int n,
                            int32_t* out) {
    BitReader bs(words, nwords);
    for (int64_t i = 0; i < size; i++) {
        int diff = logs[i];
        if (diff == 0) {
            for (int c = 0; c < n; c++) out[i * n + c] = 0;
            continue;
        }
        if (diff > 32) return -1;  // malformed log byte
        int32_t mx = (int32_t)((1u << diff) >> 1);
        for (int c = 0; c < n; c++)
            out[i * n + c] = (int32_t)bs.read(diff) - mx;
    }
    return bs.overflow ? -1 : 0;
}

// decode_indices: out[i] = (1<<ret) + read(ret) - 1 (ret==0 -> 0).
int uvt_corto_unpack_indices(const uint32_t* words, int64_t nwords,
                             const uint8_t* logs, int64_t size, int32_t* out) {
    BitReader bs(words, nwords);
    for (int64_t i = 0; i < size; i++) {
        int ret = logs[i];
        if (ret > 30) return -1;  // malformed: exceeds int32 index space
        out[i] = ret ? (int32_t)((1u << ret) + bs.read(ret) - 1) : 0;
    }
    return bs.overflow ? -1 : 0;
}

// ---------------------------------------------------------------------------
// Value stream packers (CortoOutStream.encode_* in stream.py).
// Emit logs and bit-packed words; return word count (or -1 on overflow).
// ---------------------------------------------------------------------------

// encode_values: per-component logs (logs_out[n*size] component-major).
int64_t uvt_corto_pack_values(const int64_t* values, int64_t size, int n,
                              uint8_t* logs_out, uint32_t* words_out,
                              int64_t words_capacity) {
    BitWriter bw;
    for (int c = 0; c < n; c++) {
        uint8_t* lg = logs_out + (int64_t)c * size;
        for (int64_t i = 0; i < size; i++) {
            int64_t val = values[i * n + c];
            if (val == 0) { lg[i] = 0; continue; }
            int ret = ilog2i((uint32_t)(val < 0 ? -val : val)) + 1;
            lg[i] = (uint8_t)ret;
            int64_t middle = (int64_t)((1u << ret) >> 1);
            if (val < 0) val = -val - middle;
            bw.write((uint32_t)val, ret);
        }
    }
    bw.flush();
    if ((int64_t)bw.words.size() > words_capacity) return -1;
    memcpy(words_out, bw.words.data(), bw.words.size() * 4);
    return (int64_t)bw.words.size();
}

// encode_array: shared log per tuple.
int64_t uvt_corto_pack_tuples(const int64_t* values, int64_t size, int n,
                              uint8_t* logs_out, uint32_t* words_out,
                              int64_t words_capacity) {
    BitWriter bw;
    for (int64_t i = 0; i < size; i++) {
        int diff = 0;
        for (int c = 0; c < n; c++) {
            int nb = needed_bits(values[i * n + c]);
            if (nb > diff) diff = nb;
        }
        logs_out[i] = (uint8_t)diff;
        if (diff == 0) continue;
        int64_t mx = 1ll << (diff - 1);
        for (int c = 0; c < n; c++)
            bw.write((uint32_t)(values[i * n + c] + mx), diff);
    }
    bw.flush();
    if ((int64_t)bw.words.size() > words_capacity) return -1;
    memcpy(words_out, bw.words.data(), bw.words.size() * 4);
    return (int64_t)bw.words.size();
}

// encode_indices.
int64_t uvt_corto_pack_indices(const int64_t* values, int64_t size,
                               uint8_t* logs_out, uint32_t* words_out,
                               int64_t words_capacity) {
    BitWriter bw;
    for (int64_t i = 0; i < size; i++) {
        int64_t val = values[i] + 1;
        if (val == 1) { logs_out[i] = 0; continue; }
        int ret = ilog2i((uint32_t)val);
        logs_out[i] = (uint8_t)ret;
        bw.write((uint32_t)(val - (1ll << ret)), ret);
    }
    bw.flush();
    if ((int64_t)bw.words.size() > words_capacity) return -1;
    memcpy(words_out, bw.words.data(), bw.words.size() * 4);
    return (int64_t)bw.words.size();
}

// ---------------------------------------------------------------------------
// CLER front machine, decode side (decoder.py _decode_faces; corto.ts
// decodeFaces). One call decodes all groups: per group the front restarts
// while vertex numbering, the CLER cursor and the bit cursor persist.
// ---------------------------------------------------------------------------

enum { CLER_VERTEX = 0, CLER_LEFT, CLER_RIGHT, CLER_END, CLER_BOUNDARY,
       CLER_DELAY, CLER_SPLIT };

int uvt_corto_decode_faces(const uint8_t* clers, int64_t nclers,
                           const uint32_t* words, int64_t nwords,
                           const int64_t* group_ends,  // in faces (exclusive)
                           int ngroups, int splitbits, int64_t nvert,
                           int32_t* faces,        // [3*nface]
                           int32_t* prediction) { // [nvert*3]
    BitReader bs(words, nwords);
    int64_t cler = 0;
    int64_t vertex_count = 0;

    // one front-edge record per slot (was 5 parallel vectors): better
    // locality and a single growth path.  Each CLER symbol appends at
    // most 2 edges and each component seeds 3, so 2*nface + 3*nface is a
    // safe whole-call bound — reserve once, clear per group.
    struct FEdge { int32_t v0, v1, v2, prev, next; };
    int64_t nface_total = ngroups ? group_ends[ngroups - 1] : 0;
    // reserve is a hint from *untrusted* face counts — clamp it so a
    // corrupt header can't demand a huge up-front allocation (found by
    // ASan fuzz); vectors still grow amortized past the hint
    int64_t hint = std::min<int64_t>(nface_total, 1 << 20);
    std::vector<FEdge> front;
    front.reserve(3 * hint + 16);
    std::vector<int64_t> faceorder, delayed;
    faceorder.reserve(2 * hint + 8);

    int64_t start = 0;
    for (int g = 0; g < ngroups; g++) {
        int64_t end = group_ends[g] * 3;
        front.clear();
        faceorder.clear(); delayed.clear();
        int64_t order_front = 0;
        int64_t new_edge = -1;

        while (start < end) {
            if (new_edge == -1 && order_front >= (int64_t)faceorder.size() &&
                delayed.empty()) {
                // new connected component: initial face
                int64_t last_index = vertex_count - 1;
                if (cler >= nclers) return -1;
                uint32_t split = 0;
                if (clers[cler] == CLER_SPLIT) {
                    cler++;
                    split = bs.read(3);
                } else {
                    cler++;
                }
                int32_t vindex[3];
                for (int k = 0; k < 3; k++) {
                    int64_t v;
                    if (split & (1u << k)) {
                        v = bs.read(splitbits);
                        if (v >= nvert) return -3;  // corrupt split ref
                    } else {
                        if (vertex_count >= nvert) return -2;
                        prediction[vertex_count * 3 + 0] = (int32_t)last_index;
                        prediction[vertex_count * 3 + 1] = (int32_t)last_index;
                        prediction[vertex_count * 3 + 2] = (int32_t)last_index;
                        v = vertex_count;
                        last_index = v;
                        vertex_count++;
                    }
                    vindex[k] = (int32_t)v;
                    faces[start++] = (int32_t)v;
                }
                int64_t current_edge = (int64_t)front.size();
                for (int kk = 0; kk < 3; kk++) {
                    faceorder.push_back((int64_t)front.size());
                    front.push_back(FEdge{
                        vindex[(kk + 1) % 3], vindex[(kk + 2) % 3],
                        vindex[kk],
                        (int32_t)(current_edge + (kk + 2) % 3),
                        (int32_t)(current_edge + (kk + 1) % 3)});
                }
                continue;
            }

            int64_t edge;
            if (new_edge != -1) {
                edge = new_edge;
                new_edge = -1;
            } else if (order_front < (int64_t)faceorder.size()) {
                edge = faceorder[order_front++];
            } else {
                edge = delayed.back();
                delayed.pop_back();
            }

            if (front[edge].v0 < 0) continue;  // deleted

            if (cler >= nclers) return -1;
            int c = clers[cler++];
            if (c == CLER_BOUNDARY) continue;

            // copy: push_back below may reallocate the front
            FEdge e = front[edge];
            int32_t v0 = e.v0, v1 = e.v1, v2 = e.v2;
            int32_t prev = e.prev, nxt = e.next;
            new_edge = (int64_t)front.size();
            int64_t opposite = -1;

            if (c == CLER_VERTEX || c == CLER_SPLIT) {
                if (c == CLER_SPLIT) {
                    opposite = bs.read(splitbits);
                } else {
                    if (vertex_count >= nvert) return -2;
                    prediction[vertex_count * 3 + 0] = v1;
                    prediction[vertex_count * 3 + 1] = v0;
                    prediction[vertex_count * 3 + 2] = v2;
                    opposite = vertex_count++;
                }
                front[prev].next = (int32_t)new_edge;
                front[nxt].prev = (int32_t)(new_edge + 1);
                front.push_back(FEdge{v0, (int32_t)opposite, v1, prev,
                                      (int32_t)(new_edge + 1)});
                faceorder.push_back((int64_t)front.size());
                front.push_back(FEdge{(int32_t)opposite, v1, v0,
                                      (int32_t)new_edge, nxt});
            } else if (c == CLER_LEFT) {
                int32_t pp = front[prev].prev;
                front[pp].next = (int32_t)new_edge;
                front[nxt].prev = (int32_t)new_edge;
                opposite = front[prev].v0;
                front.push_back(FEdge{(int32_t)opposite, v1, v0, pp, nxt});
                front[prev].v0 = -1;
            } else if (c == CLER_RIGHT) {
                int32_t nn = front[nxt].next;
                front[nn].prev = (int32_t)new_edge;
                front[prev].next = (int32_t)new_edge;
                opposite = front[nxt].v1;
                front.push_back(FEdge{v0, (int32_t)opposite, v1, prev, nn});
                front[nxt].v0 = -1;
            } else if (c == CLER_DELAY) {
                delayed.push_back(edge);
                new_edge = -1;
                continue;
            } else if (c == CLER_END) {
                front[front[prev].prev].next = front[nxt].next;
                front[front[nxt].next].prev = front[prev].prev;
                opposite = front[prev].v0;
                front[prev].v0 = -1;
                front[nxt].v0 = -1;
                new_edge = -1;
            } else {
                return -3;  // invalid CLER symbol
            }

            if (v1 >= nvert || v0 >= nvert || opposite >= nvert) return -4;
            faces[start] = v1;
            faces[start + 1] = v0;
            faces[start + 2] = (int32_t)opposite;
            start += 3;
        }
    }
    return (int)vertex_count;
}

// ---------------------------------------------------------------------------
// Attribute delta integration, decode side (decoder.py _attr_delta_decode).
// Sequential: entry i references already-integrated entries < i.
// mode 0: parallelogram (v[i] += v[a]+v[b]-v[c]); mode 1: diff (v[i] += v[a]);
// mode 2: point cloud (v[i] += v[i-1]).
// ---------------------------------------------------------------------------

int uvt_corto_delta_decode(int32_t* values, int64_t nvert, int n,
                           const int32_t* prediction, int mode) {
    if (mode == 2 || prediction == nullptr) {
        for (int64_t i = 1; i < nvert; i++)
            for (int c = 0; c < n; c++)
                values[i * n + c] += values[(i - 1) * n + c];
        return 0;
    }
    if (mode == 0) {
        for (int64_t i = 1; i < nvert; i++) {
            int64_t a = prediction[i * 3], b = prediction[i * 3 + 1],
                    cc = prediction[i * 3 + 2];
            if ((uint64_t)a >= (uint64_t)nvert ||
                (uint64_t)b >= (uint64_t)nvert ||
                (uint64_t)cc >= (uint64_t)nvert)
                return -1;  // corrupt prediction indices
            for (int c = 0; c < n; c++)
                values[i * n + c] +=
                    values[a * n + c] + values[b * n + c] - values[cc * n + c];
        }
        return 0;
    }
    for (int64_t i = 1; i < nvert; i++) {
        int64_t a = prediction[i * 3];
        if ((uint64_t)a >= (uint64_t)nvert) return -1;
        for (int c = 0; c < n; c++) values[i * n + c] += values[a * n + c];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Encoder-side topology build (encoder.py _build_topology): bucketed edge
// match. opposite[(f*3+k)*2 + {0,1}] = (opp_face, opp_side) or (-1,-1),
// first-claim-wins per undirected edge, both sides unset.
// ---------------------------------------------------------------------------

int uvt_corto_build_topology(const int32_t* faces, int64_t nface,
                             int64_t nvert, int32_t* opposite) {
    for (int64_t i = 0; i < nface * 3 * 2; i++) opposite[i] = -1;
    // bucket edges by min vertex
    std::vector<int32_t> head(nvert, -1);
    std::vector<int32_t> nxt(nface * 3, -1);
    std::vector<int32_t> other(nface * 3);
    for (int64_t fi = 0; fi < nface; fi++) {
        for (int k = 0; k < 3; k++) {
            int32_t a = faces[fi * 3 + (k + 1) % 3];
            int32_t b = faces[fi * 3 + (k + 2) % 3];
            int32_t lo = a < b ? a : b, hi = a < b ? b : a;
            int64_t e = fi * 3 + k;
            // search bucket for an unmatched edge with the same (lo,hi)
            int32_t found = -1;
            for (int32_t cur = head[lo]; cur != -1; cur = nxt[cur]) {
                if (other[cur] == hi && opposite[cur * 2] == -1) {
                    found = cur;
                    break;
                }
            }
            if (found != -1 && opposite[e * 2] == -1) {
                opposite[e * 2] = (int32_t)(found / 3);
                opposite[e * 2 + 1] = (int32_t)(found % 3);
                opposite[found * 2] = (int32_t)fi;
                opposite[found * 2 + 1] = k;
            } else {
                other[e] = hi;
                nxt[e] = head[lo];
                head[lo] = (int32_t)e;
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// CLER front machine, encode side (encoder.py _FrontMachine.encode_all).
// One call per group face range; `encoded`, vertex numbering, CLER and bit
// streams persist across calls through the state struct below.
// ---------------------------------------------------------------------------

struct CortoEncState {
    const int32_t* faces;
    const int32_t* topology;  // [nface*3*2]
    int64_t nface;
    int64_t nvert;
    int splitbits;
    std::vector<uint8_t> clers;
    BitWriter bw;
    std::vector<int32_t> encoded;     // original vertex -> new index or -1
    std::vector<int32_t> prediction;  // per new vertex: (t, a, b, c) originals
    std::vector<uint8_t> visited;
    int64_t current_vertex = 0;
    int64_t last_index = 0;
    int64_t max_front = 0;
};

void* uvt_corto_enc_new(const int32_t* faces, const int32_t* topology,
                        int64_t nface, int64_t nvert, int splitbits) {
    CortoEncState* st = new CortoEncState();
    st->faces = faces;
    st->topology = topology;
    st->nface = nface;
    st->nvert = nvert;
    st->splitbits = splitbits;
    st->encoded.assign(nvert, -1);
    st->visited.assign(nface, 0);
    st->prediction.reserve(nvert * 4);
    return st;
}

void uvt_corto_enc_free(void* p) { delete (CortoEncState*)p; }

// Encode faces in [face_start, face_end). Returns 0 on success.
int uvt_corto_enc_group(void* p, int64_t face_start, int64_t face_end) {
    CortoEncState* st = (CortoEncState*)p;
    const int32_t* faces = st->faces;
    const int32_t* topo = st->topology;

    std::vector<int32_t> e_face, e_side, e_prev, e_next;
    std::vector<uint8_t> e_del;
    std::vector<int64_t> faceorder, delayed;
    int64_t order = 0;
    int64_t new_edge = -1;
    int64_t current = face_start;
    int64_t totfaces = face_end - face_start;

    while (totfaces > 0) {
        if (new_edge == -1 && order >= (int64_t)faceorder.size() &&
            delayed.empty()) {
            while (current != face_end && st->visited[current]) current++;
            if (current == face_end) break;
            const int32_t* face = faces + current * 3;
            int64_t current_edge = (int64_t)e_face.size();
            uint32_t split = 0;
            for (int k = 0; k < 3; k++)
                if (st->encoded[face[k]] != -1) split |= 1u << k;
            if (split) {
                st->clers.push_back(CLER_SPLIT);
                st->bw.write(split, 3);
            } else {
                st->clers.push_back(CLER_VERTEX);
            }
            for (int k = 0; k < 3; k++) {
                int32_t vindex = face[k];
                if (st->encoded[vindex] != -1) {
                    st->bw.write((uint32_t)st->encoded[vindex], st->splitbits);
                } else {
                    st->prediction.push_back(vindex);
                    st->prediction.push_back((int32_t)st->last_index);
                    st->prediction.push_back((int32_t)st->last_index);
                    st->prediction.push_back((int32_t)st->last_index);
                    st->encoded[vindex] = (int32_t)st->current_vertex++;
                    st->last_index = vindex;
                }
            }
            for (int k = 0; k < 3; k++) {
                faceorder.push_back((int64_t)e_face.size());
                e_face.push_back((int32_t)current);
                e_side.push_back(k);
                e_prev.push_back((int32_t)(current_edge + (k + 2) % 3));
                e_next.push_back((int32_t)(current_edge + (k + 1) % 3));
                e_del.push_back(0);
            }
            st->visited[current] = 1;
            current++;
            totfaces--;
            continue;
        }

        int64_t c;
        if (new_edge != -1) {
            c = new_edge;
            new_edge = -1;
        } else if (order < (int64_t)faceorder.size()) {
            c = faceorder[order++];
        } else {
            c = delayed.back();
            delayed.pop_back();
        }

        if (e_del[c]) continue;

        int64_t eidx = (int64_t)e_face[c] * 3 + e_side[c];
        int32_t opposite_face = topo[eidx * 2];
        int32_t opposite_side = topo[eidx * 2 + 1];
        if (opposite_face == -1 || opposite_face >= face_end ||
            opposite_face < face_start || st->visited[opposite_face]) {
            st->clers.push_back(CLER_BOUNDARY);
            continue;
        }

        const int32_t* face = faces + (int64_t)opposite_face * 3;
        int k2 = opposite_side;
        int k0 = (k2 + 1) % 3;
        int k1 = (k0 + 1) % 3;

        int32_t eprev = e_prev[c];
        int32_t enext = e_next[c];
        int64_t pidx = (int64_t)e_face[eprev] * 3 + e_side[eprev];
        int64_t nidx = (int64_t)e_face[enext] * 3 + e_side[enext];
        bool close_left = topo[pidx * 2] == opposite_face;
        bool close_right = topo[nidx * 2] == opposite_face;
        new_edge = (int64_t)e_face.size();

        if (close_left && close_right) {
            st->clers.push_back(CLER_END);
            e_del[eprev] = 1;
            e_del[enext] = 1;
            e_next[e_prev[eprev]] = e_next[enext];
            e_prev[e_next[enext]] = e_prev[eprev];
            new_edge = -1;
        } else if (close_left) {
            st->clers.push_back(CLER_LEFT);
            e_del[eprev] = 1;
            int32_t pp = e_prev[eprev];  // copy: push_back may reallocate
            e_next[pp] = (int32_t)new_edge;
            e_prev[enext] = (int32_t)new_edge;
            e_face.push_back(opposite_face); e_side.push_back(k1);
            e_prev.push_back(pp); e_next.push_back(enext);
            e_del.push_back(0);
        } else if (close_right) {
            st->clers.push_back(CLER_RIGHT);
            e_del[enext] = 1;
            int32_t nn = e_next[enext];  // copy: push_back may reallocate
            e_prev[nn] = (int32_t)new_edge;
            e_next[eprev] = (int32_t)new_edge;
            e_face.push_back(opposite_face); e_side.push_back(k0);
            e_prev.push_back(eprev); e_next.push_back(nn);
            e_del.push_back(0);
        } else {
            int32_t v0 = face[k0];
            int32_t v1 = face[k1];
            int32_t opposite = face[k2];
            if (st->encoded[opposite] != -1 &&
                order < (int64_t)faceorder.size()) {
                delayed.push_back(c);
                st->clers.push_back(CLER_DELAY);
                new_edge = -1;
                continue;
            }
            if (st->encoded[opposite] != -1) {
                st->clers.push_back(CLER_SPLIT);
                st->bw.write((uint32_t)st->encoded[opposite], st->splitbits);
            } else {
                st->clers.push_back(CLER_VERTEX);
                int32_t v2 = faces[(int64_t)e_face[c] * 3 + e_side[c]];
                st->prediction.push_back(opposite);
                st->prediction.push_back(v0);
                st->prediction.push_back(v1);
                st->prediction.push_back(v2);
                st->encoded[opposite] = (int32_t)st->current_vertex++;
                st->last_index = opposite;
            }
            e_next[eprev] = (int32_t)new_edge;
            e_prev[enext] = (int32_t)(new_edge + 1);
            e_face.push_back(opposite_face); e_side.push_back(k0);
            e_prev.push_back(eprev); e_next.push_back((int32_t)(new_edge + 1));
            e_del.push_back(0);
            faceorder.push_back((int64_t)e_face.size());
            e_face.push_back(opposite_face); e_side.push_back(k1);
            e_prev.push_back((int32_t)new_edge); e_next.push_back(enext);
            e_del.push_back(0);
        }

        st->visited[opposite_face] = 1;
        totfaces--;
    }

    if ((int64_t)e_face.size() > st->max_front)
        st->max_front = (int64_t)e_face.size();
    return 0;
}

int64_t uvt_corto_enc_nclers(void* p) {
    return (int64_t)((CortoEncState*)p)->clers.size();
}
int64_t uvt_corto_enc_nwords(void* p) {
    CortoEncState* st = (CortoEncState*)p;
    return (int64_t)st->bw.words.size() + (st->bw.bits ? 1 : 0);
}
int64_t uvt_corto_enc_nverts(void* p) {
    return ((CortoEncState*)p)->current_vertex;
}
int64_t uvt_corto_enc_maxfront(void* p) {
    return ((CortoEncState*)p)->max_front;
}

// Copy results out. encoded[nvert], prediction[current_vertex*4].
int uvt_corto_enc_get(void* p, uint8_t* clers_out, uint32_t* words_out,
                      int32_t* encoded_out, int32_t* prediction_out) {
    CortoEncState* st = (CortoEncState*)p;
    memcpy(clers_out, st->clers.data(), st->clers.size());
    BitWriter bw = st->bw;  // copy so flush doesn't disturb further groups
    bw.flush();
    memcpy(words_out, bw.words.data(), bw.words.size() * 4);
    memcpy(encoded_out, st->encoded.data(), st->encoded.size() * 4);
    memcpy(prediction_out, st->prediction.data(), st->prediction.size() * 4);
    return 0;
}

// ---------------------------------------------------------------------------
// Tunstall greedy parse, encode side (tunstall.py compress): trie walk over
// the dictionary words. Tables are built in Python (format-critical, tiny);
// this is the per-byte parse loop. Returns output length or -1.
// ---------------------------------------------------------------------------

int64_t uvt_tunstall_parse(const uint8_t* words, const int32_t* index,
                           const int32_t* lengths, int n_words,
                           const uint8_t* data, int64_t n,
                           uint8_t* out, int64_t out_capacity) {
    // trie as node -> (byte -> node), word id at leaves. first_child tracks
    // insertion order for the tail-completion descent (must match the
    // Python implementation's dict-insertion-order tie-break).
    struct Node {
        int32_t word = -1;
        int32_t first_child = -1;
        std::unordered_map<uint8_t, int32_t> ch;
    };
    std::vector<Node> trie(1);
    for (int wi = 0; wi < n_words; wi++) {
        int32_t node = 0;
        for (int32_t j = 0; j < lengths[wi]; j++) {
            uint8_t b = words[index[wi] + j];
            auto it = trie[node].ch.find(b);
            if (it == trie[node].ch.end()) {
                int32_t child = (int32_t)trie.size();
                trie[node].ch.emplace(b, child);
                if (trie[node].first_child < 0) trie[node].first_child = child;
                node = child;
                trie.emplace_back();
            } else {
                node = it->second;
            }
        }
        trie[node].word = wi;
    }
    int64_t pos = 0, i = 0;
    while (i < n) {
        int32_t node = 0;
        int64_t j = i;
        while (j < n && trie[node].word < 0) {
            auto it = trie[node].ch.find(data[j]);
            if (it == trie[node].ch.end()) return -2;  // malformed dictionary
            node = it->second;
            j++;
        }
        if (trie[node].word >= 0) {
            if (pos >= out_capacity) return -1;
            out[pos++] = (uint8_t)trie[node].word;
            i = j;
        } else {
            // tail: input exhausted mid-word; descend to the first-inserted
            // child (matches the Python trie's insertion-order iteration)
            while (trie[node].word < 0) node = trie[node].first_child;
            if (pos >= out_capacity) return -1;
            out[pos++] = (uint8_t)trie[node].word;
            break;
        }
    }
    return pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tunstall dictionary construction (tunstall.py build_decoding_tables).
// WIRE-NORMATIVE: the decoder must rebuild bit-identical tables from the
// probability header, so the fixed-point arithmetic (<<8 / >>16), the
// tie-breaking order, and the low-entropy run-table branch follow the
// format's defining construction (see docs/ARCHITECTURE.md, "License
// posture") and cannot diverge.
// probs: (symbol, probability) byte pairs sorted by probability desc.
// Outputs: concatenated words buffer, index[256], lengths[256].
// Returns the word count (or -1 on overflow).
// ---------------------------------------------------------------------------

extern "C" int uvt_tunstall_tables(const uint8_t* syms_in, const uint8_t* probs_in,
                                   int n_symbols, uint8_t* words_out,
                                   int64_t words_capacity, int32_t* index_out,
                                   int32_t* lengths_out) {
    const int DICT = 256;
    if (n_symbols == 0) return 0;
    if (n_symbols == 1) {
        if (words_capacity < 1) return -1;
        words_out[0] = syms_in[0];
        index_out[0] = 0;
        lengths_out[0] = 1;
        return 1;
    }
    std::vector<int64_t> cand_probs(2 * DICT, 0);
    std::vector<int32_t> index(2 * DICT, 0), lengths(2 * DICT, 0);
    std::vector<uint8_t> word_buf(8192);
    int64_t buf_len = 0;
    std::vector<int32_t> row_head(n_symbols, 0);
    int64_t cand_end = 0;

    int64_t p0 = (int64_t)probs_in[0] << 8;
    int64_t p1 = (int64_t)probs_in[1] << 8;
    int64_t run_prob = (p0 * p0) >> 16;
    int run_cap = (DICT - 1) / (n_symbols - 1);
    int run_len = 2;
    while (run_prob > p1 && run_len < run_cap) {
        run_prob = (run_prob * p0) >> 16;
        run_len++;
    }

    int64_t dict_size;
    if (run_len >= 16) {
        word_buf[buf_len++] = syms_in[0];
        for (int k = 1; k < n_symbols; k++) {
            for (int c = 0; c < run_len - 1; c++) word_buf[buf_len++] = syms_in[0];
            word_buf[buf_len++] = syms_in[k];
        }
        row_head[0] = (run_len - 1) * n_symbols;
        for (int k = 1; k < n_symbols; k++) row_head[k] = k;
        run_prob = 0;
        for (int col = 0; col < run_len; col++) {
            for (int row = 1; row < n_symbols; row++) {
                int64_t dest = row + (int64_t)col * n_symbols;
                if (col == 0) cand_probs[dest] = (int64_t)probs_in[row] << 8;
                else cand_probs[dest] = (run_prob * ((int64_t)probs_in[row] << 8)) >> 16;
                index[dest] = row * run_len - col;
                lengths[dest] = col + 1;
            }
            if (col == 0) run_prob = p0;
            else run_prob = (run_prob * p0) >> 16;
        }
        int64_t first = (int64_t)(run_len - 1) * n_symbols;
        cand_probs[first] = run_prob;
        index[first] = 0;
        lengths[first] = run_len;
        dict_size = 1 + (int64_t)run_len * (n_symbols - 1);
        cand_end = (int64_t)run_len * n_symbols;
    } else {
        dict_size = n_symbols;
        for (int i = 0; i < n_symbols; i++) {
            row_head[i] = i;
            cand_probs[cand_end] = (int64_t)probs_in[i] << 8;
            index[cand_end] = (int32_t)buf_len;
            lengths[cand_end] = 1;
            cand_end++;
            word_buf[buf_len++] = syms_in[i];
        }
    }

    while (dict_size < DICT) {
        int argmax_row = 0;
        int64_t argmax_p = 0;
        for (int i = 0; i < n_symbols; i++) {
            int64_t p = cand_probs[row_head[i]];
            if (p > argmax_p) { argmax_row = i; argmax_p = p; }
        }
        int32_t head_id = row_head[argmax_row];
        int64_t head_prob = cand_probs[head_id];
        int32_t head_off = index[head_id];
        int32_t head_len = lengths[head_id];
        if (buf_len + (int64_t)(head_len + 1) * n_symbols + 16 > (int64_t)word_buf.size())
            word_buf.resize(word_buf.size() + std::max<int64_t>(8192, (int64_t)(head_len + 1) * n_symbols + 16));
        if (cand_end + n_symbols > (int64_t)cand_probs.size()) {
            cand_probs.resize(cand_end + n_symbols + DICT);
            index.resize(cand_end + n_symbols + DICT);
            lengths.resize(cand_end + n_symbols + DICT);
        }
        int r = 0;
        while (r < n_symbols) {
            cand_probs[cand_end] = (head_prob * ((int64_t)probs_in[r] << 8)) >> 16;
            index[cand_end] = (int32_t)buf_len;
            lengths[cand_end] = head_len + 1;
            cand_end++;
            memcpy(word_buf.data() + buf_len, word_buf.data() + head_off, head_len);
            buf_len += head_len;
            word_buf[buf_len++] = syms_in[r];
            if (dict_size + r == DICT - 1) break;
            r++;
        }
        if (r == n_symbols) row_head[argmax_row] += n_symbols;
        dict_size += n_symbols - 1;
    }

    // compact: skip removed words (rows whose start has advanced past them)
    int out_n = 0;
    int64_t wpos = 0;
    int row = 0;
    for (int64_t i = 0; i < cand_end && out_n < DICT; i++) {
        if (row >= n_symbols) row = 0;
        if (row_head[row] > i) { row++; continue; }
        int32_t len = lengths[i];
        if (wpos + len > words_capacity) return -1;
        memcpy(words_out + wpos, word_buf.data() + index[i], len);
        index_out[out_n] = (int32_t)wpos;
        lengths_out[out_n] = len;
        wpos += len;
        out_n++;
        row++;
    }
    return out_n;
}

// ---------------------------------------------------------------------------
// Octahedral normal dequantization (decoder.py _to_sphere over [N, 2] ints).
// ---------------------------------------------------------------------------

#include <cmath>

extern "C" int uvt_corto_normals_dequant(const int32_t* st, int64_t n,
                                         float unit, float* out) {
    for (int64_t i = 0; i < n; i++) {
        double x = st[i * 2], y = st[i * 2 + 1];
        double z = unit - std::fabs(x) - std::fabs(y);
        if (z < 0) {
            double ax = std::fabs(x), ay = std::fabs(y);
            double nx = (st[i * 2] > 0) ? unit - ay : ay - unit;
            double ny = (st[i * 2 + 1] > 0) ? unit - ax : ax - unit;
            x = nx; y = ny;
        }
        double norm = std::sqrt(x * x + y * y + z * z);
        if (norm > 0) {
            out[i * 3] = (float)(x / norm);
            out[i * 3 + 1] = (float)(y / norm);
            out[i * 3 + 2] = (float)(z / norm);
        } else {
            out[i * 3] = 0; out[i * 3 + 1] = 0; out[i * 3 + 2] = 1;
        }
    }
    return 0;
}
