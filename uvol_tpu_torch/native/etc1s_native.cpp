// uvol-tpu native ETC1S/BasisLZ slice emission (C ABI, ctypes-bound).
//
// The port's copy of the reference's native/etc1s_native.cpp, unchanged.
//
// Port of the per-block state machines in
// codecs/basis/etc1s_encode.py:encode_etc1s_slice_bits — the
// Python reference stays the spec; this is the ~240k-symbol/segment host
// serialization loop. One function serves both passes: mode 0 collects
// per-stream symbol frequencies, mode 1 emits LSB-first Huffman bits
// (codes supplied by the caller, canonical tables built in Python).
//
// Built by uvol_tpu_torch/native/__init__.py together with entropy.cpp.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// transcoder.py constants
enum { PRED_LEFT = 0, PRED_ABOVE = 1, PRED_CR = 2, PRED_EXPLICIT = 3 };
const int ENDPOINT_PRED_REPEAT_LAST = 256;

struct LsbBitWriter {
    uint8_t* out;
    int64_t cap_bits;
    int64_t pos = 0;
    bool overflow = false;

    LsbBitWriter(uint8_t* o, int64_t cap_bytes) : out(o), cap_bits(cap_bytes * 8) {}

    void put_bits(uint32_t value, int n) {
        if (pos + n > cap_bits) { overflow = true; return; }
        for (int i = 0; i < n; i++) {
            if ((value >> i) & 1) out[(pos + i) >> 3] |= (uint8_t)(1u << ((pos + i) & 7));
        }
        pos += n;
    }

    void put_vlc(uint32_t value, int chunk_bits) {
        uint32_t mask = (1u << chunk_bits) - 1;
        while (true) {
            uint32_t chunk = value & mask;
            value >>= chunk_bits;
            if (value) put_bits(chunk | (1u << chunk_bits), chunk_bits + 1);
            else { put_bits(chunk, chunk_bits + 1); return; }
        }
    }
};

struct ApproxMTF {
    std::vector<int32_t> v;
    explicit ApproxMTF(int size) : v(size, 0) {}
    void add(int32_t value) {
        int half = (int)v.size() / 2;
        for (int i = (int)v.size() - 1; i > half; i--) v[i] = v[i - 1];
        v[half] = value;
    }
    void use(int index) {
        if (index) std::swap(v[index - 1], v[index]);
    }
};

}  // namespace

extern "C" {

// mode 0: fill freq_* (sizes: pred 257, delta num_endpoints,
//         sel num_selectors+history_size+1, rle 64); returns 0.
// mode 1: emit bits using (codes, lens) per stream; returns bit count
//         (or -1 on buffer overflow).
int64_t uvt_etc1s_slice(
    const int32_t* eps, const int32_t* sels,
    const int32_t* prev_eps, const int32_t* prev_sels,
    int64_t nby, int64_t nbx,
    int num_endpoints, int num_selectors, int history_size, int mode,
    const uint32_t* pred_codes, const uint8_t* pred_lens,
    const uint32_t* delta_codes, const uint8_t* delta_lens,
    const uint32_t* sel_codes, const uint8_t* sel_lens,
    const uint32_t* rle_codes, const uint8_t* rle_lens,
    int64_t* freq_pred, int64_t* freq_delta, int64_t* freq_sel,
    int64_t* freq_rle,
    uint8_t* out_bits, int64_t out_capacity_bytes) {
    const bool is_p = prev_eps != nullptr;
    LsbBitWriter bw(out_bits, mode == 1 ? out_capacity_bytes : 0);

    auto emit = [&](int stream, int sym) {
        // stream: 0=pred 1=delta 2=sel 3=rle
        if (mode == 0) {
            switch (stream) {
                case 0: freq_pred[sym]++; break;
                case 1: freq_delta[sym]++; break;
                case 2: freq_sel[sym]++; break;
                case 3: freq_rle[sym]++; break;
            }
        } else {
            switch (stream) {
                case 0: bw.put_bits(pred_codes[sym], pred_lens[sym]); break;
                case 1: bw.put_bits(delta_codes[sym], delta_lens[sym]); break;
                case 2: bw.put_bits(sel_codes[sym], sel_lens[sym]); break;
                case 3: bw.put_bits(rle_codes[sym], rle_lens[sym]); break;
            }
        }
    };

    // prediction choice per block (stable across both passes)
    std::vector<int32_t> pred(nby * nbx, PRED_EXPLICIT);
    for (int64_t by = 0; by < nby; by++) {
        for (int64_t bx = 0; bx < nbx; bx++) {
            int64_t i = by * nbx + bx;
            int32_t ep = eps[i];
            if (is_p && ep == prev_eps[i] && sels[i] == prev_sels[i]) {
                pred[i] = PRED_CR;
            } else if (bx > 0 && ep == eps[i - 1]) {
                pred[i] = PRED_LEFT;
            } else if (by > 0 && ep == eps[i - nbx]) {
                pred[i] = PRED_ABOVE;
            } else {
                pred[i] = PRED_EXPLICIT;
            }
        }
    }

    // quad symbols + literal/repeat plan
    std::vector<int32_t> quad_syms;
    quad_syms.reserve(((nby + 1) / 2) * ((nbx + 1) / 2));
    for (int64_t by = 0; by < nby; by += 2) {
        for (int64_t bx = 0; bx < nbx; bx += 2) {
            int p00 = pred[by * nbx + bx];
            int p01 = (bx + 1 < nbx) ? pred[by * nbx + bx + 1] : 0;
            int p10 = (by + 1 < nby) ? pred[(by + 1) * nbx + bx] : 0;
            int p11 = (by + 1 < nby && bx + 1 < nbx)
                          ? pred[(by + 1) * nbx + bx + 1]
                          : 0;
            quad_syms.push_back(p00 | (p01 << 2) | (p10 << 4) | (p11 << 6));
        }
    }
    // plan[i] = (sym, extra) with sym -1 meaning "no emission"
    std::vector<int32_t> plan_sym(quad_syms.size(), -1);
    std::vector<int32_t> plan_extra(quad_syms.size(), -1);
    {
        size_t i = 0;
        while (i < quad_syms.size()) {
            int32_t sym = quad_syms[i];
            size_t run = 1;
            while (i + run < quad_syms.size() && quad_syms[i + run] == sym)
                run++;
            plan_sym[i] = sym;
            int64_t rest = (int64_t)run - 1;
            if (rest >= 3) {
                plan_sym[i + 1] = ENDPOINT_PRED_REPEAT_LAST;
                plan_extra[i + 1] = (int32_t)(rest - 3);
            } else {
                for (size_t k = 1; k < run; k++) plan_sym[i + k] = sym;
            }
            i += run;
        }
    }

    ApproxMTF hist(history_size);
    int32_t prev_ep_v = 0;
    int64_t sel_rle_left = 0;
    size_t qi = 0;
    for (int64_t by = 0; by < nby; by++) {
        for (int64_t bx = 0; bx < nbx; bx++) {
            if ((by & 1) == 0 && (bx & 1) == 0) {
                int32_t sym = plan_sym[qi];
                int32_t extra = plan_extra[qi];
                qi++;
                if (sym >= 0) {
                    emit(0, sym);
                    if (sym == ENDPOINT_PRED_REPEAT_LAST && mode == 1)
                        bw.put_vlc((uint32_t)extra, 4);
                }
            }

            int64_t i = by * nbx + bx;
            int p = pred[i];
            int32_t sel = sels[i];

            if (p != PRED_CR) {
                int32_t ep = eps[i];
                if (p == PRED_EXPLICIT) {
                    int64_t d = (int64_t)ep - prev_ep_v;
                    d %= num_endpoints;
                    if (d < 0) d += num_endpoints;
                    emit(1, (int)d);
                }
                prev_ep_v = ep;
            }

            if (sel_rle_left) { sel_rle_left--; continue; }
            if (sel == hist.v[0] || p == PRED_CR) {
                // run of hist[0]-or-wildcard blocks starting here
                int64_t run = 0;
                int64_t yy = by, xx = bx;
                while (yy < nby) {
                    int64_t j = yy * nbx + xx;
                    if (sels[j] == hist.v[0] || pred[j] == PRED_CR) run++;
                    else break;
                    if (++xx == nbx) { xx = 0; yy++; }
                }
                if (run >= 2) {
                    int64_t base_rle = (run - 1) - 1;
                    if (base_rle >= 63) {
                        emit(2, num_selectors + history_size);
                        emit(3, 63);
                        if (mode == 1)
                            bw.put_vlc((uint32_t)(base_rle - 63), 7);
                    } else {
                        emit(2, num_selectors + history_size);
                        emit(3, (int)base_rle);
                    }
                    sel_rle_left = run - 1;
                } else {
                    emit(2, num_selectors + 0);
                    hist.use(0);
                }
                continue;
            }
            int idx = -1;
            for (int k = 0; k < history_size; k++) {
                if (hist.v[k] == sel) { idx = k; break; }
            }
            if (idx > 0) {
                emit(2, num_selectors + idx);
                hist.use(idx);
            } else {
                emit(2, sel);
                hist.add(sel);
            }
        }
    }
    if (mode == 1) return bw.overflow ? -1 : bw.pos;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Slice decode (transcoder.py decode_etc1s_slice): the playback-side block
// state machine. Huffman decode via 16-bit flat lookup tables built by the
// caller: lut[next16bits] = (sym << 5) | code_len, 0 = invalid.
// ---------------------------------------------------------------------------

namespace {

struct LsbBitReader {
    const uint8_t* data;
    int64_t nbytes;
    int64_t pos = 0;  // bit position

    uint32_t peek16() const {
        int64_t byte = pos >> 3;
        uint32_t v = 0;
        // little-endian 24-bit window, zero-padded past the end
        for (int k = 0; k < 3; k++)
            v |= (uint32_t)(byte + k < nbytes ? data[byte + k] : 0) << (8 * k);
        return (v >> (pos & 7)) & 0xFFFF;
    }

    uint32_t get_bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) {
            int64_t b = pos >> 3;
            uint32_t bit = b < nbytes ? (data[b] >> (pos & 7)) & 1 : 0;
            v |= bit << i;
            pos++;
        }
        return v;
    }

    int decode(const uint32_t* lut) {
        uint32_t e = lut[peek16()];
        if (e == 0) return -1;
        pos += (int)(e & 31);
        return (int)(e >> 5);
    }

    uint32_t get_vlc(int chunk_bits) {
        uint32_t v = 0;
        int ofs = 0;
        while (true) {
            uint32_t s = get_bits(chunk_bits + 1);
            v |= (s & ((1u << chunk_bits) - 1)) << ofs;
            ofs += chunk_bits;
            if (!(s & (1u << chunk_bits))) return v;
        }
    }
};

}  // namespace

extern "C" int64_t uvt_etc1s_slice_decode(
    const uint8_t* data, int64_t nbytes, int64_t nby, int64_t nbx,
    int num_endpoints, int num_selectors, int history_size,
    const int32_t* prev,  // [nby*nbx*2] or null
    const uint32_t* lut_pred, const uint32_t* lut_delta,
    const uint32_t* lut_sel, const uint32_t* lut_rle,
    int32_t* out) {
    const int ENDPOINT_PRED_REPEAT = 256;
    LsbBitReader br{data, nbytes};
    ApproxMTF hist(history_size);

    int64_t pred_rle = 0;
    int prev_sym = 0, cur_bits = 0;
    int32_t prev_ep = 0;
    int64_t sel_rle = 0;
    std::vector<int32_t> stored(nbx, 0);
    bool bad = false;

    auto decode_selector = [&]() -> int32_t {
        int sym = br.decode(lut_sel);
        if (sym < 0) { bad = true; return 0; }
        if (sym == num_selectors + history_size) {
            int rle = br.decode(lut_rle);
            if (rle < 0) { bad = true; return 0; }
            if (rle == 63) rle += (int)br.get_vlc(7);
            sel_rle = rle + 1;
            return hist.v[0];
        }
        if (sym >= num_selectors) {
            int idx = sym - num_selectors;
            int32_t s = hist.v[idx];
            hist.use(idx);
            return s;
        }
        hist.add(sym);
        return sym;
    };

    for (int64_t by = 0; by < nby && !bad; by++) {
        for (int64_t bx = 0; bx < nbx; bx++) {
            int pred;
            if ((by & 1) == 0 && (bx & 1) == 0) {
                if (pred_rle) {
                    pred_rle--;
                    cur_bits = prev_sym;
                } else {
                    cur_bits = br.decode(lut_pred);
                    if (cur_bits < 0) { bad = true; break; }
                    if (cur_bits == ENDPOINT_PRED_REPEAT) {
                        pred_rle = (int64_t)br.get_vlc(4) + 2;
                        cur_bits = prev_sym;
                    } else {
                        prev_sym = cur_bits;
                    }
                }
                stored[bx] = (cur_bits >> 4) & 3;
                if (bx + 1 < nbx) stored[bx + 1] = (cur_bits >> 6) & 3;
                pred = cur_bits & 3;
            } else if ((by & 1) == 0) {
                pred = (cur_bits >> 2) & 3;
            } else {
                pred = stored[bx];
            }

            int64_t i = (by * nbx + bx) * 2;
            if (pred == PRED_CR) {
                out[i] = prev ? prev[i] : 0;
                out[i + 1] = prev ? prev[i + 1] : 0;
                if (sel_rle) sel_rle--;
                else decode_selector();
                continue;
            }

            int32_t ep;
            if (pred == PRED_LEFT) {
                // bx==0 wraps to the same row's last block — not yet
                // decoded, so 0 (mirrors the Python decoder's negative
                // indexing; real basisu streams do emit these on edges)
                int64_t src = by * nbx + (bx == 0 ? nbx - 1 : bx - 1);
                ep = out[src * 2];
            } else if (pred == PRED_ABOVE) {
                int64_t src = (by == 0 ? nby - 1 : by - 1) * nbx + bx;
                ep = out[src * 2];
            } else {
                int delta = br.decode(lut_delta);
                if (delta < 0) { bad = true; break; }
                ep = prev_ep + delta;
                if (ep >= num_endpoints) ep -= num_endpoints;
            }
            prev_ep = ep;

            int32_t sel;
            if (sel_rle) { sel_rle--; sel = hist.v[0]; }
            else sel = decode_selector();
            out[i] = ep;
            out[i + 1] = sel;
        }
    }
    return bad ? -1 : br.pos;
}

// ---------------------------------------------------------------------------
// Global palette decode loops (transcoder.py decode_endpoints /
// decode_selectors tails). Huffman tables are parsed in Python; these are
// the per-entry symbol loops, driven by 16-bit flat LUTs.
// ---------------------------------------------------------------------------

extern "C" int64_t uvt_etc1s_palette_endpoints(
    const uint8_t* data, int64_t nbytes, int64_t bit_pos,
    int64_t num_endpoints, int grayscale,
    const uint32_t* lut0, const uint32_t* lut1, const uint32_t* lut2,
    const uint32_t* lut_inten,
    uint8_t* color5_out,  // [E, 3]
    uint8_t* inten_out    // [E]
) {
    LsbBitReader br{data, nbytes};
    br.pos = bit_pos;
    int prev_color5[3] = {16, 16, 16};
    int prev_inten = 0;
    const int pal0_hi = 9, pal1_hi = 21;  // COLOR5_PAL{0,1}_PREV_HI
    for (int64_t i = 0; i < num_endpoints; i++) {
        int d = br.decode(lut_inten);
        if (d < 0) return -1;
        prev_inten = (d + prev_inten) & 7;
        inten_out[i] = (uint8_t)prev_inten;
        int nchan = grayscale ? 1 : 3;
        for (int c = 0; c < nchan; c++) {
            int prev = prev_color5[c];
            const uint32_t* lut =
                prev <= pal0_hi ? lut0 : (prev <= pal1_hi ? lut1 : lut2);
            int delta = br.decode(lut);
            if (delta < 0) return -1;
            int v = (prev + delta) & 31;
            color5_out[i * 3 + c] = (uint8_t)v;
            prev_color5[c] = v;
        }
        if (grayscale) {
            color5_out[i * 3 + 1] = color5_out[i * 3];
            color5_out[i * 3 + 2] = color5_out[i * 3];
            prev_color5[1] = prev_color5[0];
            prev_color5[2] = prev_color5[0];
        }
    }
    return br.pos;
}

extern "C" int64_t uvt_etc1s_palette_selectors(
    const uint8_t* data, int64_t nbytes, int64_t bit_pos,
    int64_t num_selectors, const uint32_t* lut_delta,
    uint8_t* out  // [S, 16] codes 0..3, row-major y*4+x
) {
    LsbBitReader br{data, nbytes};
    br.pos = bit_pos;
    int prev_bytes[4] = {0, 0, 0, 0};
    for (int64_t i = 0; i < num_selectors; i++) {
        for (int y = 0; y < 4; y++) {
            int d = br.decode(lut_delta);
            if (d < 0) return -1;
            int byte = d ^ prev_bytes[y];
            prev_bytes[y] = byte;
            for (int x = 0; x < 4; x++)
                out[i * 16 + y * 4 + x] = (uint8_t)((byte >> (2 * x)) & 3);
        }
    }
    return br.pos;
}

// ---------------------------------------------------------------------------
// Canonical Huffman table parse (transcoder.py read_huffman_table): the
// code-length-coded size stream, decoded with a locally built 7-bit flat
// table for the 21 code-length codes. Writes the symbol code sizes and
// returns the new bit position (or a negative error). *out_n = 0 means a
// null table (total_used_syms == 0).
// ---------------------------------------------------------------------------
extern "C" int64_t uvt_huffman_read_table(
    const uint8_t* data, int64_t nbytes, int64_t bit_pos,
    uint8_t* out_sizes,  // cap 1 << 14
    int64_t* out_n) {
    LsbBitReader br{data, nbytes};
    br.pos = bit_pos;
    static const int ORDER[21] = {17, 18, 19, 20, 0, 8, 7, 9,  6, 10, 5,
                                  11, 4,  12, 3,  13, 2, 14, 1, 15, 16};
    int64_t total = br.get_bits(14);
    *out_n = total;
    if (total == 0) return br.pos;
    if (total > (1 << 14)) return -1;
    int num_cl = (int)br.get_bits(5);
    if (num_cl > 21) return -1;
    int cl_sizes[21] = {0};
    for (int i = 0; i < num_cl; i++) cl_sizes[ORDER[i]] = (int)br.get_bits(3);

    // canonical assignment by (length, symbol), codes bit-reversed for the
    // LSB-first reader; 7-bit flat lut entry = (sym << 5) | len
    uint32_t cl_lut[128] = {0};
    {
        int code = 0;
        for (int len = 1; len <= 7; len++) {
            for (int sym = 0; sym < 21; sym++) {
                if (cl_sizes[sym] != len) continue;
                int rev = 0, c = code;
                for (int k = 0; k < len; k++) {
                    rev = (rev << 1) | (c & 1);
                    c >>= 1;
                }
                for (int f = rev; f < 128; f += 1 << len)
                    cl_lut[f] = ((uint32_t)sym << 5) | (uint32_t)len;
                code++;
            }
            code <<= 1;
        }
    }
    auto cl_decode = [&]() -> int {
        int64_t byte = br.pos >> 3;
        uint32_t v = 0;
        for (int k = 0; k < 2; k++)
            v |= (uint32_t)(byte + k < nbytes ? data[byte + k] : 0) << (8 * k);
        uint32_t e = cl_lut[(v >> (br.pos & 7)) & 0x7F];
        if (e == 0) return -1;
        br.pos += (int)(e & 31);
        return (int)(e >> 5);
    };

    std::memset(out_sizes, 0, (size_t)total);
    int64_t cur = 0;
    int prev_nonzero = 0;
    while (cur < total) {
        int c = cl_decode();
        if (c < 0) return -1;
        if (c <= 16) {
            out_sizes[cur++] = (uint8_t)c;
            if (c) prev_nonzero = c;
        } else if (c == 17) {  // small zero run
            cur += (int)br.get_bits(3) + 3;
        } else if (c == 18) {  // big zero run
            cur += (int)br.get_bits(7) + 11;
        } else if (c == 19 || c == 20) {  // repeats of previous nonzero
            int rep = c == 19 ? (int)br.get_bits(2) + 3
                              : (int)br.get_bits(7) + 7;
            if (cur + rep > total) return -1;
            for (int k = 0; k < rep; k++) out_sizes[cur++] = (uint8_t)prev_nonzero;
        } else {
            return -1;
        }
    }
    return br.pos;
}

// ---------------------------------------------------------------------------
// One-pass ETC1 word emission (transcoder.py etc1_word_tables apply step).
// blocks [n,2] int32 palette indices -> out [n,2] uint32 ETC1 words via the
// per-palette-entry LUTs; replaces two numpy fancy-gathers + an np.stack
// (three temporaries per 64K-block frame in the playback hot loop).
// ---------------------------------------------------------------------------
extern "C" int uvt_etc1s_words(const int32_t* blocks, int64_t n,
                               const uint32_t* word1_of, int64_t n_e,
                               const uint32_t* word2_of, int64_t n_s,
                               uint32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int32_t e = blocks[i * 2];
        const int32_t s = blocks[i * 2 + 1];
        if (e < 0 || e >= n_e || s < 0 || s >= n_s) return -1;
        out[i * 2] = word1_of[e];
        out[i * 2 + 1] = word2_of[s];
    }
    return 0;
}
