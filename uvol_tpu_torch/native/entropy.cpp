// uvol-tpu native entropy hot loops (C ABI, ctypes-bound).
//
// The port's copy of the reference's native/entropy.cpp, unchanged: the
// sequential host serialization loops that Python is too slow for at
// production frame rates, the Draco-format rANS symbol decode/encode
// (codecs/rans.py and codecs/symbol_coding.py are the bit-exact Python
// paths these mirror) and the Corto Tunstall expand
// (codecs/corto/tunstall.py).
//
// Built by uvol_tpu_torch/native/__init__.py together with etc1s_native.cpp,
// and linked into the Draco and the Corto libraries.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// rANS (Draco wire layout; see codecs/rans.py for the format notes)
// ---------------------------------------------------------------------------

// Decode `n` symbols. probs: probability table summing to `precision`.
// buf: the rANS byte buffer (renorm bytes + final-state marker).
// Returns 0 on success.
int uvt_rans_decode(const uint32_t* probs, int num_probs, int precision_bits,
                    const uint8_t* buf, int buf_len, uint32_t* out, int n) {
    const uint32_t precision = 1u << precision_bits;
    const uint32_t l_base = precision * 4;

    // slot -> symbol lookup + cumulative table
    std::vector<uint32_t> lut(precision);
    std::vector<uint32_t> cum(num_probs + 1, 0);
    uint32_t c = 0;
    for (int s = 0; s < num_probs; s++) {
        cum[s] = c;
        for (uint32_t k = 0; k < probs[s]; k++) lut[c + k] = s;
        c += probs[s];
    }
    if (c != precision) return -1;

    // read final state from the marker at the end of the buffer
    uint64_t state;
    int offset;
    const uint8_t* b = buf;
    int nb = buf_len;
    uint32_t x = b[nb - 1] >> 6;
    if (x == 0) {
        state = (b[nb - 1] & 0x3F);
        offset = nb - 1;
    } else if (x == 1) {
        state = (b[nb - 2] | (uint32_t(b[nb - 1]) << 8)) & 0x3FFF;
        offset = nb - 2;
    } else if (x == 2) {
        state = (b[nb - 3] | (uint32_t(b[nb - 2]) << 8) |
                 (uint32_t(b[nb - 1]) << 16)) & 0x3FFFFF;
        offset = nb - 3;
    } else {
        state = (b[nb - 4] | (uint32_t(b[nb - 3]) << 8) |
                 (uint32_t(b[nb - 2]) << 16) | (uint32_t(b[nb - 1]) << 24)) &
                0x3FFFFFFF;
        offset = nb - 4;
    }
    state += l_base;

    // precision is a power of two: mask/shift instead of runtime div/mod
    // (the division by a non-constant was ~2x the whole symbol loop)
    const uint32_t mask = precision - 1;
    for (int i = 0; i < n; i++) {
        while (state < l_base && offset > 0) {
            offset--;
            state = state * 256 + b[offset];
        }
        uint32_t rem = (uint32_t)state & mask;
        uint32_t sym = lut[rem];
        state = (state >> precision_bits) * probs[sym] + rem - cum[sym];
        out[i] = sym;
    }
    return 0;
}

// Encode `n` symbols; writes rANS bytes (renorm + marker) into out.
// Returns the payload length, or -1 on overflow.
int uvt_rans_encode(const uint32_t* probs, int num_probs, int precision_bits,
                    const uint32_t* symbols, int n, uint8_t* out,
                    int out_capacity) {
    const uint64_t precision = 1ull << precision_bits;
    const uint64_t l_base = precision * 4;
    std::vector<uint64_t> cum(num_probs + 1, 0);
    for (int s = 0; s < num_probs; s++) cum[s + 1] = cum[s] + probs[s];

    // per-symbol reciprocals: at the division site state < 1024*p (the
    // renorm loop guarantees it), so a 32-bit reciprocal estimate plus a
    // <=2-step fixup gives the exact quotient without a hardware divide
    // (the per-symbol udiv dominated this loop)
    std::vector<uint64_t> recip(num_probs, 0);
    for (int s = 0; s < num_probs; s++)
        if (probs[s]) recip[s] = ((uint64_t)1 << 32) / probs[s];

    std::vector<uint8_t> renorm;
    renorm.reserve(n);
    uint64_t state = l_base;
    const uint64_t upper_factor = 256 * (l_base / precision);
    for (int i = n - 1; i >= 0; i--) {
        uint32_t s = symbols[i];
        uint64_t p = probs[s];
        if (p == 0) return -1;  // keep the old SIGFPE fail-fast as an error
        uint64_t bound = upper_factor * p;
        while (state >= bound) {
            renorm.push_back((uint8_t)(state & 0xFF));
            state >>= 8;
        }
        uint64_t q = (state * recip[s]) >> 32;  // state < 2^30: no overflow
        uint64_t r = state - q * p;
        while (r >= p) { q++; r -= p; }
        state = q * precision + r + cum[s];
    }
    // final-state marker
    uint8_t marker[4];
    int mlen;
    uint64_t st = state - l_base;
    if (st < (1ull << 6)) {
        marker[0] = (uint8_t)st;
        mlen = 1;
    } else if (st < (1ull << 14)) {
        uint32_t v = (1u << 14) | (uint32_t)st;
        marker[0] = v & 0xFF;
        marker[1] = v >> 8;
        mlen = 2;
    } else if (st < (1ull << 22)) {
        uint32_t v = (2u << 22) | (uint32_t)st;
        marker[0] = v & 0xFF;
        marker[1] = (v >> 8) & 0xFF;
        marker[2] = v >> 16;
        mlen = 3;
    } else if (st < (1ull << 30)) {
        uint32_t v = (3u << 30) | (uint32_t)st;
        marker[0] = v & 0xFF;
        marker[1] = (v >> 8) & 0xFF;
        marker[2] = (v >> 16) & 0xFF;
        marker[3] = v >> 24;
        mlen = 4;
    } else {
        return -1;
    }
    int total = (int)renorm.size() + mlen;
    if (total > out_capacity) return -1;
    memcpy(out, renorm.data(), renorm.size());
    memcpy(out + renorm.size(), marker, mlen);
    return total;
}

// ---------------------------------------------------------------------------
// Tunstall decompress (Corto): words/lengths tables are built in Python
// (format-critical); this is just the byte-expansion hot loop.
// ---------------------------------------------------------------------------

// words: concatenated dictionary words; index/lengths: per-symbol extents.
int uvt_tunstall_expand(const uint8_t* words, const int32_t* index,
                        const int32_t* lengths, const uint8_t* comp,
                        int comp_len, uint8_t* out, int out_size) {
    if (comp_len == 0) return 0;
    int pos = 0;
    for (int k = 0; k < comp_len - 1; k++) {
        int s = comp[k];
        int len = lengths[s];
        if (pos + len > out_size) return -1;
        memcpy(out + pos, words + index[s], len);
        pos += len;
    }
    int s = comp[comp_len - 1];
    int rest = out_size - pos;
    if (rest < 0) return -1;
    memcpy(out + pos, words + index[s],
           rest < lengths[s] ? rest : lengths[s]);
    return 0;
}

// ---------------------------------------------------------------------------
// One-call RAW symbol-stream encode (symbol_coding._encode_raw tail):
// bincount -> normalize_probabilities -> token-coded table -> rANS payload
// with varint length. Byte-exact with the Python reference (rans.py
// normalize_probabilities, encode_probability_table) — locked by the
// encoder byte-stability fixtures. Returns bytes written, or <0 on
// overflow / a nonzero-alphabet that cannot fit the precision (caller
// falls back to Python, which raises the documented error).
// ---------------------------------------------------------------------------

int64_t uvt_rans_symbol_encode(const uint32_t* symbols, int64_t n,
                               int64_t alphabet, int precision_bits,
                               uint8_t* out, int64_t cap) {
    if (n <= 0 || alphabet <= 0) return -1;
    const int64_t precision = (int64_t)1 << precision_bits;
    std::vector<int64_t> counts(alphabet, 0);
    for (int64_t i = 0; i < n; ++i) {
        if (symbols[i] >= (uint64_t)alphabet) return -1;
        counts[symbols[i]]++;
    }
    int64_t total = n;
    int64_t nonzero = 0;
    for (int64_t c : counts) nonzero += c != 0;
    if (nonzero > precision) return -3;

    // normalize (rans.py:83): floor-scale with min 1, then push the
    // rounding error onto symbols in descending-probability order
    // (stable: ties keep index order, matching Python's sorted())
    std::vector<int64_t> probs(alphabet, 0);
    int64_t used = 0;
    for (int64_t i = 0; i < alphabet; ++i) {
        if (!counts[i]) continue;
        int64_t p = counts[i] * precision / total;
        probs[i] = p > 1 ? p : 1;
        used += probs[i];
    }
    int64_t err = precision - used;
    if (err != 0) {
        std::vector<int32_t> order(alphabet);
        for (int64_t i = 0; i < alphabet; ++i) order[i] = (int32_t)i;
        std::stable_sort(order.begin(), order.end(),
                         [&](int32_t a, int32_t b) { return probs[a] > probs[b]; });
        int64_t k = 0;
        while (err != 0) {
            int64_t i = order[k % alphabet];
            int64_t step = err;
            if (probs[i] + step < 1) step = 1 - probs[i];
            probs[i] += step;
            err -= step;
            k++;
        }
    }

    // emit: varint alphabet + token table + varint payload + payload
    int64_t w = 0;
    auto put = [&](uint8_t b) -> bool {
        if (w >= cap) return false;
        out[w++] = b;
        return true;
    };
    auto varint = [&](uint64_t v) -> bool {
        while (v >= 0x80) {
            if (!put((uint8_t)(v) | 0x80)) return false;
            v >>= 7;
        }
        return put((uint8_t)v);
    };
    if (!varint((uint64_t)alphabet)) return -2;
    for (int64_t i = 0; i < alphabet;) {
        int64_t p = probs[i];
        if (p == 0) {
            int64_t run = 1;
            while (i + run < alphabet && run < 64 && probs[i + run] == 0) run++;
            if (!put((uint8_t)(((run - 1) << 2) | 3))) return -2;
            i += run;
            continue;
        }
        int extra = 0;
        if (p >= (1 << 6)) extra++;
        if (p >= (1 << 14)) extra++;
        if (!put((uint8_t)(((p << 2) | extra) & 0xFF))) return -2;
        for (int b = 1; b <= extra; ++b)
            if (!put((uint8_t)((p >> (8 * b - 2)) & 0xFF))) return -2;
        i++;
    }
    // payload into the tail of the buffer, then move behind the varint
    std::vector<uint32_t> probs32(alphabet);
    for (int64_t i = 0; i < alphabet; ++i) probs32[i] = (uint32_t)probs[i];
    std::vector<uint8_t> payload(n * 4 + 1024);
    int plen = uvt_rans_encode(probs32.data(), (int)alphabet, precision_bits,
                               symbols, (int)n, payload.data(),
                               (int)payload.size());
    if (plen < 0) return -2;
    if (!varint((uint64_t)plen)) return -2;
    if (w + plen > cap) return -2;
    memcpy(out + w, payload.data(), plen);
    return w + plen;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// One-call Draco rANS symbol stream decode: varint num_symbols, token-coded
// probability table, varint payload size, rANS bytes. Replaces the Python
// header parse + LUT build + per-call glue (codecs/rans.py
// RansSymbolDecoder + decode_probability_table).
// Returns the new buffer position, or -1 on malformed input.
// ---------------------------------------------------------------------------

extern "C" int64_t uvt_rans_stream_decode(
    const uint8_t* data, int64_t end, int64_t pos,
    int precision_bits, int64_t n, uint32_t* out) {
    auto varint = [&](int64_t* p) -> uint64_t {
        uint64_t result = 0;
        int shift = 0;
        while (*p < end) {
            uint8_t b = data[(*p)++];
            result |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) return result;
            shift += 7;
        }
        return (uint64_t)-1;
    };

    int64_t num_symbols = (int64_t)varint(&pos);
    if (num_symbols < 0 || pos >= end) return -1;
    std::vector<uint32_t> probs(num_symbols, 0);
    int64_t i = 0;
    while (i < num_symbols) {
        if (pos >= end) return -1;
        uint8_t d = data[pos++];
        int token = d & 3;
        if (token == 3) {
            i += (d >> 2) + 1;
            continue;
        }
        uint32_t p = d >> 2;
        for (int b = 1; b <= token; b++) {
            if (pos >= end) return -1;
            p |= (uint32_t)data[pos++] << (8 * b - 2);
        }
        probs[i++] = p;
    }
    const uint32_t precision = 1u << precision_bits;
    uint64_t total = 0;
    for (int64_t s = 0; s < num_symbols; s++) total += probs[s];
    if (total != precision) return -1;

    uint64_t size = varint(&pos);
    if (size == (uint64_t)-1 || pos + (int64_t)size > end) return -1;
    int rc = uvt_rans_decode(probs.data(), (int)num_symbols, precision_bits,
                             data + pos, (int)size, out, (int)n);
    if (rc != 0) return -1;
    return pos + (int64_t)size;
}
