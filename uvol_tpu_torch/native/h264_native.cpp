// Native H.264 baseline-intra slice codec — the hot path behind
// codecs/h264.py's compressed V1 texture track. Bit-identical port of
// codecs/h264_intra.py (the Python SliceCoder stays as oracle and
// fallback; parity locked by tests/test_h264_intra.py):
//   encode: I_4x4 mode decision (SAD + mode-bit cost), chroma DC/H/V,
//           per-MB I_PCM escape rows, CAVLC, full slice RBSP emit.
//   decode: I_PCM + I_4x4 + I_16x16 + all chroma modes, slice-header
//           parse for the SPS/PPS shapes the Python layer validates.
// Build: g++ -O3 -shared -fPIC h264_native.cpp -o libuvt_h264.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <vector>

namespace {

#include "h264_tables.inc"

// ---------------------------------------------------------------------------
// Bit I/O (MSB-first) + Exp-Golomb
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t *d;
  long nbits, pos = 0;
  bool ok = true;
  BitReader(const uint8_t *data, long nbytes) : d(data), nbits(8 * nbytes) {}
  uint32_t u(int bits) {
    if (pos + bits > nbits) { ok = false; return 0; }
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) {
      v = (v << 1) | ((d[pos >> 3] >> (7 - (pos & 7))) & 1);
      ++pos;
    }
    return v;
  }
  uint32_t ue() {
    int zeros = 0;
    while (ok && u(1) == 0) {
      if (++zeros > 31) { ok = false; return 0; }
    }
    return ((1u << zeros) - 1) + (zeros ? u(zeros) : 0);
  }
  int32_t se() {
    uint32_t k = ue();
    return (k % 2) ? (int32_t)((k + 1) / 2) : -(int32_t)(k / 2);
  }
  void align() { pos = (pos + 7) & ~7L; }
  const uint8_t *bytes_at(long n) {
    if (pos % 8 || pos + 8 * n > nbits) { ok = false; return nullptr; }
    const uint8_t *p = d + (pos >> 3);
    pos += 8 * n;
    return p;
  }
};

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint32_t acc = 0;
  int n = 0;
  void u(uint32_t v, int bits) {
    for (int i = bits - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++n == 8) { bytes.push_back((uint8_t)acc); acc = 0; n = 0; }
    }
  }
  void ue(uint32_t v) {
    ++v;
    int nb = 32 - __builtin_clz(v);
    u(0, nb - 1);
    u(v, nb);
  }
  void se(int32_t v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
  void align() { while (n) u(0, 1); }
  void append(const BitWriter &o) {  // bit-level concat (RD winner splice)
    for (uint8_t b : o.bytes) u(b, 8);
    if (o.n) u(o.acc, o.n);
  }
  void raw(const uint8_t *p, long len) {
    bytes.insert(bytes.end(), p, p + len);
  }
  void trailing() { u(1, 1); align(); }
};

int read_vlc(BitReader &r, const uint8_t *lens, const uint8_t *bits, int n,
             int max_len = 24) {
  uint32_t code = 0;
  for (int length = 1; length <= max_len; ++length) {
    if (!r.ok) return -1;
    code = (code << 1) | r.u(1);
    for (int i = 0; i < n; ++i)
      if (lens[i] == length && bits[i] == code) return i;
  }
  r.ok = false;
  return -1;
}

// ---------------------------------------------------------------------------
// CAVLC residual block (9.2) — mirrors read/write_residual_block
// ---------------------------------------------------------------------------

int read_residual(BitReader &r, int nc, int max_coeff, int64_t out[16]) {
  std::memset(out, 0, 16 * sizeof(int64_t));
  int idx;
  if (nc == -1) {
    idx = read_vlc(r, kCdcTokenLen, kCdcTokenBits, 20);
  } else if (nc < 2) {
    idx = read_vlc(r, kCoeffTokenLen0, kCoeffTokenBits0, 68);
  } else if (nc < 4) {
    idx = read_vlc(r, kCoeffTokenLen1, kCoeffTokenBits1, 68);
  } else if (nc < 8) {
    idx = read_vlc(r, kCoeffTokenLen2, kCoeffTokenBits2, 68);
  } else {
    uint32_t code = r.u(6);
    idx = (code == 3) ? 0 : 4 * (code / 4 + 1) + code % 4;
  }
  if (idx < 0 || !r.ok) return -1;
  int total_coeff = idx / 4, t1s = idx % 4;
  if (total_coeff == 0) return 0;
  if (total_coeff > max_coeff) return -1;
  int64_t levels[16];
  int nl = 0;
  for (int i = 0; i < t1s; ++i) levels[nl++] = r.u(1) ? -1 : 1;
  int suffix_length = (total_coeff > 10 && t1s < 3) ? 1 : 0;
  for (int i = 0; i < total_coeff - t1s; ++i) {
    int prefix = 0;
    while (r.ok && r.u(1) == 0)
      if (++prefix > 32) return -1;
    if (!r.ok) return -1;
    int size;
    if (prefix == 14 && suffix_length == 0) size = 4;
    else if (prefix >= 15) size = prefix - 3;
    else size = suffix_length;
    int64_t suffix = size ? r.u(size) : 0;
    int64_t level_code = ((int64_t)(prefix < 15 ? prefix : 15)
                          << suffix_length) + suffix;
    if (prefix >= 15 && suffix_length == 0) level_code += 15;
    if (prefix >= 16) level_code += (1ll << (prefix - 3)) - 4096;
    if (i == 0 && t1s < 3) level_code += 2;
    int64_t level = (level_code + 2) >> 1;
    if (level_code & 1) level = -level;
    levels[nl++] = level;
    if (suffix_length == 0) suffix_length = 1;
    if (llabs(level) > (3ll << (suffix_length - 1)) && suffix_length < 6)
      ++suffix_length;
  }
  int tz = 0;
  if (total_coeff < max_coeff) {
    if (nc == -1)
      tz = read_vlc(r, kCdcTzLen + 4 * (total_coeff - 1),
                    kCdcTzBits + 4 * (total_coeff - 1), 4);
    else
      tz = read_vlc(r, kTzLen + 16 * (total_coeff - 1),
                    kTzBits + 16 * (total_coeff - 1), 16);
    if (tz < 0) return -1;
  }
  if (total_coeff + tz > max_coeff) return -1;
  int pos = total_coeff + tz - 1;
  int zeros_left = tz;
  for (int i = 0; i < total_coeff; ++i) {
    if (pos < 0) return -1;
    out[pos] = levels[i];
    if (i < total_coeff - 1) {
      int run = 0;
      if (zeros_left > 0) {
        int zl = zeros_left < 7 ? zeros_left : 7;
        run = read_vlc(r, kRunLen + 15 * (zl - 1), kRunBits + 15 * (zl - 1),
                       15);
        if (run < 0 || run > zeros_left) return -1;
      }
      zeros_left -= run;
      pos -= run + 1;
    }
  }
  return total_coeff;
}

void write_level_code(BitWriter &w, int64_t level_code, int s) {
  int64_t s_base;
  if (s == 0) {
    if (level_code < 14) { w.u(1, (int)level_code + 1); return; }
    if (level_code < 30) { w.u(1, 15); w.u((uint32_t)(level_code - 14), 4); return; }
    level_code -= 15;
    s_base = 15;
  } else {
    s_base = 15ll << s;
    if (level_code < s_base) {
      w.u(1, (int)(level_code >> s) + 1);
      w.u((uint32_t)(level_code & ((1 << s) - 1)), s);
      return;
    }
  }
  if (level_code < s_base + 4096) {
    w.u(1, 16);
    w.u((uint32_t)(level_code - s_base), 12);
    return;
  }
  int p = 16;
  while (level_code - s_base - ((1ll << (p - 3)) - 4096) >= (1ll << (p - 3)))
    ++p;
  w.u(1, p + 1);
  w.u((uint32_t)(level_code - s_base - ((1ll << (p - 3)) - 4096)), p - 3);
}

int write_residual(BitWriter &w, const int64_t *coeffs, int max_coeff,
                   int nc) {
  int nz[16], total_coeff = 0;
  for (int i = 0; i < max_coeff; ++i)
    if (coeffs[i]) nz[total_coeff++] = i;
  int t1s = 0;
  for (int i = total_coeff - 1; i >= 0; --i) {
    if (llabs(coeffs[nz[i]]) == 1 && t1s < 3) ++t1s;
    else break;
  }
  int idx = total_coeff * 4 + t1s;
  if (nc == -1) w.u(kCdcTokenBits[idx], kCdcTokenLen[idx]);
  else if (nc < 2) w.u(kCoeffTokenBits0[idx], kCoeffTokenLen0[idx]);
  else if (nc < 4) w.u(kCoeffTokenBits1[idx], kCoeffTokenLen1[idx]);
  else if (nc < 8) w.u(kCoeffTokenBits2[idx], kCoeffTokenLen2[idx]);
  else w.u(kCoeffTokenBits3[idx], 6);
  if (total_coeff == 0) return 0;
  for (int i = 0; i < t1s; ++i)
    w.u(coeffs[nz[total_coeff - 1 - i]] < 0 ? 1 : 0, 1);
  int suffix_length = (total_coeff > 10 && t1s < 3) ? 1 : 0;
  for (int i = 0; i < total_coeff - t1s; ++i) {
    int64_t level = coeffs[nz[total_coeff - 1 - t1s - i]];
    int64_t level_code = 2 * llabs(level) - 2 + (level < 0 ? 1 : 0);
    if (i == 0 && t1s < 3) level_code -= 2;
    write_level_code(w, level_code, suffix_length);
    if (suffix_length == 0) suffix_length = 1;
    if (llabs(level) > (3ll << (suffix_length - 1)) && suffix_length < 6)
      ++suffix_length;
  }
  int tz = nz[total_coeff - 1] + 1 - total_coeff;
  if (total_coeff < max_coeff) {
    if (nc == -1)
      w.u(kCdcTzBits[4 * (total_coeff - 1) + tz],
          kCdcTzLen[4 * (total_coeff - 1) + tz]);
    else
      w.u(kTzBits[16 * (total_coeff - 1) + tz],
          kTzLen[16 * (total_coeff - 1) + tz]);
  }
  int zeros_left = tz;
  for (int i = 0; i < total_coeff - 1; ++i) {
    int run = nz[total_coeff - 1 - i] - nz[total_coeff - 2 - i] - 1;
    if (zeros_left > 0) {
      int zl = zeros_left < 7 ? zeros_left : 7;
      w.u(kRunBits[15 * (zl - 1) + run], kRunLen[15 * (zl - 1) + run]);
    }
    zeros_left -= run;
  }
  return total_coeff;
}

// ---------------------------------------------------------------------------
// Transforms / quant
// ---------------------------------------------------------------------------

inline uint8_t clip8(int64_t x) {
  return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

void forward4x4(const int64_t x[16], int64_t w[16]) {
  static const int c[4][4] = {
      {1, 1, 1, 1}, {2, 1, -1, -2}, {1, -1, -1, 1}, {1, -2, 2, -1}};
  int64_t t[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      int64_t s = 0;
      for (int k = 0; k < 4; ++k) s += c[i][k] * x[4 * k + j];
      t[4 * i + j] = s;
    }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      int64_t s = 0;
      for (int k = 0; k < 4; ++k) s += t[4 * i + k] * c[j][k];
      w[4 * i + j] = s;
    }
}

void inverse4x4(const int64_t d[16], int64_t out[16]) {
  int64_t f[16];
  for (int i = 0; i < 4; ++i) {  // rows
    int64_t d0 = d[4 * i], d1 = d[4 * i + 1], d2 = d[4 * i + 2],
            d3 = d[4 * i + 3];
    int64_t e0 = d0 + d2, e1 = d0 - d2, e2 = (d1 >> 1) - d3,
            e3 = d1 + (d3 >> 1);
    f[4 * i] = e0 + e3;
    f[4 * i + 1] = e1 + e2;
    f[4 * i + 2] = e1 - e2;
    f[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; ++j) {  // columns
    int64_t f0 = f[j], f1 = f[4 + j], f2 = f[8 + j], f3 = f[12 + j];
    int64_t g0 = f0 + f2, g1 = f0 - f2, g2 = (f1 >> 1) - f3,
            g3 = f1 + (f3 >> 1);
    out[j] = (g0 + g3 + 32) >> 6;
    out[4 + j] = (g1 + g2 + 32) >> 6;
    out[8 + j] = (g1 - g2 + 32) >> 6;
    out[12 + j] = (g0 - g3 + 32) >> 6;
  }
}

void quant4x4(const int64_t w[16], int qp, bool skip_dc, int64_t out[16]) {
  int qbits = 15 + qp / 6;
  int64_t f = (1ll << qbits) / 3;
  for (int i = 0; i < 16; ++i) {
    int64_t mf = kQuantMF[3 * (qp % 6) + kPosClass[i]];
    int64_t lv = (llabs(w[i]) * mf + f) >> qbits;
    out[i] = w[i] < 0 ? -lv : lv;
  }
  if (skip_dc) out[0] = 0;
}

void dequant4x4(const int64_t c[16], int qp, int64_t out[16]) {
  for (int i = 0; i < 16; ++i) {
    int64_t v = kDequantV[3 * (qp % 6) + kPosClass[i]];
    out[i] = (c[i] * v) << (qp / 6);
  }
}

// ---------------------------------------------------------------------------
// Intra prediction
// ---------------------------------------------------------------------------

// left[4] / top[4] / tr[4] / tl valid per flags; out row-major 4x4
bool predict4x4(int mode, const int64_t *left, const int64_t *top,
                const int64_t *tr, int64_t tl, bool has_l, bool has_t,
                bool has_tl, int64_t p[16]) {
  int64_t t[8];
  if (has_t) {
    for (int i = 0; i < 4; ++i) t[i] = top[i];
    for (int i = 0; i < 4; ++i) t[4 + i] = tr ? tr[i] : top[3];
  }
  auto T = [&](int i) { return i < 0 ? tl : t[i]; };
  auto L = [&](int i) { return i < 0 ? tl : left[i]; };
  switch (mode) {
    case 0:
      if (!has_t) return false;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) p[4 * y + x] = t[x];
      return true;
    case 1:
      if (!has_l) return false;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) p[4 * y + x] = left[y];
      return true;
    case 2: {
      int64_t dc;
      if (has_t && has_l) {
        int64_t s = 0;
        for (int i = 0; i < 4; ++i) s += t[i] + left[i];
        dc = (s + 4) >> 3;
      } else if (has_t) {
        int64_t s = t[0] + t[1] + t[2] + t[3];
        dc = (s + 2) >> 2;
      } else if (has_l) {
        int64_t s = left[0] + left[1] + left[2] + left[3];
        dc = (s + 2) >> 2;
      } else {
        dc = 128;
      }
      for (int i = 0; i < 16; ++i) p[i] = dc;
      return true;
    }
    case 3:
      if (!has_t) return false;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          if (x == 3 && y == 3)
            p[4 * y + x] = (T(6) + 3 * T(7) + 2) >> 2;
          else {
            int i = x + y;
            p[4 * y + x] = (T(i) + 2 * T(i + 1) + T(i + 2) + 2) >> 2;
          }
        }
      return true;
    case 4:
      if (!has_t || !has_l) return false;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          if (x > y)
            p[4 * y + x] =
                (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
          else if (x < y)
            p[4 * y + x] =
                (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
          else
            p[4 * y + x] = (T(0) + 2 * tl + L(0) + 2) >> 2;
        }
      return true;
    case 5:
      if (!has_t || !has_l) return false;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          int z = 2 * x - y, i = x - (y >> 1);
          if (z >= 0 && z % 2 == 0)
            p[4 * y + x] = (T(i - 1) + T(i) + 1) >> 1;
          else if (z >= 0)
            p[4 * y + x] = (T(i - 2) + 2 * T(i - 1) + T(i) + 2) >> 2;
          else if (z == -1)
            p[4 * y + x] = (L(0) + 2 * tl + T(0) + 2) >> 2;
          else
            p[4 * y + x] = (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2;
        }
      return true;
    case 6:
      if (!has_t || !has_l) return false;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          int z = 2 * y - x, i = y - (x >> 1);
          if (z >= 0 && z % 2 == 0)
            p[4 * y + x] = (L(i - 1) + L(i) + 1) >> 1;
          else if (z >= 0)
            p[4 * y + x] = (L(i - 2) + 2 * L(i - 1) + L(i) + 2) >> 2;
          else if (z == -1)
            p[4 * y + x] = (L(0) + 2 * tl + T(0) + 2) >> 2;
          else
            p[4 * y + x] = (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2;
        }
      return true;
    case 7:
      if (!has_t) return false;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          int i = x + (y >> 1);
          if (y % 2 == 0)
            p[4 * y + x] = (T(i) + T(i + 1) + 1) >> 1;
          else
            p[4 * y + x] = (T(i) + 2 * T(i + 1) + T(i + 2) + 2) >> 2;
        }
      return true;
    case 8:
      if (!has_l) return false;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          int z = x + 2 * y, i = y + (x >> 1);
          if (z % 2 == 0 && z < 6)
            p[4 * y + x] = (L(i) + L(i + 1) + 1) >> 1;
          else if (z % 2 == 1 && z < 5)
            p[4 * y + x] = (L(i) + 2 * L(i + 1) + L(i + 2) + 2) >> 2;
          else if (z == 5)
            p[4 * y + x] = (L(2) + 3 * L(3) + 2) >> 2;
          else
            p[4 * y + x] = L(3);
        }
      return true;
  }
  return false;
}

// chroma 8x8 prediction into p[64] (row-major)
bool predict_chroma(int mode, const uint8_t *plane, int stride, int cx,
                    int cy, bool has_l, bool has_t, int64_t p[64]) {
  int64_t left[8], top[8];
  if (has_l)
    for (int i = 0; i < 8; ++i) left[i] = plane[(cy + i) * stride + cx - 1];
  if (has_t)
    for (int i = 0; i < 8; ++i) top[i] = plane[(cy - 1) * stride + cx + i];
  if (mode == 0) {
    for (int qy = 0; qy < 8; qy += 4)
      for (int qx = 0; qx < 8; qx += 4) {
        int64_t dc;
        bool use_t = has_t, use_l = has_l;
        if (qx != qy) {  // off-diagonal quadrants prefer one side
          if (qx == 4) { use_l = has_l && !has_t; }
          else { use_t = has_t && !has_l; }
        }
        int64_t st = 0, sl = 0;
        for (int i = 0; i < 4; ++i) {
          if (has_t) st += top[qx + i];
          if (has_l) sl += left[qy + i];
        }
        if (use_t && use_l) dc = (st + sl + 4) >> 3;
        else if (use_t) dc = (st + 2) >> 2;
        else if (use_l) dc = (sl + 2) >> 2;
        else dc = 128;
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) p[(qy + y) * 8 + qx + x] = dc;
      }
    return true;
  }
  if (mode == 1) {
    if (!has_l) return false;
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) p[8 * y + x] = left[y];
    return true;
  }
  if (mode == 2) {
    if (!has_t) return false;
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) p[8 * y + x] = top[x];
    return true;
  }
  if (mode == 3) {
    if (!has_t || !has_l) return false;
    int64_t tl = plane[(cy - 1) * stride + cx - 1];
    int64_t hh = 0, vv = 0;
    for (int i = 0; i < 4; ++i) {
      hh += (i + 1) * (top[4 + i] - (2 - i >= 0 ? top[2 - i] : tl));
      vv += (i + 1) * (left[4 + i] - (2 - i >= 0 ? left[2 - i] : tl));
    }
    int64_t a = 16 * (left[7] + top[7]);
    int64_t b = (17 * hh + 16) >> 5, c = (17 * vv + 16) >> 5;
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        p[8 * y + x] = clip8((a + b * (x - 3) + c * (y - 3) + 16) >> 5);
    return true;
  }
  return false;
}

bool predict16(int mode, const uint8_t *plane, int stride, int x0, int y0,
               bool has_l, bool has_t, int64_t p[256]) {
  int64_t left[16], top[16];
  if (has_l)
    for (int i = 0; i < 16; ++i) left[i] = plane[(y0 + i) * stride + x0 - 1];
  if (has_t)
    for (int i = 0; i < 16; ++i) top[i] = plane[(y0 - 1) * stride + x0 + i];
  if (mode == 0) {
    if (!has_t) return false;
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x) p[16 * y + x] = top[x];
    return true;
  }
  if (mode == 1) {
    if (!has_l) return false;
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x) p[16 * y + x] = left[y];
    return true;
  }
  if (mode == 2) {
    int64_t dc;
    if (has_t && has_l) {
      int64_t s = 0;
      for (int i = 0; i < 16; ++i) s += top[i] + left[i];
      dc = (s + 16) >> 5;
    } else if (has_t || has_l) {
      int64_t s = 0;
      const int64_t *src = has_t ? top : left;
      for (int i = 0; i < 16; ++i) s += src[i];
      dc = (s + 8) >> 4;
    } else {
      dc = 128;
    }
    for (int i = 0; i < 256; ++i) p[i] = dc;
    return true;
  }
  if (mode == 3) {
    if (!has_t || !has_l) return false;
    int64_t tl = plane[(y0 - 1) * stride + x0 - 1];
    int64_t hh = 0, vv = 0;
    for (int i = 0; i < 8; ++i) {
      hh += (i + 1) * (top[8 + i] - (6 - i >= 0 ? top[6 - i] : tl));
      vv += (i + 1) * (left[8 + i] - (6 - i >= 0 ? left[6 - i] : tl));
    }
    int64_t a = 16 * (left[15] + top[15]);
    int64_t b = (5 * hh + 32) >> 6, c = (5 * vv + 32) >> 6;
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x)
        p[16 * y + x] = clip8((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
    return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// Inter prediction: quarter-pel luma (8.4.2.2.1) + eighth-pel chroma
// (8.4.2.2.2) motion compensation — bit-identical mirror of
// codecs/h264_intra.py:_mc_luma/_mc_chroma (the Python oracle).
// ---------------------------------------------------------------------------

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// w,h <= 16; out is row-major w*h with stride `ostride`
void mc_luma(const uint8_t *ref, int iw, int ih, int x0, int y0, int w,
             int h, int mvx, int mvy, uint8_t *out, int ostride) {
  const int fx = mvx & 3, fy = mvy & 3;
  const int ix = x0 + (mvx >> 2), iy = y0 + (mvy >> 2);
  if (fx == 0 && fy == 0) {
    for (int y = 0; y < h; ++y) {
      const uint8_t *row = ref + (size_t)clampi(iy + y, 0, ih - 1) * iw;
      if (ix >= 0 && ix + w <= iw) {
        std::memcpy(out + (size_t)y * ostride, row + ix, w);
      } else {
        for (int x = 0; x < w; ++x)
          out[(size_t)y * ostride + x] = row[clampi(ix + x, 0, iw - 1)];
      }
    }
    return;
  }
  // padded integer window: 2 left/top, 3+1 right/bottom (6-tap + qpel)
  const int W = w + 6, H = h + 6;      // max 22x22
  int32_t win[22 * 22];
  for (int y = 0; y < H; ++y) {
    const uint8_t *row = ref + (size_t)clampi(iy - 2 + y, 0, ih - 1) * iw;
    for (int x = 0; x < W; ++x)
      win[y * W + x] = row[clampi(ix - 2 + x, 0, iw - 1)];
  }
  const int BW = w + 1, BH = h + 1;    // half-pel grids are (h+1)x(w+1)
  // b: horizontal 6-tap (raw retained for j), rows 0..H-1, cols 0..w
  int32_t b_raw[22 * 17], b[17 * 17], hh[17 * 17];
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < BW; ++x) {
      const int32_t *p = win + y * W + x;
      b_raw[y * BW + x] =
          p[0] - 5 * p[1] + 20 * p[2] + 20 * p[3] - 5 * p[4] + p[5];
    }
  for (int y = 0; y < BH; ++y)
    for (int x = 0; x < BW; ++x)
      b[y * BW + x] = clampi((b_raw[(y + 2) * BW + x] + 16) >> 5, 0, 255);
  // h: vertical 6-tap, rows 0..h, cols 0..w
  for (int y = 0; y < BH; ++y)
    for (int x = 0; x < BW; ++x) {
      const int32_t *p = win + y * W + (x + 2);
      hh[y * BW + x] = clampi(
          (p[0] - 5 * p[W] + 20 * p[2 * W] + 20 * p[3 * W] - 5 * p[4 * W] +
           p[5 * W] + 16) >> 5,
          0, 255);
    }
  int32_t j[17 * 17];
  if (fx && fy) {  // center half-pel: 6-tap vertically over raw b, >>10
    for (int y = 0; y < BH; ++y)
      for (int x = 0; x < BW; ++x) {
        const int32_t *p = b_raw + y * BW + x;
        j[y * BW + x] = clampi(
            (p[0] - 5 * p[BW] + 20 * p[2 * BW] + 20 * p[3 * BW] -
             5 * p[4 * BW] + p[5 * BW] + 512) >> 10,
            0, 255);
      }
  }
  auto G = [&](int dx, int dy, int x, int y) {
    return win[(2 + dy + y) * W + 2 + dx + x];
  };
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int v;
      if (fy == 0) {  // a, b, c
        int bv = b[y * BW + x];
        if (fx == 1) v = (G(0, 0, x, y) + bv + 1) >> 1;
        else if (fx == 2) v = bv;
        else v = (G(1, 0, x, y) + bv + 1) >> 1;
      } else if (fx == 0) {  // d, h, n
        int hv = hh[y * BW + x];
        if (fy == 1) v = (G(0, 0, x, y) + hv + 1) >> 1;
        else if (fy == 2) v = hv;
        else v = (G(0, 1, x, y) + hv + 1) >> 1;
      } else if (fx == 2) {  // f, j, q
        int jv = j[y * BW + x];
        if (fy == 1) v = (b[y * BW + x] + jv + 1) >> 1;
        else if (fy == 2) v = jv;
        else v = (b[(y + 1) * BW + x] + jv + 1) >> 1;
      } else if (fy == 2) {  // i, k
        int jv = j[y * BW + x];
        if (fx == 1) v = (hh[y * BW + x] + jv + 1) >> 1;
        else v = (hh[y * BW + x + 1] + jv + 1) >> 1;
      } else {  // e, g, p, r
        int bdy = (fy == 1) ? 0 : 1, hdx = (fx == 1) ? 0 : 1;
        v = (b[(y + bdy) * BW + x] + hh[y * BW + x + hdx] + 1) >> 1;
      }
      out[(size_t)y * ostride + x] = (uint8_t)v;
    }
}

void mc_chroma(const uint8_t *ref, int iw, int ih, int x0, int y0, int w,
               int h, int mvx, int mvy, uint8_t *out, int ostride) {
  const int fx = mvx & 7, fy = mvy & 7;
  const int ix = x0 + (mvx >> 3), iy = y0 + (mvy >> 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t *r0 = ref + (size_t)clampi(iy + y, 0, ih - 1) * iw;
    const uint8_t *r1 = ref + (size_t)clampi(iy + y + 1, 0, ih - 1) * iw;
    for (int x = 0; x < w; ++x) {
      int xa = clampi(ix + x, 0, iw - 1), xb = clampi(ix + x + 1, 0, iw - 1);
      int a = r0[xa], b = r0[xb], c = r1[xa], d = r1[xb];
      out[(size_t)y * ostride + x] = (uint8_t)(
          ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b + (8 - fx) * fy * c +
           fx * fy * d + 32) >> 6);
    }
  }
}

// ---------------------------------------------------------------------------
// Slice context
// ---------------------------------------------------------------------------

struct Slice {
  int cw, ch, qp, cqp_off;
  uint8_t *y, *cb, *cr;
  std::vector<int16_t> tc_y, tc_cb, tc_cr;
  std::vector<int8_t> modes;
  // P-slice motion state per 4x4 block: quarter-pel MVs, refIdx (-1 =
  // intra / undecoded), decoded mask (8.4.1.3 neighbor availability) —
  // mirrors SliceCoder.mv/mvref/decoded4
  std::vector<int16_t> mv4x, mv4y;
  std::vector<int8_t> ref4;
  std::vector<uint8_t> dec4;
  Slice(int w, int h, int qp_, int cqp, uint8_t *py, uint8_t *pcb,
        uint8_t *pcr)
      : cw(w), ch(h), qp(qp_), cqp_off(cqp), y(py), cb(pcb), cr(pcr),
        tc_y((h / 4) * (w / 4), 0), tc_cb((h / 8) * (w / 8), 0),
        tc_cr((h / 8) * (w / 8), 0), modes((h / 4) * (w / 4), -1),
        mv4x((h / 4) * (w / 4), 0), mv4y((h / 4) * (w / 4), 0),
        ref4((h / 4) * (w / 4), -1), dec4((h / 4) * (w / 4), 0) {}

  // -- MV neighbor probes (8.4.1.3); out = {avail, refok, mx, my} ----------
  struct Nb { bool avail, refok; int mx, my; };
  Nb probe_mv(int px, int py) const {
    int wb4 = cw / 4, hb4 = ch / 4;
    if (px < 0 || py < 0 || px >= wb4 || py >= hb4 || !dec4[py * wb4 + px])
      return {false, false, 0, 0};
    bool ok = ref4[py * wb4 + px] == 0;
    return {true, ok, ok ? (int)mv4x[py * wb4 + px] : 0,
            ok ? (int)mv4y[py * wb4 + px] : 0};
  }
  void mv_neighbors(int bx, int by, int wb, Nb out[3]) const {
    out[0] = probe_mv(bx - 1, by);
    out[1] = probe_mv(bx, by - 1);
    out[2] = probe_mv(bx + wb, by - 1);
    if (!out[2].avail) out[2] = probe_mv(bx - 1, by - 1);  // D fallback
  }
  static int median3(int a, int b, int c) {
    if (a > b) { int t = a; a = b; b = t; }
    if (b > c) b = c;
    return a > b ? a : b;
  }
  void predict_mv(int bx, int by, int wb, int hb, int part, int &px,
                  int &py) const {
    Nb n[3];
    mv_neighbors(bx, by, wb, n);
    if (wb == 4 && hb == 2) {        // 16x8: top -> B, bottom -> A
      if (part == 0 && n[1].refok) { px = n[1].mx; py = n[1].my; return; }
      if (part == 1 && n[0].refok) { px = n[0].mx; py = n[0].my; return; }
    } else if (wb == 2 && hb == 4) { // 8x16: left -> A, right -> C
      if (part == 0 && n[0].refok) { px = n[0].mx; py = n[0].my; return; }
      if (part == 1 && n[2].refok) { px = n[2].mx; py = n[2].my; return; }
    }
    int nok = (int)n[0].refok + n[1].refok + n[2].refok;
    if (nok == 1) {
      const Nb &m = n[0].refok ? n[0] : (n[1].refok ? n[1] : n[2]);
      px = m.mx; py = m.my;
      return;
    }
    if (!n[1].avail && !n[2].avail && n[0].avail) {
      px = n[0].mx; py = n[0].my;
      return;
    }
    px = median3(n[0].mx, n[1].mx, n[2].mx);
    py = median3(n[0].my, n[1].my, n[2].my);
  }
  void skip_mv(int mbx, int mby, int &mx, int &my) const {
    int bx = 4 * mbx, by = 4 * mby;
    Nb n[3];
    mv_neighbors(bx, by, 4, n);
    mx = my = 0;
    if (!n[0].avail || !n[1].avail) return;
    if (n[0].refok && n[0].mx == 0 && n[0].my == 0) return;
    if (n[1].refok && n[1].mx == 0 && n[1].my == 0) return;
    predict_mv(bx, by, 4, 4, 0, mx, my);
  }
  void set_mv_region(int bx, int by, int wb, int hb, int mx, int my,
                     int8_t ref) {
    int wb4 = cw / 4;
    for (int j = 0; j < hb; ++j)
      for (int i = 0; i < wb; ++i) {
        size_t idx = (size_t)(by + j) * wb4 + bx + i;
        mv4x[idx] = (int16_t)mx;
        mv4y[idx] = (int16_t)my;
        ref4[idx] = ref;
        dec4[idx] = 1;
      }
  }
  void mark_intra_mv(int mbx, int mby) {
    set_mv_region(4 * mbx, 4 * mby, 4, 4, 0, 0, -1);
  }
  int nc_of(const std::vector<int16_t> &plane, int cols, int bx, int by) {
    int na = bx > 0 ? plane[by * cols + bx - 1] : -1;
    int nb = by > 0 ? plane[(by - 1) * cols + bx] : -1;
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
  }
  int nc_luma(int bx, int by) { return nc_of(tc_y, cw / 4, bx, by); }
  int pred_mode4(int bx, int by) {
    int a = bx > 0 ? modes[by * (cw / 4) + bx - 1] : -1;
    int b = by > 0 ? modes[(by - 1) * (cw / 4) + bx] : -1;
    if (a < 0 || b < 0) return 2;
    return a < b ? a : b;
  }
  void mark_pcm(int mbx, int mby) {
    for (int j = 0; j < 4; ++j)
      for (int i = 0; i < 4; ++i) {
        tc_y[(4 * mby + j) * (cw / 4) + 4 * mbx + i] = 16;
        modes[(4 * mby + j) * (cw / 4) + 4 * mbx + i] = 2;
      }
    for (int j = 0; j < 2; ++j)
      for (int i = 0; i < 2; ++i) {
        tc_cb[(2 * mby + j) * (cw / 8) + 2 * mbx + i] = 16;
        tc_cr[(2 * mby + j) * (cw / 8) + 2 * mbx + i] = 16;
      }
  }
  // luma 4x4 neighbors; returns availability mask
  void luma_neighbors(int x0, int y0, int blk, int64_t left[4],
                      int64_t top[4], int64_t tr[4], int64_t &tl,
                      bool &has_l, bool &has_t, bool &has_tr) {
    has_l = x0 > 0;
    has_t = y0 > 0;
    static const bool no_tr[16] = {0, 0, 0, 1, 0, 0, 0, 1,
                                   0, 0, 0, 1, 0, 1, 0, 1};
    has_tr = has_t && (x0 + 8 <= cw) && !no_tr[blk];
    if (has_l)
      for (int i = 0; i < 4; ++i) left[i] = y[(y0 + i) * cw + x0 - 1];
    if (has_t)
      for (int i = 0; i < 4; ++i) top[i] = y[(y0 - 1) * cw + x0 + i];
    if (has_tr)
      for (int i = 0; i < 4; ++i) tr[i] = y[(y0 - 1) * cw + x0 + 4 + i];
    tl = (has_l && has_t) ? y[(y0 - 1) * cw + x0 - 1] : 0;
  }
};

void add_block(uint8_t *plane, int stride, int x0, int y0,
               const int64_t pred[16], const int64_t d[16]) {
  int64_t res[16];
  inverse4x4(d, res);
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      plane[(y0 + y) * stride + x0 + x] = clip8(pred[4 * y + x] + res[4 * y + x]);
}

void scan_to_raster(const int64_t scan[16], int64_t raster[16]) {
  for (int i = 0; i < 16; ++i) raster[kZigzag[i]] = scan[i];
}

}  // namespace

// ---------------------------------------------------------------------------
// Decode entry
// ---------------------------------------------------------------------------

extern "C" int uvt_h264_decode_slice(
    const uint8_t *rbsp, long rbsp_len,
    int coded_w, int coded_h, int log2_max_frame_num, int poc_type,
    int log2_max_poc, int pic_init_qp, int cqp_offset,
    int deblock_present, int bottom_poc_present, int redundant_present,
    int idr, int nal_ref_idc,
    const uint8_t *prev_y, const uint8_t *prev_cb, const uint8_t *prev_cr,
    uint8_t *out_y, uint8_t *out_cb, uint8_t *out_cr) {
  BitReader r(rbsp, rbsp_len);
  if (r.ue() != 0) return -2;  // multi-slice
  uint32_t slice_type = r.ue();
  bool is_p = slice_type % 5 == 0;
  if (!is_p && slice_type % 5 != 2) return -2;
  if (is_p && (idr || !prev_y)) return -2;
  r.ue();
  r.u(log2_max_frame_num);
  if (idr) r.ue();
  if (poc_type == 0) {
    r.u(log2_max_poc);
    if (bottom_poc_present) r.se();
  }
  if (redundant_present) r.ue();
  if (is_p) {
    if (r.u(1)) {           // num_ref_idx_active_override
      if (r.ue() != 0) return -2;  // multi-ref: Python raises
    }
    if (r.u(1)) return -2;  // ref_pic_list_modification
  }
  if (idr) { r.u(1); r.u(1); }
  else if (nal_ref_idc) {
    if (r.u(1)) return -2;  // adaptive ref marking
  }
  int qp = pic_init_qp + r.se();
  if (qp < 0 || qp > 51) return -1;  // spec range; also guards table reads
  if (deblock_present) {
    uint32_t idc = r.ue();
    if (idc != 1) return -3;  // deblocking on: unsupported (Python raises)
  } else {
    return -3;  // no control flag => filter implicitly ON: refuse
  }
  if (!r.ok) return -1;
  Slice sc(coded_w, coded_h, qp, cqp_offset, out_y, out_cb, out_cr);
  std::memset(out_y, 0, (size_t)coded_w * coded_h);
  std::memset(out_cb, 0, (size_t)(coded_w / 2) * (coded_h / 2));
  std::memset(out_cr, 0, (size_t)(coded_w / 2) * (coded_h / 2));

  int w_mb = coded_w / 16, h_mb = coded_h / 16;
  int total_mbs = w_mb * h_mb;
  int mb_i = 0;
  while (mb_i < total_mbs) {
    {
      int mbx = mb_i % w_mb, mby = mb_i / w_mb;
      if (is_p) {
        uint32_t skip_run = r.ue();
        if (!r.ok || skip_run > (uint32_t)(total_mbs - mb_i)) return -1;
        for (uint32_t k = 0; k < skip_run; ++k) {
          mbx = mb_i % w_mb;
          mby = mb_i / w_mb;
          // P_Skip: motion-compensate with the derived skip MV
          // (8.4.1.1); zero-motion streams reduce to the co-located copy
          int smx, smy;
          sc.skip_mv(mbx, mby, smx, smy);
          if (smx == 0 && smy == 0) {
            for (int j = 0; j < 16; ++j)
              std::memcpy(out_y + (16 * mby + j) * coded_w + 16 * mbx,
                          prev_y + (16 * mby + j) * coded_w + 16 * mbx, 16);
            for (int j = 0; j < 8; ++j) {
              std::memcpy(out_cb + (8 * mby + j) * (coded_w / 2) + 8 * mbx,
                          prev_cb + (8 * mby + j) * (coded_w / 2) + 8 * mbx,
                          8);
              std::memcpy(out_cr + (8 * mby + j) * (coded_w / 2) + 8 * mbx,
                          prev_cr + (8 * mby + j) * (coded_w / 2) + 8 * mbx,
                          8);
            }
          } else {
            mc_luma(prev_y, coded_w, coded_h, 16 * mbx, 16 * mby, 16, 16,
                    smx, smy, out_y + 16 * mby * coded_w + 16 * mbx,
                    coded_w);
            mc_chroma(prev_cb, coded_w / 2, coded_h / 2, 8 * mbx, 8 * mby,
                      8, 8, smx, smy,
                      out_cb + 8 * mby * (coded_w / 2) + 8 * mbx,
                      coded_w / 2);
            mc_chroma(prev_cr, coded_w / 2, coded_h / 2, 8 * mbx, 8 * mby,
                      8, 8, smx, smy,
                      out_cr + 8 * mby * (coded_w / 2) + 8 * mbx,
                      coded_w / 2);
          }
          sc.set_mv_region(4 * mbx, 4 * mby, 4, 4, smx, smy, 0);
          for (int j = 0; j < 4; ++j)
            for (int i2 = 0; i2 < 4; ++i2) {
              sc.tc_y[(4 * mby + j) * (coded_w / 4) + 4 * mbx + i2] = 0;
              sc.modes[(4 * mby + j) * (coded_w / 4) + 4 * mbx + i2] = 2;
            }
          for (int j = 0; j < 2; ++j)
            for (int i2 = 0; i2 < 2; ++i2) {
              sc.tc_cb[(2 * mby + j) * (coded_w / 8) + 2 * mbx + i2] = 0;
              sc.tc_cr[(2 * mby + j) * (coded_w / 8) + 2 * mbx + i2] = 0;
            }
          ++mb_i;
        }
        if (mb_i >= total_mbs) break;
        mbx = mb_i % w_mb;
        mby = mb_i / w_mb;
      }
      ++mb_i;
      uint32_t mb_type = r.ue();
      if (!r.ok) return -1;
      bool inter = false;
      uint8_t pred_y16[256], pred_cb8[64], pred_cr8[64];
      if (is_p) {
        if (mb_type < 5) {
          // P_L0_16x16 (0) / P_L0_L0_16x8 (1) / P_L0_L0_8x16 (2);
          // P_8x8 sub-partitions (3/4): Python raises NotImplementedError
          if (mb_type > 2) return -2;
          inter = true;
          int bx = 4 * mbx, by = 4 * mby;
          struct { int pbx, pby, wb, hb; } parts[2];
          int nparts;
          if (mb_type == 0) {
            parts[0] = {bx, by, 4, 4};
            nparts = 1;
          } else if (mb_type == 1) {
            parts[0] = {bx, by, 4, 2};
            parts[1] = {bx, by + 2, 4, 2};
            nparts = 2;
          } else {
            parts[0] = {bx, by, 2, 4};
            parts[1] = {bx + 2, by, 2, 4};
            nparts = 2;
          }
          for (int pi = 0; pi < nparts; ++pi) {
            int mvdx = r.se(), mvdy = r.se();
            if (!r.ok) return -1;
            int pmx, pmy;
            sc.predict_mv(parts[pi].pbx, parts[pi].pby, parts[pi].wb,
                          parts[pi].hb, pi, pmx, pmy);
            int mx = pmx + mvdx, my = pmy + mvdy;
            int lx = 4 * (parts[pi].pbx - bx), ly = 4 * (parts[pi].pby - by);
            mc_luma(prev_y, coded_w, coded_h, 4 * parts[pi].pbx,
                    4 * parts[pi].pby, 4 * parts[pi].wb, 4 * parts[pi].hb,
                    mx, my, pred_y16 + ly * 16 + lx, 16);
            mc_chroma(prev_cb, coded_w / 2, coded_h / 2, 2 * parts[pi].pbx,
                      2 * parts[pi].pby, 2 * parts[pi].wb, 2 * parts[pi].hb,
                      mx, my, pred_cb8 + (ly / 2) * 8 + lx / 2, 8);
            mc_chroma(prev_cr, coded_w / 2, coded_h / 2, 2 * parts[pi].pbx,
                      2 * parts[pi].pby, 2 * parts[pi].wb, 2 * parts[pi].hb,
                      mx, my, pred_cr8 + (ly / 2) * 8 + lx / 2, 8);
            sc.set_mv_region(parts[pi].pbx, parts[pi].pby, parts[pi].wb,
                             parts[pi].hb, mx, my, 0);
          }
        } else {
          mb_type -= 5;
          sc.mark_intra_mv(mbx, mby);
        }
      }
      if (!inter && mb_type == 25) {  // I_PCM
        r.align();
        const uint8_t *py = r.bytes_at(256);
        const uint8_t *pcb = r.bytes_at(64);
        const uint8_t *pcr = r.bytes_at(64);
        if (!r.ok) return -1;
        for (int j = 0; j < 16; ++j)
          std::memcpy(out_y + (16 * mby + j) * coded_w + 16 * mbx,
                      py + 16 * j, 16);
        for (int j = 0; j < 8; ++j) {
          std::memcpy(out_cb + (8 * mby + j) * (coded_w / 2) + 8 * mbx,
                      pcb + 8 * j, 8);
          std::memcpy(out_cr + (8 * mby + j) * (coded_w / 2) + 8 * mbx,
                      pcr + 8 * j, 8);
        }
        sc.mark_pcm(mbx, mby);
        continue;
      }
      int i16_pred = -1, cbp = 0;
      int mode4[16];
      int chroma_mode = 0;
      if (inter) {
        uint32_t code = r.ue();
        if (code >= 48 || !r.ok) return -1;
        cbp = kCbpInterFromCode[code];
        if (cbp) sc.qp = ((sc.qp + r.se() + 52) % 52 + 52) % 52;
      } else if (mb_type == 0) {  // I_4x4
        for (int blk = 0; blk < 16; ++blk) {
          int bx = 4 * mbx + kBlkX[blk], by = 4 * mby + kBlkY[blk];
          int pm = sc.pred_mode4(bx, by);
          int mode;
          if (r.u(1)) mode = pm;
          else {
            int rem = r.u(3);
            mode = rem + (rem >= pm ? 1 : 0);
          }
          sc.modes[by * (coded_w / 4) + bx] = (int8_t)mode;
          mode4[blk] = mode;
        }
        chroma_mode = r.ue();
        if (chroma_mode > 3 || !r.ok) return -1;
        uint32_t code = r.ue();
        if (code >= 48) return -1;
        cbp = kCbpIntraFromCode[code];
        if (cbp) sc.qp = ((sc.qp + r.se() + 52) % 52 + 52) % 52;
      } else if (mb_type <= 24) {  // I_16x16
        i16_pred = (mb_type - 1) % 4;
        int cbp_chroma = ((mb_type - 1) / 4) % 3;
        int cbp_luma = (int)(mb_type - 1) >= 12 ? 15 : 0;
        chroma_mode = r.ue();
        if (chroma_mode > 3 || !r.ok) return -1;
        sc.qp = ((sc.qp + r.se() + 52) % 52 + 52) % 52;
        cbp = cbp_luma | (cbp_chroma << 4);
      } else {
        return -1;
      }
      // I16 DC block first
      int64_t dc16[16] = {0};
      if (i16_pred >= 0) {
        int64_t scan[16];
        int tc = read_residual(r, sc.nc_luma(4 * mbx, 4 * mby), 16, scan);
        if (tc < 0) return -1;
        int64_t c[16];
        scan_to_raster(scan, c);
        // inverse 4x4 Hadamard
        static const int hh[4][4] = {{1, 1, 1, 1}, {1, 1, -1, -1},
                                     {1, -1, -1, 1}, {1, -1, 1, -1}};
        int64_t t[16], f[16];
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) {
            int64_t s = 0;
            for (int k = 0; k < 4; ++k) s += hh[i][k] * c[4 * k + j];
            t[4 * i + j] = s;
          }
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) {
            int64_t s = 0;
            for (int k = 0; k < 4; ++k) s += t[4 * i + k] * hh[k][j];
            f[4 * i + j] = s;
          }
        int q = sc.qp;
        int64_t ls = 16ll * kDequantV[3 * (q % 6)];
        for (int i = 0; i < 16; ++i) {
          if (q >= 36) dc16[i] = (f[i] * ls) << (q / 6 - 6);
          else dc16[i] = (f[i] * ls + (1ll << (5 - q / 6))) >> (6 - q / 6);
        }
      }
      // luma residual blocks
      int64_t luma[16][16];
      std::memset(luma, 0, sizeof(luma));
      int max_l = i16_pred >= 0 ? 15 : 16;
      for (int i8 = 0; i8 < 4; ++i8)
        for (int i4 = 0; i4 < 4; ++i4) {
          int blk = 4 * i8 + i4;
          int bx = 4 * mbx + kBlkX[blk], by = 4 * mby + kBlkY[blk];
          if (cbp & (1 << i8)) {
            int64_t scan[16] = {0};
            int64_t tmp[16];
            int tc = read_residual(r, sc.nc_luma(bx, by), max_l, tmp);
            if (tc < 0) return -1;
            for (int k = 0; k < max_l; ++k) scan[16 - max_l + k] = tmp[k];
            std::memcpy(luma[blk], scan, sizeof(scan));
            sc.tc_y[by * (coded_w / 4) + bx] = (int16_t)tc;
          } else {
            sc.tc_y[by * (coded_w / 4) + bx] = 0;
          }
        }
      // chroma residuals
      int64_t cdc[2][4] = {{0}};
      int64_t cac[2][4][16];
      std::memset(cac, 0, sizeof(cac));
      if (cbp >> 4) {
        for (int c = 0; c < 2; ++c) {
          int64_t tmp[16];
          int tc = read_residual(r, -1, 4, tmp);
          if (tc < 0) return -1;
          for (int k = 0; k < 4; ++k) cdc[c][k] = tmp[k];
        }
      }
      for (int c = 0; c < 2; ++c) {
        std::vector<int16_t> &tp = c == 0 ? sc.tc_cb : sc.tc_cr;
        for (int blk = 0; blk < 4; ++blk) {
          int bx = 2 * mbx + blk % 2, by = 2 * mby + blk / 2;
          if ((cbp >> 4) == 2) {
            int64_t tmp[16];
            int tc = read_residual(r, sc.nc_of(tp, coded_w / 8, bx, by), 15,
                                   tmp);
            if (tc < 0) return -1;
            for (int k = 0; k < 15; ++k) cac[c][blk][1 + k] = tmp[k];
            tp[by * (coded_w / 8) + bx] = (int16_t)tc;
          } else {
            tp[by * (coded_w / 8) + bx] = 0;
          }
        }
      }
      // ---- reconstruction ----
      if (inter) {
        for (int blk = 0; blk < 16; ++blk) {
          int bxx = kBlkX[blk], byy = kBlkY[blk];
          int64_t c[16], d[16];
          scan_to_raster(luma[blk], c);
          dequant4x4(c, sc.qp, d);
          int64_t pp[16];
          for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
              pp[4 * yy + xx] = pred_y16[16 * (4 * byy + yy) + 4 * bxx + xx];
          add_block(out_y, coded_w, 16 * mbx + 4 * bxx, 16 * mby + 4 * byy,
                    pp, d);
        }
        for (int j = 0; j < 4; ++j)
          for (int i = 0; i < 4; ++i)
            sc.modes[(4 * mby + j) * (coded_w / 4) + 4 * mbx + i] = 2;
      } else if (i16_pred >= 0) {
        int64_t pred[256];
        if (!predict16(i16_pred, out_y, coded_w, 16 * mbx, 16 * mby, mbx > 0,
                       mby > 0, pred))
          return -1;
        for (int blk = 0; blk < 16; ++blk) {
          int bxx = kBlkX[blk], byy = kBlkY[blk];
          int64_t c[16], d[16];
          scan_to_raster(luma[blk], c);
          dequant4x4(c, sc.qp, d);
          d[0] = dc16[4 * byy + bxx];
          int64_t pp[16];
          for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
              pp[4 * yy + xx] = pred[16 * (4 * byy + yy) + 4 * bxx + xx];
          add_block(out_y, coded_w, 16 * mbx + 4 * bxx, 16 * mby + 4 * byy,
                    pp, d);
        }
        for (int j = 0; j < 4; ++j)
          for (int i = 0; i < 4; ++i)
            sc.modes[(4 * mby + j) * (coded_w / 4) + 4 * mbx + i] = 2;
      } else {
        for (int blk = 0; blk < 16; ++blk) {
          int bx = 4 * mbx + kBlkX[blk], by = 4 * mby + kBlkY[blk];
          int x0 = 4 * bx, y0 = 4 * by;
          int64_t left[4], top[4], tr[4], tl;
          bool hl, ht, htr;
          sc.luma_neighbors(x0, y0, blk, left, top, tr, tl, hl, ht, htr);
          int64_t pred[16];
          if (!predict4x4(mode4[blk], left, top, htr ? tr : nullptr, tl, hl,
                          ht, hl && ht, pred))
            return -1;
          int64_t c[16], d[16];
          scan_to_raster(luma[blk], c);
          dequant4x4(c, sc.qp, d);
          add_block(out_y, coded_w, x0, y0, pred, d);
        }
      }
      // chroma recon
      int qpc_i = sc.qp + sc.cqp_off;
      qpc_i = qpc_i < 0 ? 0 : (qpc_i > 51 ? 51 : qpc_i);
      int qpc = kChromaQp[qpc_i];
      for (int c = 0; c < 2; ++c) {
        uint8_t *plane = c == 0 ? out_cb : out_cr;
        int stride = coded_w / 2;
        int64_t pred[64];
        if (inter) {
          const uint8_t *src = c == 0 ? pred_cb8 : pred_cr8;
          for (int i = 0; i < 64; ++i) pred[i] = src[i];
        } else if (!predict_chroma(chroma_mode, plane, stride, 8 * mbx,
                                   8 * mby, mbx > 0, mby > 0, pred))
          return -1;
        int64_t f00 = cdc[c][0] + cdc[c][1] + cdc[c][2] + cdc[c][3];
        int64_t f01 = cdc[c][0] - cdc[c][1] + cdc[c][2] - cdc[c][3];
        int64_t f10 = cdc[c][0] + cdc[c][1] - cdc[c][2] - cdc[c][3];
        int64_t f11 = cdc[c][0] - cdc[c][1] - cdc[c][2] + cdc[c][3];
        int64_t ls = 16ll * kDequantV[3 * (qpc % 6)];
        int64_t dcv[4] = {((f00 * ls) << (qpc / 6)) >> 5,
                          ((f01 * ls) << (qpc / 6)) >> 5,
                          ((f10 * ls) << (qpc / 6)) >> 5,
                          ((f11 * ls) << (qpc / 6)) >> 5};
        for (int blk = 0; blk < 4; ++blk) {
          int64_t cc[16], d[16];
          scan_to_raster(cac[c][blk], cc);
          dequant4x4(cc, qpc, d);
          d[0] = dcv[blk];
          int64_t pp[16];
          int bxx = blk % 2, byy = blk / 2;
          for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
              pp[4 * yy + xx] = pred[8 * (4 * byy + yy) + 4 * bxx + xx];
          add_block(plane, stride, 8 * mbx + 4 * bxx, 8 * mby + 4 * byy, pp,
                    d);
        }
      }
    }
  }
  return r.ok ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Encode entry — whole IDR slice RBSP (header + MBs + trailing)
// ---------------------------------------------------------------------------

extern "C" long uvt_h264_encode_slice(
    const uint8_t *src_y, const uint8_t *src_cb, const uint8_t *src_cr,
    int w, int h, int qp, int pcm_from_mby, int idr_pic_id,
    const uint8_t *prev_y, const uint8_t *prev_cb, const uint8_t *prev_cr,
    int frame_num, double skip_thresh,
    uint8_t *recon_y, uint8_t *recon_cb, uint8_t *recon_cr,
    uint8_t *out, long out_cap) {
  const bool is_p = prev_y != nullptr;
  BitWriter bw;
  bw.ue(0);                       // first_mb_in_slice
  bw.ue(is_p ? 5 : 7);            // slice_type (all slices)
  bw.ue(0);                       // pps id
  bw.u(is_p ? (frame_num & 0xF) : 0, 4);
  if (!is_p) bw.ue(idr_pic_id & 0xFFFF);
  if (is_p) {
    bw.u(0, 1);  // num_ref_idx_active_override
    bw.u(0, 1);  // ref_pic_list_modification_flag_l0
    bw.u(0, 1);  // adaptive_ref_pic_marking (sliding window)
  } else {
    bw.u(0, 1);
    bw.u(0, 1);  // dec_ref_pic_marking (IDR form)
  }
  bw.se(qp - 26);
  bw.ue(1);  // deblocking off

  std::vector<uint8_t> ry((size_t)w * h), rcb((size_t)(w / 2) * (h / 2)),
      rcr((size_t)(w / 2) * (h / 2));
  Slice sc(w, h, qp, 0, ry.data(), rcb.data(), rcr.data());
  double lam_f = 0.85 * std::pow(2.0, (qp - 12) / 3.0);
  int64_t lam = (int64_t)lam_f;
  if (lam < 1) lam = 1;
  const int mb_off = is_p ? 5 : 0;

  int qpc = kChromaQp[qp < 0 ? 0 : (qp > 51 ? 51 : qp)];
  int w_mb = w / 16, h_mb = h / 16;
  uint32_t skip_run = 0;
  for (int mby = 0; mby < h_mb; ++mby)
    for (int mbx = 0; mbx < w_mb; ++mbx) {
      const bool is_pcm = pcm_from_mby >= 0 && mby >= pcm_from_mby;
      if (is_p) {
        // P_Skip decision: SSD of the co-located reference MB; counter
        // strip MBs may only skip when BIT-EXACT (ssd == 0)
        int64_t ssd = 0;
        for (int j = 0; j < 16; ++j)
          for (int i2 = 0; i2 < 16; ++i2) {
            int64_t d = (int64_t)src_y[(16 * mby + j) * w + 16 * mbx + i2] -
                        prev_y[(16 * mby + j) * w + 16 * mbx + i2];
            ssd += d * d;
          }
        for (int j = 0; j < 8; ++j)
          for (int i2 = 0; i2 < 8; ++i2) {
            long o = (8 * mby + j) * (w / 2) + 8 * mbx + i2;
            int64_t d0 = (int64_t)src_cb[o] - prev_cb[o];
            int64_t d1 = (int64_t)src_cr[o] - prev_cr[o];
            ssd += d0 * d0 + d1 * d1;
          }
        if ((double)ssd <= (is_pcm ? 0.0 : skip_thresh)) {
          for (int j = 0; j < 16; ++j)
            std::memcpy(ry.data() + (16 * mby + j) * w + 16 * mbx,
                        prev_y + (16 * mby + j) * w + 16 * mbx, 16);
          for (int j = 0; j < 8; ++j) {
            std::memcpy(rcb.data() + (8 * mby + j) * (w / 2) + 8 * mbx,
                        prev_cb + (8 * mby + j) * (w / 2) + 8 * mbx, 8);
            std::memcpy(rcr.data() + (8 * mby + j) * (w / 2) + 8 * mbx,
                        prev_cr + (8 * mby + j) * (w / 2) + 8 * mbx, 8);
          }
          for (int j = 0; j < 4; ++j)
            for (int i2 = 0; i2 < 4; ++i2) {
              sc.tc_y[(4 * mby + j) * (w / 4) + 4 * mbx + i2] = 0;
              sc.modes[(4 * mby + j) * (w / 4) + 4 * mbx + i2] = 2;
            }
          for (int j = 0; j < 2; ++j)
            for (int i2 = 0; i2 < 2; ++i2) {
              sc.tc_cb[(2 * mby + j) * (w / 8) + 2 * mbx + i2] = 0;
              sc.tc_cr[(2 * mby + j) * (w / 8) + 2 * mbx + i2] = 0;
            }
          ++skip_run;
          continue;
        }
        bw.ue(skip_run);
        skip_run = 0;
      }
      if (is_pcm) {  // I_PCM
        bw.ue(25 + mb_off);
        bw.align();
        uint8_t buf[384];
        for (int j = 0; j < 16; ++j)
          std::memcpy(buf + 16 * j, src_y + (16 * mby + j) * w + 16 * mbx,
                      16);
        for (int j = 0; j < 8; ++j) {
          std::memcpy(buf + 256 + 8 * j,
                      src_cb + (8 * mby + j) * (w / 2) + 8 * mbx, 8);
          std::memcpy(buf + 320 + 8 * j,
                      src_cr + (8 * mby + j) * (w / 2) + 8 * mbx, 8);
        }
        bw.raw(buf, 384);
        for (int j = 0; j < 16; ++j)
          std::memcpy(ry.data() + (16 * mby + j) * w + 16 * mbx, buf + 16 * j,
                      16);
        for (int j = 0; j < 8; ++j) {
          std::memcpy(rcb.data() + (8 * mby + j) * (w / 2) + 8 * mbx,
                      buf + 256 + 8 * j, 8);
          std::memcpy(rcr.data() + (8 * mby + j) * (w / 2) + 8 * mbx,
                      buf + 320 + 8 * j, 8);
        }
        sc.mark_pcm(mbx, mby);
        continue;
      }
      // ---- I_4x4 ----
      int modes[16];
      int64_t coeffs[16][16];
      for (int blk = 0; blk < 16; ++blk) {
        int bx = 4 * mbx + kBlkX[blk], by = 4 * mby + kBlkY[blk];
        int x0 = 4 * bx, y0 = 4 * by;
        int64_t left[4], top[4], tr[4], tl;
        bool hl, ht, htr;
        sc.luma_neighbors(x0, y0, blk, left, top, tr, tl, hl, ht, htr);
        int64_t src[16];
        for (int yy = 0; yy < 4; ++yy)
          for (int xx = 0; xx < 4; ++xx)
            src[4 * yy + xx] = src_y[(y0 + yy) * w + x0 + xx];
        int pm = sc.pred_mode4(bx, by);
        int64_t best_cost = -1;
        int best_mode = 2;
        int64_t best_pred[16];
        for (int mode = 0; mode < 9; ++mode) {
          int64_t pred[16];
          if (!predict4x4(mode, left, top, htr ? tr : nullptr, tl, hl, ht,
                          hl && ht, pred))
            continue;
          int64_t cost = 0;
          for (int i = 0; i < 16; ++i)
            cost += llabs(src[i] - pred[i]);
          cost += lam * (mode == pm ? 1 : 4);
          if (best_cost < 0 || cost < best_cost) {
            best_cost = cost;
            best_mode = mode;
            std::memcpy(best_pred, pred, sizeof(pred));
          }
        }
        modes[blk] = best_mode;
        sc.modes[by * (w / 4) + bx] = (int8_t)best_mode;
        int64_t res[16], wt[16], q[16];
        for (int i = 0; i < 16; ++i) res[i] = src[i] - best_pred[i];
        forward4x4(res, wt);
        quant4x4(wt, qp, false, q);
        for (int i = 0; i < 16; ++i) coeffs[blk][i] = q[kZigzag[i]];
        int64_t d[16];
        dequant4x4(q, qp, d);
        add_block(ry.data(), w, x0, y0, best_pred, d);
      }
      // chroma: best of DC/H/V over both components
      int best_c = 0;
      int64_t best_sad = -1;
      int64_t cpred[2][64];
      for (int cm = 0; cm < 3; ++cm) {
        if (cm == 1 && mbx == 0) continue;
        if (cm == 2 && mby == 0) continue;
        int64_t sad = 0;
        int64_t p0[64], p1[64];
        if (!predict_chroma(cm, rcb.data(), w / 2, 8 * mbx, 8 * mby, mbx > 0,
                            mby > 0, p0))
          continue;
        if (!predict_chroma(cm, rcr.data(), w / 2, 8 * mbx, 8 * mby, mbx > 0,
                            mby > 0, p1))
          continue;
        for (int yy = 0; yy < 8; ++yy)
          for (int xx = 0; xx < 8; ++xx) {
            sad += llabs(
                (int64_t)src_cb[(8 * mby + yy) * (w / 2) + 8 * mbx + xx] -
                p0[8 * yy + xx]);
            sad += llabs(
                (int64_t)src_cr[(8 * mby + yy) * (w / 2) + 8 * mbx + xx] -
                p1[8 * yy + xx]);
          }
        if (best_sad < 0 || sad < best_sad) {
          best_sad = sad;
          best_c = cm;
          std::memcpy(cpred[0], p0, sizeof(p0));
          std::memcpy(cpred[1], p1, sizeof(p1));
        }
      }
      int64_t cdc_q[2][4];
      int64_t cac_q[2][4][16];
      for (int c = 0; c < 2; ++c) {
        const uint8_t *srcp = c == 0 ? src_cb : src_cr;
        uint8_t *recp = c == 0 ? rcb.data() : rcr.data();
        int stride = w / 2;
        int64_t ws[4][16];
        for (int b = 0; b < 4; ++b) {
          int bxx = b % 2, byy = b / 2;
          int64_t res[16];
          for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
              res[4 * yy + xx] =
                  (int64_t)srcp[(8 * mby + 4 * byy + yy) * stride + 8 * mbx +
                                4 * bxx + xx] -
                  cpred[c][8 * (4 * byy + yy) + 4 * bxx + xx];
          forward4x4(res, ws[b]);
        }
        int64_t d0 = ws[0][0], d1 = ws[1][0], d2 = ws[2][0], d3 = ws[3][0];
        int64_t fdc[4] = {d0 + d1 + d2 + d3, d0 - d1 + d2 - d3,
                          d0 + d1 - d2 - d3, d0 - d1 - d2 + d3};
        int64_t mf = kQuantMF[3 * (qpc % 6)];
        int qbits = 15 + qpc / 6;
        int64_t fdz = 2 * ((1ll << qbits) / 3);
        for (int i = 0; i < 4; ++i) {
          int64_t lv = (llabs(fdc[i]) * mf + fdz) >> (qbits + 1);
          cdc_q[c][i] = fdc[i] < 0 ? -lv : lv;
        }
        for (int b = 0; b < 4; ++b) {
          int64_t q[16];
          quant4x4(ws[b], qpc, true, q);
          for (int i = 0; i < 16; ++i) cac_q[c][b][i] = q[kZigzag[i]];
        }
        // reconstruct
        int64_t g0 = cdc_q[c][0] + cdc_q[c][1] + cdc_q[c][2] + cdc_q[c][3];
        int64_t g1 = cdc_q[c][0] - cdc_q[c][1] + cdc_q[c][2] - cdc_q[c][3];
        int64_t g2 = cdc_q[c][0] + cdc_q[c][1] - cdc_q[c][2] - cdc_q[c][3];
        int64_t g3 = cdc_q[c][0] - cdc_q[c][1] - cdc_q[c][2] + cdc_q[c][3];
        int64_t ls = 16ll * kDequantV[3 * (qpc % 6)];
        int64_t dcv[4] = {((g0 * ls) << (qpc / 6)) >> 5,
                          ((g1 * ls) << (qpc / 6)) >> 5,
                          ((g2 * ls) << (qpc / 6)) >> 5,
                          ((g3 * ls) << (qpc / 6)) >> 5};
        for (int b = 0; b < 4; ++b) {
          int64_t cc[16], d[16];
          scan_to_raster(cac_q[c][b], cc);
          dequant4x4(cc, qpc, d);
          d[0] = dcv[b];
          int64_t pp[16];
          int bxx = b % 2, byy = b / 2;
          for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx)
              pp[4 * yy + xx] = cpred[c][8 * (4 * byy + yy) + 4 * bxx + xx];
          add_block(recp, stride, 8 * mbx + 4 * bxx, 8 * mby + 4 * byy, pp,
                    d);
        }
      }
      // cbp
      int cbp = 0;
      for (int i8 = 0; i8 < 4; ++i8) {
        bool any = false;
        for (int i4 = 0; i4 < 4 && !any; ++i4)
          for (int i = 0; i < 16; ++i)
            if (coeffs[4 * i8 + i4][i]) { any = true; break; }
        if (any) cbp |= 1 << i8;
      }
      bool any_ac = false, any_dc = false;
      for (int c = 0; c < 2; ++c) {
        for (int b = 0; b < 4; ++b)
          for (int i = 0; i < 16; ++i)
            if (cac_q[c][b][i]) any_ac = true;
        for (int i = 0; i < 4; ++i)
          if (cdc_q[c][i]) any_dc = true;
      }
      if (any_ac) cbp |= 2 << 4;
      else if (any_dc) cbp |= 1 << 4;
      // syntax
      bw.ue(0 + mb_off);
      for (int blk = 0; blk < 16; ++blk) {
        int bx = 4 * mbx + kBlkX[blk], by = 4 * mby + kBlkY[blk];
        int pm = sc.pred_mode4(bx, by);
        int mode = modes[blk];
        if (mode == pm) bw.u(1, 1);
        else {
          bw.u(0, 1);
          bw.u(mode - (mode > pm ? 1 : 0), 3);
        }
      }
      bw.ue(best_c);
      int code = -1;
      for (int i = 0; i < 48; ++i)
        if (kCbpIntraFromCode[i] == cbp) { code = i; break; }
      bw.ue(code);
      if (cbp) bw.se(0);
      for (int i8 = 0; i8 < 4; ++i8)
        for (int i4 = 0; i4 < 4; ++i4) {
          int blk = 4 * i8 + i4;
          int bx = 4 * mbx + kBlkX[blk], by = 4 * mby + kBlkY[blk];
          if (cbp & (1 << i8))
            sc.tc_y[by * (w / 4) + bx] = (int16_t)write_residual(
                bw, coeffs[blk], 16, sc.nc_luma(bx, by));
          else
            sc.tc_y[by * (w / 4) + bx] = 0;
        }
      if (cbp >> 4)
        for (int c = 0; c < 2; ++c) write_residual(bw, cdc_q[c], 4, -1);
      for (int c = 0; c < 2; ++c) {
        std::vector<int16_t> &tp = c == 0 ? sc.tc_cb : sc.tc_cr;
        for (int blk = 0; blk < 4; ++blk) {
          int bx = 2 * mbx + blk % 2, by = 2 * mby + blk / 2;
          if ((cbp >> 4) == 2)
            tp[by * (w / 8) + bx] = (int16_t)write_residual(
                bw, cac_q[c][blk] + 1, 15, sc.nc_of(tp, w / 8, bx, by));
          else
            tp[by * (w / 8) + bx] = 0;
        }
      }
    }
  if (is_p && skip_run) bw.ue(skip_run);  // trailing skip run
  bw.trailing();
  if ((long)bw.bytes.size() > out_cap) return -2;
  std::memcpy(out, bw.bytes.data(), bw.bytes.size());
  if (recon_y) {
    std::memcpy(recon_y, ry.data(), ry.size());
    std::memcpy(recon_cb, rcb.data(), rcb.size());
    std::memcpy(recon_cr, rcr.data(), rcr.size());
  }
  return (long)bw.bytes.size();
}

// ---------------------------------------------------------------------------
// Motion-compensated P-slice ENCODE (round 5) — bit-identical native
// mirror of codecs/h264.py:encode_p_planes(motion=True) + the
// SliceCoder encode methods it trial-runs (encode_mb_inter16 /
// encode_mb_i16 / encode_mb_i4x4, h264_intra.py). The Python coder
// stays as oracle and fallback (~40 s/frame at 1024^2); parity locked
// by tests/test_h264_inter.py.
// ---------------------------------------------------------------------------

namespace {

int se_bits_c(int v) {
  unsigned code_num = v > 0 ? 2u * v - 1 : -2 * v;
  int bl = 32 - __builtin_clz(code_num + 1);
  return 2 * bl - 1;
}

// Python int(round(v / 4.0)): floor division + round-half-to-even
int round_div4_half_even(int v) {
  int q = v >> 2;
  int r = v & 3;
  if (r == 0 || r == 1) return q;
  if (r == 3) return q + 1;
  return (q % 2 == 0) ? q : q + 1;  // .5 -> even
}

struct PEnc {
  const uint8_t *sy, *scb, *scr;   // source planes
  const uint8_t *py, *pcb, *pcr;   // reference (prev recon) planes
  int w, h;
  Slice *sc;
  int qp;
  int64_t lam;
};

// source luma 4x4 at absolute (x0, y0) into s[16]
inline void load_src4(const uint8_t *plane, int stride, int x0, int y0,
                      int64_t s[16]) {
  for (int yy = 0; yy < 4; ++yy)
    for (int xx = 0; xx < 4; ++xx)
      s[4 * yy + xx] = plane[(size_t)(y0 + yy) * stride + x0 + xx];
}

// ---- shared chroma machinery (mirrors the Python encoders' chroma) ----

// best of DC/H/V by SAD over both components; fills cpred[2][64]
int chroma_select(PEnc &e, int mbx, int mby, int64_t cpred[2][64]) {
  int cx = 8 * mbx, cy = 8 * mby;
  int stride = e.w / 2;
  int best_mode = 0;
  int64_t best_sad = -1;
  for (int cm = 0; cm < 3; ++cm) {
    if (cm == 1 && mbx == 0) continue;
    if (cm == 2 && mby == 0) continue;
    int64_t p0[64], p1[64];
    if (!predict_chroma(cm, e.sc->cb, stride, cx, cy, mbx > 0, mby > 0, p0))
      continue;
    if (!predict_chroma(cm, e.sc->cr, stride, cx, cy, mbx > 0, mby > 0, p1))
      continue;
    int64_t sad = 0;
    for (int yy = 0; yy < 8; ++yy)
      for (int xx = 0; xx < 8; ++xx) {
        sad += llabs((int64_t)e.scb[(size_t)(cy + yy) * stride + cx + xx] -
                     p0[8 * yy + xx]);
        sad += llabs((int64_t)e.scr[(size_t)(cy + yy) * stride + cx + xx] -
                     p1[8 * yy + xx]);
      }
    if (best_sad < 0 || sad < best_sad) {
      best_sad = sad;
      best_mode = cm;
      std::memcpy(cpred[0], p0, sizeof(p0));
      std::memcpy(cpred[1], p1, sizeof(p1));
    }
  }
  return best_mode;
}

// quantize chroma residual vs cpred: cdc_q scan[4] + cac_q scan[4][16]
// (AC slot 0 zero); also reconstructs into the slice planes
void chroma_quant_recon(PEnc &e, int mbx, int mby,
                        const int64_t cpred[2][64], int qpc,
                        int64_t cdc_q[2][4], int64_t cac_q[2][4][16]) {
  int cx = 8 * mbx, cy = 8 * mby;
  int stride = e.w / 2;
  for (int c = 0; c < 2; ++c) {
    const uint8_t *srcp = c == 0 ? e.scb : e.scr;
    uint8_t *recp = c == 0 ? e.sc->cb : e.sc->cr;
    int64_t ws[4][16];
    for (int b = 0; b < 4; ++b) {
      int bxx = b % 2, byy = b / 2;
      int64_t res[16];
      for (int yy = 0; yy < 4; ++yy)
        for (int xx = 0; xx < 4; ++xx)
          res[4 * yy + xx] =
              (int64_t)srcp[(size_t)(cy + 4 * byy + yy) * stride + cx +
                            4 * bxx + xx] -
              cpred[c][8 * (4 * byy + yy) + 4 * bxx + xx];
      forward4x4(res, ws[b]);
    }
    int64_t d0 = ws[0][0], d1 = ws[1][0], d2 = ws[2][0], d3 = ws[3][0];
    int64_t fdc[4] = {d0 + d1 + d2 + d3, d0 - d1 + d2 - d3,
                      d0 + d1 - d2 - d3, d0 - d1 - d2 + d3};
    int64_t mf = kQuantMF[3 * (qpc % 6)];
    int qbits = 15 + qpc / 6;
    int64_t fdz = 2 * ((1ll << qbits) / 3);
    for (int i = 0; i < 4; ++i) {
      int64_t lv = (llabs(fdc[i]) * mf + fdz) >> (qbits + 1);
      cdc_q[c][i] = fdc[i] < 0 ? -lv : lv;
    }
    for (int b = 0; b < 4; ++b) {
      int64_t q[16];
      quant4x4(ws[b], qpc, true, q);
      for (int i = 0; i < 16; ++i) cac_q[c][b][i] = q[kZigzag[i]];
    }
    // reconstruct
    int64_t g0 = cdc_q[c][0] + cdc_q[c][1] + cdc_q[c][2] + cdc_q[c][3];
    int64_t g1 = cdc_q[c][0] - cdc_q[c][1] + cdc_q[c][2] - cdc_q[c][3];
    int64_t g2 = cdc_q[c][0] + cdc_q[c][1] - cdc_q[c][2] - cdc_q[c][3];
    int64_t g3 = cdc_q[c][0] - cdc_q[c][1] - cdc_q[c][2] + cdc_q[c][3];
    int64_t ls = 16ll * kDequantV[3 * (qpc % 6)];
    int64_t dcv[4] = {((g0 * ls) << (qpc / 6)) >> 5,
                      ((g1 * ls) << (qpc / 6)) >> 5,
                      ((g2 * ls) << (qpc / 6)) >> 5,
                      ((g3 * ls) << (qpc / 6)) >> 5};
    for (int b = 0; b < 4; ++b) {
      int64_t cc[16], d[16];
      scan_to_raster(cac_q[c][b], cc);
      dequant4x4(cc, qpc, d);
      d[0] = dcv[b];
      int64_t pp[16];
      int bxx = b % 2, byy = b / 2;
      for (int yy = 0; yy < 4; ++yy)
        for (int xx = 0; xx < 4; ++xx)
          pp[4 * yy + xx] = cpred[c][8 * (4 * byy + yy) + 4 * bxx + xx];
      add_block(recp, stride, cx + 4 * bxx, cy + 4 * byy, pp, d);
    }
  }
}

int chroma_cbp_of(const int64_t cdc_q[2][4], const int64_t cac_q[2][4][16]) {
  bool any_ac = false, any_dc = false;
  for (int c = 0; c < 2; ++c) {
    for (int b = 0; b < 4; ++b)
      for (int i = 0; i < 16; ++i)
        if (cac_q[c][b][i]) any_ac = true;
    for (int i = 0; i < 4; ++i)
      if (cdc_q[c][i]) any_dc = true;
  }
  return any_ac ? 2 : (any_dc ? 1 : 0);
}

void write_chroma_residuals(PEnc &e, BitWriter &bw, int mbx, int mby,
                            int cbp, const int64_t cdc_q[2][4],
                            const int64_t cac_q[2][4][16]) {
  if (cbp >> 4)
    for (int c = 0; c < 2; ++c)
      write_residual(bw, cdc_q[c], 4, -1);
  for (int c = 0; c < 2; ++c) {
    std::vector<int16_t> &tp = c == 0 ? e.sc->tc_cb : e.sc->tc_cr;
    for (int blk = 0; blk < 4; ++blk) {
      int bx = 2 * mbx + blk % 2, by = 2 * mby + blk / 2;
      if ((cbp >> 4) == 2)
        tp[by * (e.w / 8) + bx] = (int16_t)write_residual(
            bw, cac_q[c][blk] + 1, 15, e.sc->nc_of(tp, e.w / 8, bx, by));
      else
        tp[by * (e.w / 8) + bx] = 0;
    }
  }
}

// ---- per-MB encoders (syntax + reconstruction + state) -----------------

void mb_enc_i4(PEnc &e, BitWriter &bw, int mbx, int mby, int off) {
  Slice &sc = *e.sc;
  int qp = e.qp;
  int modes[16];
  int64_t coeffs[16][16];
  for (int blk = 0; blk < 16; ++blk) {
    int bx = 4 * mbx + kBlkX[blk], by = 4 * mby + kBlkY[blk];
    int x0 = 4 * bx, y0 = 4 * by;
    int64_t left[4], top[4], tr[4], tl;
    bool hl, ht, htr;
    sc.luma_neighbors(x0, y0, blk, left, top, tr, tl, hl, ht, htr);
    int64_t src[16];
    load_src4(e.sy, e.w, x0, y0, src);
    int pm = sc.pred_mode4(bx, by);
    int64_t best_cost = -1;
    int best_mode = 2;
    int64_t best_pred[16];
    for (int mode = 0; mode < 9; ++mode) {
      int64_t pred[16];
      if (!predict4x4(mode, left, top, htr ? tr : nullptr, tl, hl, ht,
                      hl && ht, pred))
        continue;
      int64_t cost = 0;
      for (int i = 0; i < 16; ++i) cost += llabs(src[i] - pred[i]);
      cost += e.lam * (mode == pm ? 1 : 4);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best_mode = mode;
        std::memcpy(best_pred, pred, sizeof(pred));
      }
    }
    modes[blk] = best_mode;
    sc.modes[by * (e.w / 4) + bx] = (int8_t)best_mode;
    int64_t res[16], wt[16], q[16];
    for (int i = 0; i < 16; ++i) res[i] = src[i] - best_pred[i];
    forward4x4(res, wt);
    quant4x4(wt, qp, false, q);
    for (int i = 0; i < 16; ++i) coeffs[blk][i] = q[kZigzag[i]];
    int64_t d[16];
    dequant4x4(q, qp, d);
    add_block(sc.y, e.w, x0, y0, best_pred, d);
  }
  int64_t cpred[2][64];
  int chroma_mode = chroma_select(e, mbx, mby, cpred);
  int qpc_i = qp + sc.cqp_off;
  qpc_i = qpc_i < 0 ? 0 : (qpc_i > 51 ? 51 : qpc_i);
  int qpc = kChromaQp[qpc_i];
  int64_t cdc_q[2][4];
  int64_t cac_q[2][4][16];
  chroma_quant_recon(e, mbx, mby, cpred, qpc, cdc_q, cac_q);
  int cbp = 0;
  for (int i8 = 0; i8 < 4; ++i8) {
    bool any = false;
    for (int i4 = 0; i4 < 4 && !any; ++i4)
      for (int i = 0; i < 16; ++i)
        if (coeffs[4 * i8 + i4][i]) { any = true; break; }
    if (any) cbp |= 1 << i8;
  }
  cbp |= chroma_cbp_of(cdc_q, cac_q) << 4;
  // syntax
  bw.ue(0 + off);
  for (int blk = 0; blk < 16; ++blk) {
    int bx = 4 * mbx + kBlkX[blk], by = 4 * mby + kBlkY[blk];
    int pm = sc.pred_mode4(bx, by);
    int mode = modes[blk];
    if (mode == pm) bw.u(1, 1);
    else {
      bw.u(0, 1);
      bw.u(mode - (mode > pm ? 1 : 0), 3);
    }
  }
  bw.ue(chroma_mode);
  int code = -1;
  for (int i = 0; i < 48; ++i)
    if (kCbpIntraFromCode[i] == cbp) { code = i; break; }
  bw.ue(code);
  if (cbp) bw.se(0);
  for (int i8 = 0; i8 < 4; ++i8)
    for (int i4 = 0; i4 < 4; ++i4) {
      int blk = 4 * i8 + i4;
      int bx = 4 * mbx + kBlkX[blk], by = 4 * mby + kBlkY[blk];
      if (cbp & (1 << i8))
        sc.tc_y[by * (e.w / 4) + bx] = (int16_t)write_residual(
            bw, coeffs[blk], 16, sc.nc_luma(bx, by));
      else
        sc.tc_y[by * (e.w / 4) + bx] = 0;
    }
  write_chroma_residuals(e, bw, mbx, mby, cbp, cdc_q, cac_q);
}

void mb_enc_i16(PEnc &e, BitWriter &bw, int mbx, int mby, int off) {
  Slice &sc = *e.sc;
  int qp = e.qp;
  int x0 = 16 * mbx, y0 = 16 * mby;
  int bx0 = 4 * mbx, by0 = 4 * mby;
  bool left_avail = mbx > 0, top_avail = mby > 0;
  int64_t src[256];
  for (int yy = 0; yy < 16; ++yy)
    for (int xx = 0; xx < 16; ++xx)
      src[16 * yy + xx] = e.sy[(size_t)(y0 + yy) * e.w + x0 + xx];
  int pred_mode = -1;
  int64_t best_sad = -1;
  int64_t pred[256];
  for (int pm = 0; pm < 4; ++pm) {
    if (pm == 0 && !top_avail) continue;
    if (pm == 1 && !left_avail) continue;
    if (pm == 3 && !(top_avail && left_avail)) continue;
    int64_t p[256];
    if (!predict16(pm, sc.y, e.w, x0, y0, left_avail, top_avail, p))
      continue;
    int64_t sad = 0;
    for (int i = 0; i < 256; ++i) sad += llabs(src[i] - p[i]);
    if (best_sad < 0 || sad < best_sad) {
      best_sad = sad;
      pred_mode = pm;
      std::memcpy(pred, p, sizeof(p));
    }
  }
  // residual transform per 4x4; DC Hadamard chain (JM halved form)
  int64_t ws[16][16];
  for (int b = 0; b < 16; ++b) {
    int bxx = kBlkX[b], byy = kBlkY[b];
    int64_t res[16];
    for (int yy = 0; yy < 4; ++yy)
      for (int xx = 0; xx < 4; ++xx)
        res[4 * yy + xx] = src[16 * (4 * byy + yy) + 4 * bxx + xx] -
                           pred[16 * (4 * byy + yy) + 4 * bxx + xx];
    forward4x4(res, ws[b]);
  }
  static const int hh4[4][4] = {{1, 1, 1, 1}, {1, 1, -1, -1},
                                {1, -1, -1, 1}, {1, -1, 1, -1}};
  int64_t dcs[16];
  for (int b = 0; b < 16; ++b) dcs[4 * kBlkY[b] + kBlkX[b]] = ws[b][0];
  int64_t t[16], fdc[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      int64_t s = 0;
      for (int k = 0; k < 4; ++k) s += hh4[i][k] * dcs[4 * k + j];
      t[4 * i + j] = s;
    }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      int64_t s = 0;
      for (int k = 0; k < 4; ++k) s += t[4 * i + k] * hh4[k][j];
      // Python // 2 floors on negatives: arithmetic shift
      fdc[4 * i + j] = s >> 1;
    }
  int64_t mf = kQuantMF[3 * (qp % 6)];
  int qbits = 15 + qp / 6;
  int64_t fdz = 2 * ((1ll << qbits) / 3);
  int64_t qdc[16], dc_scan[16];
  for (int i = 0; i < 16; ++i) {
    int64_t lv = (llabs(fdc[i]) * mf + fdz) >> (qbits + 1);
    qdc[i] = fdc[i] < 0 ? -lv : lv;
  }
  for (int i = 0; i < 16; ++i) dc_scan[i] = qdc[kZigzag[i]];
  int64_t acs[16][16];
  for (int b = 0; b < 16; ++b) {
    int64_t q[16];
    quant4x4(ws[b], qp, true, q);
    for (int i = 0; i < 16; ++i) acs[b][i] = q[kZigzag[i]];
  }
  int cbp_luma = 0;
  for (int b = 0; b < 16 && !cbp_luma; ++b)
    for (int i = 1; i < 16; ++i)
      if (acs[b][i]) { cbp_luma = 15; break; }
  // chroma (shared machinery)
  int64_t cpred[2][64];
  int chroma_mode = chroma_select(e, mbx, mby, cpred);
  int qpc_i = qp + sc.cqp_off;
  qpc_i = qpc_i < 0 ? 0 : (qpc_i > 51 ? 51 : qpc_i);
  int qpc = kChromaQp[qpc_i];
  int64_t cdc_q[2][4];
  int64_t cac_q[2][4][16];
  // NOTE recon order: luma recon must use `pred` built from the PRE-MB
  // plane state; chroma recon is independent. Python reconstructs luma
  // after writing syntax; chroma via _recon_chroma. We quantize chroma
  // first (it also reconstructs), matching Python's compute order where
  // chroma quant happens before syntax.
  chroma_quant_recon(e, mbx, mby, cpred, qpc, cdc_q, cac_q);
  int cbp_chroma = chroma_cbp_of(cdc_q, cac_q);
  // ---- syntax ----
  int mb_type = 1 + pred_mode + 4 * cbp_chroma + (cbp_luma ? 12 : 0);
  bw.ue(mb_type + off);
  bw.ue(chroma_mode);
  bw.se(0);  // mb_qp_delta (always present for I16)
  write_residual(bw, dc_scan, 16, sc.nc_luma(bx0, by0));
  int cbp = cbp_luma | (cbp_chroma << 4);
  for (int i8 = 0; i8 < 4; ++i8)
    for (int i4 = 0; i4 < 4; ++i4) {
      int blk = 4 * i8 + i4;
      int bx = bx0 + kBlkX[blk], by = by0 + kBlkY[blk];
      if (cbp & (1 << i8))
        sc.tc_y[by * (e.w / 4) + bx] = (int16_t)write_residual(
            bw, acs[blk] + 1, 15, sc.nc_luma(bx, by));
      else
        sc.tc_y[by * (e.w / 4) + bx] = 0;
    }
  write_chroma_residuals(e, bw, mbx, mby, cbp, cdc_q, cac_q);
  // ---- luma recon (mirror _decode_i16) ----
  int64_t c16[16] = {0};
  for (int i = 0; i < 16; ++i) c16[kZigzag[i]] = dc_scan[i];
  int64_t t2[16], fr[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      int64_t s = 0;
      for (int k = 0; k < 4; ++k) s += hh4[i][k] * c16[4 * k + j];
      t2[4 * i + j] = s;
    }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      int64_t s = 0;
      for (int k = 0; k < 4; ++k) s += t2[4 * i + k] * hh4[k][j];
      fr[4 * i + j] = s;
    }
  int64_t ls = 16ll * kDequantV[3 * (qp % 6)];
  int64_t dc16[16];
  for (int i = 0; i < 16; ++i) {
    if (qp >= 36) dc16[i] = (fr[i] * ls) << (qp / 6 - 6);
    else dc16[i] = (fr[i] * ls + (1ll << (5 - qp / 6))) >> (6 - qp / 6);
  }
  for (int blk = 0; blk < 16; ++blk) {
    int bxx = kBlkX[blk], byy = kBlkY[blk];
    int64_t scan_full[16];
    if (cbp_luma) {
      std::memcpy(scan_full, acs[blk], sizeof(scan_full));
      scan_full[0] = 0;
    } else {
      std::memset(scan_full, 0, sizeof(scan_full));
    }
    int64_t cc[16], d[16];
    scan_to_raster(scan_full, cc);
    dequant4x4(cc, qp, d);
    d[0] = dc16[4 * byy + bxx];
    int64_t pp[16];
    for (int yy = 0; yy < 4; ++yy)
      for (int xx = 0; xx < 4; ++xx)
        pp[4 * yy + xx] = pred[16 * (4 * byy + yy) + 4 * bxx + xx];
    add_block(sc.y, e.w, x0 + 4 * bxx, y0 + 4 * byy, pp, d);
  }
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i)
      sc.modes[(by0 + j) * (e.w / 4) + bx0 + i] = 2;
}

void mb_enc_inter16(PEnc &e, BitWriter &bw, int mbx, int mby, int mvx,
                    int mvy) {
  Slice &sc = *e.sc;
  int qp = e.qp;
  int x0 = 16 * mbx, y0 = 16 * mby;
  int cx = 8 * mbx, cy = 8 * mby;
  int bx = 4 * mbx, by = 4 * mby;
  int pmx, pmy;
  sc.predict_mv(bx, by, 4, 4, 0, pmx, pmy);
  uint8_t pred_y[256], pred_cb[64], pred_cr[64];
  mc_luma(e.py, e.w, e.h, x0, y0, 16, 16, mvx, mvy, pred_y, 16);
  mc_chroma(e.pcb, e.w / 2, e.h / 2, cx, cy, 8, 8, mvx, mvy, pred_cb, 8);
  mc_chroma(e.pcr, e.w / 2, e.h / 2, cx, cy, 8, 8, mvx, mvy, pred_cr, 8);
  int64_t coeffs[16][16];
  for (int blk = 0; blk < 16; ++blk) {
    int lx = 4 * kBlkX[blk], ly = 4 * kBlkY[blk];
    int64_t res[16], wt[16], q[16];
    for (int yy = 0; yy < 4; ++yy)
      for (int xx = 0; xx < 4; ++xx)
        res[4 * yy + xx] =
            (int64_t)e.sy[(size_t)(y0 + ly + yy) * e.w + x0 + lx + xx] -
            pred_y[16 * (ly + yy) + lx + xx];
    forward4x4(res, wt);
    quant4x4(wt, qp, false, q);
    for (int i = 0; i < 16; ++i) coeffs[blk][i] = q[kZigzag[i]];
  }
  int qpc_i = qp + sc.cqp_off;
  qpc_i = qpc_i < 0 ? 0 : (qpc_i > 51 ? 51 : qpc_i);
  int qpc = kChromaQp[qpc_i];
  int64_t cpred[2][64];
  for (int i = 0; i < 64; ++i) {
    cpred[0][i] = pred_cb[i];
    cpred[1][i] = pred_cr[i];
  }
  int64_t cdc_q[2][4];
  int64_t cac_q[2][4][16];
  chroma_quant_recon(e, mbx, mby, cpred, qpc, cdc_q, cac_q);
  int cbp = 0;
  for (int i8 = 0; i8 < 4; ++i8) {
    bool any = false;
    for (int i4 = 0; i4 < 4 && !any; ++i4)
      for (int i = 0; i < 16; ++i)
        if (coeffs[4 * i8 + i4][i]) { any = true; break; }
    if (any) cbp |= 1 << i8;
  }
  cbp |= chroma_cbp_of(cdc_q, cac_q) << 4;
  // ---- syntax ----
  bw.ue(0);  // mb_type P_L0_16x16
  bw.se(mvx - pmx);
  bw.se(mvy - pmy);
  bw.ue(kCbpInterToCode[cbp]);
  if (cbp) bw.se(0);
  for (int i8 = 0; i8 < 4; ++i8)
    for (int i4 = 0; i4 < 4; ++i4) {
      int blk = 4 * i8 + i4;
      int bxx = bx + kBlkX[blk], byy = by + kBlkY[blk];
      if (cbp & (1 << i8))
        sc.tc_y[byy * (e.w / 4) + bxx] = (int16_t)write_residual(
            bw, coeffs[blk], 16, sc.nc_luma(bxx, byy));
      else
        sc.tc_y[byy * (e.w / 4) + bxx] = 0;
    }
  write_chroma_residuals(e, bw, mbx, mby, cbp, cdc_q, cac_q);
  // ---- reconstruct luma ----
  for (int blk = 0; blk < 16; ++blk) {
    int lx = 4 * kBlkX[blk], ly = 4 * kBlkY[blk];
    int64_t cc[16], d[16];
    scan_to_raster(coeffs[blk], cc);
    dequant4x4(cc, qp, d);
    int64_t pp[16];
    for (int yy = 0; yy < 4; ++yy)
      for (int xx = 0; xx < 4; ++xx)
        pp[4 * yy + xx] = pred_y[16 * (ly + yy) + lx + xx];
    add_block(sc.y, e.w, x0 + lx, y0 + ly, pp, d);
  }
  sc.set_mv_region(bx, by, 4, 4, mvx, mvy, 0);
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i)
      sc.modes[(by + j) * (e.w / 4) + bx + i] = 2;
}

// P_Skip reconstruction: MC with the derived skip MV + state update
void mb_skip(PEnc &e, int mbx, int mby) {
  Slice &sc = *e.sc;
  int smx, smy;
  sc.skip_mv(mbx, mby, smx, smy);
  if (smx == 0 && smy == 0) {
    for (int j = 0; j < 16; ++j)
      std::memcpy(sc.y + (size_t)(16 * mby + j) * e.w + 16 * mbx,
                  e.py + (size_t)(16 * mby + j) * e.w + 16 * mbx, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(sc.cb + (size_t)(8 * mby + j) * (e.w / 2) + 8 * mbx,
                  e.pcb + (size_t)(8 * mby + j) * (e.w / 2) + 8 * mbx, 8);
      std::memcpy(sc.cr + (size_t)(8 * mby + j) * (e.w / 2) + 8 * mbx,
                  e.pcr + (size_t)(8 * mby + j) * (e.w / 2) + 8 * mbx, 8);
    }
  } else {
    mc_luma(e.py, e.w, e.h, 16 * mbx, 16 * mby, 16, 16, smx, smy,
            sc.y + (size_t)16 * mby * e.w + 16 * mbx, e.w);
    mc_chroma(e.pcb, e.w / 2, e.h / 2, 8 * mbx, 8 * mby, 8, 8, smx, smy,
              sc.cb + (size_t)8 * mby * (e.w / 2) + 8 * mbx, e.w / 2);
    mc_chroma(e.pcr, e.w / 2, e.h / 2, 8 * mbx, 8 * mby, 8, 8, smx, smy,
              sc.cr + (size_t)8 * mby * (e.w / 2) + 8 * mbx, e.w / 2);
  }
  sc.set_mv_region(4 * mbx, 4 * mby, 4, 4, smx, smy, 0);
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) {
      sc.tc_y[(4 * mby + j) * (e.w / 4) + 4 * mbx + i] = 0;
      sc.modes[(4 * mby + j) * (e.w / 4) + 4 * mbx + i] = 2;
    }
  for (int j = 0; j < 2; ++j)
    for (int i = 0; i < 2; ++i) {
      sc.tc_cb[(2 * mby + j) * (e.w / 8) + 2 * mbx + i] = 0;
      sc.tc_cr[(2 * mby + j) * (e.w / 8) + 2 * mbx + i] = 0;
    }
}

// per-MB state snapshot for RD trials (everything a trial can touch)
struct MbSnap {
  uint8_t y[256], cb[64], cr[64];
  int16_t tcy[16], tccb[4], tccr[4];
  int8_t modes[16], ref[16];
  int16_t mvx[16], mvy[16];
  uint8_t dec[16];
};

void mb_snapshot(PEnc &e, int mbx, int mby, MbSnap &s) {
  Slice &sc = *e.sc;
  for (int j = 0; j < 16; ++j)
    std::memcpy(s.y + 16 * j, sc.y + (size_t)(16 * mby + j) * e.w + 16 * mbx,
                16);
  for (int j = 0; j < 8; ++j) {
    std::memcpy(s.cb + 8 * j,
                sc.cb + (size_t)(8 * mby + j) * (e.w / 2) + 8 * mbx, 8);
    std::memcpy(s.cr + 8 * j,
                sc.cr + (size_t)(8 * mby + j) * (e.w / 2) + 8 * mbx, 8);
  }
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) {
      size_t idx = (size_t)(4 * mby + j) * (e.w / 4) + 4 * mbx + i;
      s.tcy[4 * j + i] = sc.tc_y[idx];
      s.modes[4 * j + i] = sc.modes[idx];
      s.ref[4 * j + i] = sc.ref4[idx];
      s.mvx[4 * j + i] = sc.mv4x[idx];
      s.mvy[4 * j + i] = sc.mv4y[idx];
      s.dec[4 * j + i] = sc.dec4[idx];
    }
  for (int j = 0; j < 2; ++j)
    for (int i = 0; i < 2; ++i) {
      size_t idx = (size_t)(2 * mby + j) * (e.w / 8) + 2 * mbx + i;
      s.tccb[2 * j + i] = sc.tc_cb[idx];
      s.tccr[2 * j + i] = sc.tc_cr[idx];
    }
}

void mb_restore(PEnc &e, int mbx, int mby, const MbSnap &s) {
  Slice &sc = *e.sc;
  for (int j = 0; j < 16; ++j)
    std::memcpy(sc.y + (size_t)(16 * mby + j) * e.w + 16 * mbx, s.y + 16 * j,
                16);
  for (int j = 0; j < 8; ++j) {
    std::memcpy(sc.cb + (size_t)(8 * mby + j) * (e.w / 2) + 8 * mbx,
                s.cb + 8 * j, 8);
    std::memcpy(sc.cr + (size_t)(8 * mby + j) * (e.w / 2) + 8 * mbx,
                s.cr + 8 * j, 8);
  }
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) {
      size_t idx = (size_t)(4 * mby + j) * (e.w / 4) + 4 * mbx + i;
      sc.tc_y[idx] = s.tcy[4 * j + i];
      sc.modes[idx] = s.modes[4 * j + i];
      sc.ref4[idx] = s.ref[4 * j + i];
      sc.mv4x[idx] = s.mvx[4 * j + i];
      sc.mv4y[idx] = s.mvy[4 * j + i];
      sc.dec4[idx] = s.dec[4 * j + i];
    }
  for (int j = 0; j < 2; ++j)
    for (int i = 0; i < 2; ++i) {
      size_t idx = (size_t)(2 * mby + j) * (e.w / 8) + 2 * mbx + i;
      sc.tc_cb[idx] = s.tccb[2 * j + i];
      sc.tc_cr[idx] = s.tccr[2 * j + i];
    }
}

int64_t mb_ssd(PEnc &e, int mbx, int mby) {
  Slice &sc = *e.sc;
  int64_t ssd = 0;
  for (int j = 0; j < 16; ++j)
    for (int i = 0; i < 16; ++i) {
      size_t o = (size_t)(16 * mby + j) * e.w + 16 * mbx + i;
      int64_t d = (int64_t)sc.y[o] - e.sy[o];
      ssd += d * d;
    }
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 8; ++i) {
      size_t o = (size_t)(8 * mby + j) * (e.w / 2) + 8 * mbx + i;
      int64_t d0 = (int64_t)sc.cb[o] - e.scb[o];
      int64_t d1 = (int64_t)sc.cr[o] - e.scr[o];
      ssd += d0 * d0 + d1 * d1;
    }
  return ssd;
}

}  // namespace

extern "C" long uvt_h264_encode_slice_motion(
    const uint8_t *src_y, const uint8_t *src_cb, const uint8_t *src_cr,
    int w, int h, int qp, int pcm_from_mby,
    const uint8_t *prev_y, const uint8_t *prev_cb, const uint8_t *prev_cr,
    int frame_num, double skip_thresh,
    uint8_t *recon_y, uint8_t *recon_cb, uint8_t *recon_cr,
    uint8_t *out, long out_cap) {
  BitWriter bw;
  bw.ue(0);                  // first_mb_in_slice
  bw.ue(5);                  // slice_type P (all slices)
  bw.ue(0);                  // pps id
  bw.u(frame_num & 0xF, 4);
  bw.u(0, 1);                // num_ref_idx_active_override
  bw.u(0, 1);                // ref_pic_list_modification_flag_l0
  bw.u(0, 1);                // adaptive_ref_pic_marking
  bw.se(qp - 26);
  bw.ue(1);                  // deblocking off

  std::vector<uint8_t> ry((size_t)w * h), rcb((size_t)(w / 2) * (h / 2)),
      rcr((size_t)(w / 2) * (h / 2));
  Slice sc(w, h, qp, 0, ry.data(), rcb.data(), rcr.data());
  double lam_f = 0.85 * std::pow(2.0, (qp - 12) / 3.0);
  int64_t lam = (int64_t)lam_f;
  if (lam < 1) lam = 1;
  PEnc e{src_y, src_cb, src_cr, prev_y, prev_cb, prev_cr, w, h, &sc, qp,
         lam};

  int w_mb = w / 16, h_mb = h / 16;
  uint32_t skip_run = 0;
  // coarse grid offsets (dy outer, dx inner, -16..16 step 4) — the
  // argmin tie rule (first minimum) matches np.argmin
  int odx[81], ody[81];
  {
    int k = 0;
    for (int dy = -16; dy <= 16; dy += 4)
      for (int dx = -16; dx <= 16; dx += 4) {
        odx[k] = dx;
        ody[k] = dy;
        ++k;
      }
  }
  // edge-padded reference luma (pad 19, same as the Python np.pad edge
  // form): every coarse/refine SAD window indexes it without per-pixel
  // clamping — the clamped int64 loops this replaces were ~80 us/MB,
  // the whole 81-offset coarse search now auto-vectorizes
  const int PAD = 19;
  const int PS = w + 2 * PAD;
  std::vector<uint8_t> refpad((size_t)PS * (h + 2 * PAD));
  for (int yy = -PAD; yy < h + PAD; ++yy) {
    const uint8_t *row = prev_y + (size_t)clampi(yy, 0, h - 1) * w;
    uint8_t *dst = refpad.data() + (size_t)(yy + PAD) * PS;
    std::memset(dst, row[0], PAD);
    std::memcpy(dst + PAD, row, w);
    std::memset(dst + PAD + w, row[w - 1], PAD);
  }
  auto sad16 = [&](const uint8_t *src, const uint8_t *ref) {
    int64_t s = 0;
    for (int j = 0; j < 16; ++j) {
      const uint8_t *pa = src + (size_t)j * w;
      const uint8_t *pb = ref + (size_t)j * PS;
      int32_t row = 0;
      for (int i = 0; i < 16; ++i)
        row += pa[i] > pb[i] ? pa[i] - pb[i] : pb[i] - pa[i];
      s += row;
    }
    return s;
  };
  for (int mby = 0; mby < h_mb; ++mby)
    for (int mbx = 0; mbx < w_mb; ++mbx) {
      const bool is_pcm = pcm_from_mby >= 0 && mby >= pcm_from_mby;
      int x0 = 16 * mbx, y0 = 16 * mby;
      if (!is_pcm) {
        // ---- skip candidate: MC with the derived skip MV ----
        int smx, smy;
        sc.skip_mv(mbx, mby, smx, smy);
        uint8_t sp_y[256], sp_cb[64], sp_cr[64];
        mc_luma(prev_y, w, h, x0, y0, 16, 16, smx, smy, sp_y, 16);
        mc_chroma(prev_cb, w / 2, h / 2, 8 * mbx, 8 * mby, 8, 8, smx, smy,
                  sp_cb, 8);
        mc_chroma(prev_cr, w / 2, h / 2, 8 * mbx, 8 * mby, 8, 8, smx, smy,
                  sp_cr, 8);
        int64_t ssd = 0;
        for (int j = 0; j < 16; ++j)
          for (int i = 0; i < 16; ++i) {
            int64_t d = (int64_t)src_y[(size_t)(y0 + j) * w + x0 + i] -
                        sp_y[16 * j + i];
            ssd += d * d;
          }
        for (int j = 0; j < 8; ++j)
          for (int i = 0; i < 8; ++i) {
            size_t o = (size_t)(8 * mby + j) * (w / 2) + 8 * mbx + i;
            int64_t d0 = (int64_t)src_cb[o] - sp_cb[8 * j + i];
            int64_t d1 = (int64_t)src_cr[o] - sp_cr[8 * j + i];
            ssd += d0 * d0 + d1 * d1;
          }
        if ((double)ssd <= skip_thresh) {
          mb_skip(e, mbx, mby);
          ++skip_run;
          continue;
        }
        // ---- motion search ----
        int pmx, pmy;
        sc.predict_mv(4 * mbx, 4 * mby, 4, 4, 0, pmx, pmy);
        auto mvd_bits = [&](int mx, int my) {
          return se_bits_c(4 * mx - pmx) + se_bits_c(4 * my - pmy);
        };
        // coarse winner (first minimum)
        const uint8_t *src_mb = src_y + (size_t)y0 * w + x0;
        const uint8_t *pad_mb =
            refpad.data() + (size_t)(y0 + PAD) * PS + x0 + PAD;
        int best_k = 0;
        int64_t best_coarse = -1;
        for (int k = 0; k < 81; ++k) {
          int64_t sad =
              sad16(src_mb, pad_mb + (size_t)ody[k] * PS + odx[k]);
          if (best_coarse < 0 || sad < best_coarse) {
            best_coarse = sad;
            best_k = k;
          }
        }
        auto refine = [&](int bx0, int by0, int &out_mx, int &out_my,
                          int64_t &out_sad) {
          // clamp the base so probed windows stay within +-19 (pad)
          bx0 = clampi(bx0, -16, 16);
          by0 = clampi(by0, -16, 16);
          int64_t best_cost = -1;
          for (int dy = -3; dy <= 3; ++dy)
            for (int dx = -3; dx <= 3; ++dx) {
              int mx = bx0 + dx, my = by0 + dy;
              int64_t sad =
                  sad16(src_mb, pad_mb + (size_t)my * PS + mx);
              int64_t cost = sad + lam * mvd_bits(mx, my);
              if (best_cost < 0 || cost < best_cost) {
                best_cost = cost;
                out_mx = 4 * mx;
                out_my = 4 * my;
                out_sad = sad;
              }
            }
        };
        int mv1x, mv1y, mv2x, mv2y;
        int64_t sad1, sad2;
        refine(odx[best_k], ody[best_k], mv1x, mv1y, sad1);
        refine(round_div4_half_even(pmx), round_div4_half_even(pmy), mv2x,
               mv2y, sad2);
        int mvx, mvy;
        if (sad1 + lam * mvd_bits(mv1x / 4, mv1y / 4) <=
            sad2 + lam * mvd_bits(mv2x / 4, mv2y / 4)) {
          mvx = mv1x;
          mvy = mv1y;
        } else {
          mvx = mv2x;
          mvy = mv2y;
        }
        // ---- RD mode decision: trial-encode skip/inter/i16/i4; the
        // winner's bits + post-MB state are spliced in directly (no
        // duplicate encode) ----
        MbSnap snap, best_post;
        mb_snapshot(e, mbx, mby, snap);
        double best_cost = (double)ssd + (double)lam * 2.0;  // skip
        int best_mode = 0;  // 0 skip, 1 inter, 2 i16, 3 i4
        BitWriter best_bits;
        for (int cand = 1; cand <= 3; ++cand) {
          BitWriter trial;
          if (cand == 1) mb_enc_inter16(e, trial, mbx, mby, mvx, mvy);
          else if (cand == 2) {
            mb_enc_i16(e, trial, mbx, mby, 5);
            sc.mark_intra_mv(mbx, mby);
          } else {
            mb_enc_i4(e, trial, mbx, mby, 5);
            sc.mark_intra_mv(mbx, mby);
          }
          long bits = 8L * (long)trial.bytes.size() + trial.n;
          double cost = (double)mb_ssd(e, mbx, mby) + (double)lam * bits;
          if (cost < best_cost) {
            best_cost = cost;
            best_mode = cand;
            mb_snapshot(e, mbx, mby, best_post);
            best_bits = std::move(trial);
          }
          mb_restore(e, mbx, mby, snap);
        }
        if (best_mode == 0) {
          mb_skip(e, mbx, mby);
          ++skip_run;
          continue;
        }
        bw.ue(skip_run);
        skip_run = 0;
        bw.append(best_bits);
        mb_restore(e, mbx, mby, best_post);
        continue;
      }
      // ---- PCM counter strip: colocated skip only when bit-exact AND
      // the derived skip vector is zero ----
      int64_t ssd = 0;
      for (int j = 0; j < 16 && ssd == 0; ++j)
        for (int i = 0; i < 16; ++i) {
          int64_t d = (int64_t)src_y[(size_t)(y0 + j) * w + x0 + i] -
                      prev_y[(size_t)(y0 + j) * w + x0 + i];
          ssd += d * d;
        }
      if (ssd == 0)
        for (int j = 0; j < 8 && ssd == 0; ++j)
          for (int i = 0; i < 8; ++i) {
            size_t o = (size_t)(8 * mby + j) * (w / 2) + 8 * mbx + i;
            int64_t d0 = (int64_t)src_cb[o] - prev_cb[o];
            int64_t d1 = (int64_t)src_cr[o] - prev_cr[o];
            ssd += d0 * d0 + d1 * d1;
          }
      bool can_skip = ssd == 0;
      if (can_skip) {
        int smx, smy;
        sc.skip_mv(mbx, mby, smx, smy);
        if (smx != 0 || smy != 0) can_skip = false;
      }
      if (can_skip) {
        mb_skip(e, mbx, mby);
        ++skip_run;
        continue;
      }
      bw.ue(skip_run);
      skip_run = 0;
      // I_PCM
      bw.ue(25 + 5);
      bw.align();
      uint8_t buf[384];
      for (int j = 0; j < 16; ++j)
        std::memcpy(buf + 16 * j, src_y + (size_t)(y0 + j) * w + x0, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(buf + 256 + 8 * j,
                    src_cb + (size_t)(8 * mby + j) * (w / 2) + 8 * mbx, 8);
        std::memcpy(buf + 320 + 8 * j,
                    src_cr + (size_t)(8 * mby + j) * (w / 2) + 8 * mbx, 8);
      }
      bw.raw(buf, 384);
      for (int j = 0; j < 16; ++j)
        std::memcpy(ry.data() + (size_t)(y0 + j) * w + x0, buf + 16 * j, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(rcb.data() + (size_t)(8 * mby + j) * (w / 2) + 8 * mbx,
                    buf + 256 + 8 * j, 8);
        std::memcpy(rcr.data() + (size_t)(8 * mby + j) * (w / 2) + 8 * mbx,
                    buf + 320 + 8 * j, 8);
      }
      sc.mark_pcm(mbx, mby);
      sc.mark_intra_mv(mbx, mby);
    }
  if (skip_run) bw.ue(skip_run);
  bw.trailing();
  if ((long)bw.bytes.size() > out_cap) return -2;
  std::memcpy(out, bw.bytes.data(), bw.bytes.size());
  if (recon_y) {
    std::memcpy(recon_y, ry.data(), ry.size());
    std::memcpy(recon_cb, rcb.data(), rcb.size());
    std::memcpy(recon_cr, rcr.data(), rcr.size());
  }
  return (long)bw.bytes.size();
}

// ---------------------------------------------------------------------------
// YUV420 -> RGB (decode-glue hot path): bit-exact float32 mirror of
// codecs/h264.py:yuv420_to_rgb (numpy promotes the float64 scalars to
// float32 under NEP 50; rintf == np.round half-to-even). ~32 ms/frame
// of numpy glue at 1024^2 collapses to one pass.
// ---------------------------------------------------------------------------

extern "C" void uvt_yuv420_to_rgb(const uint8_t *y, const uint8_t *cb,
                                  const uint8_t *cr, int w, int h,
                                  uint8_t *rgb) {
  const int cw = w / 2;
  for (int row = 0; row < h; ++row) {
    const uint8_t *yr = y + (size_t)row * w;
    const uint8_t *cbr = cb + (size_t)(row / 2) * cw;
    const uint8_t *crr = cr + (size_t)(row / 2) * cw;
    uint8_t *out = rgb + (size_t)row * w * 3;
    for (int col = 0; col < w; ++col) {
      float yf = (float)yr[col];
      float cbf = (float)cbr[col / 2] - 128.0f;
      float crf = (float)crr[col / 2] - 128.0f;
      float r = yf + 1.402f * crf;
      float g = (yf - 0.344136f * cbf) - 0.714136f * crf;
      float b = yf + 1.772f * cbf;
      r = rintf(r); g = rintf(g); b = rintf(b);
      r = r < 0.f ? 0.f : (r > 255.f ? 255.f : r);
      g = g < 0.f ? 0.f : (g > 255.f ? 255.f : g);
      b = b < 0.f ? 0.f : (b > 255.f ? 255.f : b);
      out[3 * col] = (uint8_t)r;
      out[3 * col + 1] = (uint8_t)g;
      out[3 * col + 2] = (uint8_t)b;
    }
  }
}
