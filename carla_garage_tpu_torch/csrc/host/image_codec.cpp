// Baseline JPEG and the PNG row filters, on the host, for the port's image
// I/O (carla_garage_tpu_torch/utils/image_io.py).
//
// The reference's datasets store camera frames as JPEG and label maps as
// PNG (data_agent.py:341-372). The JAX package reads and writes them
// through PIL; the card's machine has no PIL, so the port carries its own
// codec. Plain C interface for ctypes, built with g++ at first use.
//
// JPEG: baseline (SOF0) and extended sequential (SOF1) Huffman, 8-bit, 1 or
// 3 components, interleaved or not, restart intervals. Decoding follows
// libjpeg's defaults as PIL uses them: the integer inverse DCT of
// jidctint.c (JDCT_ISLOW), "fancy" triangle upsampling of h2v1 and h2v2
// chroma (jdsample.c) and the table-driven YCbCr->RGB of jdcolor.c, so a
// file decodes to the pixels libjpeg gives. Encoding follows libjpeg's
// compressor: jccolor.c's RGB->YCbCr, jcsample.c's h2v1 / h2v2
// downsampling, jfdctint.c's integer forward DCT, jcdctmgr.c's rounding
// quantization and the Annex-K Huffman tables; the quantization tables come
// from the caller. Blocks outside the image are padded by edge replication
// (libjpeg writes DC-only dummy blocks there), which changes no visible
// pixel.
//
// PNG: the five row filters of the PNG specification (section 9), both
// ways. Compression (zlib) stays in Python.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum Err {
  kOk = 0,
  kTruncated = -1,
  kBadMarker = -2,
  kUnsupported = -3,
  kBadHuffman = -4,
  kBadTable = -5,
  kSmallBuffer = -6,
  kBadData = -7,
};

// ---------------------------------------------------------------- IDCT --
// jidctint.c (libjpeg 6b, as libjpeg-turbo keeps it), CONST_BITS 13,
// PASS1_BITS 2.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: x + 128 clamped to [0, 255] for x in
// [-512, 511], wrapping modulo 1024 beyond (its table is indexed by
// x & 1023).
inline uint8_t idct_limit(int64_t x) {
  int v = static_cast<int>(((x & 1023) ^ 512) - 512) + 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// coef: 64 quantized coefficients in natural order; q: the quantization
// table in natural order. Writes an 8x8 block at out (row stride `stride`).
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {                    // pass 1: columns
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3;
    int64_t tmp10, tmp11, tmp12, tmp13;
    z2 = int64_t(in[16]) * qt[16];
    z3 = int64_t(in[48]) * qt[48];
    z1 = (z2 + z3) * F0_541196100;
    tmp2 = z1 + z3 * (-F1_847759065);
    tmp3 = z1 + z2 * F0_765366865;
    z2 = int64_t(in[0]) * qt[0];
    z3 = int64_t(in[32]) * qt[32];
    tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qt[56];
    tmp1 = int64_t(in[40]) * qt[40];
    tmp2 = int64_t(in[24]) * qt[24];
    tmp3 = int64_t(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    ws[c + 0] = static_cast<int>(descale(tmp10 + tmp3, s));
    ws[c + 56] = static_cast<int>(descale(tmp10 - tmp3, s));
    ws[c + 8] = static_cast<int>(descale(tmp11 + tmp2, s));
    ws[c + 48] = static_cast<int>(descale(tmp11 - tmp2, s));
    ws[c + 16] = static_cast<int>(descale(tmp12 + tmp1, s));
    ws[c + 40] = static_cast<int>(descale(tmp12 - tmp1, s));
    ws[c + 24] = static_cast<int>(descale(tmp13 + tmp0, s));
    ws[c + 32] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  for (int r = 0; r < 8; ++r) {                    // pass 2: rows
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3;
    int64_t tmp10, tmp11, tmp12, tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * F0_541196100;
    tmp2 = z1 + z3 * (-F1_847759065);
    tmp3 = z1 + z2 * F0_765366865;
    tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, s));
    o[7] = idct_limit(descale(tmp10 - tmp3, s));
    o[1] = idct_limit(descale(tmp11 + tmp2, s));
    o[6] = idct_limit(descale(tmp11 - tmp2, s));
    o[2] = idct_limit(descale(tmp12 + tmp1, s));
    o[5] = idct_limit(descale(tmp12 - tmp1, s));
    o[3] = idct_limit(descale(tmp13 + tmp0, s));
    o[4] = idct_limit(descale(tmp13 - tmp0, s));
  }
}

// ----------------------------------------------------------------- FDCT --
// jfdctint.c: in-place on level-shifted samples; the output is scaled up
// by 8, which the quantizer's divisor (8 x table) takes back out.
void fdct_islow(int* d) {
  for (int r = 0; r < 8; ++r) {                    // pass 1: rows
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541196100;
    const int s = kConstBits - kPass1Bits;
    p[2] = static_cast<int>(descale(z1 + tmp13 * F0_765366865, s));
    p[6] = static_cast<int>(descale(z1 + tmp12 * (-F1_847759065), s));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp4 *= F0_298631336;
    tmp5 *= F2_053119869;
    tmp6 *= F3_072711026;
    tmp7 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(descale(tmp4 + z1 + z3, s));
    p[5] = static_cast<int>(descale(tmp5 + z2 + z4, s));
    p[3] = static_cast<int>(descale(tmp6 + z2 + z3, s));
    p[1] = static_cast<int>(descale(tmp7 + z1 + z4, s));
  }
  for (int c = 0; c < 8; ++c) {                    // pass 2: columns
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541196100;
    const int s = kConstBits + kPass1Bits;
    p[16] = static_cast<int>(descale(z1 + tmp13 * F0_765366865, s));
    p[48] = static_cast<int>(descale(z1 + tmp12 * (-F1_847759065), s));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp4 *= F0_298631336;
    tmp5 *= F2_053119869;
    tmp6 *= F3_072711026;
    tmp7 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(descale(tmp4 + z1 + z3, s));
    p[40] = static_cast<int>(descale(tmp5 + z2 + z4, s));
    p[24] = static_cast<int>(descale(tmp6 + z2 + z3, s));
    p[8] = static_cast<int>(descale(tmp7 + z1 + z4, s));
  }
}

// ---------------------------------------------------------- Huffman dec --
struct HuffDec {
  bool present = false;
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
};

int build_huff_dec(const uint8_t* bits, const uint8_t* vals, int nvals,
                   HuffDec* h) {
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    h->valptr[l] = k;
    h->mincode[l] = code;
    code += bits[l - 1];
    k += bits[l - 1];
    if (code > (1 << l)) return kBadHuffman;
    h->maxcode[l] = bits[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  if (k != nvals || k > 256) return kBadHuffman;
  std::memcpy(h->vals, vals, nvals);
  h->present = true;
  return kOk;
}

// Entropy-coded bits, with 0xFF00 unstuffing. At a marker it feeds zeros
// (as libjpeg does) and remembers that it stopped there.
struct BitReader {
  const uint8_t* d;
  int64_t n, pos;
  uint32_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 24) {
      uint32_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t next = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= b << (24 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    fill();
    return buf >> (32 - k);
  }
  void skip(int k) {
    buf <<= k;
    cnt -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = static_cast<int>(peek(k));
    skip(k);
    return v;
  }
  void reset() {
    buf = 0;
    cnt = 0;
  }
};

inline int decode_symbol(BitReader& br, const HuffDec& h) {
  uint32_t bits16 = br.peek(16);
  for (int l = 1; l <= 16; ++l) {
    int code = static_cast<int>(bits16 >> (16 - l));
    if (code <= h.maxcode[l]) {
      br.skip(l);
      return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
  }
  return -1;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;      // Huffman tables of the current scan
  int pred = 0;            // DC predictor
  int bw = 0, bh = 0;      // plane size in blocks (the MCU grid)
  std::vector<uint8_t> plane;
};

// Two-byte big-endian length of a marker segment at p.
inline int seg_len(const uint8_t* p) { return (p[0] << 8) | p[1]; }

struct Decoder {
  const uint8_t* d = nullptr;
  int64_t n = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0, restart = 0;
  bool frame = false;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  Component comp[3];

  int parse_dqt(const uint8_t* p, int len) {
    int i = 0;
    while (i < len) {
      int pq = p[i] >> 4, tq = p[i] & 15;
      ++i;
      if (tq > 3 || pq > 1) return kBadTable;
      if (i + 64 * (pq + 1) > len) return kTruncated;
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (p[i + 2 * k] << 8) | p[i + 2 * k + 1] : p[i + k];
        qt[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      i += 64 * (pq + 1);
      qt_present[tq] = true;
    }
    return kOk;
  }

  int parse_dht(const uint8_t* p, int len) {
    int i = 0;
    while (i < len) {
      if (i + 17 > len) return kTruncated;
      int tc = p[i] >> 4, th = p[i] & 15;
      if (tc > 1 || th > 3) return kBadHuffman;
      int total = 0;
      for (int k = 0; k < 16; ++k) total += p[i + 1 + k];
      if (i + 17 + total > len) return kTruncated;
      int r = build_huff_dec(p + i + 1, p + i + 17, total,
                             tc ? &ac[th] : &dc[th]);
      if (r) return r;
      i += 17 + total;
    }
    return kOk;
  }

  int parse_sof(const uint8_t* p, int len) {
    if (len < 6) return kTruncated;
    if (p[0] != 8) return kUnsupported;          // 8-bit samples only
    height = (p[1] << 8) | p[2];
    width = (p[3] << 8) | p[4];
    ncomp = p[5];
    if (ncomp != 1 && ncomp != 3) return kUnsupported;
    if (width == 0 || height == 0) return kUnsupported;
    if (len < 6 + 3 * ncomp) return kTruncated;
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = p[6 + 3 * c];
      comp[c].h = p[7 + 3 * c] >> 4;
      comp[c].v = p[7 + 3 * c] & 15;
      comp[c].tq = p[8 + 3 * c];
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 ||
          comp[c].v > 4 || comp[c].tq > 3)
        return kBadData;
      hmax = std::max(hmax, comp[c].h);
      vmax = std::max(vmax, comp[c].v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      comp[c].bw = mcux * comp[c].h;
      comp[c].bh = mcuy * comp[c].v;
      comp[c].plane.assign(size_t(comp[c].bw) * 8 * comp[c].bh * 8, 0);
    }
    frame = true;
    return kOk;
  }

  int decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const HuffDec& hd = dc[c.td];
    const HuffDec& ha = ac[c.ta];
    int s = decode_symbol(br, hd);
    if (s < 0 || s > 16) return kBadHuffman;
    int diff = s ? extend(br.get(s), s) : 0;
    c.pred += diff;
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(br, ha);
      if (rs < 0) return kBadHuffman;
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) return kBadData;
        coef[kNatural[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    const int stride = c.bw * 8;
    idct_islow(coef, qt[c.tq], c.plane.data() + size_t(by) * 8 * stride +
                                   size_t(bx) * 8,
               stride);
    return kOk;
  }

  // Skips to the restart marker that ends an interval and past it.
  int next_restart(BitReader& br) {
    br.reset();
    int64_t p = br.pos;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] >= 0xD0 &&
                          d[p + 1] <= 0xD7))
      ++p;
    if (p + 1 >= n) return kTruncated;
    br.pos = p + 2;
    br.at_marker = false;
    return kOk;
  }

  // Decodes one scan starting at `pos` (after the SOS header); returns the
  // position of the marker that ends it, or an error.
  int64_t decode_scan(int64_t pos, Component** sc, int ns) {
    BitReader br{d, n, pos};
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
    int64_t mcu = 0;
    auto restart_if_due = [&]() -> int {
      if (restart && mcu > 0 && mcu % restart == 0) {
        int r = next_restart(br);
        if (r) return r;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      }
      return kOk;
    };
    if (ns == 1) {
      // non-interleaved: one block an MCU over the component's own extent
      Component& c = *sc[0];
      int cw = (width * c.h + hmax - 1) / hmax;
      int ch = (height * c.v + vmax - 1) / vmax;
      int bw = (cw + 7) / 8, bh = (ch + 7) / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx, ++mcu) {
          int r = restart_if_due();
          if (!r) r = decode_block(br, c, bx, by);
          if (r) return r;
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx, ++mcu) {
          int r = restart_if_due();
          if (r) return r;
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h) {
                r = decode_block(br, c, mx * c.h + h, my * c.v + v);
                if (r) return r;
              }
          }
        }
    }
    // the scan ends at the next marker that is not a restart
    int64_t p = br.pos;
    while (p + 1 < n) {
      if (d[p] == 0xFF && d[p + 1] != 0x00 && d[p + 1] != 0xFF &&
          !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7))
        return p;
      ++p;
    }
    return kTruncated;
  }

  int run() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kBadMarker;
    int64_t pos = 2;
    bool scanned = false;
    while (true) {
      while (pos < n && d[pos] != 0xFF) ++pos;   // tolerate stray bytes
      while (pos < n && d[pos] == 0xFF) ++pos;   // fill bytes
      if (pos >= n) return scanned ? kOk : kTruncated;
      int m = d[pos++];
      if (m == 0xD9) return scanned ? kOk : kBadData;   // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (pos + 2 > n) return kTruncated;
      int len = seg_len(d + pos);
      if (len < 2 || pos + len > n) return kTruncated;
      const uint8_t* p = d + pos + 2;
      int body = len - 2;
      int r = kOk;
      switch (m) {
        case 0xC0:
        case 0xC1:
          r = parse_sof(p, body);
          break;
        case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return kUnsupported;                   // progressive, lossless,
                                                 // arithmetic
        case 0xC4:
          r = parse_dht(p, body);
          break;
        case 0xDB:
          r = parse_dqt(p, body);
          break;
        case 0xDD:
          if (body < 2) return kTruncated;
          restart = (p[0] << 8) | p[1];
          break;
        case 0xDA: {
          if (!frame) return kBadData;
          int ns = p[0];
          if (ns < 1 || ns > ncomp || body < 1 + 2 * ns + 3)
            return kBadData;
          Component* sc[3];
          for (int i = 0; i < ns; ++i) {
            int id = p[1 + 2 * i], t = p[2 + 2 * i];
            sc[i] = nullptr;
            for (int c = 0; c < ncomp; ++c)
              if (comp[c].id == id) sc[i] = &comp[c];
            if (!sc[i]) return kBadData;
            sc[i]->td = t >> 4;
            sc[i]->ta = t & 15;
            if (sc[i]->td > 3 || sc[i]->ta > 3 ||
                !dc[sc[i]->td].present || !ac[sc[i]->ta].present ||
                !qt_present[sc[i]->tq])
              return kBadTable;
          }
          int64_t end = decode_scan(pos + len, sc, ns);
          if (end < 0) return static_cast<int>(end);
          scanned = true;
          pos = end;
          continue;
        }
        default:
          break;                                 // APPn, COM, ...: skip
      }
      if (r) return r;
      pos += len;
    }
  }
};

// Upsamples component c of `dec` to the full image into out (row stride
// out_stride, pixel step `step`): libjpeg's h2v1 / h2v2 "fancy" triangle
// filters where the component is more than 2 samples wide, else and for
// any other integer ratio plain replication.
int upsample(const Decoder& dec, const Component& c, uint8_t* out,
             int step) {
  const int W = dec.width, H = dec.height;
  const int cw = (W * c.h + dec.hmax - 1) / dec.hmax;
  const int ch = (H * c.v + dec.vmax - 1) / dec.vmax;
  const int stride = c.bw * 8;
  const uint8_t* pl = c.plane.data();
  auto at = [&](int y, int x) { return int(pl[size_t(y) * stride + x]); };
  auto put = [&](int y, int x, int v) {
    if (y < H && x < W) out[(size_t(y) * W + x) * step] = uint8_t(v);
  };
  if (dec.hmax % c.h || dec.vmax % c.v) return kUnsupported;
  const int fh = dec.hmax / c.h, fv = dec.vmax / c.v;
  if (fh == 2 && fv == 1 && cw > 2) {             // h2v1 fancy
    for (int y = 0; y < ch; ++y) {
      put(y, 0, at(y, 0));
      put(y, 1, (at(y, 0) * 3 + at(y, 1) + 2) >> 2);
      for (int x = 1; x < cw - 1; ++x) {
        int v3 = at(y, x) * 3;
        put(y, 2 * x, (v3 + at(y, x - 1) + 1) >> 2);
        put(y, 2 * x + 1, (v3 + at(y, x + 1) + 2) >> 2);
      }
      int v = at(y, cw - 1);
      put(y, 2 * cw - 2, (v * 3 + at(y, cw - 2) + 1) >> 2);
      put(y, 2 * cw - 1, v);
    }
    return kOk;
  }
  if (fh == 2 && fv == 2 && cw > 2) {             // h2v2 fancy
    std::vector<int> cols(cw);
    for (int y = 0; y < ch; ++y) {
      for (int half = 0; half < 2; ++half) {
        int y1 = half == 0 ? std::max(y - 1, 0) : std::min(y + 1, ch - 1);
        for (int x = 0; x < cw; ++x) cols[x] = at(y, x) * 3 + at(y1, x);
        int oy = 2 * y + half;
        put(oy, 0, (cols[0] * 4 + 8) >> 4);
        put(oy, 1, (cols[0] * 3 + cols[1] + 7) >> 4);
        for (int x = 1; x < cw - 1; ++x) {
          put(oy, 2 * x, (cols[x] * 3 + cols[x - 1] + 8) >> 4);
          put(oy, 2 * x + 1, (cols[x] * 3 + cols[x + 1] + 7) >> 4);
        }
        put(oy, 2 * cw - 2, (cols[cw - 1] * 3 + cols[cw - 2] + 8) >> 4);
        put(oy, 2 * cw - 1, (cols[cw - 1] * 4 + 7) >> 4);
      }
    }
    return kOk;
  }
  for (int y = 0; y < H; ++y)                     // replication (h1v1 too)
    for (int x = 0; x < W; ++x)
      out[(size_t(y) * W + x) * step] =
          uint8_t(at(std::min(y / fv, ch - 1), std::min(x / fh, cw - 1)));
  return kOk;
}

// jdcolor.c's tables: SCALEBITS 16, FIX(x) = x * 65536 rounded.
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------- Huffman enc --
// ITU-T T.81 Annex K.3 tables (libjpeg's std_huff_tables).
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
  HuffEnc(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k) {
        code[vals[k]] = static_cast<uint16_t>(c++);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct Writer {
  uint8_t* out;
  int64_t cap, pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  void byte(int b) {
    if (pos < cap) out[pos] = static_cast<uint8_t>(b);
    else overflow = true;
    ++pos;
  }
  void word(int w) {
    byte(w >> 8);
    byte(w & 255);
  }
  void bits(uint32_t v, int n) {       // entropy-coded, with 0xFF stuffing
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      int b = (acc >> (nbits - 8)) & 255;
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() {                       // pad the last byte with 1-bits
    if (nbits > 0) bits(0x7F, 8 - nbits);
    acc = 0;
    nbits = 0;
  }
};

inline int nbits_of(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(Writer& w, const int* q, int& pred, const HuffEnc& dc,
                  const HuffEnc& ac) {
  int diff = q[0] - pred;
  pred = q[0];
  int s = nbits_of(diff);
  w.bits(dc.code[s], dc.size[s]);
  if (s) w.bits(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = q[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    int sz = nbits_of(v);
    int sym = (run << 4) | sz;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits(v < 0 ? v - 1 : v, sz);
    run = 0;
  }
  if (run) w.bits(ac.code[0], ac.size[0]);
}

// One component's samples, downsampled by (fh, fv) from the full-size plane
// `full` (W x H) as jcsample.c does (columns replicated to the component's
// block width, rows to a whole row group, alternating rounding bias), then
// replicated out to the MCU grid (bw x bh blocks).
std::vector<uint8_t> component_plane(const std::vector<uint8_t>& full, int W,
                                     int H, int fh, int fv, int bw, int bh) {
  const int cw = (W + fh - 1) / fh, ch = (H + fv - 1) / fv;
  const int wib = (cw + 7) / 8;
  const int pw = bw * 8, ph = bh * 8;
  std::vector<uint8_t> out(size_t(pw) * ph);
  auto src = [&](int y, int x) {
    return int(full[size_t(std::min(y, H - 1)) * W + std::min(x, W - 1)]);
  };
  for (int y = 0; y < ch; ++y) {
    int bias = fh == 2 && fv == 2 ? 1 : 0;
    for (int x = 0; x < wib * 8; ++x) {
      int v;
      if (fh == 1 && fv == 1) {
        v = src(y, x);
      } else if (fh == 2 && fv == 1) {
        v = (src(y, 2 * x) + src(y, 2 * x + 1) + bias) >> 1;
      } else {
        v = (src(2 * y, 2 * x) + src(2 * y, 2 * x + 1) +
             src(2 * y + 1, 2 * x) + src(2 * y + 1, 2 * x + 1) + bias) >> 2;
      }
      bias ^= fv == 2 ? 3 : 1;
      out[size_t(y) * pw + x] = static_cast<uint8_t>(v);
    }
  }
  for (int y = 0; y < ph; ++y)                     // replicate to the grid
    for (int x = 0; x < pw; ++x)
      if (y >= ch || x >= wib * 8)
        out[size_t(y) * pw + x] =
            out[size_t(std::min(y, ch - 1)) * pw + std::min(x, wib * 8 - 1)];
  return out;
}

}  // namespace

extern "C" {

// Header of a JPEG: width, height and component count, or an error (< 0).
int jpg_info(const uint8_t* data, int64_t len, int* width, int* height,
             int* ncomp) {
  int64_t pos = 2;
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return kBadMarker;
  while (pos + 4 <= len) {
    while (pos < len && data[pos] != 0xFF) ++pos;
    while (pos < len && data[pos] == 0xFF) ++pos;
    if (pos + 3 > len) break;
    int m = data[pos++];
    int l = seg_len(data + pos);
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (pos + 8 > len) return kTruncated;
      *height = (data[pos + 3] << 8) | data[pos + 4];
      *width = (data[pos + 5] << 8) | data[pos + 6];
      *ncomp = data[pos + 7];
      return kOk;
    }
    if (m == 0xD9 || m == 0xDA) break;
    pos += l;
  }
  return kTruncated;
}

// Decodes a JPEG into out (height x width x ncomp bytes, RGB or gray).
int jpg_decode(const uint8_t* data, int64_t len, uint8_t* out,
               int64_t out_cap) {
  Decoder dec;
  dec.d = data;
  dec.n = len;
  int r = dec.run();
  if (r) return r;
  const int W = dec.width, H = dec.height, nc = dec.ncomp;
  if (out_cap < int64_t(W) * H * nc) return kSmallBuffer;
  if (nc == 1) return upsample(dec, dec.comp[0], out, 1);
  std::vector<uint8_t> ycc(size_t(W) * H * 3);
  for (int c = 0; c < 3; ++c) {
    r = upsample(dec, dec.comp[c], ycc.data() + c, 3);
    if (r) return r;
  }
  static const YccTables t;
  for (size_t i = 0; i < size_t(W) * H; ++i) {
    int y = ycc[3 * i], cb = ycc[3 * i + 1], cr = ycc[3 * i + 2];
    out[3 * i] = clamp255(y + t.cr_r[cr]);
    out[3 * i + 1] =
        clamp255(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + t.cb_b[cb]);
  }
  return kOk;
}

// Encodes height x width x ncomp (1: gray, 3: RGB) bytes as a baseline
// JFIF JPEG. qluma / qchroma: quantization tables in natural order (values
// 1..255); hs x vs: the luma sampling factors (1x1: 4:4:4, 2x1: 4:2:2,
// 2x2: 4:2:0; ignored for gray); restart: the restart interval in MCUs (0:
// none). Returns the byte count, or an error (< 0).
int64_t jpg_encode(const uint8_t* pix, int width, int height, int ncomp,
                   const uint16_t* qluma, const uint16_t* qchroma, int hs,
                   int vs, int restart, uint8_t* out, int64_t cap) {
  if ((ncomp != 1 && ncomp != 3) || width < 1 || height < 1 ||
      width > 65535 || height > 65535 || restart < 0 || restart > 65535)
    return kUnsupported;
  if (ncomp == 1) hs = vs = 1;
  if (!((hs == 1 && vs == 1) || (hs == 2 && vs == 1) || (hs == 2 && vs == 2)))
    return kUnsupported;
  for (int i = 0; i < 64; ++i)
    if (qluma[i] < 1 || qluma[i] > 255 || qchroma[i] < 1 || qchroma[i] > 255)
      return kBadTable;
  const int W = width, H = height;
  const size_t npx = size_t(W) * H;
  std::vector<uint8_t> full[3];
  if (ncomp == 1) {
    full[0].assign(pix, pix + npx);
  } else {                                        // jccolor.c rgb_ycc
    const int64_t half = int64_t(1) << 15, off = int64_t(128) << 16;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    const int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const int64_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.5);
    const int64_t gcr = -fix(0.41869), bcr = -fix(0.08131);
    for (int c = 0; c < 3; ++c) full[c].resize(npx);
    for (size_t i = 0; i < npx; ++i) {
      int64_t r = pix[3 * i], g = pix[3 * i + 1], b = pix[3 * i + 2];
      full[0][i] = uint8_t((ry * r + gy * g + by * b + half) >> 16);
      full[1][i] = uint8_t((rcb * r + gcb * g + bcb * b + off + half - 1) >> 16);
      full[2][i] = uint8_t((bcb * r + gcr * g + bcr * b + off + half - 1) >> 16);
    }
  }
  const int mcux = (W + 8 * hs - 1) / (8 * hs);
  const int mcuy = (H + 8 * vs - 1) / (8 * vs);
  int ch[3] = {hs, 1, 1}, cv[3] = {vs, 1, 1};
  std::vector<uint8_t> plane[3];
  for (int c = 0; c < ncomp; ++c)
    plane[c] = component_plane(full[c], W, H, hs / ch[c], vs / cv[c],
                               mcux * ch[c], mcuy * cv[c]);

  Writer w{out, cap};
  w.word(0xFFD8);
  const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  w.word(0xFFE0);
  w.word(16);
  for (uint8_t b : jfif) w.byte(b);
  const uint16_t* tables[2] = {qluma, qchroma};
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); ++t) {
    w.word(0xFFDB);
    w.word(67);
    w.byte(t);
    for (int k = 0; k < 64; ++k) w.byte(tables[t][kNatural[k]]);
  }
  w.word(0xFFC0);
  w.word(8 + 3 * ncomp);
  w.byte(8);
  w.word(H);
  w.word(W);
  w.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte(c + 1);
    w.byte((ch[c] << 4) | cv[c]);
    w.byte(c ? 1 : 0);
  }
  struct Dht { int cls, id; const uint8_t* bits; const uint8_t* vals; };
  const Dht dhts[4] = {{0, 0, kDcLumBits, kDcVals},
                       {1, 0, kAcLumBits, kAcLumVals},
                       {0, 1, kDcChrBits, kDcVals},
                       {1, 1, kAcChrBits, kAcChrVals}};
  for (int t = 0; t < (ncomp == 3 ? 4 : 2); ++t) {
    int total = 0;
    for (int k = 0; k < 16; ++k) total += dhts[t].bits[k];
    w.word(0xFFC4);
    w.word(2 + 17 + total);
    w.byte((dhts[t].cls << 4) | dhts[t].id);
    for (int k = 0; k < 16; ++k) w.byte(dhts[t].bits[k]);
    for (int k = 0; k < total; ++k) w.byte(dhts[t].vals[k]);
  }
  if (restart) {
    w.word(0xFFDD);
    w.word(4);
    w.word(restart);
  }
  w.word(0xFFDA);
  w.word(6 + 2 * ncomp);
  w.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte(c + 1);
    w.byte(c ? 0x11 : 0x00);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  static const HuffEnc dc_l(kDcLumBits, kDcVals), ac_l(kAcLumBits, kAcLumVals);
  static const HuffEnc dc_c(kDcChrBits, kDcVals), ac_c(kAcChrBits, kAcChrVals);
  int divisor[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) divisor[t][i] = tables[t][i] * 8;
  int pred[3] = {0, 0, 0};
  int64_t mcu = 0, n_rst = 0;
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx, ++mcu) {
      if (restart && mcu > 0 && mcu % restart == 0) {
        w.flush();
        w.word(0xFFD0 + (n_rst++ & 7));
        pred[0] = pred[1] = pred[2] = 0;
      }
      for (int c = 0; c < ncomp; ++c) {
        const int stride = mcux * ch[c] * 8;
        const int t = c ? 1 : 0;
        for (int v = 0; v < cv[c]; ++v)
          for (int h = 0; h < ch[c]; ++h) {
            int blk[64];
            const uint8_t* src = plane[c].data() +
                                 size_t((my * cv[c] + v) * 8) * stride +
                                 (mx * ch[c] + h) * 8;
            for (int y = 0; y < 8; ++y)
              for (int x = 0; x < 8; ++x)
                blk[8 * y + x] = int(src[size_t(y) * stride + x]) - 128;
            fdct_islow(blk);
            for (int i = 0; i < 64; ++i) {       // jcdctmgr.c quantize
              int qv = divisor[t][i], v2 = blk[i];
              if (v2 < 0) {
                v2 = -v2 + (qv >> 1);
                v2 = v2 >= qv ? -(v2 / qv) : 0;
              } else {
                v2 += qv >> 1;
                v2 = v2 >= qv ? v2 / qv : 0;
              }
              blk[i] = v2;
            }
            encode_block(w, blk, pred[c], t ? dc_c : dc_l, t ? ac_c : ac_l);
          }
      }
    }
  w.flush();
  w.word(0xFFD9);
  return w.overflow ? int64_t(kSmallBuffer) : w.pos;
}

// PNG: undoes the row filters. raw: height rows of (1 filter byte +
// rowbytes); out: height x rowbytes; bpp: bytes a pixel. Returns 0, or -1
// for an unknown filter type.
int png_unfilter(const uint8_t* raw, int height, int rowbytes, int bpp,
                 uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = raw + size_t(y) * (rowbytes + 1);
    int type = in[0];
    ++in;
    uint8_t* o = out + size_t(y) * rowbytes;
    const uint8_t* up = y ? o - rowbytes : nullptr;
    for (int x = 0; x < rowbytes; ++x) {
      int a = x >= bpp ? o[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = up && x >= bpp ? up[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1;
      }
      o[x] = static_cast<uint8_t>(in[x] + pred);
    }
  }
  return 0;
}

// PNG: applies row filter types[y] (0-4) to each row of pix (height x
// rowbytes) into out (height rows of 1 + rowbytes). Returns 0, or -1 for an
// unknown type.
int png_filter(const uint8_t* pix, int height, int rowbytes, int bpp,
               const uint8_t* types, uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = pix + size_t(y) * rowbytes;
    const uint8_t* up = y ? in - rowbytes : nullptr;
    uint8_t* o = out + size_t(y) * (rowbytes + 1);
    int type = types[y];
    if (type > 4) return -1;
    o[0] = static_cast<uint8_t>(type);
    ++o;
    for (int x = 0; x < rowbytes; ++x) {
      int a = x >= bpp ? in[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = up && x >= bpp ? up[x - bpp] : 0;
      int pred = 0;
      if (type == 1) pred = a;
      else if (type == 2) pred = b;
      else if (type == 3) pred = (a + b) >> 1;
      else if (type == 4) {
        int p = a + b - c;
        int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
        pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
      }
      o[x] = static_cast<uint8_t>(in[x] - pred);
    }
  }
  return 0;
}

}  // extern "C"
