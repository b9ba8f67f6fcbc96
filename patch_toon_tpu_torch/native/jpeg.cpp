// Baseline JPEG, both ways, as libjpeg-turbo does it with the defaults that
// Pillow uses (Pillow 12 on libjpeg-turbo 3).
//
// Decoder. Scope: SOF0 and 8-bit SOF1, Huffman coding, one or more
// sequential scans, restart intervals; 1 component (gray) or 3 (YCbCr,
// with a JFIF marker or by libjpeg's rule on the component ids); each
// component at the full or half resolution of the largest sampling factor
// in either direction (4:4:4, 4:2:2, 4:4:0, 4:2:0). Every stage is
// libjpeg-turbo's default one, so the pixels are Pillow's, bit for bit:
// - dequantization and the islow IDCT (jidctint.c), the output through the
//   IDCT's range-limit table (jdmaster.c), wrap-around included;
// - fancy upsampling (jdsample.c): h2v1 (3a + b + 1 >> 2, 3a + b + 2 >> 2),
//   h1v2 (biases 1 above, 2 below), h2v2 (3a + b + 8 >> 4, 3a + c + 7 >> 4)
//   with box replication for a component 2 samples wide or less; the rows
//   above the first and below the last real row (the component's own
//   height) repeat those rows, and edge columns stop at the component's own
//   width (jdmainct.c);
// - the fixed-point YCbCr -> RGB of jdcolor.c.
// Progressive, arithmetic, lossless and hierarchical files, other sample
// precisions, 2 or 4 components, an Adobe marker, RGB component ids and
// other sampling factors are refused with their own codes (codec.h). Data
// that a valid stream cannot hold (a bad Huffman code, a block that runs
// past 63, entropy data cut short, a missing restart marker) is an error,
// where libjpeg would warn and go on.
//
// Encoder: 8-bit RGB to what jpeg_set_defaults + jpeg_set_quality writes
// (Pillow's save(format="JPEG", quality=q) with no other options): SOI, a
// JFIF 1.01 APP0 without density, the two DQT, SOF0, the four Annex K
// Huffman tables, SOS, the data, EOI; YCbCr 4:2:0 by jccolor.c's tables,
// edges replicated out to the blocks and the iMCU as jcprepct.c and
// jcsample.c do (the 2x2 average with the alternating bias 1, 2), dummy
// blocks that repeat the previous DC (jccoefct.c), the islow forward DCT
// (jfdctint.c) and libjpeg-turbo's reciprocal quantization (jcdctmgr.c),
// byte stuffing, the last byte padded with 1-bits.

#include <cstring>
#include <vector>

#include "codec.h"

namespace frameio {
namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// islow DCT constants, CONST_BITS 13 (jfdctint.c, jidctint.c)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr long kFix0298 = 2446, kFix0390 = 3196, kFix0541 = 4433,
               kFix0765 = 6270, kFix0899 = 7373, kFix1175 = 9633,
               kFix1501 = 12299, kFix1847 = 15137, kFix1961 = 16069,
               kFix2053 = 16819, kFix2562 = 20995, kFix3072 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

// ------------------------------------------------------------ decoder

struct HuffTable {
  bool defined = false;
  // a 16-bit lookahead: (code length << 8) | symbol, 0 for no code
  std::vector<uint16_t> lookup;
};

bool build_huff(const uint8_t bits[16], const uint8_t* vals, int nvals,
                HuffTable* t) {
  t->lookup.assign(1 << 16, 0);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i) {
      if (k >= nvals || code >= (1 << len)) return false;
      const int span = 1 << (16 - len);
      uint16_t entry = uint16_t((len << 8) | vals[k++]);
      for (int j = 0; j < span; ++j) t->lookup[(code << (16 - len)) + j] = entry;
      ++code;
    }
    code <<= 1;
  }
  t->defined = true;
  return true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks, padded to whole MCUs
  int dw = 0, dh = 0;  // the component's own size in samples
  bool latched = false;
  uint16_t qt[64] = {0};  // natural order
  std::vector<int16_t> coef;
  int pred = 0;
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int bits = 0;
  int phantom = 0;  // zero bytes fed past a marker or the end
  bool at_marker = false;

  void fill() {
    while (bits <= 56) {
      uint8_t b = 0;
      if (at_marker || p >= end) {
        ++phantom;
      } else if (*p != 0xFF) {
        b = *p++;
      } else {
        const uint8_t* q = p + 1;
        while (q < end && *q == 0xFF) ++q;  // fill bytes
        if (q < end && *q == 0) {
          b = 0xFF;
          p = q + 1;
        } else {
          at_marker = true;  // p stays on the marker's first 0xFF
          ++phantom;
        }
      }
      acc |= uint64_t(b) << (56 - bits);
      bits += 8;
    }
  }
  // bits consumed that were not in the data
  bool overrun() const { return bits < 8 * phantom; }
  uint32_t peek16() {
    if (bits < 16) fill();
    return uint32_t(acc >> 48);
  }
  void skip(int n) {
    acc <<= n;
    bits -= n;
  }
  int receive(int n) {
    if (n == 0) return 0;
    if (bits < n) fill();
    int v = int(acc >> (64 - n));
    skip(n);
    return v;
  }
  void reset() {
    acc = 0;
    bits = 0;
    phantom = 0;
    at_marker = false;
  }
};

inline int extend(int v, int n) {
  return n && v < (1 << (n - 1)) ? v - (1 << n) + 1 : v;
}

struct Decoder {
  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint16_t qt[4][64] = {{0}};
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  bool have_frame = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  Component comp[3];

  int u16(size_t at) const { return (data[at] << 8) | data[at + 1]; }

  // the next marker's code at pos (fill bytes skipped), -1 at the end
  int next_marker() {
    while (pos < size && data[pos] != 0xFF) ++pos;  // stray bytes
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) return -1;
    return data[pos++];
  }

  int read_frame(int marker, const uint8_t* b, int len) {
    if (marker == 0xC2 || marker == 0xC6) return kJpegProgressive;
    if (marker >= 0xC9) return kJpegArithmetic;  // C9-CB, CD-CF
    if (marker == 0xC3 || marker == 0xC5 || marker == 0xC7)
      return kJpegLossless;
    if (len < 6) return kMalformed;
    if (b[0] != 8) return kJpegPrecision;
    height = (b[1] << 8) | b[2];
    width = (b[3] << 8) | b[4];
    ncomp = b[5];
    if (width == 0 || height == 0 || len < 6 + 3 * ncomp) return kMalformed;
    if (ncomp != 1 && ncomp != 3) return kJpegColor;
    if (uint64_t(width) * height * ncomp > kMaxBytes) return kMalformed;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return kMalformed;
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    if (ncomp == 1) {  // one component: its factors do not matter
      comp[0].h = comp[0].v = 1;
      hmax = vmax = 1;
    } else {
      if (adobe) return kJpegColor;
      // libjpeg's rule without a JFIF marker: ids 'R' 'G' 'B' mean RGB
      if (!jfif && comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66)
        return kJpegColor;
      for (int i = 0; i < ncomp; ++i) {
        const Component& c = comp[i];
        if (hmax % c.h || vmax % c.v || hmax / c.h > 2 || vmax / c.v > 2)
          return kJpegSampling;
      }
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    have_frame = true;
    return kOk;
  }

  int read_dqt(const uint8_t* b, int len) {
    int i = 0;
    while (i < len) {
      int pq = b[i] >> 4, tq = b[i] & 15;
      if (pq > 1 || tq > 3 || i + 1 + 64 * (pq + 1) > len) return kMalformed;
      ++i;
      for (int k = 0; k < 64; ++k) {
        qt[tq][kZigzag[k]] = pq ? uint16_t((b[i] << 8) | b[i + 1]) : b[i];
        i += pq + 1;
      }
      qt_defined[tq] = true;
    }
    return kOk;
  }

  int read_dht(const uint8_t* b, int len) {
    int i = 0;
    while (i < len) {
      if (i + 17 > len) return kMalformed;
      int tc = b[i] >> 4, th = b[i] & 15;
      if (tc > 1 || th > 3) return kMalformed;
      int n = 0;
      for (int k = 0; k < 16; ++k) n += b[i + 1 + k];
      if (n > 256 || i + 17 + n > len) return kMalformed;
      if (!build_huff(b + i + 1, b + i + 17, n, tc ? &ac[th] : &dc[th]))
        return kMalformed;
      i += 17 + n;
    }
    return kOk;
  }

  bool decode_symbol(BitReader* br, const HuffTable& t, int* sym) {
    uint16_t e = t.lookup[br->peek16()];
    if (!e) return false;
    br->skip(e >> 8);
    *sym = e & 0xFF;
    return true;
  }

  bool decode_block(BitReader* br, Component& c, int16_t* blk) {
    int s;
    if (!decode_symbol(br, dc[c.td], &s) || s > 15) return false;
    int diff = extend(br->receive(s), s);
    c.pred += diff;
    blk[0] = int16_t(c.pred);
    for (int k = 1; k < 64;) {
      int rs;
      if (!decode_symbol(br, ac[c.ta], &rs)) return false;
      int r = rs >> 4, n = rs & 15;
      if (n) {
        k += r;
        if (k > 63) return false;
        blk[kZigzag[k]] = int16_t(extend(br->receive(n), n));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    return true;
  }

  int read_scan(const uint8_t* b, int len) {
    if (!have_frame) return kMalformed;
    int ns = b[0];
    if (ns < 1 || ns > ncomp || len < 1 + 2 * ns + 3) return kMalformed;
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = b[1 + 2 * i], t = b[2 + 2 * i];
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) return kMalformed;
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        return kMalformed;
      if (!c->latched) {  // libjpeg latches a table at the first scan
        if (!qt_defined[c->tq]) return kMalformed;
        memcpy(c->qt, qt[c->tq], sizeof(c->qt));
        c->latched = true;
      }
      c->pred = 0;
      sc[i] = c;
    }
    int ss = b[1 + 2 * ns], se = b[2 + 2 * ns], a = b[3 + 2 * ns];
    if (ss != 0 || se != 63 || a != 0) return kMalformed;

    // MCUs of this scan: one block each when it holds one component
    int cols = mcux, rows = mcuy;
    if (ns == 1) {
      cols = (sc[0]->dw + 7) / 8;
      rows = (sc[0]->dh + 7) / 8;
    }
    BitReader br{data + pos, data + size};
    const long total = long(cols) * rows;
    int next_rst = 0;
    for (long m = 0; m < total; ++m) {
      if (restart_interval && m && m % restart_interval == 0) {
        if (br.overrun()) return kMalformed;
        // the marker after the interval's data: bytes before it are junk
        const uint8_t* q = br.p;
        while (q + 1 < data + size &&
               !(q[0] == 0xFF && q[1] != 0 && q[1] != 0xFF))
          ++q;
        if (q + 1 >= data + size || q[1] != 0xD0 + next_rst)
          return kMalformed;
        next_rst = (next_rst + 1) & 7;
        br.p = q + 2;
        br.reset();
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      }
      const int my = int(m / cols), mx = int(m % cols);
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        const int nh = ns == 1 ? 1 : c.h, nv = ns == 1 ? 1 : c.v;
        for (int v = 0; v < nv; ++v)
          for (int h = 0; h < nh; ++h) {
            const int by = my * nv + v, bx = mx * nh + h;
            int16_t* blk = &c.coef[(size_t(by) * c.bw + bx) * 64];
            if (!decode_block(&br, c, blk)) return kMalformed;
          }
      }
    }
    if (br.overrun()) return kMalformed;
    // on to the marker after the scan's data
    const uint8_t* q = br.p;
    while (q + 1 < data + size && !(q[0] == 0xFF && q[1] != 0 && q[1] != 0xFF))
      ++q;
    pos = size_t(q - data);
    return kOk;
  }

  int parse(bool header_only) {
    if (size < 3 || data[0] != 0xFF || data[1] != 0xD8) return kNotImage;
    pos = 2;
    for (;;) {
      int marker = next_marker();
      if (marker < 0) return kMalformed;  // no EOI
      if (marker == 0xD9) return have_frame ? kOk : kMalformed;
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) ||
          marker == 0x01)
        continue;  // no length
      if (pos + 2 > size) return kMalformed;
      const int len = u16(pos) - 2;
      if (len < 0 || pos + 2 + size_t(len) > size) return kMalformed;
      const uint8_t* b = data + pos + 2;
      pos += 2 + size_t(len);
      int rc = kOk;
      // jdmarker.c's rules: a JFIF APP0 of 14 bytes or more, an Adobe
      // APP14 of 12 or more
      if (marker == 0xE0 && len >= 14 && memcmp(b, "JFIF\0", 5) == 0) {
        jfif = true;
      } else if (marker == 0xEE && len >= 12 && memcmp(b, "Adobe", 5) == 0) {
        adobe = true;
      } else if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
                 marker != 0xC8 && marker != 0xCC) {
        if (have_frame) return kMalformed;
        if (header_only) {  // the size of any kind of JPEG
          if (len < 6) return kMalformed;
          height = (b[1] << 8) | b[2];
          width = (b[3] << 8) | b[4];
          ncomp = b[5];
          return width && height ? kOk : kMalformed;
        }
        rc = read_frame(marker, b, len);
      } else if (marker == 0xDB) {
        rc = read_dqt(b, len);
      } else if (marker == 0xC4) {
        rc = read_dht(b, len);
      } else if (marker == 0xDD) {
        if (len < 2) return kMalformed;
        restart_interval = (b[0] << 8) | b[1];
      } else if (marker == 0xDA) {
        if (header_only) return kMalformed;
        rc = read_scan(b, len);
      } else if (marker == 0xDC) {
        rc = kMalformed;  // DNL: not in a file with a height
      }
      if (rc != kOk) return rc;
    }
  }
};

// the IDCT's output table (jdmaster.c prepare_range_limit_table), indexed
// by the descaled value & 1023
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x) {
      int s = x < 512 ? x : x - 1024;  // the wrap of & RANGE_MASK
      if (x >= 512 && x < 1024 - 128) s = -129;
      if (x >= 128 && x < 512) s = 127;
      int v = s + 128;
      t[x] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kRange;

// jidctint.c's jpeg_idct_islow of one block into out (stride samples)
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = int(long(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    long z2 = long(ip[16]) * qp[16], z3 = long(ip[48]) * qp[48];
    long z1 = (z2 + z3) * kFix0541;
    long tmp2 = z1 + z3 * -kFix1847;
    long tmp3 = z1 + z2 * kFix0765;
    z2 = long(ip[0]) * qp[0];
    z3 = long(ip[32]) * qp[32];
    long tmp0 = (z2 + z3) * (1L << kConstBits);
    long tmp1 = (z2 - z3) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = long(ip[56]) * qp[56];
    tmp1 = long(ip[40]) * qp[40];
    tmp2 = long(ip[24]) * qp[24];
    tmp3 = long(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * kFix1175;
    tmp0 *= kFix0298;
    tmp1 *= kFix2053;
    tmp2 *= kFix3072;
    tmp3 *= kFix1501;
    z1 *= -kFix0899;
    z2 *= -kFix2562;
    z3 *= -kFix1961;
    z4 *= -kFix0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, n));
    wp[56] = int(descale(tmp10 - tmp3, n));
    wp[8] = int(descale(tmp11 + tmp2, n));
    wp[48] = int(descale(tmp11 - tmp2, n));
    wp[16] = int(descale(tmp12 + tmp1, n));
    wp[40] = int(descale(tmp12 - tmp1, n));
    wp[24] = int(descale(tmp13 + tmp0, n));
    wp[32] = int(descale(tmp13 - tmp0, n));
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    long z2 = wp[2], z3 = wp[6];
    long z1 = (z2 + z3) * kFix0541;
    long tmp2 = z1 + z3 * -kFix1847;
    long tmp3 = z1 + z2 * kFix0765;
    long tmp0 = (long(wp[0]) + wp[4]) * (1L << kConstBits);
    long tmp1 = (long(wp[0]) - wp[4]) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * kFix1175;
    tmp0 *= kFix0298;
    tmp1 *= kFix2053;
    tmp2 *= kFix3072;
    tmp3 *= kFix1501;
    z1 *= -kFix0899;
    z2 *= -kFix2562;
    z3 *= -kFix1961;
    z4 *= -kFix0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// a component's samples (bh*8 x bw*8) from its coefficients
std::vector<uint8_t> component_plane(const Component& c) {
  const size_t stride = size_t(c.bw) * 8;
  std::vector<uint8_t> plane(stride * c.bh * 8);
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.qt,
                 &plane[size_t(by) * 8 * stride + size_t(bx) * 8], stride);
  return plane;
}

// jdsample.c's fancy upsampling of a component to width x height (plane
// stride `stride`; the component's own size c.dw x c.dh)
std::vector<uint8_t> upsample(const std::vector<uint8_t>& plane,
                              size_t stride, const Component& c, int hr,
                              int vr, int width, int height) {
  std::vector<uint8_t> out(size_t(width) * height);
  const int dw = c.dw, dh = c.dh;
  std::vector<uint8_t> line(size_t(2) * dw + 2);
  std::vector<int> colsum(dw);
  for (int y = 0; y < height; ++y) {
    uint8_t* op = &out[size_t(y) * width];
    const int r = vr == 2 ? y / 2 : y;
    const uint8_t* p0 = &plane[size_t(r) * stride];
    if (hr == 1 && vr == 1) {
      memcpy(op, p0, width);
      continue;
    }
    // the neighbour row of a vertical pass: above for even rows, below for
    // odd ones, repeating the component's first and last rows
    const int rn = y % 2 == 0 ? (r > 0 ? r - 1 : 0) : (r + 1 < dh ? r + 1 : dh - 1);
    const uint8_t* p1 = &plane[size_t(rn) * stride];
    uint8_t* lp = line.data();
    if (hr == 2 && vr == 1) {
      if (dw > 2) {
        lp[0] = p0[0];
        lp[1] = uint8_t((p0[0] * 3 + p0[1] + 2) >> 2);
        for (int j = 1; j < dw - 1; ++j) {
          int v = p0[j] * 3;
          lp[2 * j] = uint8_t((v + p0[j - 1] + 1) >> 2);
          lp[2 * j + 1] = uint8_t((v + p0[j + 1] + 2) >> 2);
        }
        lp[2 * dw - 2] = uint8_t((p0[dw - 1] * 3 + p0[dw - 2] + 1) >> 2);
        lp[2 * dw - 1] = p0[dw - 1];
      } else {
        for (int j = 0; j < dw; ++j) lp[2 * j] = lp[2 * j + 1] = p0[j];
      }
    } else if (hr == 1 && vr == 2) {
      const int bias = y % 2 == 0 ? 1 : 2;
      for (int j = 0; j < dw; ++j)
        lp[j] = uint8_t((p0[j] * 3 + p1[j] + bias) >> 2);
    } else if (dw > 2) {  // h2v2
      for (int j = 0; j < dw; ++j) colsum[j] = p0[j] * 3 + p1[j];
      lp[0] = uint8_t((colsum[0] * 4 + 8) >> 4);
      lp[1] = uint8_t((colsum[0] * 3 + colsum[1] + 7) >> 4);
      for (int j = 1; j < dw - 1; ++j) {
        lp[2 * j] = uint8_t((colsum[j] * 3 + colsum[j - 1] + 8) >> 4);
        lp[2 * j + 1] = uint8_t((colsum[j] * 3 + colsum[j + 1] + 7) >> 4);
      }
      lp[2 * dw - 2] = uint8_t((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
      lp[2 * dw - 1] = uint8_t((colsum[dw - 1] * 4 + 7) >> 4);
    } else {  // h2v2 box: rows and columns repeated
      for (int j = 0; j < dw; ++j) lp[2 * j] = lp[2 * j + 1] = p0[j];
    }
    memcpy(op, lp, width);
  }
  return out;
}

// jdcolor.c's tables: SCALEBITS 16, FIX(x) = (long)(x * 65536 + 0.5)
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    const long half = 1L << 15;
    auto fix = [](double x) { return long(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      long x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

int finish(Decoder& d, Image* out) {
  const int w = d.width, h = d.height;
  for (int i = 0; i < d.ncomp; ++i)
    if (!d.comp[i].latched) return kMalformed;  // a component in no scan
  out->width = uint32_t(w);
  out->height = uint32_t(h);
  out->channels = uint32_t(d.ncomp);
  out->pixels.assign(size_t(w) * h * d.ncomp, 0);
  if (d.ncomp == 1) {
    const Component& c = d.comp[0];
    std::vector<uint8_t> plane = component_plane(c);
    for (int y = 0; y < h; ++y)
      memcpy(&out->pixels[size_t(y) * w], &plane[size_t(y) * c.bw * 8], w);
    return kOk;
  }
  std::vector<uint8_t> full[3];
  for (int i = 0; i < 3; ++i) {
    const Component& c = d.comp[i];
    std::vector<uint8_t> plane = component_plane(c);
    full[i] = upsample(plane, size_t(c.bw) * 8, c, d.hmax / c.h,
                       d.vmax / c.v, w, h);
  }
  uint8_t* op = out->pixels.data();
  const size_t n = size_t(w) * h;
  for (size_t i = 0; i < n; ++i) {
    int y = full[0][i], cb = full[1][i], cr = full[2][i];
    op[3 * i] = clamp255(y + kYcc.cr_r[cr]);
    op[3 * i + 1] = clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    op[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
  }
  return kOk;
}

// ------------------------------------------------------------ encoder

// Annex K tables in natural order (jcparam.c)
const int kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kAcLumaVals[162] = {
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
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kAcChromaVals[162] = {
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

// codes and lengths by symbol (jchuff.c jpeg_make_c_derived_tbl)
struct CodeTable {
  uint16_t code[256] = {0};
  uint8_t size[256] = {0};
  CodeTable(const uint8_t bits[16], const uint8_t* vals) {
    int c = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i) {
        code[vals[k]] = uint16_t(c++);
        size[vals[k++]] = uint8_t(len);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>* out;
  uint32_t acc = 0;
  int bits = 0;
  void put(uint32_t code, int n) {
    acc = (acc << n) | (code & ((1u << n) - 1));
    bits += n;
    while (bits >= 8) {
      bits -= 8;
      uint8_t b = uint8_t(acc >> bits);
      out->push_back(b);
      if (b == 0xFF) out->push_back(0);
    }
  }
  void flush() {  // the partial byte filled with 1-bits
    if (bits) put(0x7F, 8 - bits);
  }
};

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM: (reciprocal,
// correction, shift) with q = ((|x| + corr) * recip) >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = uint32_t((uint64_t(1) << r) / divisor);
  uint32_t fr = uint32_t((uint64_t(1) << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

// jfdctint.c's jpeg_fdct_islow, in place
void fdct_islow(int* d) {
  for (int r = 0; r < 8; ++r) {
    int* p = d + 8 * r;
    long tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    long tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    long tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    long tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int((tmp10 - tmp11) * (1 << kPass1Bits));
    long z1 = (tmp12 + tmp13) * kFix0541;
    const int n = kConstBits - kPass1Bits;
    p[2] = int(descale(z1 + tmp13 * kFix0765, n));
    p[6] = int(descale(z1 + tmp12 * -kFix1847, n));
    z1 = tmp4 + tmp7;
    long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    long z5 = (z3 + z4) * kFix1175;
    tmp4 *= kFix0298;
    tmp5 *= kFix2053;
    tmp6 *= kFix3072;
    tmp7 *= kFix1501;
    z1 *= -kFix0899;
    z2 *= -kFix2562;
    z3 *= -kFix1961;
    z4 *= -kFix0390;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, n));
    p[5] = int(descale(tmp5 + z2 + z4, n));
    p[3] = int(descale(tmp6 + z2 + z3, n));
    p[1] = int(descale(tmp7 + z1 + z4, n));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    long tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    long tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    long tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    long tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int(descale(tmp10 - tmp11, kPass1Bits));
    long z1 = (tmp12 + tmp13) * kFix0541;
    const int n = kConstBits + kPass1Bits;
    p[16] = int(descale(z1 + tmp13 * kFix0765, n));
    p[48] = int(descale(z1 + tmp12 * -kFix1847, n));
    z1 = tmp4 + tmp7;
    long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    long z5 = (z3 + z4) * kFix1175;
    tmp4 *= kFix0298;
    tmp5 *= kFix2053;
    tmp6 *= kFix3072;
    tmp7 *= kFix1501;
    z1 *= -kFix0899;
    z2 *= -kFix2562;
    z3 *= -kFix1961;
    z4 *= -kFix0390;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, n));
    p[40] = int(descale(tmp5 + z2 + z4, n));
    p[24] = int(descale(tmp6 + z2 + z3, n));
    p[8] = int(descale(tmp7 + z1 + z4, n));
  }
}

// the quantized coefficients (natural order) of the block at (bx, by) of
// a plane of the given stride
void forward_block(const uint8_t* plane, size_t stride, int bx, int by,
                   const Divisor* div, int16_t* out) {
  int ws[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c)
      ws[8 * r + c] = int(plane[(size_t(by) * 8 + r) * stride + bx * 8 + c]) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int t = ws[i];
    const Divisor& dv = div[i];
    if (t < 0) {
      uint32_t prod = (uint32_t(-t) + dv.corr) * dv.recip;
      out[i] = int16_t(-int(prod >> dv.shift));
    } else {
      uint32_t prod = (uint32_t(t) + dv.corr) * dv.recip;
      out[i] = int16_t(prod >> dv.shift);
    }
  }
}

inline int nbits(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter* bw, const int16_t* blk, int* last_dc,
                  const CodeTable& dct, const CodeTable& act) {
  int diff = blk[0] - *last_dc;
  *last_dc = blk[0];
  int mag = diff < 0 ? -diff : diff;
  int n = nbits(mag);
  bw->put(dct.code[n], dct.size[n]);
  if (n) bw->put(uint32_t(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = blk[kZigzag[k]];
    if (!v) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw->put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    mag = v < 0 ? -v : v;
    n = nbits(mag);
    int sym = (run << 4) + n;
    bw->put(act.code[sym], act.size[sym]);
    bw->put(uint32_t(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) bw->put(act.code[0], act.size[0]);
}

void put16(std::vector<uint8_t>* o, int v) {
  o->push_back(uint8_t(v >> 8));
  o->push_back(uint8_t(v));
}

void put_dht(std::vector<uint8_t>* o, int tc_th, const uint8_t bits[16],
             const uint8_t* vals, int n) {
  o->push_back(0xFF);
  o->push_back(0xC4);
  put16(o, 2 + 1 + 16 + n);
  o->push_back(uint8_t(tc_th));
  o->insert(o->end(), bits, bits + 16);
  o->insert(o->end(), vals, vals + n);
}

}  // namespace

int probe_jpeg(const uint8_t* data, size_t size, uint32_t* width,
               uint32_t* height, uint32_t* channels) {
  Decoder d(data, size);
  int rc = d.parse(true);
  if (rc != kOk) return rc;
  *width = uint32_t(d.width);
  *height = uint32_t(d.height);
  *channels = uint32_t(d.ncomp);
  return kOk;
}

int decode_jpeg(const uint8_t* data, size_t size, Image* out) {
  Decoder d(data, size);
  int rc = d.parse(false);
  return rc == kOk ? finish(d, out) : rc;
}

int encode_jpeg(const uint8_t* rgb, uint32_t width, uint32_t height,
                int quality, std::vector<uint8_t>* out, const uint8_t* comment,
                uint32_t comment_size) {
  if (!width || !height || width > 65535 || height > 65535 || quality < 1 ||
      quality > 100 || comment_size > 65533)
    return kBadArgs;
  const int w = int(width), h = int(height);
  // jpeg_set_quality(quality, force_baseline = TRUE)
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  for (int i = 0; i < 64; ++i) {
    for (int t = 0; t < 2; ++t) {
      long v = (long(t ? kStdChroma[i] : kStdLuma[i]) * scale + 50) / 100;
      qt[t][i] = uint16_t(v < 1 ? 1 : v > 255 ? 255 : v);
    }
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(uint32_t(qt[t][i]) << 3);

  // jccolor.c rgb_ycc_convert: SCALEBITS 16, Cb and Cr rounded with
  // ONE_HALF - 1 and offset by 128 << 16
  auto fix = [](double x) { return long(x * 65536.0 + 0.5); };
  const long half = 1L << 15, cbcr = 128L << 16;
  const long ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
  const long rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.5);
  const long gcr = -fix(0.41869), bcr = -fix(0.08131);
  const size_t npx = size_t(w) * h;
  std::vector<uint8_t> ycc[3];
  for (auto& p : ycc) p.resize(npx);
  for (size_t i = 0; i < npx; ++i) {
    long r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    ycc[0][i] = uint8_t((ry * r + gy * g + by * b + half) >> 16);
    ycc[1][i] = uint8_t((rcb * r + gcb * g + bcb * b + cbcr + half - 1) >> 16);
    ycc[2][i] = uint8_t((bcb * r + gcr * g + bcr * b + cbcr + half - 1) >> 16);
  }

  // 4:2:0: Y 2x2 blocks an MCU, Cb and Cr 1 each
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;
  // Y with its right edge repeated out to its blocks, and its bottom row
  // down to the last iMCU row
  const size_t ys = size_t(ybw) * 8;
  std::vector<uint8_t> yplane(ys * mcuy * 16);
  for (int y = 0; y < mcuy * 16; ++y) {
    const uint8_t* src = &ycc[0][size_t(y < h ? y : h - 1) * w];
    uint8_t* dst = &yplane[size_t(y) * ys];
    memcpy(dst, src, w);
    memset(dst + w, src[w - 1], ys - w);
  }
  // Cb, Cr: the full-resolution plane repeated right to twice the blocks
  // and down to an even row count, averaged 2x2 with the bias 1, 2, 1, ...
  // along each row, then the last averaged row repeated to the iMCU
  const size_t cs = size_t(mcux) * 8;
  const int crows = (h + 1) / 2;
  std::vector<uint8_t> cplane[2];
  for (int t = 0; t < 2; ++t) {
    const std::vector<uint8_t>& full = ycc[1 + t];
    std::vector<uint8_t>& out_plane = cplane[t];
    out_plane.resize(cs * mcuy * 8);
    auto at = [&](int y, int x) {
      return int(full[size_t(y < h ? y : h - 1) * w + (x < w ? x : w - 1)]);
    };
    for (int oy = 0; oy < crows; ++oy) {
      uint8_t* dst = &out_plane[size_t(oy) * cs];
      int bias = 1;
      for (size_t ox = 0; ox < cs; ++ox) {
        const int x = int(2 * ox), y = 2 * oy;
        dst[ox] = uint8_t((at(y, x) + at(y, x + 1) + at(y + 1, x) +
                           at(y + 1, x + 1) + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int oy = crows; oy < mcuy * 8; ++oy)
      memcpy(&out_plane[size_t(oy) * cs], &out_plane[size_t(crows - 1) * cs], cs);
  }

  // markers: SOI, APP0 (JFIF 1.01, no density), COM (a comment, when
  // given), DQT x2, SOF0, DHT x4, SOS
  out->clear();
  out->reserve(npx / 2 + 1024);
  static const uint8_t kHead[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J',
                                  'F',  'I',  'F',  0x00, 0x01, 0x01, 0x00,
                                  0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  out->insert(out->end(), kHead, kHead + sizeof(kHead));
  if (comment_size) {  // COM, where Pillow's jpeg_write_marker puts it
    out->push_back(0xFF);
    out->push_back(0xFE);
    put16(out, int(comment_size + 2));
    out->insert(out->end(), comment, comment + comment_size);
  }
  for (int t = 0; t < 2; ++t) {
    out->push_back(0xFF);
    out->push_back(0xDB);
    put16(out, 67);
    out->push_back(uint8_t(t));
    for (int k = 0; k < 64; ++k) out->push_back(uint8_t(qt[t][kZigzag[k]]));
  }
  static const uint8_t kSofTail[] = {0x03, 0x01, 0x22, 0x00, 0x02, 0x11,
                                     0x01, 0x03, 0x11, 0x01};
  out->push_back(0xFF);
  out->push_back(0xC0);
  put16(out, 17);
  out->push_back(8);
  put16(out, h);
  put16(out, w);
  out->insert(out->end(), kSofTail, kSofTail + sizeof(kSofTail));
  put_dht(out, 0x00, kDcLumaBits, kDcVals, 12);
  put_dht(out, 0x10, kAcLumaBits, kAcLumaVals, 162);
  put_dht(out, 0x01, kDcChromaBits, kDcVals, 12);
  put_dht(out, 0x11, kAcChromaBits, kAcChromaVals, 162);
  static const uint8_t kSos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00,
                                 0x02, 0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  out->insert(out->end(), kSos, kSos + sizeof(kSos));

  static const CodeTable dc_luma(kDcLumaBits, kDcVals);
  static const CodeTable ac_luma(kAcLumaBits, kAcLumaVals);
  static const CodeTable dc_chroma(kDcChromaBits, kDcVals);
  static const CodeTable ac_chroma(kAcChromaBits, kAcChromaVals);
  BitWriter bw{out};
  int last_dc[3] = {0, 0, 0};
  int16_t blk[4][64], cblk[64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      // Y's four blocks; one outside the blocks on the right copies the
      // DC of the block before it, a row below them the last block's DC
      for (int v = 0; v < 2; ++v) {
        int16_t* row = blk[2 * v];
        const int yb = 2 * my + v;
        for (int hh = 0; hh < 2; ++hh) {
          int16_t* b = row + 64 * hh;
          const int xb = 2 * mx + hh;
          if (yb < ybh && xb < ybw) {
            forward_block(yplane.data(), ys, xb, yb, div[0], b);
          } else {
            memset(b, 0, 64 * sizeof(int16_t));
            b[0] = yb < ybh ? b[-64] : blk[1][0];
          }
        }
      }
      for (int i = 0; i < 4; ++i)
        encode_block(&bw, blk[i], &last_dc[0], dc_luma, ac_luma);
      for (int t = 0; t < 2; ++t) {
        forward_block(cplane[t].data(), cs, mx, my, div[1], cblk);
        encode_block(&bw, cblk, &last_dc[1 + t], dc_chroma, ac_chroma);
      }
    }
  }
  bw.flush();
  out->push_back(0xFF);
  out->push_back(0xD9);
  return kOk;
}

}  // namespace frameio
