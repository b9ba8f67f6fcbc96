// Pillow's LANCZOS resize of 8-bit images, bit for bit (Pillow's
// libImaging/Resample.c: precompute_coeffs, normalize_coeffs_8bpc and the
// 8bpc horizontal and vertical passes).
//
// The weights are doubles rounded to 22 fractional bits, so a weight that
// rounds otherwise at .5 changes a pixel: the library is built with
// -ffp-contract=off and without -ffast-math, so that every product and sum
// is the IEEE operation Pillow's C code does.

#include <cmath>
#include <vector>

#include "codec.h"

namespace frameio {
namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;
constexpr double kSupport = 3.0;  // LANCZOS: sinc windowed by sinc(x/3)

double sinc(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return sin(x) / x;
}

double lanczos(double x) {
  if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3);
  return 0.0;
}

// each output index's first tap, tap count and 22-bit weights (ksize a row)
struct Taps {
  int ksize = 0;
  std::vector<int> first, count;
  std::vector<int32_t> weights;
};

Taps precompute(int in_size, int out_size) {
  Taps t;
  // Pillow passes the box as floats: in1 - in0 is a float subtraction
  const float in0 = 0.0f, in1 = float(in_size);
  double scale = double(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = kSupport * filterscale;
  t.ksize = int(ceil(support)) * 2 + 1;
  t.first.resize(out_size);
  t.count.resize(out_size);
  t.weights.assign(size_t(out_size) * t.ksize, 0);
  std::vector<double> k(t.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double w = lanczos((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    int32_t* out = &t.weights[size_t(xx) * t.ksize];
    for (int x = 0; x < xmax; ++x)
      out[x] = k[x] < 0 ? int32_t(-0.5 + k[x] * (1 << kPrecisionBits))
                        : int32_t(0.5 + k[x] * (1 << kPrecisionBits));
    t.first[xx] = xmin;
    t.count[xx] = xmax;
  }
  return t;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return uint8_t(in >> kPrecisionBits);
}

// rows [row0, row0 + rows) of src (width w) to dst (width ow)
void horizontal(const uint8_t* src, int w, int c, int row0, int rows,
                const Taps& t, int ow, uint8_t* dst) {
  for (int yy = 0; yy < rows; ++yy) {
    const uint8_t* in = src + size_t(row0 + yy) * w * c;
    uint8_t* out = dst + size_t(yy) * ow * c;
    for (int xx = 0; xx < ow; ++xx) {
      const int32_t* k = &t.weights[size_t(xx) * t.ksize];
      const uint8_t* p = in + size_t(t.first[xx]) * c;
      for (int ch = 0; ch < c; ++ch) {
        int ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < t.count[xx]; ++x) ss += p[x * c + ch] * k[x];
        out[xx * c + ch] = clip8(ss);
      }
    }
  }
}

// src rows start at source row `shift`; every output row of width w
void vertical(const uint8_t* src, int w, int c, int shift, const Taps& t,
              int oh, uint8_t* dst) {
  const size_t stride = size_t(w) * c;
  for (int yy = 0; yy < oh; ++yy) {
    const int32_t* k = &t.weights[size_t(yy) * t.ksize];
    const uint8_t* in = src + size_t(t.first[yy] - shift) * stride;
    uint8_t* out = dst + size_t(yy) * stride;
    for (size_t i = 0; i < stride; ++i) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < t.count[yy]; ++y) ss += in[y * stride + i] * k[y];
      out[i] = clip8(ss);
    }
  }
}

}  // namespace

int resize_lanczos(const uint8_t* src, uint32_t width, uint32_t height,
                   uint32_t channels, uint32_t out_width, uint32_t out_height,
                   uint8_t* dst) {
  if ((channels != 1 && channels != 3) || !width || !height || !out_width ||
      !out_height || width > (1u << 16) || height > (1u << 16) ||
      out_width > (1u << 16) || out_height > (1u << 16))
    return kBadArgs;
  try {
    const int w = int(width), h = int(height), c = int(channels);
    const int ow = int(out_width), oh = int(out_height);
    const bool need_h = ow != w, need_v = oh != h;
    if (!need_h && !need_v) {
      std::copy(src, src + size_t(w) * h * c, dst);
      return kOk;
    }
    Taps tv = precompute(h, oh);
    if (!need_h) {
      vertical(src, w, c, 0, tv, oh, dst);
      return kOk;
    }
    Taps th = precompute(w, ow);
    // the horizontal pass runs only on the rows the vertical pass reads
    const int first = tv.first[0];
    const int last = tv.first[oh - 1] + tv.count[oh - 1];
    if (!need_v) {
      horizontal(src, w, c, 0, h, th, ow, dst);
      return kOk;
    }
    std::vector<uint8_t> tmp(size_t(last - first) * ow * c);
    horizontal(src, w, c, first, last - first, th, ow, tmp.data());
    vertical(tmp.data(), ow, c, first, tv, oh, dst);
    return kOk;
  } catch (...) {
    return kInternal;
  }
}

}  // namespace frameio
