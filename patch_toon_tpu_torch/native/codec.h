// Declarations shared by the native library's sources: frameio.cpp (PNG,
// the loader and the writer), jpeg.cpp (baseline JPEG) and resample.cpp
// (Pillow's LANCZOS resize). One library is built from all of them.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace frameio {

enum Code {
  kOk = 0,
  kReadFailed = -1,   // the file could not be read
  kMalformed = -2,    // truncated segment, bad header, absurd size, bad data
  kUnsupported = -3,  // palette, 16-bit, interlaced PNG: read with PIL instead
  kInflate = -4,      // the compressed data is damaged or the wrong size
  kBadFilter = -5,    // a row filter type outside 0-4
  kNotImage = -6,     // neither a PNG nor a JPEG signature: PIL instead
  kWriteFailed = -7,  // open, write or close of the output failed
  kBadArgs = -8,      // a channel count or size the entry does not take
  kInternal = -9,     // out of memory or another C++ exception
  // JPEG files outside the decoder's scope, each read with PIL instead
  kJpegProgressive = -10,  // SOF2 / SOF6
  kJpegArithmetic = -11,   // SOF9-SOF15
  kJpegPrecision = -12,    // a sample precision other than 8 bits
  kJpegLossless = -13,     // SOF3, or hierarchical (SOF5, SOF7)
  kJpegColor = -14,        // CMYK / YCCK, 2 components, Adobe or RGB
  kJpegSampling = -15,     // sampling factors other than 1x1/2x1/1x2/2x2
};

// a frame of at most 2^30 bytes (e.g. 16384 x 16384 RGBA)
constexpr uint64_t kMaxBytes = uint64_t(1) << 30;

struct Image {
  uint32_t width = 0;
  uint32_t height = 0;
  uint32_t channels = 0;
  std::vector<uint8_t> pixels;  // row-major, tightly packed
};

// the width, height and component count in a baseline JPEG's frame header
// (any JPEG whose header parses, refused kinds included)
int probe_jpeg(const uint8_t* data, size_t size, uint32_t* width,
               uint32_t* height, uint32_t* channels);

// a baseline JPEG to 8-bit gray (1 channel) or RGB (3), as libjpeg-turbo
// decodes it with its defaults (islow IDCT, fancy upsampling)
int decode_jpeg(const uint8_t* data, size_t size, Image* out);

// 8-bit RGB to a baseline JFIF file as libjpeg-turbo writes it with its
// defaults and jpeg_set_quality(quality): 4:2:0, islow DCT, Annex K tables;
// a comment of comment_size bytes (at most 65533) as a COM segment after
// APP0, as Pillow's save writes im.info["comment"]
int encode_jpeg(const uint8_t* rgb, uint32_t width, uint32_t height,
                int quality, std::vector<uint8_t>* out,
                const uint8_t* comment = nullptr, uint32_t comment_size = 0);

// Pillow's LANCZOS resize of 8-bit (h, w, channels) to (oh, ow, channels)
int resize_lanczos(const uint8_t* src, uint32_t width, uint32_t height,
                   uint32_t channels, uint32_t out_width, uint32_t out_height,
                   uint8_t* dst);

}  // namespace frameio
