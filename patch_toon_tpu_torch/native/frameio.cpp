// frameio: the port's native image codec (PNG here, baseline JPEG in
// jpeg.cpp), threaded in-order frame loader and asynchronous frame writer,
// and the C interface of the library, which also holds resample.cpp's
// LANCZOS resize.
//
// Counterpart of patch_toon_tpu/native/frameio.cpp (the JAX package's copy,
// which the port does not load). Decoding and encoding run in C++ threads
// with a bounded in-order ring, so frame IO overlaps the card's work in the
// streaming engine; every entry point is called through ctypes, which
// releases the interpreter lock for the call.
//
// A file is decoded by its signature, whatever its name: PNG or JPEG. PNG
// scope: 8-bit non-interlaced, colour types 0 (gray), 2 (RGB), 4
// (gray+alpha) and 6 (RGBA), in both directions; zlib for inflate, deflate
// and crc32. JPEG scope: jpeg.cpp. A file outside them is refused with its
// own code (kNotImage, kUnsupported, the kJpeg* codes), on which the Python
// side reads it with PIL; every other failure is an error that the caller
// reports. The successful native decodes are counted by format.
//
// Differences from the JAX copy: the codes above tell a format the codec
// does not take from a damaged file; the decoded size must match IHDR
// exactly; a header whose pixel count is absurd is refused before any
// allocation; the encoder takes gray+alpha; a short write or a failed close
// counts as a failed write; a failed frame advances the loader's window
// like a decoded one; no C++ exception crosses the C interface.
//
// C interface only.

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include "codec.h"

namespace {

using namespace frameio;  // Image and the codes

// successful native decodes since the last reset, by format
std::atomic<uint64_t> png_decodes{0}, jpeg_decodes{0};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

const uint8_t kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};

// ---------------------------------------------------------------- PNG read

int decode_png(const uint8_t* data, size_t size, Image* out) {
  if (size < 8 || memcmp(data, kSignature, 8) != 0) return kNotImage;

  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  bool have_ihdr = false;
  std::vector<uint8_t> idat;

  while (pos + 8 <= size) {
    uint32_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (uint64_t(pos) + 12 + len > size) return kMalformed;

    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return kMalformed;
      width = be32(body);
      height = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
      have_ihdr = true;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + size_t(len);
  }

  if (!have_ihdr || width == 0 || height == 0) return kMalformed;
  if (bit_depth != 8 || interlace != 0) return kUnsupported;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return kUnsupported;  // palette
  }
  if (uint64_t(width) * height * channels > kMaxBytes) return kMalformed;

  const size_t stride = size_t(width) * channels;
  const size_t raw_size = (stride + 1) * height;
  std::vector<uint8_t> raw(raw_size);

  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kInflate;
  zs.next_in = const_cast<uint8_t*>(idat.data());
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  int zret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zs.avail_out != 0 || (zret != Z_STREAM_END && zret != Z_OK))
    return kInflate;

  out->width = width;
  out->height = height;
  out->channels = channels;
  out->pixels.assign(stride * height, 0);

  const int bpp = channels;  // bytes per pixel at 8 bits
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = raw.data() + (stride + 1) * y + 1;
    uint8_t* dst = out->pixels.data() + stride * y;
    const uint8_t* up = y ? out->pixels.data() + stride * (y - 1) : nullptr;
    switch (filter) {
      case 0:
        memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        for (size_t x = 0; x < stride; ++x)
          dst[x] = src[x] + (x >= size_t(bpp) ? dst[x - bpp] : 0);
        break;
      case 2:  // Up
        for (size_t x = 0; x < stride; ++x)
          dst[x] = src[x] + (up ? up[x] : 0);
        break;
      case 3:  // Average
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = up ? up[x] : 0;
          dst[x] = src[x] + uint8_t((a + b) / 2);
        }
        break;
      case 4:  // Paeth
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
          dst[x] = src[x] + uint8_t(paeth(a, b, c));
        }
        break;
      default:
        return kBadFilter;
    }
  }
  return kOk;
}

// --------------------------------------------------------------- PNG write

void put_be32(std::vector<uint8_t>* v, uint32_t x) {
  v->push_back(uint8_t(x >> 24));
  v->push_back(uint8_t(x >> 16));
  v->push_back(uint8_t(x >> 8));
  v->push_back(uint8_t(x));
}

void put_chunk(std::vector<uint8_t>* v, const char* type,
               const uint8_t* body, size_t len) {
  put_be32(v, uint32_t(len));
  size_t start = v->size();
  v->insert(v->end(), type, type + 4);
  if (len) v->insert(v->end(), body, body + len);
  uint32_t crc = crc32(0, v->data() + start, uInt(4 + len));
  put_be32(v, crc);
}

int encode_png(const uint8_t* pixels, uint32_t width, uint32_t height,
               uint32_t channels, int compress_level,
               std::vector<uint8_t>* out) {
  if (channels < 1 || channels > 4 || width == 0 || height == 0)
    return kBadArgs;
  if (uint64_t(width) * height * channels > kMaxBytes) return kBadArgs;
  static const uint8_t kColorType[5] = {0, 0, 4, 2, 6};
  out->assign(kSignature, kSignature + 8);

  uint8_t ihdr[13];
  ihdr[0] = uint8_t(width >> 24); ihdr[1] = uint8_t(width >> 16);
  ihdr[2] = uint8_t(width >> 8);  ihdr[3] = uint8_t(width);
  ihdr[4] = uint8_t(height >> 24); ihdr[5] = uint8_t(height >> 16);
  ihdr[6] = uint8_t(height >> 8);  ihdr[7] = uint8_t(height);
  ihdr[8] = 8;  // bit depth
  ihdr[9] = kColorType[channels];
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);

  const size_t stride = size_t(width) * channels;
  std::vector<uint8_t> raw((stride + 1) * height);
  for (uint32_t y = 0; y < height; ++y) {
    raw[(stride + 1) * y] = 0;  // filter None
    memcpy(raw.data() + (stride + 1) * y + 1, pixels + stride * y, stride);
  }

  uLongf bound = compressBound(uLong(raw.size()));
  std::vector<uint8_t> compressed(bound);
  if (compress2(compressed.data(), &bound, raw.data(), uLong(raw.size()),
                compress_level) != Z_OK)
    return kInternal;
  put_chunk(out, "IDAT", compressed.data(), bound);
  put_chunk(out, "IEND", nullptr, 0);
  return kOk;
}

int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return kReadFailed;
  long n = -1;
  if (fseek(f, 0, SEEK_END) == 0) n = ftell(f);
  if (n < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return kReadFailed;
  }
  out->resize(size_t(n));
  size_t got = n ? fread(out->data(), 1, size_t(n), f) : 0;
  fclose(f);
  return got == size_t(n) ? kOk : kReadFailed;
}

int write_file(const char* path, const std::vector<uint8_t>& data) {
  FILE* f = fopen(path, "wb");
  if (!f) return kWriteFailed;
  size_t put = fwrite(data.data(), 1, data.size(), f);
  int closed = fclose(f);
  return put == data.size() && closed == 0 ? kOk : kWriteFailed;
}

bool is_jpeg(const std::vector<uint8_t>& file) {
  return file.size() >= 3 && file[0] == 0xFF && file[1] == 0xD8 &&
         file[2] == 0xFF;
}

int read_and_decode(const char* path, Image* img) {
  try {
    std::vector<uint8_t> file;
    int rc = read_file(path, &file);
    if (rc != kOk) return rc;
    if (is_jpeg(file)) {
      rc = decode_jpeg(file.data(), file.size(), img);
      if (rc == kOk) jpeg_decodes.fetch_add(1);
    } else {
      rc = decode_png(file.data(), file.size(), img);
      if (rc == kOk) png_decodes.fetch_add(1);
    }
    return rc;
  } catch (...) {
    return kInternal;
  }
}

// the size and channel count in a PNG's IHDR or a JPEG's frame header
int probe(const char* path, uint32_t* width, uint32_t* height,
          uint32_t* channels) {
  try {
    std::vector<uint8_t> file;
    int rc = read_file(path, &file);
    if (rc != kOk) return rc;
    if (is_jpeg(file))
      return probe_jpeg(file.data(), file.size(), width, height, channels);
    if (file.size() < 8 || memcmp(file.data(), kSignature, 8) != 0)
      return kNotImage;
    if (file.size() < 8 + 8 + 13 || memcmp(file.data() + 12, "IHDR", 4) != 0)
      return kMalformed;
    static const uint32_t kBands[7] = {1, 0, 3, 1, 2, 0, 4};
    const uint8_t* ihdr = file.data() + 16;
    *width = be32(ihdr);
    *height = be32(ihdr + 4);
    *channels = ihdr[9] < 7 ? kBands[ihdr[9]] : 0;
    return *width && *height && *channels ? kOk : kMalformed;
  } catch (...) {
    return kInternal;
  }
}

int encode_and_write(const char* path, const uint8_t* pixels, uint32_t width,
                     uint32_t height, uint32_t channels, int level) {
  try {
    std::vector<uint8_t> png;
    int rc = encode_png(pixels, width, height, channels, level, &png);
    return rc == kOk ? write_file(path, png) : rc;
  } catch (...) {
    return kInternal;
  }
}

// hands a decoded image to the caller as a malloc'd buffer
int export_image(const Image& img, uint8_t** pixels, uint32_t* width,
                 uint32_t* height, uint32_t* channels) {
  *pixels = static_cast<uint8_t*>(malloc(img.pixels.size()));
  if (!*pixels) return kInternal;
  memcpy(*pixels, img.pixels.data(), img.pixels.size());
  *width = img.width;
  *height = img.height;
  *channels = img.channels;
  return kOk;
}

// --------------------------------------------------- threaded frame loader

struct Slot {
  Image img;
  int status = 0;
  bool done = false;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_window;
  std::atomic<size_t> next_job{0};
  size_t next_consume = 0;  // guarded by mu
  size_t window = 8;
  bool stopping = false;

  void work() {
    for (;;) {
      size_t i = next_job.fetch_add(1);
      if (i >= paths.size()) return;
      {
        // bound the decode window so memory stays O(window)
        std::unique_lock<std::mutex> lock(mu);
        cv_window.wait(lock, [&] {
          return stopping || i < next_consume + window;
        });
        if (stopping) return;
      }
      Image img;
      int rc = read_and_decode(paths[i].c_str(), &img);
      {
        std::lock_guard<std::mutex> lock(mu);
        slots[i].img = std::move(img);
        slots[i].status = rc;
        slots[i].done = true;
      }
      cv_ready.notify_all();
    }
  }
};

// --------------------------------------------------- threaded frame writer

struct WriteJob {
  std::string path;
  std::vector<uint8_t> pixels;
  uint32_t width, height, channels;
};

struct Writer {
  std::vector<std::thread> workers;
  std::queue<WriteJob> jobs;
  std::mutex mu;
  std::condition_variable cv;
  int pending = 0;  // guarded by mu
  std::atomic<int> errors{0};
  bool stopping = false;
  int compress_level = 1;  // speed over size for streaming video

  void work() {
    for (;;) {
      WriteJob job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] { return stopping || !jobs.empty(); });
        if (jobs.empty()) return;  // stopping, and nothing left to write
        job = std::move(jobs.front());
        jobs.pop();
      }
      int rc = encode_and_write(job.path.c_str(), job.pixels.data(),
                                job.width, job.height, job.channels,
                                compress_level);
      if (rc != kOk) errors.fetch_add(1);
      {
        std::lock_guard<std::mutex> lock(mu);
        --pending;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// one-shot decode into a malloc'd buffer (free with frameio_free); 0 or a
// negative code
int frameio_decode(const char* path, uint8_t** pixels, uint32_t* width,
                   uint32_t* height, uint32_t* channels) {
  Image img;
  int rc = read_and_decode(path, &img);
  return rc == kOk ? export_image(img, pixels, width, height, channels) : rc;
}

int frameio_encode(const char* path, const uint8_t* pixels, uint32_t width,
                   uint32_t height, uint32_t channels, int compress_level) {
  return encode_and_write(path, pixels, width, height, channels,
                          compress_level);
}

// the size and channel count of a PNG or JPEG from its header
int frameio_probe(const char* path, uint32_t* width, uint32_t* height,
                  uint32_t* channels) {
  return probe(path, width, height, channels);
}

// 8-bit RGB to a baseline 4:2:0 JPEG at `quality` (jpeg.cpp), with a COM
// segment of comment_size bytes when that is not 0
int frameio_encode_jpeg(const char* path, const uint8_t* rgb, uint32_t width,
                        uint32_t height, int quality, const uint8_t* comment,
                        uint32_t comment_size) {
  try {
    std::vector<uint8_t> jpeg;
    int rc = encode_jpeg(rgb, width, height, quality, &jpeg, comment,
                         comment_size);
    return rc == kOk ? write_file(path, jpeg) : rc;
  } catch (...) {
    return kInternal;
  }
}

// Pillow's LANCZOS resize of 8-bit (height, width, 1 or 3) into dst
int frameio_resize(const uint8_t* src, uint32_t width, uint32_t height,
                   uint32_t channels, uint8_t* dst, uint32_t out_width,
                   uint32_t out_height) {
  return resize_lanczos(src, width, height, channels, out_width, out_height,
                        dst);
}

// successful native decodes since the last reset, by format
void frameio_decode_counts(uint64_t* png, uint64_t* jpeg) {
  *png = png_decodes.load();
  *jpeg = jpeg_decodes.load();
}

void frameio_zero_decode_counts() {
  png_decodes.store(0);
  jpeg_decodes.store(0);
}

void frameio_free(uint8_t* p) { free(p); }

// -- loader ------------------------------------------------------------------

void* frameio_loader_create(const char** paths, int n, int num_threads,
                            int window) {
  try {
    auto* loader = new Loader();
    loader->paths.assign(paths, paths + n);
    loader->slots.resize(n);
    loader->window = window > 0 ? size_t(window) : 8;
    int threads = num_threads > 0 ? num_threads : 4;
    for (int i = 0; i < threads; ++i)
      loader->workers.emplace_back([loader] { loader->work(); });
    return loader;
  } catch (...) {
    return nullptr;
  }
}

// blocks until frame `index` is decoded; 0 or the frame's negative code
int frameio_loader_get(void* handle, int index, uint8_t** pixels,
                       uint32_t* width, uint32_t* height,
                       uint32_t* channels) {
  auto* loader = static_cast<Loader*>(handle);
  if (index < 0 || size_t(index) >= loader->slots.size()) return kBadArgs;
  std::unique_lock<std::mutex> lock(loader->mu);
  loader->cv_ready.wait(lock, [&] { return loader->slots[index].done; });
  Slot& slot = loader->slots[index];
  int rc = slot.status;
  if (rc == kOk) rc = export_image(slot.img, pixels, width, height, channels);
  // a frame taken, decoded or not, advances the window
  if (size_t(index) >= loader->next_consume)
    loader->next_consume = size_t(index) + 1;
  slot.img.pixels.clear();
  slot.img.pixels.shrink_to_fit();
  loader->cv_window.notify_all();
  return rc;
}

void frameio_loader_destroy(void* handle) {
  auto* loader = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(loader->mu);
    loader->stopping = true;
  }
  loader->cv_window.notify_all();
  loader->next_job.store(loader->paths.size());
  for (auto& t : loader->workers) t.join();
  delete loader;
}

// -- writer ------------------------------------------------------------------

void* frameio_writer_create(int num_threads, int compress_level) {
  try {
    auto* writer = new Writer();
    writer->compress_level = compress_level;
    int threads = num_threads > 0 ? num_threads : 2;
    for (int i = 0; i < threads; ++i)
      writer->workers.emplace_back([writer] { writer->work(); });
    return writer;
  } catch (...) {
    return nullptr;
  }
}

// copies the pixels and queues the write; 0, or kInternal when the copy
// could not be made (nothing is queued then)
int frameio_writer_submit(void* handle, const char* path,
                          const uint8_t* pixels, uint32_t width,
                          uint32_t height, uint32_t channels) {
  auto* writer = static_cast<Writer*>(handle);
  try {
    WriteJob job;
    job.path = path;
    job.pixels.assign(pixels, pixels + size_t(width) * height * channels);
    job.width = width;
    job.height = height;
    job.channels = channels;
    std::lock_guard<std::mutex> lock(writer->mu);
    writer->jobs.push(std::move(job));
    ++writer->pending;
  } catch (...) {
    return kInternal;
  }
  writer->cv.notify_all();
  return kOk;
}

// waits for every queued write; the number of writes that failed so far
int frameio_writer_flush(void* handle) {
  auto* writer = static_cast<Writer*>(handle);
  std::unique_lock<std::mutex> lock(writer->mu);
  writer->cv.wait(lock, [&] { return writer->pending == 0; });
  return writer->errors.load();
}

// writes what is queued, then stops the threads
void frameio_writer_destroy(void* handle) {
  auto* writer = static_cast<Writer*>(handle);
  {
    std::lock_guard<std::mutex> lock(writer->mu);
    writer->stopping = true;
  }
  writer->cv.notify_all();
  for (auto& t : writer->workers) t.join();
  delete writer;
}

}  // extern "C"
