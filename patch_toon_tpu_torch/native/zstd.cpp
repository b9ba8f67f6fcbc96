// A decoder of zstd frames (RFC 8878) and the CRC-32C checksum, the two
// codecs an Orbax checkpoint's OCDBT database and zarr chunks are written
// with (utils/ocdbt.py, utils/orbax.py). Built into the native library with
// frameio.cpp, jpeg.cpp and resample.cpp.
//
// Covered: frame headers (window descriptor or single segment, optional
// content size), raw / RLE / compressed blocks, literals raw, RLE or
// Huffman-coded (1 or 4 streams, treeless repeats of the previous table),
// sequences in predefined, RLE, FSE and repeat modes with the three repeat
// offsets, concatenated and skippable frames, and the XXH64 content
// checksum, which is verified. A dictionary ID, a reserved bit, a truncated
// frame or any inconsistency is an error with its own code.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

namespace {

enum ZCode {
  kZOk = 0,
  kZTruncated = -20,   // the input ends inside a frame
  kZMagic = -21,       // neither a zstd nor a skippable frame
  kZReserved = -22,    // a reserved bit or block type is set
  kZDictionary = -23,  // the frame names a dictionary
  kZCorrupt = -24,     // a table, stream or sequence that cannot be decoded
  kZChecksum = -25,    // the content checksum does not match
  kZTooLarge = -26,    // the output does not fit the caller's buffer
  kZWindow = -27,      // a window or block larger than the format allows
  kZInternal = -28,    // out of memory
};

struct Error {
  int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | (rd16(p + 2) << 16); }
inline uint64_t rd64(const uint8_t* p) { return rd32(p) | (uint64_t(rd32(p + 4)) << 32); }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// -- XXH64 --------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// -- bit readers ----------------------------------------------------------------

// A backward bitstream (Huffman and FSE streams): read from the end, the
// highest set bit of the last byte marks the start. Bits before the
// beginning read as zeros; pos < 0 afterwards is an overflow.
struct BackReader {
  const uint8_t* p;
  size_t n;
  int64_t pos;  // bits left

  BackReader(const uint8_t* data, size_t size) : p(data), n(size) {
    if (size == 0 || data[size - 1] == 0) fail(kZCorrupt);
    pos = int64_t(size - 1) * 8 + highbit(data[size - 1]);
  }
  // the n bits below pos, without consuming them (n <= 56)
  inline uint64_t peek(int bits) const {
    if (bits == 0) return 0;
    int64_t start = pos - bits;
    uint64_t word;
    int shift;
    if (start >= 0) {
      size_t byte = size_t(start >> 3);
      shift = int(start & 7);
      if (byte + 8 <= n) {
        word = rd64(p + byte);
      } else {
        word = 0;
        for (size_t i = byte; i < n && i < byte + 8; ++i)
          word |= uint64_t(p[i]) << (8 * (i - byte));
      }
      return (word >> shift) & ((uint64_t(1) << bits) - 1);
    }
    // some bits lie before the beginning: they are zeros
    if (pos <= 0) return 0;
    word = 0;
    for (size_t i = 0; i < n && i < 8; ++i) word |= uint64_t(p[i]) << (8 * i);
    uint64_t have = word & ((uint64_t(1) << pos) - 1);
    return have << (-start);
  }
  inline uint64_t read(int bits) {
    uint64_t v = peek(bits);
    pos -= bits;
    return v;
  }
};

// A forward bitstream (the FSE table descriptions), LSB first; bits past
// the end read as zeros and are caught by the caller's length check.
struct FwdReader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits consumed
  FwdReader(const uint8_t* data, size_t size) : p(data), n(size) {}
  uint32_t peek(int bits) const {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) {
      const size_t b = pos + i;
      if ((b >> 3) < n) v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  void skip(int bits) { pos += bits; }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// -- FSE ----------------------------------------------------------------------

struct FseEntry {
  uint8_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool valid = false;
};

// normalized counts (-1 = "less than 1") of a table of 2^log cells
void build_fse(const int16_t* counts, int nsym, int log, FseTable* out) {
  const int size = 1 << log;
  out->log = log;
  out->t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (counts[s] == -1) {
      if (high < 0) fail(kZCorrupt);
      out->t[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(counts[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      out->t[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail(kZCorrupt);
  for (int u = 0; u < size; ++u) {
    const int s = out->t[u].symbol;
    const uint32_t state = next[s]++;
    if (state == 0) fail(kZCorrupt);
    const int bits = log - highbit(state);
    out->t[u].bits = uint8_t(bits);
    out->t[u].base = uint16_t((state << bits) - size);
  }
  out->valid = true;
}

// an FSE table description (RFC 8878 4.1.1); returns the bytes it took
size_t read_fse(const uint8_t* p, size_t n, int max_log, int max_sym,
                FseTable* out) {
  FwdReader r(p, n);
  const int log = int(r.peek(4)) + 5;
  r.skip(4);
  if (log > max_log) fail(kZCorrupt);
  int16_t counts[256] = {0};
  int remaining = (1 << log) + 1, threshold = 1 << log, bits = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t rep = r.peek(2);
        r.skip(2);
        n0 += int(rep);
        if (rep != 3) break;
      }
      if (n0 > max_sym + 1) fail(kZCorrupt);
      while (sym < n0) counts[sym++] = 0;
      if (sym > max_sym) break;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const uint32_t low = r.peek(bits - 1);
    if (int(low) < max) {
      count = int(low);
      r.skip(bits - 1);
    } else {
      count = int(r.peek(bits));
      if (count >= threshold) count -= max;
      r.skip(bits);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    counts[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --bits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || sym > max_sym + 1) fail(kZCorrupt);
  build_fse(counts, sym, log, out);
  if (r.bytes() > n) fail(kZTruncated);
  return r.bytes();
}

void rle_fse(uint8_t symbol, FseTable* out) {
  out->log = 0;
  out->t.assign(1, FseEntry{symbol, 0, 0});
  out->valid = true;
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(BackReader& br, const FseTable& table) {
    t = &table;
    state = uint32_t(br.read(table.log));
  }
  inline uint8_t symbol() const { return t->t[state].symbol; }
  inline void update(BackReader& br) {
    const FseEntry& e = t->t[state];
    state = e.base + uint32_t(br.read(e.bits));
  }
};

// -- Huffman ------------------------------------------------------------------

struct HufTable {
  int log = 0;
  std::vector<uint16_t> t;  // symbol << 8 | bits
  bool valid = false;
};

// the Huffman tree description (RFC 8878 4.2.1); returns the bytes it took
size_t read_huffman(const uint8_t* p, size_t n, HufTable* out) {
  if (n < 1) fail(kZTruncated);
  uint8_t w[256] = {0};
  int nw = 0;
  const int head = p[0];
  size_t used;
  if (head < 128) {
    used = 1 + size_t(head);
    if (used > n || head == 0) fail(head == 0 ? kZCorrupt : kZTruncated);
    FseTable ft;
    const size_t tl = read_fse(p + 1, size_t(head), 6, 255, &ft);
    if (tl >= size_t(head)) fail(kZCorrupt);
    BackReader br(p + 1 + tl, size_t(head) - tl);
    FseState s1, s2;
    s1.init(br, ft);
    s2.init(br, ft);
    for (;;) {
      if (nw > 253) fail(kZCorrupt);
      w[nw++] = s1.symbol();
      s1.update(br);
      if (br.pos < 0) {
        w[nw++] = s2.symbol();
        break;
      }
      w[nw++] = s2.symbol();
      s2.update(br);
      if (br.pos < 0) {
        w[nw++] = s1.symbol();
        break;
      }
    }
  } else {
    nw = head - 127;
    used = 1 + size_t((nw + 1) / 2);
    if (used > n) fail(kZTruncated);
    for (int i = 0; i < nw; ++i)
      w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
  }
  uint32_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail(kZCorrupt);
    if (w[i]) sum += uint32_t(1) << (w[i] - 1);
  }
  if (sum == 0) fail(kZCorrupt);
  const int log = highbit(sum) + 1;
  if (log > 11) fail(kZCorrupt);
  const uint32_t rest = (uint32_t(1) << log) - sum;
  if (rest == 0 || (rest & (rest - 1))) fail(kZCorrupt);
  if (nw >= 256) fail(kZCorrupt);
  w[nw++] = uint8_t(highbit(rest) + 1);
  // ranks: each weight's first cell, symbols in order within a weight
  uint32_t rank[13] = {0};
  for (int i = 0; i < nw; ++i) rank[w[i]]++;
  uint32_t start[13] = {0}, cur = 0;
  for (int k = 1; k <= log; ++k) {
    start[k] = cur;
    cur += rank[k] << (k - 1);
  }
  if (cur != (uint32_t(1) << log)) fail(kZCorrupt);
  out->log = log;
  out->t.assign(size_t(1) << log, 0);
  for (int s = 0; s < nw; ++s) {
    const int k = w[s];
    if (!k) continue;
    const uint32_t len = uint32_t(1) << (k - 1);
    const uint16_t e = uint16_t((s << 8) | (log + 1 - k));
    for (uint32_t i = 0; i < len; ++i) out->t[start[k] + i] = e;
    start[k] += len;
  }
  out->valid = true;
  return used;
}

void huffman_stream(const HufTable& h, const uint8_t* p, size_t n,
                    uint8_t* dst, size_t count) {
  BackReader br(p, n);
  const int log = h.log;
  const uint16_t* t = h.t.data();
  size_t i = 0;
  // while 64 bits lie below pos: one load, then 4 symbols of at most 11
  // bits each from the 57+ bits it holds (the top bit is bit pos - 1)
  while (i + 4 <= count && br.pos >= 64) {
    const int64_t base = (br.pos - 57) >> 3;  // ceil((pos - 64) / 8)
    const int avail = int(br.pos - base * 8);  // 57..64 bits below pos
    uint64_t c = rd64(p + base) << (64 - avail);
    for (int j = 0; j < 4; ++j) {
      const uint16_t e = t[c >> (64 - log)];
      dst[i++] = uint8_t(e >> 8);
      c <<= (e & 0xFF);
      br.pos -= (e & 0xFF);
    }
  }
  for (; i < count; ++i) {
    const uint16_t e = t[br.peek(log)];
    dst[i] = uint8_t(e >> 8);
    br.pos -= (e & 0xFF);
  }
  if (br.pos != 0) fail(kZCorrupt);
}

// -- sequences ----------------------------------------------------------------

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,    1,    2,     3,     4,     5,    6,    7,
                              8,    9,    10,    11,    12,    13,   14,   15,
                              16,   18,   20,    22,    24,    28,   32,   40,
                              48,   64,   128,   256,   512,   1024, 2048, 4096,
                              8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

struct Out {
  uint8_t* base;  // the output buffer
  size_t cap;
  size_t len;
  std::vector<uint8_t>* grow;  // non-null: a growable buffer
  void reserve(size_t extra) {
    if (len + extra <= cap) return;
    if (!grow) fail(kZTooLarge);
    size_t want = cap ? cap : 1024;
    while (want < len + extra) want *= 2;
    grow->resize(want);
    base = grow->data();
    cap = want;
  }
};

// one mode byte's table: predefined, RLE, FSE description or repeat
size_t table_for(int mode, const uint8_t* p, size_t n, const int16_t* dflt,
                 int dflt_n, int dflt_log, int max_log, int max_sym,
                 FseTable* t) {
  switch (mode) {
    case 0:
      build_fse(dflt, dflt_n, dflt_log, t);
      return 0;
    case 1:
      if (n < 1) fail(kZTruncated);
      if (p[0] > max_sym) fail(kZCorrupt);
      rle_fse(p[0], t);
      return 1;
    case 2:
      return read_fse(p, n, max_log, max_sym, t);
    default:
      if (!t->valid) fail(kZCorrupt);
      return 0;
  }
}

void compressed_block(const uint8_t* p, size_t n, FrameState* fs, Out* out,
                      size_t frame_start) {
  if (n < 1) fail(kZTruncated);
  // literals section
  const int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hsize = 0;
  int streams = 1;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      regen = p[0] >> 3;
      hsize = 1;
    } else if (sf == 1) {
      if (n < 2) fail(kZTruncated);
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      hsize = 2;
    } else {
      if (n < 3) fail(kZTruncated);
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      hsize = 3;
    }
    csize = ltype == 0 ? regen : 1;
  } else {
    if (sf < 2) {
      if (n < 3) fail(kZTruncated);
      const uint32_t c = rd24(p);
      regen = (c >> 4) & 0x3FF;
      csize = (c >> 14) & 0x3FF;
      hsize = 3;
      streams = sf == 0 ? 1 : 4;
    } else if (sf == 2) {
      if (n < 4) fail(kZTruncated);
      const uint32_t c = rd32(p);
      regen = (c >> 4) & 0x3FFF;
      csize = c >> 18;
      hsize = 4;
      streams = 4;
    } else {
      if (n < 5) fail(kZTruncated);
      const uint64_t c = rd32(p) | (uint64_t(p[4]) << 32);
      regen = (c >> 4) & 0x3FFFF;
      csize = size_t(c >> 22);
      hsize = 5;
      streams = 4;
    }
  }
  if (regen > (size_t(128) << 10)) fail(kZCorrupt);
  if (hsize + csize > n) fail(kZTruncated);
  // every byte of it is written below before it is read
  std::unique_ptr<uint8_t[]> lit_buf(new uint8_t[regen ? regen : 1]);
  uint8_t* lit = lit_buf.get();
  const uint8_t* lp = p + hsize;
  if (ltype == 0) {
    memcpy(lit, lp, regen);
  } else if (ltype == 1) {
    memset(lit, lp[0], regen);
  } else {
    size_t used = 0;
    if (ltype == 2) {
      used = read_huffman(lp, csize, &fs->huf);
    } else if (!fs->huf.valid) {
      fail(kZCorrupt);
    }
    const uint8_t* sp = lp + used;
    const size_t sn = csize - used;
    if (streams == 1) {
      huffman_stream(fs->huf, sp, sn, lit, regen);
    } else {
      if (sn < 6) fail(kZCorrupt);
      const size_t s1 = rd16(sp), s2 = rd16(sp + 2), s3 = rd16(sp + 4);
      if (6 + s1 + s2 + s3 > sn) fail(kZCorrupt);
      const size_t s4 = sn - 6 - s1 - s2 - s3;
      const size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(kZCorrupt);
      const uint8_t* q = sp + 6;
      huffman_stream(fs->huf, q, s1, lit, seg);
      huffman_stream(fs->huf, q + s1, s2, lit + seg, seg);
      huffman_stream(fs->huf, q + s1 + s2, s3, lit + 2 * seg, seg);
      huffman_stream(fs->huf, q + s1 + s2 + s3, s4, lit + 3 * seg,
                     regen - 3 * seg);
    }
  }
  p += hsize + csize;
  n -= hsize + csize;

  // sequences section
  if (n < 1) fail(kZTruncated);
  size_t nseq = p[0], h = 1;
  if (nseq >= 128) {
    if (nseq < 255) {
      if (n < 2) fail(kZTruncated);
      nseq = ((nseq - 128) << 8) + p[1];
      h = 2;
    } else {
      if (n < 3) fail(kZTruncated);
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      h = 3;
    }
  }
  p += h;
  n -= h;
  size_t li = 0;
  if (nseq > 0) {
    if (n < 1) fail(kZTruncated);
    const int modes = p[0];
    if (modes & 3) fail(kZReserved);
    p += 1;
    n -= 1;
    size_t k = table_for((modes >> 6) & 3, p, n, kLLDefault, 36, 6, 9, 35,
                         &fs->ll);
    p += k;
    n -= k;
    k = table_for((modes >> 4) & 3, p, n, kOFDefault, 29, 5, 8, 31, &fs->of);
    p += k;
    n -= k;
    k = table_for((modes >> 2) & 3, p, n, kMLDefault, 53, 6, 9, 52, &fs->ml);
    p += k;
    n -= k;
    BackReader br(p, n);
    FseState ll, of, ml;
    ll.init(br, fs->ll);
    of.init(br, fs->of);
    ml.init(br, fs->ml);
    uint32_t* rep = fs->rep;
    for (size_t s = 0; s < nseq; ++s) {
      const int ofc = of.symbol(), llc = ll.symbol(), mlc = ml.symbol();
      if (ofc > 31 || llc > 35 || mlc > 52) fail(kZCorrupt);
      const uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
      const size_t mlen = kMLBase[mlc] + size_t(br.read(kMLBits[mlc]));
      const size_t llen = kLLBase[llc] + size_t(br.read(kLLBits[llc]));
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      } else {
        int idx = int(ofv) - 1 + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? uint64_t(rep[0]) - 1 : rep[idx];
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        }
      }
      if (s + 1 < nseq) {
        ll.update(br);
        ml.update(br);
        of.update(br);
      }
      if (br.pos < 0) fail(kZCorrupt);
      if (llen > regen - li) fail(kZCorrupt);
      out->reserve(llen + mlen);
      memcpy(out->base + out->len, lit + li, llen);
      out->len += llen;
      li += llen;
      if (offset == 0 || offset > out->len - frame_start) fail(kZCorrupt);
      uint8_t* d = out->base + out->len;
      const uint8_t* src = d - offset;
      if (offset >= mlen) {
        memcpy(d, src, mlen);
      } else {
        for (size_t i = 0; i < mlen; ++i) d[i] = src[i];
      }
      out->len += mlen;
    }
    if (br.pos != 0) fail(kZCorrupt);
  } else if (n != 0) {
    fail(kZCorrupt);
  }
  const size_t rest = regen - li;
  out->reserve(rest);
  memcpy(out->base + out->len, lit + li, rest);
  out->len += rest;
}

struct Header {
  bool skippable = false;
  uint64_t skip = 0;           // a skippable frame's payload bytes
  bool has_size = false;
  uint64_t content_size = 0;
  uint64_t window = 0;
  bool checksum = false;
  size_t bytes = 0;            // the header's own bytes
};

Header read_header(const uint8_t* p, size_t n) {
  Header h;
  if (n < 4) fail(kZTruncated);
  const uint32_t magic = rd32(p);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) fail(kZTruncated);
    h.skippable = true;
    h.skip = rd32(p + 4);
    h.bytes = 8;
    return h;
  }
  if (magic != 0xFD2FB528u) fail(kZMagic);
  if (n < 5) fail(kZTruncated);
  const int fhd = p[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict = fhd & 3;
  if (fhd & 8) fail(kZReserved);
  h.checksum = (fhd >> 2) & 1;
  size_t at = 5;
  if (!single) {
    if (n < at + 1) fail(kZTruncated);
    const int wd = p[at++];
    const int exp = wd >> 3, mant = wd & 7;
    if (10 + exp > 41) fail(kZWindow);
    const uint64_t base = uint64_t(1) << (10 + exp);
    h.window = base + (base / 8) * mant;
  }
  const int dict_bytes = dict == 0 ? 0 : dict == 1 ? 1 : dict == 2 ? 2 : 4;
  if (n < at + dict_bytes) fail(kZTruncated);
  uint32_t dict_id = 0;
  for (int i = 0; i < dict_bytes; ++i) dict_id |= uint32_t(p[at + i]) << (8 * i);
  at += dict_bytes;
  if (dict_id != 0) fail(kZDictionary);
  const int fcs_bytes =
      fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (n < at + fcs_bytes) fail(kZTruncated);
  if (fcs_bytes) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_bytes; ++i) v |= uint64_t(p[at + i]) << (8 * i);
    if (fcs_bytes == 2) v += 256;
    h.has_size = true;
    h.content_size = v;
  }
  at += fcs_bytes;
  if (single) h.window = h.content_size;
  h.bytes = at;
  return h;
}

// one frame from p (after its header) into out; returns the bytes it took
size_t decode_frame(const uint8_t* p, size_t n, const Header& h, Out* out) {
  FrameState fs;
  const size_t start = out->len;
  const uint64_t max_block = h.window < (128u << 10) ? h.window : (128u << 10);
  size_t at = 0;
  for (;;) {
    if (n < at + 3) fail(kZTruncated);
    const uint32_t bh = rd24(p + at);
    at += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail(kZReserved);
    if (type != 1 && n < at + size) fail(kZTruncated);
    if (size > (128u << 10) || (type != 1 && size > max_block && max_block))
      fail(kZWindow);
    if (type == 0) {
      out->reserve(size);
      memcpy(out->base + out->len, p + at, size);
      out->len += size;
      at += size;
    } else if (type == 1) {
      if (n < at + 1) fail(kZTruncated);
      out->reserve(size);
      memset(out->base + out->len, p[at], size);
      out->len += size;
      at += 1;
    } else {
      compressed_block(p + at, size, &fs, out, start);
      at += size;
    }
    if (last) break;
  }
  const size_t produced = out->len - start;
  if (h.has_size && produced != h.content_size) fail(kZCorrupt);
  if (h.checksum) {
    if (n < at + 4) fail(kZTruncated);
    const uint32_t want = rd32(p + at);
    const uint32_t got = uint32_t(xxh64(out->base + start, produced));
    if (want != got) fail(kZChecksum);
    at += 4;
  }
  return at;
}

void decode_all(const uint8_t* src, size_t n, Out* out) {
  size_t at = 0;
  if (n == 0) fail(kZTruncated);
  while (at < n) {
    const Header h = read_header(src + at, n - at);
    at += h.bytes;
    if (h.skippable) {
      if (n - at < h.skip) fail(kZTruncated);
      at += h.skip;
      continue;
    }
    if (h.has_size) out->reserve(size_t(h.content_size));
    at += decode_frame(src + at, n - at, h, out);
  }
}

// -- CRC-32C ------------------------------------------------------------------

uint32_t crc_table[8][256];
bool crc_ready = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      crc_table[t][i] =
          (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
  return true;
}();

}  // namespace

extern "C" {

// every frame of src into dst (cap bytes); *written the bytes produced
int zstd_decompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap,
                    uint64_t* written) {
  try {
    Out out{dst, size_t(cap), 0, nullptr};
    decode_all(src, size_t(n), &out);
    *written = out.len;
    return kZOk;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kZInternal;
  }
}

// every frame of src into a malloc'd buffer (free with frameio_free)
int zstd_decompress_alloc(const uint8_t* src, uint64_t n, uint8_t** dst,
                          uint64_t* written) {
  try {
    std::vector<uint8_t> buf;
    Out out{nullptr, 0, 0, &buf};
    decode_all(src, size_t(n), &out);
    uint8_t* p = static_cast<uint8_t*>(malloc(out.len ? out.len : 1));
    if (!p) return kZInternal;
    if (out.len) memcpy(p, out.base, out.len);
    *dst = p;
    *written = out.len;
    return kZOk;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kZInternal;
  }
}

// CRC-32C (Castagnoli) of src, continuing from crc (0 to start)
uint32_t crc32c(const uint8_t* src, uint64_t n, uint32_t crc) {
  (void)crc_ready;
  uint32_t c = ~crc;
  while (n >= 8) {
    const uint32_t lo = rd32(src) ^ c, hi = rd32(src + 4);
    c = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF] ^
        crc_table[5][(lo >> 16) & 0xFF] ^ crc_table[4][lo >> 24] ^
        crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
        crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
    src += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ crc_table[0][(c ^ *src++) & 0xFF];
  return ~c;
}

}  // extern "C"
