// A Zstandard decoder (RFC 8878), decompression only, in plain C++17.
//
// It decodes a buffer of one or more frames: Zstandard frames, whose
// outputs are concatenated, and skippable frames, which are skipped. A
// frame's blocks may be raw, RLE or compressed; a compressed block's
// literals may be raw, RLE, Huffman-coded with a new tree or with the
// previous one ("treeless"), in one stream or four; its sequences' three
// FSE tables may be predefined, RLE, described in the block or repeated
// from the previous block. The three repeat offsets carry across the
// blocks of a frame. A frame's content checksum, when it has one, is held
// against the low 32 bits of the output's XXH64, computed here. A frame
// that names a dictionary is refused with its ID: nothing here carries one.
//
// C interface (ctypes, utils/zstd.py):
//   int zstd_decompress(const uint8_t* src, size_t n, uint8_t** out,
//                       size_t* out_n, char* err, size_t err_n);
//       0 and a malloc'd *out of *out_n bytes (free with zstd_free), or
//       -1 and a message in err.
//   void zstd_free(uint8_t* p);
//   uint64_t zstd_xxh64(const uint8_t* p, size_t n, uint64_t seed);

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64

constexpr uint64_t kP1 = 11400714785074694791ULL;
constexpr uint64_t kP2 = 14029467366897019727ULL;
constexpr uint64_t kP3 = 1609587929392839161ULL;
constexpr uint64_t kP4 = 9650029242287828579ULL;
constexpr uint64_t kP5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * kP2, 31) * kP1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * kP1 + kP4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed,
             v4 = seed - kP1;
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
    h = seed + kP5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * kP1 + kP4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * kP1), 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * kP5), 11) * kP1;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------- bit streams

// A little-endian bit stream read forwards (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits consumed
  FwdBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int k) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 8 && byte + i < n; ++i)
      v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ULL << k) - 1));
  }
  void skip(int k) {
    pos += k;
    if (pos > n * 8) fail("FSE table description runs past its data");
  }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// A bit stream read backwards from its end, as FSE and Huffman streams are
// written: the last byte's highest set bit marks the start. Bits before
// the stream's start read as zeros; ``overflowed`` tells that they were.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;  // bits left to read, counted from the stream's start
  BackBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    if (n == 0) fail("empty bit stream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("bit stream without its end mark");
    pos = int64_t(n - 1) * 8 + highbit(last);
  }
  // the ``k`` (<= 32) bits below ``pos``, the first of them the highest
  uint32_t peek(int k) const {
    if (k == 0) return 0;
    int64_t lo = pos - k;
    uint64_t v;
    if (lo >= 0 && (size_t(lo) >> 3) + 8 <= n) {
      std::memcpy(&v, p + (lo >> 3), 8);
      return uint32_t((v >> (lo & 7)) & ((1ULL << k) - 1));
    }
    v = 0;
    for (int64_t b = pos - 1; b >= lo; --b) {
      uint32_t bit = b >= 0 ? (p[b >> 3] >> (b & 7)) & 1 : 0;
      v = (v << 1) | bit;
    }
    return uint32_t(v);
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    pos -= k;
    return v;
  }
  bool overflowed() const { return pos < 0; }
};

// -------------------------------------------------------------- FSE

struct FseCell {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = -1;  // -1: none yet
  std::vector<FseCell> cells;
};

// The decoding table of normalised counts ``norm`` (-1: "less than one").
void fse_build(FseTable& t, const int16_t* norm, int n_symbols, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.cells.assign(size, FseCell{0, 0, 0});
  std::vector<uint32_t> next(n_symbols);
  uint32_t high = size - 1;
  for (int s = 0; s < n_symbols; ++s) {
    if (norm[s] == -1) {
      t.cells[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < n_symbols; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table: the counts do not fill the table");
  for (uint32_t u = 0; u < size; ++u) {
    FseCell& c = t.cells[u];
    uint32_t x = next[c.symbol]++;
    c.bits = uint8_t(log - highbit(x));
    c.base = uint16_t((x << c.bits) - size);
  }
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.cells.assign(1, FseCell{symbol, 0, 0});
}

// Read an FSE table description; returns the bytes it took.
size_t fse_read(FseTable& t, const uint8_t* p, size_t n, int max_symbol,
                int max_log, const char* what) {
  FwdBits bits(p, n);
  if (n == 0) fail(std::string(what) + ": missing FSE table description");
  int log = int(bits.peek(4)) + 5;
  bits.skip(4);
  if (log > max_log)
    fail(std::string(what) + ": FSE accuracy log " + std::to_string(log) +
         " above " + std::to_string(max_log));
  int16_t norm[256];
  int32_t remaining = (1 << log) + 1;
  int32_t threshold = 1 << log;
  int nbits = log + 1;
  int s = 0;
  while (remaining > 1) {
    if (s > max_symbol)
      fail(std::string(what) + ": FSE table names too many symbols");
    int32_t max = (2 * threshold - 1) - remaining;
    int32_t v;
    uint32_t low = bits.peek(nbits - 1);
    if (int32_t(low) < max) {
      v = int32_t(low);
      bits.skip(nbits - 1);
    } else {
      v = int32_t(bits.peek(nbits));
      if (v >= threshold) v -= max;
      bits.skip(nbits);
    }
    int16_t count = int16_t(v - 1);
    remaining -= count < 0 ? -count : count;
    norm[s++] = count;
    if (count == 0) {
      for (;;) {
        uint32_t rep = bits.peek(2);
        bits.skip(2);
        for (uint32_t i = 0; i < rep; ++i) {
          if (s > max_symbol)
            fail(std::string(what) + ": FSE zero run past the last symbol");
          norm[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(std::string(what) + ": FSE counts overrun");
  if (bits.bytes() > n)
    fail(std::string(what) + ": FSE table description truncated");
  fse_build(t, norm, s, log);
  return bits.bytes();
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(const FseTable& table, BackBits& in) {
    t = &table;
    state = in.read(table.log);
  }
  uint16_t symbol() const { return t->cells[state].symbol; }
  void update(BackBits& in) {
    const FseCell& c = t->cells[state];
    state = c.base + in.read(c.bits);
  }
};

// ------------------------------------------------------------ Huffman

struct HufTable {
  int max_bits = 0;  // 0: none yet
  std::vector<uint8_t> symbol, bits;
};

// Read a Huffman tree description; returns the bytes it took.
size_t huf_read(HufTable& h, const uint8_t* p, size_t n) {
  if (n == 0) fail("literals: missing Huffman tree description");
  uint8_t weights[256];
  int n_weights = 0;
  size_t used;
  uint8_t head = p[0];
  if (head >= 128) {
    n_weights = head - 127;
    used = 1 + (n_weights + 1) / 2;
    if (used > n) fail("literals: Huffman weights truncated");
    for (int i = 0; i < n_weights; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {
    used = 1 + head;
    if (used > n || head == 0) fail("literals: Huffman weights truncated");
    FseTable t;
    size_t k = fse_read(t, p + 1, head, 255, 6, "Huffman weights");
    if (k >= head) fail("literals: Huffman weights hold no stream");
    BackBits in(p + 1 + k, head - k);
    FseState s1, s2;
    s1.init(t, in);
    s2.init(t, in);
    for (;;) {
      if (n_weights > 254) fail("literals: too many Huffman weights");
      weights[n_weights++] = uint8_t(s1.symbol());
      s1.update(in);
      if (in.overflowed()) {
        weights[n_weights++] = uint8_t(s2.symbol());
        break;
      }
      if (n_weights > 254) fail("literals: too many Huffman weights");
      weights[n_weights++] = uint8_t(s2.symbol());
      s2.update(in);
      if (in.overflowed()) {
        if (n_weights > 254) fail("literals: too many Huffman weights");
        weights[n_weights++] = uint8_t(s1.symbol());
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < n_weights; ++i) {
    if (weights[i] > 11) fail("literals: Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("literals: Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("literals: Huffman weights do not sum up");
  if (max_bits > 11) fail("literals: Huffman code longer than 11 bits");
  weights[n_weights++] = uint8_t(highbit(left) + 1);
  h.max_bits = max_bits;
  h.symbol.assign(1u << max_bits, 0);
  h.bits.assign(1u << max_bits, 0);
  uint32_t pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < n_weights; ++s) {
      if (weights[s] != w) continue;
      uint32_t len = 1u << (w - 1);
      for (uint32_t i = 0; i < len; ++i) {
        h.symbol[pos + i] = uint8_t(s);
        h.bits[pos + i] = uint8_t(max_bits + 1 - w);
      }
      pos += len;
    }
  }
  if (pos != (1u << max_bits)) fail("literals: Huffman table incomplete");
  return used;
}

// One Huffman stream's reader: ``next`` peeks the table's width below
// the position and steps back by the code's length.
struct HufIn {
  BackBits in;
  const HufTable& h;
  HufIn(const HufTable& h_, const uint8_t* p, size_t n) : in(p, n), h(h_) {}
  uint8_t next() {
    uint32_t idx = in.peek(h.max_bits);
    in.pos -= h.bits[idx];
    return h.symbol[idx];
  }
  void done() const {
    if (in.pos != 0) fail("literals: Huffman stream not fully consumed");
  }
};

void huf_stream(const HufTable& h, const uint8_t* p, size_t n, uint8_t* out,
                size_t count) {
  HufIn s(h, p, n);
  for (size_t i = 0; i < count; ++i) out[i] = s.next();
  s.done();
}

// Four streams of ``seg``, ``seg``, ``seg`` and ``last`` symbols, decoded
// in step: four independent chains of table lookups.
void huf_streams4(const HufTable& h, const uint8_t* const p[4],
                  const size_t n[4], uint8_t* out, size_t seg, size_t last) {
  HufIn a(h, p[0], n[0]), b(h, p[1], n[1]), c(h, p[2], n[2]),
      d(h, p[3], n[3]);
  uint8_t *oa = out, *ob = out + seg, *oc = out + 2 * seg, *od = out + 3 * seg;
  size_t both = last < seg ? last : seg;
  for (size_t i = 0; i < both; ++i) {
    oa[i] = a.next();
    ob[i] = b.next();
    oc[i] = c.next();
    od[i] = d.next();
  }
  for (size_t i = both; i < seg; ++i) {
    oa[i] = a.next();
    ob[i] = b.next();
    oc[i] = c.next();
  }
  for (size_t i = both; i < last; ++i) od[i] = d.next();
  a.done();
  b.done();
  c.done();
  d.done();
}

// ----------------------------------------------------------- sequences

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ------------------------------------------------------------- output

struct Out {
  uint8_t* p = nullptr;
  size_t n = 0, cap = 0;
  ~Out() { std::free(p); }
  void reserve(size_t want) {  // p is never null after a first call
    if (p && want <= cap) return;
    size_t c = cap ? cap : 1 << 16;
    while (c < want) c *= 2;
    uint8_t* q = static_cast<uint8_t*>(std::realloc(p, c));
    if (!q) fail("out of memory");
    p = q;
    cap = c;
  }
  uint8_t* take() {
    uint8_t* q = p;
    p = nullptr;
    n = cap = 0;
    return q;
  }
};

constexpr size_t kBlockMax = 128 * 1024;

struct Frame {
  Out& out;
  size_t start;           // the frame's first output byte
  uint64_t window;
  uint32_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;
  std::vector<uint8_t> lit;
  size_t block_start = 0;  // the block's first output byte
  Frame(Out& o, uint64_t w) : out(o), start(o.n), window(w) {}

  size_t literals(const uint8_t* p, size_t n);
  void sequences(const uint8_t* p, size_t n);
  void block(const uint8_t* p, size_t n) {
    block_start = out.n;
    size_t k = literals(p, n);
    sequences(p + k, n - k);
  }
};

size_t Frame::literals(const uint8_t* p, size_t n) {
  if (n == 0) fail("compressed block without a literals section");
  int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
  size_t regen, comp = 0, head;
  if (type < 2) {
    if ((fmt & 1) == 0) {
      head = 1;
      regen = p[0] >> 3;
    } else if (fmt == 1) {
      head = 2;
      if (n < 2) fail("literals header truncated");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      head = 3;
      if (n < 3) fail("literals header truncated");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
  } else {
    head = fmt < 2 ? 3 : fmt == 2 ? 4 : 5;
    if (n < head) fail("literals header truncated");
    uint64_t h = 0;
    for (size_t i = 0; i < head; ++i) h |= uint64_t(p[i]) << (8 * i);
    int w = fmt < 2 ? 10 : fmt == 2 ? 14 : 18;
    regen = (h >> 4) & ((1u << w) - 1);
    comp = (h >> (4 + w)) & ((1u << w) - 1);
  }
  if (regen > kBlockMax) fail("literals above the block maximum");
  lit.resize(regen);
  if (type == 0) {
    if (head + regen > n) fail("raw literals truncated");
    std::memcpy(lit.data(), p + head, regen);
    return head + regen;
  }
  if (type == 1) {
    if (head + 1 > n) fail("RLE literals truncated");
    std::memset(lit.data(), p[head], regen);
    return head + 1;
  }
  if (head + comp > n) fail("compressed literals truncated");
  const uint8_t* q = p + head;
  size_t m = comp;
  if (type == 2) {
    size_t k = huf_read(huf, q, m);
    q += k;
    m -= k;
  } else if (huf.max_bits == 0) {
    fail("treeless literals with no earlier Huffman tree in the frame");
  }
  if (fmt == 0) {
    huf_stream(huf, q, m, lit.data(), regen);
  } else {
    if (m < 6) fail("four literal streams without their jump table");
    size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8),
           s3 = q[4] | (q[5] << 8);
    if (6 + s1 + s2 + s3 > m) fail("literal stream sizes overrun");
    size_t s4 = m - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("too few literals for four streams");
    const uint8_t* r = q + 6;
    const uint8_t* ps[4] = {r, r + s1, r + s1 + s2, r + s1 + s2 + s3};
    const size_t ns[4] = {s1, s2, s3, s4};
    huf_streams4(huf, ps, ns, lit.data(), seg, regen - 3 * seg);
  }
  return head + comp;
}

void table_for(FseTable& t, int mode, const uint8_t*& p, const uint8_t* end,
               const int16_t* def, int def_n, int def_log, int max_symbol,
               int max_log, const char* what) {
  switch (mode) {
    case 0:
      fse_build(t, def, def_n, def_log);
      break;
    case 1:
      if (p >= end) fail(std::string(what) + ": RLE symbol missing");
      if (*p > max_symbol) fail(std::string(what) + ": RLE symbol too large");
      fse_rle(t, *p++);
      break;
    case 2:
      p += fse_read(t, p, size_t(end - p), max_symbol, max_log, what);
      break;
    default:
      if (t.log < 0)
        fail(std::string(what) + ": repeat mode with no earlier table");
  }
}

void Frame::sequences(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  size_t nseq = 0;
  if (n == 0) fail("compressed block without a sequences section");
  uint8_t b0 = *p++;
  if (b0 < 128) {
    nseq = b0;
  } else if (b0 < 255) {
    if (p >= end) fail("sequence count truncated");
    nseq = (size_t(b0 - 128) << 8) + *p++;
  } else {
    if (end - p < 2) fail("sequence count truncated");
    nseq = p[0] + (size_t(p[1]) << 8) + 0x7F00;
    p += 2;
  }
  size_t li = 0;  // literals used
  if (nseq > 0) {
    if (p >= end) fail("sequence modes missing");
    uint8_t modes = *p++;
    if (modes & 3) fail("sequence modes: reserved bits set");
    table_for(ll, modes >> 6, p, end, kLLDefault, 36, 6, 35, 9,
              "literal lengths");
    table_for(of, (modes >> 4) & 3, p, end, kOFDefault, 29, 5, 31, 8,
              "offsets");
    table_for(ml, (modes >> 2) & 3, p, end, kMLDefault, 53, 6, 52, 9,
              "match lengths");
    if (p >= end) fail("sequences: no bit stream");
    BackBits in(p, size_t(end - p));
    FseState sll, sof, sml;
    sll.init(ll, in);
    sof.init(of, in);
    sml.init(ml, in);
    for (size_t i = 0; i < nseq; ++i) {
      uint32_t ofc = sof.symbol(), mlc = sml.symbol(), llc = sll.symbol();
      if (ofc > 31) fail("offset code above 31");
      uint32_t ofv = (1u << ofc) + in.read(int(ofc));
      uint32_t mlen = kMLBase[mlc] + in.read(kMLBits[mlc]);
      uint32_t llen = kLLBase[llc] + in.read(kLLBits[llc]);
      uint32_t off;
      if (ofv > 3) {
        off = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        uint32_t idx = ofv - 1 + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          off = rep[0];
        } else {
          off = idx == 3 ? rep[0] - 1 : rep[idx];
          if (off == 0) fail("repeat offset of 0");
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sll.update(in);
        sml.update(in);
        sof.update(in);
      }
      if (in.overflowed()) fail("sequences: bit stream overread");
      if (li + llen > lit.size()) fail("sequence takes more literals than "
                                       "the block holds");
      if (out.n - block_start + llen + mlen > kBlockMax)
        fail("block decodes past the block maximum");
      out.reserve(out.n + llen + mlen);
      std::memcpy(out.p + out.n, lit.data() + li, llen);
      out.n += llen;
      li += llen;
      if (off > out.n - start || off > window)
        fail("match offset " + std::to_string(off) +
             " reaches before the frame's start or past its window");
      uint8_t* dst = out.p + out.n;
      const uint8_t* src = dst - off;
      if (off >= mlen) {
        std::memcpy(dst, src, mlen);
      } else {
        for (uint32_t k = 0; k < mlen; ++k) dst[k] = src[k];
      }
      out.n += mlen;
    }
    if (in.pos != 0) fail("sequences: bit stream not fully consumed");
  } else if (p != end) {
    fail("block without sequences has bytes left");
  }
  size_t rest = lit.size() - li;
  out.reserve(out.n + rest);
  std::memcpy(out.p + out.n, lit.data() + li, rest);
  out.n += rest;
}

// One frame at ``p`` (its magic read); returns the bytes it took.
size_t decode_frame(const uint8_t* p, size_t n, Out& out) {
  size_t pos = 4;
  if (n < 5) fail("frame header truncated");
  uint8_t fhd = p[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      dict_flag = fhd & 3;
  if (fhd & 8) fail("frame header: reserved bit set");
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) fail("frame header truncated");
    uint8_t wd = p[pos++];
    int exp = wd >> 3, mant = wd & 7;
    uint64_t base = 1ULL << (10 + exp);
    window = base + (base / 8) * mant;
  }
  static const int kDictSize[4] = {0, 1, 2, 4};
  static const int kFcsSize[4] = {0, 2, 4, 8};
  int ds = kDictSize[dict_flag];
  int fs = fcs_flag == 0 ? single : kFcsSize[fcs_flag];
  if (pos + ds + fs > n) fail("frame header truncated");
  uint32_t dict = 0;
  for (int i = 0; i < ds; ++i) dict |= uint32_t(p[pos + i]) << (8 * i);
  pos += ds;
  if (dict != 0)
    fail("frame needs dictionary " + std::to_string(dict) +
         "; no dictionary is supported");
  uint64_t fcs = 0;
  bool has_fcs = fs > 0;
  for (int i = 0; i < fs; ++i) fcs |= uint64_t(p[pos + i]) << (8 * i);
  if (fs == 2) fcs += 256;
  pos += fs;
  if (single) window = fcs;
  if (has_fcs && fcs <= (1ULL << 32)) out.reserve(out.n + fcs);
  Frame f(out, window);
  for (;;) {
    if (pos + 3 > n) fail("block header truncated");
    uint32_t bh = p[pos] | (p[pos + 1] << 8) | (p[pos + 2] << 16);
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (size > kBlockMax) fail("block above its maximum size");
    if (type == 0) {
      if (pos + size > n) fail("raw block truncated");
      out.reserve(out.n + size);
      std::memcpy(out.p + out.n, p + pos, size);
      out.n += size;
      pos += size;
    } else if (type == 1) {
      if (pos + 1 > n) fail("RLE block truncated");
      out.reserve(out.n + size);
      std::memset(out.p + out.n, p[pos], size);
      out.n += size;
      pos += 1;
    } else {
      if (pos + size > n) fail("compressed block truncated");
      size_t before = out.n;
      f.block(p + pos, size);
      if (out.n - before > kBlockMax)
        fail("block decodes past the block maximum");
      pos += size;
    }
    if (last) break;
  }
  size_t got = out.n - f.start;
  if (has_fcs && got != fcs)
    fail("frame content size " + std::to_string(fcs) + " but " +
         std::to_string(got) + " bytes decoded");
  if (checksum) {
    if (pos + 4 > n) fail("content checksum truncated");
    uint32_t want = rd32(p + pos);
    uint32_t have = uint32_t(xxh64(out.p + f.start, got, 0));
    if (want != have) fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decompress(const uint8_t* p, size_t n, Out& out) {
  size_t pos = 0;
  if (n == 0) fail("no frame");
  while (pos < n) {
    if (n - pos < 4) fail("trailing bytes after the last frame");
    uint32_t magic = rd32(p + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("skippable frame truncated");
      uint32_t size = rd32(p + pos + 4);
      if (size > n - pos - 8) fail("skippable frame truncated");
      pos += 8 + size;
    } else if (magic == 0xFD2FB528u) {
      pos += decode_frame(p + pos, n - pos, out);
    } else {
      char buf[64];
      std::snprintf(buf, sizeof buf, "bad frame magic 0x%08x at byte %zu",
                    magic, pos);
      fail(buf);
    }
  }
}

}  // namespace

extern "C" {

int zstd_decompress(const uint8_t* src, size_t n, uint8_t** out,
                    size_t* out_n, char* err, size_t err_n) {
  Out o;
  try {
    decompress(src, n, o);
  } catch (const std::exception& e) {
    if (err_n) {
      std::strncpy(err, e.what(), err_n - 1);
      err[err_n - 1] = 0;
    }
    return -1;
  }
  *out_n = o.n;
  *out = o.n ? o.take() : static_cast<uint8_t*>(std::malloc(1));
  return 0;
}

void zstd_free(uint8_t* p) { std::free(p); }

uint64_t zstd_xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  return xxh64(p, n, seed);
}

}  // extern "C"
