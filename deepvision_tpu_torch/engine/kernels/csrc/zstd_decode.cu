// Zstandard decoder (RFC 8878), host code for the card path's checkpoint
// loads.
//
// Orbax keeps a checkpoint's OCDBT nodes and zarr chunks as zstd frames;
// the card's machine has no zstd library, and the plain Python decoder
// (engine/zstd.py) runs at a few MB/s.  This file is the compiled decoder a
// CUDA load uses: host-only C++ (no device code, no CUDA header), built into
// the kernel library with the other csrc/ sources and bound with ctypes.  It
// follows the RFC and engine/zstd.py section by section and gives the same
// bytes; it is not a TPU kernel and has no device counterpart.
//
// Scope, as engine/zstd.py: zstd and skippable frames, concatenated; raw,
// RLE and compressed blocks; raw, RLE, Huffman (direct or FSE-compressed
// weights) and treeless literals in 1 or 4 streams; predefined, RLE, FSE and
// repeat sequence tables; repeat offsets; the XXH64 content checksum,
// verified.  Frames that name a dictionary are refused.
//
// C interface:
//   long long dv_zstd_decompress(src, n, dst, cap)
// decodes every frame of src[0, n) into dst[0, cap) and returns the bytes
// written, or a negative DvZstdError.

#include <stdint.h>
#include <string.h>

#include <initializer_list>

namespace {

enum DvZstdError {
  DV_ZSTD_CORRUPT = -1,    // not a stream this decoder accepts
  DV_ZSTD_DST_SMALL = -2,  // the output does not fit in cap
  DV_ZSTD_CHECKSUM = -3,   // content checksum mismatch
  DV_ZSTD_DICTIONARY = -4, // the frame names a dictionary
  DV_ZSTD_TRUNCATED = -5,  // the input ends inside a frame
};

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }
inline void need(bool ok, int code = DV_ZSTD_CORRUPT) {
  if (!ok) fail(code);
}

constexpr int64_t kMaxBlock = 128 * 1024;

inline uint64_t load_le(const uint8_t* p, int64_t avail) {
  uint64_t v = 0;
  if (avail >= 8) {
    memcpy(&v, p, 8);
    return v;
  }
  for (int64_t i = 0; i < avail; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }

// ---- bit readers ---------------------------------------------------------

// Little-endian, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  int64_t n;
  int64_t bit = 0;
  uint32_t peek(int k) const {
    int64_t i = bit >> 3;
    if (i >= n) return 0;
    uint64_t w = load_le(p + i, n - i) >> (bit & 7);
    return uint32_t(w & ((1ull << k) - 1));
  }
  void skip(int k) {
    bit += k;
    need(((bit + 7) >> 3) <= n);
  }
  int64_t nbytes() const { return (bit + 7) >> 3; }
};

// zstd's backward streams: reading starts under the highest set bit of
// the last byte and takes bits from the top down; bits before the start
// read as zeros and pos goes negative.
struct BackBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;
  BackBits(const uint8_t* start, int64_t len) : p(start), n(len) {
    need(len > 0 && start[len - 1] != 0);
    pos = (len - 1) * 8 + highbit(start[len - 1]);
  }
  // the k bits just under pos, the highest first (k <= 56)
  uint64_t peek(int k) const {
    if (k == 0) return 0;
    int64_t low = pos - k;
    if (low >= 0) {
      int64_t i = low >> 3;
      return (load_le(p + i, n - i) >> (low & 7)) & ((1ull << k) - 1);
    }
    if (pos <= 0) return 0;
    return (load_le(p, n) & ((1ull << pos) - 1)) << (-low);
  }
  uint64_t read(int k) {
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
};

// ---- FSE (RFC 8878 4.1) --------------------------------------------------

struct FseCell {
  uint8_t sym;
  uint8_t nb;
  uint16_t base;
};

struct FseTable {
  int log = -1;  // -1: no table yet
  FseCell cell[512];
};

// Read an FSE table description from p[0, n); returns the bytes used.
int64_t read_fse_counts(const uint8_t* p, int64_t n, int max_symbol,
                        int max_log, int16_t* probs, int* nsym, int* log) {
  ForwardBits bits{p, n};
  int lg = int(bits.peek(4)) + 5;
  bits.skip(4);
  need(lg <= max_log);
  int remaining = (1 << lg) + 1;
  int threshold = 1 << lg;
  int nbits = lg + 1;
  int s = 0;
  while (remaining > 1) {
    need(s <= max_symbol);
    int top = (2 * threshold - 1) - remaining;
    int low = int(bits.peek(nbits - 1));
    int count;
    if (low < top) {
      count = low;
      bits.skip(nbits - 1);
    } else {
      count = int(bits.peek(nbits));
      if (count >= threshold) count -= top;
      bits.skip(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    probs[s++] = int16_t(count);
    if (count == 0) {
      for (;;) {
        int flag = int(bits.peek(2));
        bits.skip(2);
        for (int r = 0; r < flag; ++r) {
          need(s <= max_symbol);
          probs[s++] = 0;
        }
        if (flag != 3) break;
      }
    }
    while (remaining < threshold) {
      nbits -= 1;
      threshold >>= 1;
    }
  }
  need(remaining == 1);
  *nsym = s;
  *log = lg;
  return bits.nbytes();
}

void build_fse(const int16_t* probs, int nsym, int log, FseTable* t) {
  int size = 1 << log;
  int high = size - 1;
  uint8_t symbols[512];
  for (int s = 0; s < nsym; ++s)
    if (probs[s] == -1) symbols[high--] = uint8_t(s);
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < probs[s]; ++i) {
      symbols[pos] = uint8_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  need(pos == 0);
  int next[256];
  for (int s = 0; s < nsym; ++s) next[s] = probs[s] == -1 ? 1 : probs[s];
  for (int state = 0; state < size; ++state) {
    int s = symbols[state];
    int x = next[s]++;
    int nb = log - highbit(uint32_t(x));
    t->cell[state].sym = uint8_t(s);
    t->cell[state].nb = uint8_t(nb);
    t->cell[state].base = uint16_t((x << nb) - size);
  }
  t->log = log;
}

void rle_table(uint8_t sym, FseTable* t) {
  t->cell[0] = FseCell{sym, 0, 0};
  t->log = 0;
}

// ---- sequence code tables (RFC 8878 3.1.1.3.2) ---------------------------

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
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,
    12, 13, 14, 15, 16, 18, 20, 22, 24, 28,  32,  40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Predefined {
  FseTable ll, ml, of;
  Predefined() {
    build_fse(kLLDefault, 36, 6, &ll);
    build_fse(kMLDefault, 53, 6, &ml);
    build_fse(kOFDefault, 29, 5, &of);
  }
};

const Predefined& predefined() {
  static const Predefined p;
  return p;
}

// ---- Huffman literals (RFC 8878 4.2) -------------------------------------

struct Huffman {
  int max_bits = 0;  // 0: no table yet
  uint8_t sym[1 << 11];
  uint8_t nb[1 << 11];
};

// Read a tree description at p[0, n); returns the bytes used.
int64_t read_huffman(const uint8_t* p, int64_t n, Huffman* h) {
  need(n >= 1);
  int header = p[0];
  uint8_t weights[256];
  int nw = 0;
  int64_t used;
  if (header >= 128) {
    nw = header - 127;
    int64_t nbytes = (nw + 1) / 2;
    need(1 + nbytes <= n);
    for (int i = 0; i < nw; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + nbytes;
  } else {
    need(1 + header <= n);
    int16_t probs[256];
    int nsym, log;
    int64_t desc = read_fse_counts(p + 1, header, 255, 6, probs, &nsym, &log);
    FseTable t;
    build_fse(probs, nsym, log, &t);
    BackBits bits(p + 1 + desc, header - desc);
    int s1 = int(bits.read(log)), s2 = int(bits.read(log));
    for (;;) {
      need(nw <= 253);
      weights[nw++] = t.cell[s1].sym;
      s1 = t.cell[s1].base + int(bits.read(t.cell[s1].nb));
      if (bits.pos < 0) {
        weights[nw++] = t.cell[s2].sym;
        break;
      }
      weights[nw++] = t.cell[s2].sym;
      s2 = t.cell[s2].base + int(bits.read(t.cell[s2].nb));
      if (bits.pos < 0) {
        weights[nw++] = t.cell[s1].sym;
        break;
      }
    }
    used = 1 + header;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    need(weights[i] <= 11);
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  need(total > 0);
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  need((rest & (rest - 1)) == 0 && max_bits <= 11 && nw < 256);
  weights[nw++] = uint8_t(highbit(rest) + 1);
  int pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    int span = 1 << (w - 1);
    for (int s = 0; s < nw; ++s) {
      if (weights[s] != w) continue;
      memset(h->sym + pos, s, span);
      memset(h->nb + pos, max_bits + 1 - w, span);
      pos += span;
    }
  }
  h->max_bits = max_bits;
  return used;
}

void huffman_stream(const uint8_t* p, int64_t n, int64_t count,
                    const Huffman& h, uint8_t* out) {
  BackBits bits(p, n);
  const int mb = h.max_bits;
  for (int64_t i = 0; i < count; ++i) {
    int idx = int(bits.peek(mb));
    out[i] = h.sym[idx];
    bits.pos -= h.nb[idx];
    need(bits.pos >= 0);
  }
  need(bits.pos == 0);
}

// ---- frames --------------------------------------------------------------

struct FrameState {
  Huffman huf;
  FseTable ll, of, ml;
  uint64_t reps[3] = {1, 4, 8};
};

struct Out {
  uint8_t* dst;
  int64_t cap;
  int64_t n = 0;
  void put(const uint8_t* src, int64_t k) {
    need(n + k <= cap, DV_ZSTD_DST_SMALL);
    memcpy(dst + n, src, size_t(k));
    n += k;
  }
  void fill(uint8_t b, int64_t k) {
    need(n + k <= cap, DV_ZSTD_DST_SMALL);
    memset(dst + n, b, size_t(k));
    n += k;
  }
};

// Decode the literals section at p[0, n) into lits; returns bytes used.
int64_t literals(const uint8_t* p, int64_t n, FrameState* st, uint8_t* lits,
                 int64_t* nlits) {
  need(n >= 1);
  int b0 = p[0];
  int kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind < 2) {
    int64_t size, pos;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      pos = 1;
    } else if (fmt == 1) {
      need(n >= 2);
      size = (b0 >> 4) | (int64_t(p[1]) << 4);
      pos = 2;
    } else {
      need(n >= 3);
      size = (b0 >> 4) | (int64_t(p[1]) << 4) | (int64_t(p[2]) << 12);
      pos = 3;
    }
    need(size <= kMaxBlock);
    *nlits = size;
    if (kind == 0) {
      need(pos + size <= n);
      memcpy(lits, p + pos, size_t(size));
      return pos + size;
    }
    need(pos < n);
    memset(lits, p[pos], size_t(size));
    return pos + 1;
  }
  const int nhead = fmt == 0 || fmt == 1 ? 3 : fmt == 2 ? 4 : 5;
  const int width = fmt == 0 || fmt == 1 ? 10 : fmt == 2 ? 14 : 18;
  need(n >= nhead);
  uint64_t word = 0;
  for (int i = 0; i < nhead; ++i) word |= uint64_t(p[i]) << (8 * i);
  int64_t size = int64_t((word >> 4) & ((1ull << width) - 1));
  int64_t csize = int64_t((word >> (4 + width)) & ((1ull << width) - 1));
  int64_t stop = nhead + csize;
  need(stop <= n && size <= kMaxBlock);
  int64_t pos = nhead;
  if (kind == 2) {
    pos += read_huffman(p + pos, stop - pos, &st->huf);
  } else {
    need(st->huf.max_bits > 0);
  }
  *nlits = size;
  if (fmt == 0) {
    huffman_stream(p + pos, stop - pos, size, st->huf, lits);
    return stop;
  }
  need(pos + 6 <= stop);
  int64_t s1 = p[pos] | (p[pos + 1] << 8);
  int64_t s2 = p[pos + 2] | (p[pos + 3] << 8);
  int64_t s3 = p[pos + 4] | (p[pos + 5] << 8);
  int64_t b[5] = {pos + 6, 0, 0, 0, stop};
  b[1] = b[0] + s1;
  b[2] = b[1] + s2;
  b[3] = b[2] + s3;
  need(b[3] <= stop);
  int64_t each = (size + 3) / 4;
  need(size - 3 * each >= 0);
  for (int i = 0; i < 4; ++i) {
    int64_t cnt = i < 3 ? each : size - 3 * each;
    huffman_stream(p + b[i], b[i + 1] - b[i], cnt, st->huf, lits + i * each);
  }
  return stop;
}

int64_t seq_table(int mode, const uint8_t* p, int64_t n, int max_symbol,
                  int max_log, const FseTable& pre, FseTable* t) {
  if (mode == 0) {
    *t = pre;
    return 0;
  }
  if (mode == 1) {
    need(n >= 1 && p[0] <= max_symbol);
    rle_table(p[0], t);
    return 1;
  }
  if (mode == 2) {
    int16_t probs[64];
    int nsym, log;
    int64_t used =
        read_fse_counts(p, n, max_symbol, max_log, probs, &nsym, &log);
    build_fse(probs, nsym, log, t);
    return used;
  }
  need(t->log >= 0);
  return 0;
}

void block(const uint8_t* p, int64_t n, FrameState* st, Out* out,
           int64_t frame_start, uint8_t* lits) {
  int64_t nlits;
  int64_t pos = literals(p, n, st, lits, &nlits);
  need(pos < n);
  int b0 = p[pos];
  int64_t nseq;
  if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    need(pos + 2 <= n);
    nseq = ((b0 - 128) << 8) + p[pos + 1];
    pos += 2;
  } else {
    need(pos + 3 <= n);
    nseq = p[pos + 1] + (p[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  if (nseq == 0) {
    need(pos == n);
    out->put(lits, nlits);
    return;
  }
  need(pos < n);
  int modes = p[pos++];
  need((modes & 3) == 0);
  const Predefined& pre = predefined();
  pos += seq_table(modes >> 6, p + pos, n - pos, 35, 9, pre.ll, &st->ll);
  pos += seq_table((modes >> 4) & 3, p + pos, n - pos, 31, 8, pre.of, &st->of);
  pos += seq_table((modes >> 2) & 3, p + pos, n - pos, 52, 9, pre.ml, &st->ml);
  need(pos <= n);
  BackBits bits(p + pos, n - pos);
  const FseCell* ll = st->ll.cell;
  const FseCell* of = st->of.cell;
  const FseCell* ml = st->ml.cell;
  int ls = int(bits.read(st->ll.log));
  int os = int(bits.read(st->of.log));
  int ms = int(bits.read(st->ml.log));
  uint64_t* reps = st->reps;
  int64_t lit_pos = 0;
  for (int64_t i = 0; i < nseq; ++i) {
    int of_code = of[os].sym, ml_code = ml[ms].sym, ll_code = ll[ls].sym;
    need(of_code <= 31);
    uint64_t offset_value = (1ull << of_code) + bits.read(of_code);
    int64_t mlen = kMLBase[ml_code] + int64_t(bits.read(kMLBits[ml_code]));
    int64_t llen = kLLBase[ll_code] + int64_t(bits.read(kLLBits[ll_code]));
    uint64_t offset;
    if (offset_value > 3) {
      offset = offset_value - 3;
      reps[2] = reps[1];
      reps[1] = reps[0];
      reps[0] = offset;
    } else {
      int idx = int(offset_value) - (llen ? 1 : 0);
      if (idx == 0) {
        offset = reps[0];
      } else {
        offset = idx == 3 ? reps[0] - 1 : reps[idx];
        if (idx > 1) reps[2] = reps[1];
        reps[1] = reps[0];
        reps[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      ls = ll[ls].base + int(bits.read(ll[ls].nb));
      ms = ml[ms].base + int(bits.read(ml[ms].nb));
      os = of[os].base + int(bits.read(of[os].nb));
    }
    need(lit_pos + llen <= nlits);
    out->put(lits + lit_pos, llen);
    lit_pos += llen;
    need(offset > 0 && int64_t(offset) <= out->n - frame_start);
    need(out->n + mlen <= out->cap, DV_ZSTD_DST_SMALL);
    uint8_t* d = out->dst + out->n;
    const uint8_t* s = d - offset;
    if (int64_t(offset) >= mlen) {
      memcpy(d, s, size_t(mlen));
    } else {
      for (int64_t k = 0; k < mlen; ++k) d[k] = s[k];
    }
    out->n += mlen;
  }
  need(bits.pos == 0);
  out->put(lits + lit_pos, nlits - lit_pos);
}

// ---- XXH64 ---------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

uint64_t xxh64(const uint8_t* p, int64_t n) {
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
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t w;
    memcpy(&w, p, 4);
    h = rotl(h ^ (uint64_t(w) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// Decode the frame whose header starts at src[pos] (after its magic);
// returns the position after it.
int64_t frame(const uint8_t* src, int64_t n, int64_t pos, Out* out,
              FrameState* st, uint8_t* lits) {
  need(pos < n, DV_ZSTD_TRUNCATED);
  int fhd = src[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  need((fhd & 8) == 0);
  need((fhd & 3) == 0, DV_ZSTD_DICTIONARY);
  int64_t window = -1;
  if (!single) {
    need(pos < n, DV_ZSTD_TRUNCATED);
    int wd = src[pos++];
    int64_t base = int64_t(1) << (10 + (wd >> 3));
    window = base + (base >> 3) * (wd & 7);
  }
  const int fcs_size =
      fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  need(pos + fcs_size <= n, DV_ZSTD_TRUNCATED);
  int64_t content = -1;
  if (fcs_size) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_size; ++i) v |= uint64_t(src[pos + i]) << (8 * i);
    if (fcs_size == 2) v += 256;
    content = int64_t(v);
    pos += fcs_size;
  }
  const int64_t block_max =
      window < 0 || window > kMaxBlock ? kMaxBlock : window;
  *st = FrameState();
  const int64_t start = out->n;
  for (;;) {
    need(pos + 3 <= n, DV_ZSTD_TRUNCATED);
    uint32_t head = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
    pos += 3;
    int last = head & 1, type = (head >> 1) & 3;
    int64_t size = head >> 3;
    if (type == 1) {
      need(pos < n, DV_ZSTD_TRUNCATED);
      need(size <= block_max);
      out->fill(src[pos], size);
      pos += 1;
    } else {
      need(type != 3);
      need(pos + size <= n, DV_ZSTD_TRUNCATED);
      need(size <= block_max);
      if (type == 0) {
        out->put(src + pos, size);
      } else {
        int64_t before = out->n;
        block(src + pos, size, st, out, start, lits);
        need(out->n - before <= block_max);
      }
      pos += size;
    }
    if (last) break;
  }
  need(content < 0 || out->n - start == content);
  if (fhd & 4) {
    need(pos + 4 <= n, DV_ZSTD_TRUNCATED);
    uint32_t want = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16) |
                    (uint32_t(src[pos + 3]) << 24);
    need(uint32_t(xxh64(out->dst + start, out->n - start)) == want,
         DV_ZSTD_CHECKSUM);
    pos += 4;
  }
  return pos;
}

}  // namespace

extern "C" long long dv_zstd_decompress(const void* src_, long long n,
                                        void* dst, long long cap) {
  const uint8_t* src = static_cast<const uint8_t*>(src_);
  Out out{static_cast<uint8_t*>(dst), cap};
  // frame state and the literals buffer (one block's worth) live on the
  // heap: ~140 KB is too much for some callers' stacks
  FrameState* st = new FrameState;
  uint8_t* lits = new uint8_t[kMaxBlock];
  long long rc;
  try {
    need(n > 0);
    int64_t pos = 0;
    while (pos < n) {
      need(pos + 4 <= n, DV_ZSTD_TRUNCATED);
      uint32_t magic = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16) |
                       (uint32_t(src[pos + 3]) << 24);
      if (magic >= 0x184D2A50u && magic <= 0x184D2A5Fu) {
        need(pos + 8 <= n, DV_ZSTD_TRUNCATED);
        uint32_t size = src[pos + 4] | (src[pos + 5] << 8) |
                        (src[pos + 6] << 16) | (uint32_t(src[pos + 7]) << 24);
        pos += 8 + int64_t(size);
        need(pos <= n, DV_ZSTD_TRUNCATED);
        continue;
      }
      need(magic == 0xFD2FB528u);
      pos = frame(src, n, pos + 4, &out, st, lits);
    }
    rc = out.n;
  } catch (const Fail& f) {
    rc = f.code;
  }
  delete st;
  delete[] lits;
  return rc;
}
