// osmosis_tpu_torch native host ops: image resampling, normalization,
// colormapping and PNG encoding for the host side of a run.
//
// The port's copy of the JAX package's host library, the same arithmetic
// and the same bytes: fused bilinear resize + center-crop + [-1,1]
// normalization for ingest, percentile min-max normalization and a 256-entry
// colormap lookup for depth post-processing, and a zlib-backed PNG writer
// for the outputs. A plain C ABI for ctypes; osmosis_tpu_torch/utils/native.py
// builds it at first use (g++ -O3 -march=native -fopenmp, links zlib) and
// the Python layer keeps a numpy path for machines that cannot build it.
// Also, for orbax checkpoints, a Zstandard decoder (RFC 8878), the twin of
// osmosis_tpu_torch/utils/zstd.py, and CRC-32C, the twin of
// osmosis_tpu_torch/utils/ocdbt.py's crc32c_py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Fused ingest: u8 RGB [h, w, 3] -> f32 [size, size, 3] in [-1, 1].
// Scales so the SMALL side == size (bilinear, half-pixel centers -- the
// torchvision Resize convention), then center-crops size x size, then
// normalizes (x/255 - 0.5) / 0.5.
// ---------------------------------------------------------------------------
void preprocess_rgb_u8(const uint8_t* src, int h, int w, int size, float* dst) {
  // torchvision 0.14.1 (the reference's pin) _compute_resized_output_size:
  // the long side TRUNCATES (int(size * long / short)); center_crop offsets
  // use round-half-even (Python round) — std::nearbyint under the default
  // FE_TONEAREST mode.
  int new_w, new_h;
  if (w <= h) {
    new_w = size;
    new_h = (int)((double)size * h / w);
  } else {
    new_h = size;
    new_w = (int)((double)size * w / h);
  }
  const double sx = (double)w / new_w;
  const double sy = (double)h / new_h;
  const int left = (int)std::nearbyint((new_w - size) / 2.0);
  const int top = (int)std::nearbyint((new_h - size) / 2.0);

#pragma omp parallel for schedule(static)
  for (int oy = 0; oy < size; ++oy) {
    const double fy = (oy + top + 0.5) * sy - 0.5;
    int y0 = (int)std::floor(fy);
    double wy = fy - y0;
    int y1 = std::min(y0 + 1, h - 1);
    y0 = std::max(y0, 0);
    for (int ox = 0; ox < size; ++ox) {
      const double fx = (ox + left + 0.5) * sx - 0.5;
      int x0 = (int)std::floor(fx);
      double wx = fx - x0;
      int x1 = std::min(x0 + 1, w - 1);
      x0 = std::max(x0, 0);
      const uint8_t* p00 = src + (y0 * w + x0) * 3;
      const uint8_t* p01 = src + (y0 * w + x1) * 3;
      const uint8_t* p10 = src + (y1 * w + x0) * 3;
      const uint8_t* p11 = src + (y1 * w + x1) * 3;
      float* out = dst + (oy * size + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        const double v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                         wy * ((1 - wx) * p10[c] + wx * p11[c]);
        out[c] = (float)(v / 255.0 * 2.0 - 1.0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Percentile min-max normalization (utils.py:79-114 semantics):
// clip to [quantile(p_low), quantile(p_high)] (linear-interpolated
// quantiles, numpy convention), then rescale to [vmin, vmax].
// ---------------------------------------------------------------------------
static double quantile_sorted(const std::vector<float>& sorted, double q) {
  const size_t n = sorted.size();
  if (n == 1) return sorted[0];
  const double pos = q * (n - 1);
  const size_t lo = (size_t)pos;
  const double frac = pos - lo;
  if (lo + 1 >= n) return sorted[n - 1];
  return sorted[lo] * (1.0 - frac) + sorted[lo + 1] * frac;
}

void percentile_minmax_norm(const float* src, int n, float p_low, float p_high,
                            float vmin, float vmax, float* dst) {
  std::vector<float> sorted(src, src + n);
  // NaN-safe: treat NaN as 0 so std::sort stays well-ordered and the
  // output remains finite (matches "degenerate input -> zeros" behavior)
  for (auto& v : sorted)
    if (!(v == v)) v = 0.f;
  std::sort(sorted.begin(), sorted.end());
  const float lo = (float)quantile_sorted(sorted, p_low);
  const float hi = (float)quantile_sorted(sorted, p_high);
  float cmin = hi, cmax = lo;
  // after clipping, min == lo and max == hi unless degenerate
  if (lo == hi) {
    std::memset(dst, 0, sizeof(float) * n);
    return;
  }
  cmin = lo;
  cmax = hi;
  const float scale = (vmax - vmin) / (cmax - cmin);
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    float v = src[i];
    if (!(v >= lo)) v = lo;       // NaN-safe lower clamp
    else if (v > hi) v = hi;
    dst[i] = (v - cmin) * scale + vmin;
  }
}

// ---------------------------------------------------------------------------
// Colormap application: gray [n] in [0,1] -> rgb f32 [n,3] via a 256-entry
// LUT (linear interpolation between entries, matplotlib-style lookup).
// ---------------------------------------------------------------------------
void apply_colormap_lut(const float* gray, int n, const float* lut256,
                        float* rgb) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    float g = gray[i];
    // NaN-safe clamp: !(g >= 0) catches NaN as well as negatives —
    // (int)(NaN * 256) is UB and indexes out of bounds otherwise
    if (!(g >= 0.f)) g = 0.f;
    else if (g > 1.f) g = 1.f;
    const int idx = std::min((int)(g * 256.0f), 255);
    rgb[i * 3 + 0] = lut256[idx * 3 + 0];
    rgb[i * 3 + 1] = lut256[idx * 3 + 1];
    rgb[i * 3 + 2] = lut256[idx * 3 + 2];
  }
}

// ---------------------------------------------------------------------------
// PNG writer: 8-bit RGB, zlib-compressed, filter 0 rows.
// Returns 0 on success.
// ---------------------------------------------------------------------------
static void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

static void put_chunk(std::vector<uint8_t>& out, const char type[4],
                      const uint8_t* data, uint32_t len) {
  put_be32(out, len);
  const size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out.data() + start, 4 + len);
  put_be32(out, crc);
}

int png_write_rgb8(const char* path, const uint8_t* rgb, int h, int w) {
  // filter byte 0 per row
  std::vector<uint8_t> raw((size_t)h * (w * 3 + 1));
  for (int y = 0; y < h; ++y) {
    raw[(size_t)y * (w * 3 + 1)] = 0;
    std::memcpy(&raw[(size_t)y * (w * 3 + 1) + 1], rgb + (size_t)y * w * 3,
                (size_t)w * 3);
  }
  uLongf comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
    return 1;
  comp.resize(comp_cap);

  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", comp.data(), (uint32_t)comp.size());
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  const size_t n = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return n == out.size() ? 0 : 3;
}

// ---------------------------------------------------------------------------
// Zstandard decoder (RFC 8878): raw, RLE and compressed blocks, Huffman and
// treeless literals, FSE / RLE / predefined / repeated sequence tables,
// repeat offsets, skippable frames, the XXH64 content checksum. No
// dictionaries. Every read is bounds-checked; a corrupt frame throws
// ZstdError inside, and the C entry point returns a negative code.
// ---------------------------------------------------------------------------
namespace zstd {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct TooSmall : std::runtime_error {
  TooSmall() : std::runtime_error("output buffer too small") {}
};

static inline void need(bool ok, const char* what) {
  if (!ok) throw Error(what);
}

static const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                      P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                      P5 = 2870177450012600261ULL;
static inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
static inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
static inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

static uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = (uint64_t)0 - P1;
    while (p + 32 <= end) {
      v1 = xround(v1, rd64(p)); v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16)); v4 = xround(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) { h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4; p += 8; }
  if (p + 4 <= end) { h = rotl(h ^ ((uint64_t)rd32(p) * P1), 23) * P2 + P3; p += 4; }
  while (p < end) { h = rotl(h ^ (*p * P5), 11) * P1; ++p; }
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// The reverse bitstream: read from the end, after the padding marker;
// bits before the start read as 0 and set `pos` negative.
struct Backward {
  const uint8_t* base;
  int64_t pos;  // bits left
  Backward(const uint8_t* start, size_t len) : base(start) {
    need(len > 0 && start[len - 1] != 0, "bitstream without its end marker");
    int top = 31 - __builtin_clz((unsigned)start[len - 1]);
    pos = (int64_t)len * 8 - 8 + top;
    len_ = len;
  }
  size_t len_;
  inline uint64_t window(int64_t bit) const {  // 64 bits from `bit` (>= 0)
    size_t b = (size_t)(bit >> 3);
    uint64_t v = 0;
    size_t take = std::min<size_t>(8, len_ - b);
    std::memcpy(&v, base + b, take);
    return v >> (bit & 7);
  }
  inline uint32_t read(int n) {
    if (n == 0) return 0;
    int64_t old = pos;
    pos -= n;
    if (pos >= 0) return (uint32_t)(window(pos) & ((1ULL << n) - 1));
    if (old <= 0) return 0;
    uint64_t low = window(0) & ((1ULL << old) - 1);
    return (uint32_t)((low << (-pos)) & ((1ULL << n) - 1));
  }
};

struct FseEntry { uint8_t symbol, nb; uint16_t base; };
struct Fse { std::vector<FseEntry> t; int log = 0; bool set = false; };

static size_t read_ncount(const uint8_t* p, size_t len, int max_symbol, int max_log,
                          std::vector<int>& counts, int& log_out) {
  need(len > 0, "truncated FSE table description");
  int64_t avail = (int64_t)len * 8, pos = 0;
  auto peek = [&](int n) -> uint32_t {
    uint64_t v = 0;
    size_t b = (size_t)(pos >> 3);
    if (b < len) std::memcpy(&v, p + b, std::min<size_t>(8, len - b));
    return (uint32_t)((v >> (pos & 7)) & ((1ULL << n) - 1));
  };
  auto bits = [&](int n) -> uint32_t {
    need(pos + n <= avail, "truncated FSE table description");
    uint32_t v = peek(n);
    pos += n;
    return v;
  };
  int log = (int)bits(4) + 5;
  need(log <= max_log, "FSE accuracy log too large");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  counts.clear();
  while (remaining > 1) {
    need((int)counts.size() <= max_symbol, "FSE table description has too many symbols");
    int low = (int)peek(nbits - 1) & (threshold - 1);
    int top = 2 * threshold - 1 - remaining;
    int count;
    if (low < top) {
      count = low;
      bits(nbits - 1);
    } else {
      count = (int)bits(nbits) & (2 * threshold - 1);
      if (count >= threshold) count -= top;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    need(remaining >= 1, "FSE counts over the table size");
    counts.push_back(count);
    if (count == 0) {
      for (;;) {
        int rep = (int)bits(2);
        for (int k = 0; k < rep; ++k) counts.push_back(0);
        if (rep != 3) break;
      }
      need((int)counts.size() <= max_symbol + 1, "FSE table description has too many symbols");
    }
    while (remaining < threshold) { --nbits; threshold >>= 1; }
  }
  need(remaining == 1, "FSE counts do not sum to the table size");
  log_out = log;
  return (size_t)((pos + 7) / 8);
}

static void build_fse(const std::vector<int>& counts, int log, Fse& out) {
  const int size = 1 << log;
  std::vector<uint8_t> symbol(size, 0);
  std::vector<int> next(counts.size(), 0);
  int high = size - 1;
  for (size_t s = 0; s < counts.size(); ++s) {
    if (counts[s] == -1) {
      need(high >= 0, "corrupt FSE table");
      symbol[high--] = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = counts[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < counts.size(); ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      symbol[pos] = (uint8_t)s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  need(pos == 0, "corrupt FSE table");
  out.t.assign(size, FseEntry{0, 0, 0});
  for (int u = 0; u < size; ++u) {
    int s = symbol[u];
    int ns = next[s]++;
    need(ns > 0, "corrupt FSE table");
    int nb = log - (31 - __builtin_clz((unsigned)ns));
    out.t[u] = FseEntry{(uint8_t)s, (uint8_t)nb, (uint16_t)((ns << nb) - size)};
  }
  out.log = log;
  out.set = true;
}

static const int LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                   2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
static const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,  11,
                                     12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32,  40,
                                     48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                                     32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                                     17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                                     31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                     99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
                                     65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Huf { std::vector<uint16_t> t; int max_bits = 0; bool set = false; };  // symbol | nb << 8

struct State {
  Huf huf;
  Fse ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
};

static void predefined(Fse& f, const int* counts, int n, int log) {
  build_fse(std::vector<int>(counts, counts + n), log, f);
}

static size_t huffman_weights(const uint8_t* p, size_t len, std::vector<int>& w) {
  need(len > 0, "truncated Huffman tree description");
  int head = p[0];
  w.clear();
  if (head >= 128) {
    int n = head - 127;
    size_t size = (size_t)(n + 1) / 2;
    need(1 + size <= len, "truncated Huffman weights");
    for (int k = 0; k < n; ++k) {
      int byte = p[1 + k / 2];
      w.push_back(k % 2 == 0 ? byte >> 4 : byte & 15);
    }
    return 1 + size;
  }
  need((size_t)1 + head <= len, "truncated Huffman weights");
  std::vector<int> counts;
  int log;
  size_t used = read_ncount(p + 1, head, 255, 6, counts, log);
  Fse table;
  build_fse(counts, log, table);
  need(used < (size_t)head, "truncated Huffman weights");
  Backward br(p + 1 + used, head - used);
  uint32_t s1 = br.read(log), s2 = br.read(log);
  for (;;) {
    need(w.size() <= 255, "too many Huffman weights");
    const FseEntry& e1 = table.t[s1];
    w.push_back(e1.symbol);
    s1 = e1.base + br.read(e1.nb);
    if (br.pos < 0) { w.push_back(table.t[s2].symbol); break; }
    const FseEntry& e2 = table.t[s2];
    w.push_back(e2.symbol);
    s2 = e2.base + br.read(e2.nb);
    if (br.pos < 0) { w.push_back(table.t[s1].symbol); break; }
  }
  return 1 + (size_t)head;
}

static void build_huffman(std::vector<int> w, Huf& h) {
  uint32_t total = 0;
  for (int x : w) {
    need(x <= 11, "Huffman weight over 11");
    if (x) total += 1u << (x - 1);
  }
  need(total > 0, "empty Huffman tree");
  int max_bits = 32 - __builtin_clz(total);
  uint32_t rest = (1u << max_bits) - total;
  need(max_bits <= 11 && (rest & (rest - 1)) == 0, "Huffman weights do not complete a tree");
  w.push_back(32 - __builtin_clz(rest));
  need(w.size() <= 256, "too many Huffman symbols");
  h.t.assign((size_t)1 << max_bits, 0);
  size_t pos = 0;
  for (int wt = 1; wt <= max_bits; ++wt)
    for (size_t s = 0; s < w.size(); ++s)
      if (w[s] == wt) {
        size_t span = (size_t)1 << (wt - 1);
        uint16_t e = (uint16_t)(s | ((max_bits + 1 - wt) << 8));
        for (size_t k = 0; k < span; ++k) h.t[pos + k] = e;
        pos += span;
      }
  h.max_bits = max_bits;
  h.set = true;
}

static void huffman_stream(const uint8_t* p, size_t len, const Huf& h, size_t n, uint8_t* out) {
  Backward br(p, len);
  const int mb = h.max_bits;
  const uint64_t mask = (1ULL << mb) - 1;
  int64_t pos = br.pos;
  for (size_t k = 0; k < n; ++k) {
    int64_t q = pos - mb;
    uint64_t idx;
    if (q >= 0) {
      idx = br.window(q) & mask;
    } else {
      need(pos > 0, "Huffman stream overrun");
      idx = ((br.window(0) & ((1ULL << pos) - 1)) << (-q)) & mask;
    }
    uint16_t e = h.t[idx];
    out[k] = (uint8_t)(e & 0xff);
    pos -= e >> 8;
  }
  need(pos == 0, "Huffman stream not consumed exactly");
}

static size_t literals(const uint8_t* p, size_t len, State& st, std::vector<uint8_t>& lits) {
  need(len >= 1, "truncated literals section");
  int b0 = p[0], kind = b0 & 3, fmt = (b0 >> 2) & 3;
  size_t i;
  if (kind == 0 || kind == 1) {
    size_t size;
    if (fmt == 0 || fmt == 2) { size = b0 >> 3; i = 1; }
    else if (fmt == 1) { need(len >= 2, "truncated literals header"); size = (b0 >> 4) + (p[1] << 4); i = 2; }
    else { need(len >= 3, "truncated literals header"); size = (b0 >> 4) + (p[1] << 4) + ((size_t)p[2] << 12); i = 3; }
    if (kind == 0) {
      need(i + size <= len, "truncated raw literals");
      lits.assign(p + i, p + i + size);
      return i + size;
    }
    need(i < len, "truncated RLE literals");
    lits.assign(size, p[i]);
    return i + 1;
  }
  size_t regen, comp;
  int streams;
  if (fmt == 0 || fmt == 1) {
    need(len >= 3, "truncated literals header");
    uint32_t h = p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16);
    regen = (h >> 4) & 0x3FF; comp = (h >> 14) & 0x3FF; streams = fmt == 0 ? 1 : 4; i = 3;
  } else if (fmt == 2) {
    need(len >= 4, "truncated literals header");
    uint32_t h = rd32(p);
    regen = (h >> 4) & 0x3FFF; comp = h >> 18; streams = 4; i = 4;
  } else {
    need(len >= 5, "truncated literals header");
    uint64_t h = rd32(p) | ((uint64_t)p[4] << 32);
    regen = (h >> 4) & 0x3FFFF; comp = (size_t)(h >> 22); streams = 4; i = 5;
  }
  need(i + comp <= len, "truncated compressed literals");
  const size_t stop = i + comp;
  if (kind == 2) {
    std::vector<int> w;
    i += huffman_weights(p + i, stop - i, w);
    build_huffman(w, st.huf);
  } else {
    need(st.huf.set, "treeless literals without an earlier Huffman table");
  }
  lits.resize(regen);
  if (streams == 1) {
    huffman_stream(p + i, stop - i, st.huf, regen, lits.data());
  } else {
    need(i + 6 <= stop, "truncated jump table");
    size_t s1 = p[i] | (p[i + 1] << 8), s2 = p[i + 2] | (p[i + 3] << 8), s3 = p[i + 4] | (p[i + 5] << 8);
    i += 6;
    size_t b[5] = {i, i + s1, i + s1 + s2, i + s1 + s2 + s3, stop};
    need(b[3] <= stop, "corrupt jump table");
    size_t each = (regen + 3) / 4;
    need(3 * each <= regen, "corrupt literals size");
    for (int k = 0; k < 4; ++k)
      huffman_stream(p + b[k], b[k + 1] - b[k], st.huf, k < 3 ? each : regen - 3 * each,
                     lits.data() + k * each);
  }
  return stop;
}

static size_t table(const uint8_t* p, size_t len, int mode, Fse& f, int max_symbol, int max_log,
                    const int* def, int def_n, int def_log) {
  if (mode == 0) { predefined(f, def, def_n, def_log); return 0; }
  if (mode == 1) {
    need(len >= 1, "truncated RLE table");
    need(p[0] <= max_symbol, "RLE symbol out of range");
    f.t.assign(1, FseEntry{p[0], 0, 0});
    f.log = 0;
    f.set = true;
    return 1;
  }
  if (mode == 2) {
    std::vector<int> counts;
    int log;
    size_t used = read_ncount(p, len, max_symbol, max_log, counts, log);
    build_fse(counts, log, f);
    return used;
  }
  need(f.set, "repeated table without an earlier one");
  return 0;
}

struct Out {
  uint8_t* buf;
  size_t cap, n = 0, frame_start = 0;
  inline void put(const uint8_t* src, size_t k) {
    if (n + k > cap) throw TooSmall();
    std::memcpy(buf + n, src, k);
    n += k;
  }
  inline void fill(uint8_t v, size_t k) {
    if (n + k > cap) throw TooSmall();
    std::memset(buf + n, v, k);
    n += k;
  }
  inline void match(size_t off, size_t k, uint64_t window) {
    need(off <= n - frame_start && off <= window, "match offset before the start of the window");
    if (n + k > cap) throw TooSmall();
    uint8_t* d = buf + n;
    const uint8_t* s = d - off;
    if (off >= k) std::memcpy(d, s, k);
    else for (size_t j = 0; j < k; ++j) d[j] = s[j];
    n += k;
  }
};

static void block(const uint8_t* p, size_t len, State& st, Out& out, uint64_t window) {
  std::vector<uint8_t> lits;
  size_t i = literals(p, len, st, lits);
  need(i < len, "truncated sequences section");
  int b0 = p[i];
  size_t nseq;
  if (b0 == 0) { nseq = 0; i += 1; }
  else if (b0 < 128) { nseq = b0; i += 1; }
  else if (b0 < 255) { need(i + 1 < len, "truncated sequences header"); nseq = ((b0 - 128) << 8) + p[i + 1]; i += 2; }
  else { need(i + 2 < len, "truncated sequences header"); nseq = p[i + 1] + (p[i + 2] << 8) + 0x7F00; i += 3; }
  if (nseq == 0) {
    out.put(lits.data(), lits.size());
    return;
  }
  need(i < len, "truncated sequences section");
  int modes = p[i++];
  need((modes & 3) == 0, "reserved bits set in the sequence modes");
  i += table(p + i, len - i, modes >> 6, st.ll, 35, 9, LL_DEFAULT, 36, 6);
  i += table(p + i, len - i, (modes >> 4) & 3, st.of, 31, 8, OF_DEFAULT, 29, 5);
  i += table(p + i, len - i, (modes >> 2) & 3, st.ml, 52, 9, ML_DEFAULT, 53, 6);
  need(i < len, "truncated sequences bitstream");
  Backward br(p + i, len - i);
  uint32_t sll = br.read(st.ll.log), sof = br.read(st.of.log), sml = br.read(st.ml.log);
  uint64_t* rep = st.rep;
  size_t lp = 0;
  for (size_t n = 0; n < nseq; ++n) {
    const FseEntry& el = st.ll.t[sll];
    const FseEntry& eo = st.of.t[sof];
    const FseEntry& em = st.ml.t[sml];
    need(eo.symbol <= 31 && el.symbol <= 35 && em.symbol <= 52, "sequence code out of range");
    uint64_t of_val = (1ULL << eo.symbol) + br.read(eo.symbol);
    uint64_t ml = ML_BASE[em.symbol] + br.read(ML_BITS[em.symbol]);
    uint64_t ll = LL_BASE[el.symbol] + br.read(LL_BITS[el.symbol]);
    uint64_t off;
    if (of_val > 3) {
      off = of_val - 3;
      rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
    } else {
      int idx = (int)of_val + (ll == 0);
      if (idx == 1) {
        off = rep[0];
      } else if (idx == 2) {
        off = rep[1]; rep[1] = rep[0]; rep[0] = off;
      } else if (idx == 3) {
        off = rep[2]; rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
      } else {
        off = rep[0] - 1;
        need(off != 0, "zero offset");
        rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
      }
    }
    if (n != nseq - 1) {
      sll = el.base + br.read(el.nb);
      sml = em.base + br.read(em.nb);
      sof = eo.base + br.read(eo.nb);
    }
    need(br.pos >= 0, "sequence bitstream overrun");
    need(lp + ll <= lits.size(), "literal length past the literals");
    out.put(lits.data() + lp, ll);
    lp += ll;
    out.match(off, ml, window);
  }
  need(br.pos == 0, "sequence bitstream not consumed exactly");
  out.put(lits.data() + lp, lits.size() - lp);
}

static size_t header(const uint8_t* p, size_t len, size_t i, int64_t& size, uint64_t& window,
                     bool& checksum) {
  need(i < len, "truncated frame header");
  int fhd = p[i++];
  int single = (fhd >> 5) & 1, dict_flag = fhd & 3, fcs_flag = fhd >> 6;
  checksum = (fhd >> 2) & 1;
  need((fhd & 8) == 0, "reserved bit set in the frame header");
  window = 0;
  if (!single) {
    need(i < len, "truncated frame header");
    int wd = p[i++];
    int exp = (wd >> 3) + 10;
    need(exp < 63, "window too large");
    window = (1ULL << exp) + ((1ULL << exp) / 8) * (wd & 7);
  }
  static const int dict_sizes[4] = {0, 1, 2, 4};
  if (dict_flag) {
    int ds = dict_sizes[dict_flag];
    need(i + ds <= len, "truncated frame header");
    uint32_t id = 0;
    for (int k = 0; k < ds; ++k) id |= (uint32_t)p[i + k] << (8 * k);
    need(id == 0, "frames with a dictionary are not supported");
    i += ds;
  }
  static const int fcs_sizes[4] = {0, 2, 4, 8};
  int fs = fcs_flag == 0 ? (single ? 1 : 0) : fcs_sizes[fcs_flag];
  size = -1;
  if (fs) {
    need(i + fs <= len, "truncated frame header");
    uint64_t v = 0;
    for (int k = 0; k < fs; ++k) v |= (uint64_t)p[i + k] << (8 * k);
    if (fs == 2) v += 256;
    size = (int64_t)v;
  }
  i += fs;
  if (!window) window = size < 0 ? 0 : (uint64_t)size;
  return i;
}

static size_t decompress(const uint8_t* p, size_t len, uint8_t* dst, size_t cap) {
  need(len > 0, "empty input");
  Out out{dst, cap};
  size_t i = 0;
  while (i < len) {
    need(len - i >= 8, "truncated frame");
    uint32_t magic = rd32(p + i);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      uint64_t skip = rd32(p + i + 4);
      need(skip <= len - i - 8, "truncated skippable frame");
      i += 8 + skip;
      continue;
    }
    need(magic == 0xFD2FB528u, "not a zstd frame");
    int64_t size;
    uint64_t window;
    bool checksum;
    i = header(p, len, i + 4, size, window, checksum);
    if (!window) window = ~0ULL;
    out.frame_start = out.n;
    State st;
    for (;;) {
      need(i + 3 <= len, "truncated block header");
      uint32_t h = p[i] | (p[i + 1] << 8) | ((uint32_t)p[i + 2] << 16);
      i += 3;
      int last = h & 1, btype = (h >> 1) & 3;
      size_t bsize = h >> 3;
      if (btype == 0) {
        need(bsize <= len - i, "truncated raw block");
        out.put(p + i, bsize);
        i += bsize;
      } else if (btype == 1) {
        need(i < len, "truncated RLE block");
        out.fill(p[i], bsize);
        i += 1;
      } else if (btype == 2) {
        need(bsize <= len - i, "truncated compressed block");
        block(p + i, bsize, st, out, window);
        i += bsize;
      } else {
        throw Error("reserved block type");
      }
      need(size < 0 || out.n - out.frame_start <= (uint64_t)size, "frame larger than its declared size");
      if (last) break;
    }
    need(size < 0 || out.n - out.frame_start == (uint64_t)size, "frame smaller than its declared size");
    if (checksum) {
      need(i + 4 <= len, "truncated checksum");
      need(rd32(p + i) == (uint32_t)xxh64(dst + out.frame_start, out.n - out.frame_start),
           "content checksum mismatch");
      i += 4;
    }
  }
  return out.n;
}

static thread_local std::string last_error;

}  // namespace zstd

// Decompress every frame of src[0:n] into dst (capacity cap). Returns the
// bytes written, -1 for a corrupt frame (zstd_last_error() says why), -2
// when cap is too small.
long long zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  try {
    return (long long)zstd::decompress(src, n, dst, cap);
  } catch (const zstd::TooSmall&) {
    return -2;
  } catch (const std::exception& e) {
    zstd::last_error = e.what();
    return -1;
  }
}

const char* zstd_last_error() { return zstd::last_error.c_str(); }

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli, reflected 0x82F63B78; init and final xor ~0), eight
// bytes a step from eight tables (slice-by-8): the checksum of every OCDBT
// manifest and B-tree node.
// ---------------------------------------------------------------------------
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (int i = 0; i < 256; ++i) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTables tables;
  const auto& T = tables.t;
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; p += 8, n -= 8) {
    const uint32_t lo = c ^ ((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                             (uint32_t)p[3] << 24);
    const uint32_t hi = (uint32_t)p[4] | (uint32_t)p[5] << 8 | (uint32_t)p[6] << 16 |
                        (uint32_t)p[7] << 24;
    c = T[7][lo & 0xFF] ^ T[6][(lo >> 8) & 0xFF] ^ T[5][(lo >> 16) & 0xFF] ^ T[4][lo >> 24] ^
        T[3][hi & 0xFF] ^ T[2][(hi >> 8) & 0xFF] ^ T[1][(hi >> 16) & 0xFF] ^ T[0][hi >> 24];
  }
  for (; n; ++p, --n) c = T[0][(c ^ *p) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
