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

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
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

}  // extern "C"
