// K5: the phi-only fit of one guided osmosis step, every pass in one launch,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs these passes as a fori_loop of
// small fused XLA kernels (osmosis_tpu/diffusion/guided.py:390-425); the port
// ran them eagerly (diffusion/guided.py, osmosis_guided), each pass the
// operator's forward, the loss and torch.autograd.grad with respect to phi:
// some fifty small kernels a pass, nineteen passes a step in both presets.
//
// The gradient has a closed form. For one image, pixels p and channels c,
//   I = r e^{-a z} + inf (1 - e^{-b z}),  d = (y - (2 I - 1)) w,
// with r = (rgb + 1) / 2 and z, w the depth conversions of x0-hat's depth
// channel (the operator's and the loss weight's). With
//   S = sum d^2, Ta_c = sum d w r z e^{-a z}, Ub_c = sum d w z e^{-b z},
//   Ti_c = sum d w (1 - e^{-b z})
// (sums over the image's pixels, per channel) the loss's phi gradient is
//   dL/da_c = k Ta_c, dL/db_c = -k inf_c Ub_c, dL/dinf_c = -k Ti_c,
// k = 2 / sqrt(S) for the norm and 4 / (3 HW) for the mse (the image's mean
// of d^2). Where one phi_ab feeds both exponentials (underwater_physical,
// haze_physical) its gradient is the sum of the a and b terms; a parameter of
// one entry an image ([B, 1]) takes the sum over the channels. The auxiliary
// losses depend on x0-hat alone, so their phi gradient is zero.
//
// Each pass forms d as the eager loss does, one fp32 rounding an operation in
// its order (no contraction into an FMA), e^x with expf, and the depth
// conversions as PyTorch computes them (torch.pow's special exponents). The
// ten sums are taken in fp64: a thread's pixels, then a warp by shuffles, the
// CTA's warps in order in shared memory, and the cluster's CTAs in rank order
// over distributed shared memory, so every CTA holds the same totals. Every
// thread then applies the same SGD update to its copy of phi in the eager
// code's order and roundings: p' = p - eta g, then p + s (p' - p) under
// eta_scale.
//
// Bound. The data are read once: x0-hat (16 bytes a pixel) and y (12), 1.8 MB
// for a 256x256 image, about 0.55 us at 3.35 TB/s. The passes are serial: each
// ends in a reduction across the cluster that the next pass's phi waits for,
// so a launch costs the load plus n passes of (a CTA's share of the pixels'
// arithmetic + one cluster barrier and its DSMEM reads).
//
// Design. One thread-block cluster per image (grid: cluster x B), up to 16
// CTAs of 512 threads. Each CTA owns a run of pixels; it forms r, z, w once
// and keeps them with y in shared memory (8 floats a pixel, 128 KB for a
// 16-CTA cluster at 256x256) for every pass. Pixels beyond what shared memory
// holds are formed again from device memory at each pass. The CTA partials
// are double-buffered by pass parity: a CTA writes pass k + 1's while others
// may still read pass k's, and cannot write pass k + 2's before the cluster
// barrier of pass k + 1, which every CTA reaches only once it has read pass
// k's. No atomics: two calls on the same input give the same bits.
//
// Interface: plain C, loaded with ctypes. Each entry point returns the CUDA
// error of its launch (0 on success); the caller raises on anything else.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFields = 8;  // r0 r1 r2 z w y0 y1 y2
constexpr int kSums = 10;   // S, then Ta_c, Ub_c, Ti_c for c = 0, 1, 2
constexpr int kMaxSmem = 232448;  // 227 KB, the most a CTA may take on sm_90

// depth conversions (guidance/operators.py convert_depth) and the unit weight
constexpr int kOriginal = 0;  // 0.5 * (d + 1)
constexpr int kGamma = 1;     // ((d + v0) * v1) ** v2
constexpr int kMove = 2;      // d + v0
constexpr int kOne = 3;       // 1 (loss_weight none)

struct Conv {
  int kind;
  float v0, v1, v2;
};

struct Fit {
  const float* x0;      // [B, HW, 4]
  const float* y;       // [B, HW, 3]
  const float* in[3];   // phi: a (or ab), b (unused when shared), inf; [B, n[k]]
  float* out[3];        // the fitted phi, like in
  int n[3];             // entries an image: 1 or 3
  float eta[3][3];      // each entry's learning rate
  float scale;          // eta_scale
  int scaled;
  long long hw;
  int px;               // pixels a CTA owns
  int cached;           // of them, the first this many held in shared memory
  int passes;
  int mse;
  Conv depth, weight;
};

// torch.pow(x, g) for a float exponent, as PyTorch's CUDA kernels compute it
__device__ __forceinline__ float torch_pow(float x, float g) {
  if (g == 0.0f) return 1.0f;
  if (g == 1.0f) return x;
  if (g == 0.5f) return sqrtf(x);
  if (g == -0.5f) return rsqrtf(x);
  if (g == -1.0f) return 1.0f / x;
  if (g == 2.0f) return __fmul_rn(x, x);
  if (g == 3.0f) return __fmul_rn(__fmul_rn(x, x), x);
  if (g == -2.0f) return 1.0f / __fmul_rn(x, x);
  return powf(x, g);
}

__device__ __forceinline__ float convert(float d, const Conv& c) {
  switch (c.kind) {
    case kGamma:
      return torch_pow(__fmul_rn(__fadd_rn(d, c.v0), c.v1), c.v2);
    case kMove:
      return __fadd_rn(d, c.v0);
    case kOne:
      return 1.0f;
    case kOriginal:
    default:
      return __fmul_rn(0.5f, __fadd_rn(d, 1.0f));
  }
}

// pixel i's fields from x0-hat and y, as the eager loss forms them
__device__ __forceinline__ void form(const float* x0, const float* y, long long i,
                                     const Fit& f, float* v) {
  const float* q = x0 + 4 * i;
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __fmul_rn(0.5f, __fadd_rn(q[c], 1.0f));
  const float depth = q[3];
  v[3] = convert(depth, f.depth);
  v[4] = convert(depth, f.weight);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[5 + c] = y[3 * i + c];
}

template <bool SHARED>
__global__ void __launch_bounds__(kThreads, 1) phi_fit_kernel(const Fit f) {
  extern __shared__ float tile[];  // [kFields][cached]
  __shared__ double warp_part[kWarps][kSums];
  __shared__ double part[2][kSums];  // this CTA's partials, by pass parity
  __shared__ double tot[kSums];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long b = blockIdx.y;
  const long long p0 = (long long)rank * f.px;
  const int mine = (int)max(0LL, min((long long)f.px, f.hw - p0));
  const float* x0 = f.x0 + (b * f.hw + p0) * 4;
  const float* y = f.y + (b * f.hw + p0) * 3;
  const int cached = min(mine, f.cached);

  for (int i = t; i < cached; i += kThreads) {
    float v[kFields];
    form(x0, y, i, f, v);
#pragma unroll
    for (int k = 0; k < kFields; ++k) tile[k * f.cached + i] = v[k];
  }

  float p[3][3];  // this image's phi, the same in every thread
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      p[k][j] = (j < f.n[k] && !(SHARED && k == 1)) ? f.in[k][b * f.n[k] + j] : 0.0f;
  __syncthreads();

  for (int pass = 0; pass < f.passes; ++pass) {
    float a[3], bb[3], inf[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = p[0][f.n[0] == 1 ? 0 : c];
      bb[c] = SHARED ? a[c] : p[1][f.n[1] == 1 ? 0 : c];
      inf[c] = p[2][f.n[2] == 1 ? 0 : c];
    }
    double acc[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] = 0.0;
    for (int i = t; i < mine; i += kThreads) {
      float v[kFields];
      if (i < cached) {
#pragma unroll
        for (int k = 0; k < kFields; ++k) v[k] = tile[k * f.cached + i];
      } else {
        form(x0, y, i, f, v);
      }
      const float z = v[3], w = v[4];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float ea = expf(__fmul_rn(-a[c], z));
        const float eb = SHARED ? ea : expf(__fmul_rn(-bb[c], z));
        const float bsc = __fsub_rn(1.0f, eb);
        const float img = __fadd_rn(__fmul_rn(v[c], ea), __fmul_rn(inf[c], bsc));
        const float deg = __fsub_rn(__fmul_rn(2.0f, img), 1.0f);
        const float d = __fmul_rn(__fsub_rn(v[5 + c], deg), w);
        const double dw = (double)d * (double)w;
        acc[0] += (double)d * (double)d;
        acc[1 + 3 * c] += dw * (double)v[c] * (double)z * (double)ea;
        acc[2 + 3 * c] += dw * (double)z * (double)eb;
        acc[3 + 3 * c] += dw * (double)bsc;
      }
    }
#pragma unroll
    for (int q = 0; q < kSums; ++q) {
#pragma unroll
      for (int off = 16; off; off >>= 1) acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) warp_part[warp][q] = acc[q];
    }
    __syncthreads();
    double* slot = part[pass & 1];
    if (t < kSums) {
      double s = 0.0;
      for (int k = 0; k < kWarps; ++k) s += warp_part[k][t];
      slot[t] = s;
    }
    cluster.sync();  // every CTA's partials of this pass are in its slot
    if (t < kSums) {
      double s = 0.0;
      for (int r = 0; r < cs; ++r) s += cluster.map_shared_rank(slot, r)[t];
      tot[t] = s;
    }
    __syncthreads();

    // the gradient and the SGD update, the same in every thread of the cluster
    const double k = f.mse ? 4.0 / (3.0 * (double)f.hw) : 2.0 / sqrt(tot[0]);
    double g[3][3];  // per parameter, per channel
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const double ga = k * tot[1 + 3 * c];
      const double gb = -k * (double)inf[c] * tot[2 + 3 * c];
      g[0][c] = SHARED ? ga + gb : ga;
      g[1][c] = gb;
      g[2][c] = -k * tot[3 + 3 * c];
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (SHARED && q == 1) continue;
      if (f.n[q] == 1) g[q][0] = g[q][0] + g[q][1] + g[q][2];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j >= f.n[q]) continue;
        const float old = p[q][j];
        float nxt = __fsub_rn(old, __fmul_rn(f.eta[q][j], (float)g[q][j]));
        if (f.scaled) nxt = __fadd_rn(old, __fmul_rn(f.scale, __fsub_rn(nxt, old)));
        p[q][j] = nxt;
      }
    }
  }

  if (rank == 0 && t == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (SHARED && q == 1) continue;
      for (int j = 0; j < f.n[q]; ++j) f.out[q][b * f.n[q] + j] = p[q][j];
    }
  }
  cluster.sync();  // no CTA's shared memory goes while another still reads it
}

template <bool SHARED>
cudaError_t prepare() {
  static cudaError_t done = [] {
    auto fn = phi_fit_kernel<SHARED>;
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem - 4096);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return done;
}

template <bool SHARED>
cudaError_t launch(const Fit& f, long long batch, int cluster, cudaStream_t stream) {
  cudaError_t e = prepare<SHARED>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)batch, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)kFields * sizeof(float) * (size_t)f.cached;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, phi_fit_kernel<SHARED>, f);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool SHARED>
cudaError_t max_clusters(int cluster, int cached, int* out) {
  cudaError_t e = prepare<SHARED>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)kFields * sizeof(float) * (size_t)cached;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, phi_fit_kernel<SHARED>, &cfg);
}

}  // namespace

// x0: [B, HW, 4], y: [B, HW, 3], fp32, contiguous. a, b, inf: [B, n[k]] fp32
// (b unused where shared: one phi_ab in a for both exponentials); a_out,
// b_out, inf_out like them, written. n: 3 entry counts (1 or 3); eta: 3 x 3
// learning rates by parameter and entry; kinds: the depth and the weight
// conversion (0 original, 1 gamma, 2 move, 3 one); values: their 2 x 3
// values. scaled: apply eta_scale = scale. cluster: CTAs an image (1-16);
// px: pixels a CTA owns (cluster * px >= HW); cached: of them, held in shared
// memory (8 floats each). passes >= 1 SGD updates.
extern "C" int osm_phi_fit(const float* x0, const float* y, const float* a, const float* b,
                           const float* inf, float* a_out, float* b_out, float* inf_out,
                           const int* n, const float* eta, const int* kinds,
                           const float* values, float scale, int scaled, long long B,
                           long long HW, int cluster, int px, int cached, int passes,
                           int shared, int mse, void* stream) {
  if (B * HW == 0 || passes <= 0) return 0;
  if (cluster < 1 || cluster > 16 || (long long)cluster * px < HW || cached > px ||
      (long long)kFields * sizeof(float) * cached > kMaxSmem - 4096)
    return (int)cudaErrorInvalidValue;
  Fit f = {};
  f.x0 = x0;
  f.y = y;
  f.in[0] = a;
  f.in[1] = b;
  f.in[2] = inf;
  f.out[0] = a_out;
  f.out[1] = b_out;
  f.out[2] = inf_out;
  for (int k = 0; k < 3; ++k) {
    f.n[k] = n[k];
    for (int j = 0; j < 3; ++j) f.eta[k][j] = eta[3 * k + j];
  }
  f.scale = scale;
  f.scaled = scaled;
  f.hw = HW;
  f.px = px;
  f.cached = cached;
  f.passes = passes;
  f.mse = mse;
  f.depth = {kinds[0], values[0], values[1], values[2]};
  f.weight = {kinds[1], values[3], values[4], values[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(shared ? launch<true>(f, B, cluster, s) : launch<false>(f, B, cluster, s));
}

// How many clusters of `cluster` CTAs, each holding `cached` pixels, can be
// resident at once (0: the launch would fail).
extern "C" int osm_phi_fit_max_active_clusters(int shared, int cluster, int cached, int* out) {
  *out = 0;
  return (int)(shared ? max_clusters<true>(cluster, cached, out)
                      : max_clusters<false>(cluster, cached, out));
}

extern "C" const char* osm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
