// Nearest-neighbour 2x upsample and 2x2 box sum on NHWC tensors, for Hopper (sm_90a).
//
// Replaces the package's one Pallas TPU kernel, osmosis_tpu/ops/upsample.py
// (upsample_nearest_2x_pallas: _up_kernel, and its mirror _down_kernel / the
// reshape-sum backward _up_bwd).
//
// Bound: bytes. Both kernels do at most three flops per element, so they are
// memory-bound by a wide margin. [1,128,128,256] fp32 -> [1,256,256,256] reads
// 16.8 MB and writes 67.1 MB: 83.9 MB at 3.35 TB/s is about 25 us.
//
// Design: one thread owns one 16-byte vector of channels (4 fp32 or 8 bf16).
// Neighbouring threads own neighbouring channel vectors of the same pixel, so
// every load and store of a warp is a contiguous 512-byte transaction. The
// upsample reads each input vector once and stores it four times; the box sum
// reads four vectors and stores one. Sums are taken in fp32 in a fixed order,
// (x[2h,2w] + x[2h,2w+1]) + (x[2h+1,2w] + x[2h+1,2w+1]) -- the order XLA's
// reshape-sum takes, which the JAX package's backward uses -- with rounding
// intrinsics so that no multiply-add contraction changes the result: the plain
// PyTorch version in upsample.py takes the same order and matches bit for bit.
// A grid-stride loop covers any size with a grid capped near 16 blocks per SM.
//
// Interface: plain C, loaded with ctypes. Each function returns the CUDA error
// of its launch (0 on success); the caller raises on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int n = 4;
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int n = 8;
};

template <typename T>
__device__ __forceinline__ void to_float(const uint4& v, float* f);

template <>
__device__ __forceinline__ void to_float<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void to_float<__nv_bfloat16>(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 from_float(const float* f);

template <>
__device__ __forceinline__ uint4 from_float<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

template <>
__device__ __forceinline__ uint4 from_float<__nv_bfloat16>(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// x: [B, H, W, CV] vectors -> y: [B, 2H, 2W, CV] vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_nearest_2x_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                           int64_t W, int64_t CV, int64_t total, float scale) {
  const int64_t W2 = 2 * W;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t cv = i % CV;
    const int64_t p = i / CV;  // flat (b, h, w)
    const int64_t w = p % W;
    const int64_t bh = p / W;  // b * H + h; output row 2 * bh is (b, 2h)
    uint4 v = x[i];
    if (scale != 1.0f) {
      float f[Lanes<T>::n];
      to_float<T>(v, f);
#pragma unroll
      for (int k = 0; k < Lanes<T>::n; ++k) f[k] = __fmul_rn(f[k], scale);
      v = from_float<T>(f);
    }
    const int64_t o = ((2 * bh) * W2 + 2 * w) * CV + cv;
    const int64_t o2 = o + W2 * CV;
    y[o] = v;
    y[o + CV] = v;
    y[o2] = v;
    y[o2 + CV] = v;
  }
}

// x: [B, 2Ho, 2Wo, CV] vectors -> y: [B, Ho, Wo, CV] vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
box_sum_2x_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                  int64_t Wo, int64_t CV, int64_t total, float scale) {
  const int64_t Wi = 2 * Wo;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t cv = i % CV;
    const int64_t p = i / CV;  // flat (b, ho, wo)
    const int64_t w = p % Wo;
    const int64_t bh = p / Wo;  // b * Ho + ho; input row 2 * bh is (b, 2ho)
    const int64_t a = ((2 * bh) * Wi + 2 * w) * CV + cv;
    const int64_t c = a + Wi * CV;
    float f00[Lanes<T>::n], f01[Lanes<T>::n], f10[Lanes<T>::n], f11[Lanes<T>::n];
    to_float<T>(x[a], f00);
    to_float<T>(x[a + CV], f01);
    to_float<T>(x[c], f10);
    to_float<T>(x[c + CV], f11);
    float s[Lanes<T>::n];
#pragma unroll
    for (int k = 0; k < Lanes<T>::n; ++k) {
      float acc = __fadd_rn(__fadd_rn(f00[k], f01[k]), __fadd_rn(f10[k], f11[k]));
      s[k] = __fmul_rn(acc, scale);
    }
    y[i] = from_float<T>(s);
  }
}

inline int64_t grid_for(int64_t total) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. B, H, W, C are the INPUT's dims; C * itemsize
// must be a multiple of 16 and both pointers 16-byte aligned (checked by the caller).
extern "C" int osm_upsample_nearest_2x(const void* x, void* y, long long B, long long H,
                                       long long W, long long C, int dtype, float scale,
                                       void* stream) {
  const int64_t lanes = dtype == 0 ? 4 : 8;
  const int64_t CV = C / lanes;
  const int64_t total = (int64_t)B * H * W * CV;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = grid_for(total);
  if (dtype == 0) {
    upsample_nearest_2x_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), W, CV, total, scale);
  } else if (dtype == 1) {
    upsample_nearest_2x_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), W, CV, total, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B, Ho, Wo, C are the OUTPUT's dims; the input is [B, 2Ho, 2Wo, C].
extern "C" int osm_box_sum_2x(const void* x, void* y, long long B, long long Ho,
                              long long Wo, long long C, int dtype, float scale,
                              void* stream) {
  const int64_t lanes = dtype == 0 ? 4 : 8;
  const int64_t CV = C / lanes;
  const int64_t total = (int64_t)B * Ho * Wo * CV;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = grid_for(total);
  if (dtype == 0) {
    box_sum_2x_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), Wo, CV, total, scale);
  } else if (dtype == 1) {
    box_sum_2x_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), Wo, CV, total, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* osm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
