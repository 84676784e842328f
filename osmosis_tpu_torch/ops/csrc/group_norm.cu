// Fused GroupNorm(32) -> (FiLM) -> (SiLU), forward (K3) and backward (K4), for
// Hopper (sm_90a), on NHWC tensors (NCHW in channels_last memory).
//
// Replaces the JAX package's hand-written GroupNorm ops, osmosis_tpu/models/nn.py:
// group_norm (:72, backward _gn_bwd :98), norm_silu (:178, _ns_bwd :190) and
// norm_film_silu (:205, _nfs_bwd :220). Statistics as there: fp32
// var = E[x^2] - mean^2, inv = rsqrt(var + eps); the backward recomputes the
// epilogue from x and the saved [B, C] statistics. In bf16 every value of the
// epilogue and of its derivative that is a bf16 tensor there (and in the
// plain versions of ops/group_norm.py, one rounding per PyTorch op) is rounded
// to bf16 at the same point: the norm output, 1 + fs, the FiLM product and
// sum, the sigmoid, each factor of SiLU's derivative, dfilm, dfilm * gn and
// dgn; the sums over them stay fp32. In fp32 the rounding is the identity.
//
// Bound: bytes. A few dozen flops an element, far below the H100's ~20 fp32
// flops a byte, so the least time is one read of x and one write of y (K3), or
// reads of x and dy and one write of dx (K4), at 3.35 TB/s. In bf16 the rounded
// epilogue (up to 11 roundings an element, twice in K4) adds ALU time that
// keeps K3/K4 further from that bound than in fp32.
//
// Design. A channel block is a run of whole groups, cut into 16-byte vectors;
// thread t of a CTA always owns vector t % cv of the block (cv vectors a
// pixel) and walks pixels t / cv, t / cv + rows, ... (rows = threads / cv), so
// a warp reads neighbouring vectors and every thread keeps fp32 per-channel
// sums of its own lanes. Each walk loads kBatch vectors before it uses any,
// so that a warp has several loads in flight. The threads' sums meet in a
// tree over the rows in shared memory, in a fixed order. Three phases, one
// kernel template, and ops/group_norm.py's plan() picks the geometry:
//  * kResident (one launch, x read once): a thread-block cluster per (batch
//    item, channel block); its CTAs split HW and copy their tile of x (and dy)
//    into shared memory with 16-byte cp.async. Each CTA's per-channel partials
//    are read by every CTA of the cluster over distributed shared memory
//    (map_shared_rank) and summed in rank order, collapsed to its groups'
//    statistics, and the output is written from the tile.
//  * kPartials + kApply (two launches, where a tile would not fit): launch 1
//    writes per-channel partials to a [sums, B, chunks, C] fp32 scratch;
//    launch 2 sums its channels' partials in chunk order, collapses them to
//    group statistics and applies. Launch 1's CTAs all run in one wave and walk
//    their chunks forwards; launch 2's walk theirs backwards, so that their
//    first reads are launch 1's last, which L2 may still hold. x (and dy) are
//    read twice: 1.5x (1.67x) the bound's bytes, less what L2 keeps.
// No floating-point atomics: two calls on the same input are bit-identical.
//
// Interface: plain C, loaded with ctypes. Each entry point returns the CUDA
// error of its launches (0 on success); the caller raises on anything else.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kResident = 0;
constexpr int kPartials = 1;
constexpr int kApply = 2;

constexpr int kNone = 0;
constexpr int kSilu = 1;
constexpr int kFilm = 2;  // FiLM then SiLU

constexpr int kMaxThreads = 256;
constexpr int kBatch = 4;  // vectors of each tensor a thread loads before it uses them
constexpr int kMaxSmem = 232448;  // 227 KB, the most a CTA may take on sm_90

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

__device__ __forceinline__ void to_float(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void to_float(const uint4& v, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 from_float(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 from_float(const float* f, __nv_bfloat16) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// x rounded to T and back: where the JAX package (and the plain version) holds
// a value as a tensor of x's dtype, the kernel rounds it there too.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// In bf16 the kernels repeat PyTorch's eager arithmetic of the plain versions,
// each operation rounded to fp32 on its own (no contraction into an FMA) and
// the sigmoid as 1 / (1 + expf(-h)), so that kernel and plain version meet the
// same values at every bf16 rounding. The fp32 instantiation keeps its FMAs
// and its fast sigmoid.

// (x - mean) * scale + bias
__device__ __forceinline__ float affine(float xm, float sc, float b, float) { return xm * sc + b; }
__device__ __forceinline__ float affine(float xm, float sc, float b, __nv_bfloat16) {
  return __fadd_rn(__fmul_rn(xm, sc), b);
}

// x_hat = (x - mean) * inv
__device__ __forceinline__ float x_hat(float x, float mean, float inv, float) {
  return (x - mean) * inv;
}
__device__ __forceinline__ float x_hat(float x, float mean, float inv, __nv_bfloat16) {
  return __fmul_rn(__fsub_rn(x, mean), inv);
}

// dx = inv * (dgn * w - h1 - x_hat * h2)
__device__ __forceinline__ float dx_of(float inv, float dgn, float w, float h1, float xh, float h2,
                                       float) {
  return inv * (dgn * w - h1 - xh * h2);
}
__device__ __forceinline__ float dx_of(float inv, float dgn, float w, float h1, float xh, float h2,
                                       __nv_bfloat16) {
  return __fmul_rn(inv, __fsub_rn(__fsub_rn(__fmul_rn(dgn, w), h1), __fmul_rn(xh, h2)));
}

// __fdividef is 0 where 1 + e^-h overflows past 2^126, which is the sigmoid's limit
__device__ __forceinline__ float sigmoid(float h, float) {
  return __fdividef(1.0f, 1.0f + __expf(-h));
}
__device__ __forceinline__ float sigmoid(float h, __nv_bfloat16) { return 1.0f / (1.0f + expf(-h)); }

// g * SiLU'(h) with s = sigmoid(h), as g * (s * (1 + h * (1 - s))) rounded to T
// after each operation (_silu_bwd in the JAX package)
template <typename T>
__device__ __forceinline__ float silu_grad(float g, float h, float s) {
  const float u = round_to(1.0f + round_to(h * round_to(1.0f - s, T()), T()), T());
  return round_to(g * round_to(s * u, T()), T());
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Split cluster barrier: arrive once this CTA has read the others' shared
// memory, wait before it exits, so that no CTA's shared memory goes while
// another still reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Args {
  const void* x;        // [B, HW, C]
  const void* dy;       // [B, HW, C] (backward)
  void* out;            // y or dx, [B, HW, C]
  float* mean_c;        // [B, C]: written by the forward, read by the backward
  float* inv_c;         // [B, C]
  const float* w;       // [C]
  const float* bias;    // [C]
  const void* fs;       // [B, *] with row stride fs_ld, in x's dtype (FiLM)
  const void* ft;
  float* scratch;       // [sums, B, chunks, C] fp32 partials (two-launch geometry)
  float* pg;            // [4, B, C]: sum dgn, sum dgn*xhat, sum dfilm*gn, sum dfilm
  long long hw, c, fs_ld;
  int cpg, cblk, px, chunks, sums;
  float eps;
};

// Bytes of dynamic shared memory, in the order the kernel lays them out: the
// tile (kResident only), the reduction rows, the channel totals, the two
// per-channel group results. ops/group_norm.py's plan() repeats this formula.
inline long long smem_bytes(int phase, int ntensors, int cblk, int lanes, int threads,
                            int px, int sums) {
  const long long cv = cblk / lanes;
  const long long tile = phase == kResident ? (long long)px * cv * 16 * ntensors : 0;
  return tile + 4LL * (sums * (long long)threads * lanes + sums * cblk + 2 * cblk);
}

// Sum rows [0, rows) of red[q][row][cblk] into row 0, for q < sums, in a
// fixed pairing order (row r += row r + s, s halving).
__device__ __forceinline__ void tree_reduce(float* red, int sums, int rows, int cblk,
                                            int stride_q) {
  int s = 1;
  while (s < rows) s <<= 1;
  for (s >>= 1; s > 0; s >>= 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < s * cblk; i += blockDim.x) {
      const int r = i / cblk;
      if (r + s < rows) {
        for (int q = 0; q < sums; ++q) red[q * stride_q + i] += red[q * stride_q + i + s * cblk];
      }
    }
  }
  __syncthreads();
}

template <typename T, int MODE, bool BWD, int PHASE>
__global__ void __launch_bounds__(kMaxThreads) gn_kernel(Args a) {
  constexpr int L = Lanes<T>::n;
  constexpr int NT = BWD ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];

  const int cblk = a.cblk;
  const int cv = cblk / L;
  const int nthr = blockDim.x;  // a multiple of cv
  const int rows = nthr / cv;
  const int t = threadIdx.x;
  const int v = t % cv;
  const int r0 = t / cv;
  const int sums = a.sums;

  const int chunk = blockIdx.x;
  const int cb = blockIdx.y;
  const int b = blockIdx.z;

  const long long p0 = (long long)chunk * a.px;
  const int npx = (int)max(0LL, min((long long)a.px, a.hw - p0));
  const long long ch0 = (long long)cb * cblk;
  const long long ldv = a.c / L;  // a pixel's row, in vectors
  const long long base = ((long long)b * a.hw + p0) * ldv + ch0 / L + v;
  const uint4* gx = static_cast<const uint4*>(a.x) + base;
  const uint4* gdy = BWD ? static_cast<const uint4*>(a.dy) + base : nullptr;
  uint4* gout = static_cast<uint4*>(a.out) + base;

  const long long tile_vecs = PHASE == kResident ? (long long)a.px * cv : 0;
  uint4* tile = reinterpret_cast<uint4*>(smem);
  float* red = reinterpret_cast<float*>(smem + 16 * tile_vecs * NT);
  const int stride_q = nthr * L;  // = rows * cblk
  float* tot = red + sums * stride_q;
  float* ga = tot + sums * cblk;
  float* gb = ga + cblk;

  if (PHASE == kResident) {  // start the tile's copy before anything else
    for (int p = r0, j = t; p < npx; p += rows, j += nthr) {
      cp_async16(tile + j, gx + p * ldv);
      if (BWD) cp_async16(tile + tile_vecs + j, gdy + p * ldv);
    }
  }

  // this thread's lanes: channel ch0 + v * L + k of the block
  const long long cl = ch0 + (long long)v * L;
  const float n = (float)(a.hw * a.cpg);
  float w[L], bb[L], fs1[L], ft[L], mean[L], inv[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    w[k] = a.w[cl + k];
    bb[k] = a.bias[cl + k];
    fs1[k] = 1.0f;
    ft[k] = 0.0f;
    if (MODE == kFilm) {
      fs1[k] = round_to(1.0f + load_as_float(static_cast<const T*>(a.fs) + b * a.fs_ld + cl + k),
                        T());
      ft[k] = load_as_float(static_cast<const T*>(a.ft) + b * a.fs_ld + cl + k);
    }
    if (BWD) {
      mean[k] = a.mean_c[b * a.c + cl + k];
      inv[k] = a.inv_c[b * a.c + cl + k];
    }
  }

  if (PHASE == kResident) cp_async_wait_all();  // each thread reads back only what it copied
  // Pixel p of this thread's walk sits at row at(p) of the CTA's pixels: kApply
  // walks its chunk backwards, so that it first reads what kPartials, whose
  // CTAs all run at once and walk forwards, read last, which L2 may still hold.
  auto at = [&](int p) { return PHASE == kApply ? npx - 1 - p : p; };
  // element j / pixel p of this thread's walk, from the tile or device memory
  auto load_x = [&](int j, int p) {
    return PHASE == kResident ? tile[j] : gx[(long long)at(p) * ldv];
  };
  auto load_dy = [&](int j, int p) {
    return PHASE == kResident ? tile[tile_vecs + j] : gdy[(long long)at(p) * ldv];
  };

  // ---- per-thread sums over this CTA's pixels --------------------------------
  // Each walk loads kBatch vectors (of x, and of dy) before it uses any, so
  // that a warp keeps kBatch loads in flight instead of one.
  if (PHASE != kApply) {
    float acc[4][L];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < L; ++k) acc[q][k] = 0.0f;
    const bool film_grads = BWD && MODE == kFilm && sums == 4;
    for (int p = r0, j = t; p < npx; p += kBatch * rows, j += kBatch * nthr) {
      uint4 xv[kBatch], dv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (p + u * rows < npx) {
          xv[u] = load_x(j + u * nthr, p + u * rows);
          if (BWD) dv[u] = load_dy(j + u * nthr, p + u * rows);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (p + u * rows >= npx) break;
        float f[L];
        to_float(xv[u], f, T());
        if (!BWD) {
#pragma unroll
          for (int k = 0; k < L; ++k) {
            acc[0][k] += f[k];
            acc[1][k] += f[k] * f[k];
          }
        } else {
          float g[L];
          to_float(dv[u], g, T());
#pragma unroll
          for (int k = 0; k < L; ++k) {
            const float xhat = x_hat(f[k], mean[k], inv[k], T());
            const float gn = round_to(affine(f[k] - mean[k], inv[k] * w[k], bb[k], T()), T());
            float dgn = g[k], dfilm = g[k];
            if (MODE == kFilm) {
              const float h = round_to(round_to(gn * fs1[k], T()) + ft[k], T());
              dfilm = silu_grad<T>(g[k], h, round_to(sigmoid(h, T()), T()));
              dgn = round_to(dfilm * fs1[k], T());
            } else if (MODE == kSilu) {
              dgn = silu_grad<T>(g[k], gn, round_to(sigmoid(gn, T()), T()));
            }
            acc[0][k] += dgn;
            acc[1][k] += dgn * xhat;
            if (film_grads) {
              acc[2][k] += round_to(dfilm * gn, T());
              acc[3][k] += dfilm;
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)  // constant indices keep acc in registers
      if (q < sums)
#pragma unroll
        for (int k = 0; k < L; ++k) red[q * stride_q + t * L + k] = acc[q][k];
    tree_reduce(red, sums, rows, cblk, stride_q);

    if (PHASE == kPartials) {
      for (int ch = t; ch < cblk; ch += nthr)
        for (int q = 0; q < sums; ++q)
          a.scratch[(((long long)q * gridDim.z + b) * gridDim.x + chunk) * a.c + ch0 + ch] =
              red[q * stride_q + ch];
      return;
    }
  }

  // ---- channel totals --------------------------------------------------------
  bool lead;  // the CTA that writes the [B, C] results
  if (PHASE == kResident) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA's partials are in its red row 0
    const int cs = (int)cluster.num_blocks();
    for (int ch = t; ch < cblk; ch += nthr) {
      for (int q = 0; q < sums; ++q) {
        float part[16];  // all loads in flight, then the sum in rank order
#pragma unroll
        for (int r = 0; r < 16; ++r)
          if (r < cs) part[r] = cluster.map_shared_rank(red, r)[q * stride_q + ch];
        float s = 0.0f;
#pragma unroll
        for (int r = 0; r < 16; ++r)
          if (r < cs) s += part[r];
        tot[q * cblk + ch] = s;
      }
    }
    cluster_arrive();
    lead = cluster.block_rank() == 0;
  } else {
    // parts = nthr / cblk threads per channel, each summing every parts-th
    // chunk in order, then a tree over the parts
    const int parts = nthr / cblk;
    const int ch = t % cblk, part = t / cblk;
    if (part < parts) {
      for (int q = 0; q < sums; ++q) {
        const float* src = a.scratch + ((long long)q * gridDim.z + b) * a.chunks * a.c + ch0 + ch;
        float s = 0.0f;
#pragma unroll 8
        for (int k = part; k < a.chunks; k += parts) s += src[(long long)k * a.c];
        red[q * stride_q + part * cblk + ch] = s;
      }
    }
    tree_reduce(red, sums, parts, cblk, stride_q);
    for (int i = t; i < cblk; i += nthr)
      for (int q = 0; q < sums; ++q) tot[q * cblk + i] = red[q * stride_q + i];
    lead = chunk == 0;
  }
  __syncthreads();

  // ---- collapse to groups: forward (mean, inv); backward (h1, h2) ------------
  for (int ch = t; ch < cblk; ch += nthr) {
    const int g0 = ch - ch % a.cpg;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 8
    for (int i = g0; i < g0 + a.cpg; ++i) {
      if (BWD) {
        s0 += tot[i] * a.w[ch0 + i];
        s1 += tot[cblk + i] * a.w[ch0 + i];
      } else {
        s0 += tot[i];
        s1 += tot[cblk + i];
      }
    }
    const long long o = b * a.c + ch0 + ch;
    if (BWD) {
      ga[ch] = s0 / n;
      gb[ch] = s1 / n;
      if (lead && a.pg != nullptr) {
        const long long bc = (long long)gridDim.z * a.c;
        for (int q = 0; q < sums; ++q) a.pg[q * bc + o] = tot[q * cblk + ch];
      }
    } else {
      const float m = s0 / n;
      const float var = s1 / n - m * m;
      const float iv = rsqrtf(var + a.eps);
      ga[ch] = m;
      gb[ch] = iv;
      if (lead) {
        a.mean_c[o] = m;
        a.inv_c[o] = iv;
      }
    }
  }
  __syncthreads();

  // ---- apply -----------------------------------------------------------------
  float h1[L], h2[L], sc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (BWD) {
      h1[k] = ga[v * L + k];
      h2[k] = gb[v * L + k];
    } else {
      mean[k] = ga[v * L + k];
      inv[k] = gb[v * L + k];
    }
    sc[k] = inv[k] * w[k];
  }
  for (int p = r0, j = t; p < npx; p += kBatch * rows, j += kBatch * nthr) {
    uint4 xv[kBatch], dv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (p + u * rows < npx) {
        xv[u] = load_x(j + u * nthr, p + u * rows);
        if (BWD) dv[u] = load_dy(j + u * nthr, p + u * rows);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (p + u * rows >= npx) break;
      float f[L], o[L];
      to_float(xv[u], f, T());
      if (!BWD) {
#pragma unroll
        for (int k = 0; k < L; ++k) {
          float h = round_to(affine(f[k] - mean[k], sc[k], bb[k], T()), T());
          if (MODE == kFilm) h = round_to(round_to(h * fs1[k], T()) + ft[k], T());
          if (MODE != kNone) h = h * round_to(sigmoid(h, T()), T());
          o[k] = h;
        }
      } else {
        float g[L];
        to_float(dv[u], g, T());
#pragma unroll
        for (int k = 0; k < L; ++k) {
          const float xhat = x_hat(f[k], mean[k], inv[k], T());
          const float gn = round_to(affine(f[k] - mean[k], sc[k], bb[k], T()), T());
          float dgn = g[k];
          if (MODE == kFilm) {
            const float h = round_to(round_to(gn * fs1[k], T()) + ft[k], T());
            dgn = round_to(silu_grad<T>(g[k], h, round_to(sigmoid(h, T()), T())) * fs1[k], T());
          } else if (MODE == kSilu) {
            dgn = silu_grad<T>(g[k], gn, round_to(sigmoid(gn, T()), T()));
          }
          o[k] = dx_of(inv[k], dgn, w[k], h1[k], xhat, h2[k], T());
        }
      }
      gout[(long long)at(p + u * rows) * ldv] = from_float(o, T());
    }
  }
  if (PHASE == kResident) cluster_wait();
}

template <typename T, int MODE, bool BWD, int PHASE>
cudaError_t prepare() {
  static cudaError_t done = [] {
    auto fn = gn_kernel<T, MODE, BWD, PHASE>;
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e == cudaSuccess && PHASE == kResident)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return done;
}

template <typename T, int MODE, bool BWD, int PHASE>
cudaError_t launch(const Args& a, long long batch, int n_cblk, int threads, int cluster,
                   cudaStream_t stream) {
  cudaError_t e = prepare<T, MODE, BWD, PHASE>();
  if (e != cudaSuccess) return e;
  const long long smem = smem_bytes(PHASE, BWD ? 2 : 1, a.cblk, Lanes<T>::n, threads, a.px,
                                    a.sums);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.chunks, (unsigned)n_cblk, (unsigned)batch);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (PHASE == kResident) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, gn_kernel<T, MODE, BWD, PHASE>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Runs one call: geometry 0 = one cluster launch, 1 = partials then apply.
template <typename T, int MODE, bool BWD>
cudaError_t run(const Args& a, long long batch, int n_cblk, int threads, int cluster,
                int geometry, cudaStream_t s) {
  if (geometry == 0) return launch<T, MODE, BWD, kResident>(a, batch, n_cblk, threads, cluster, s);
  // the forward's partials (sums of x and x^2) do not depend on the mode
  constexpr int PMODE = BWD ? MODE : kNone;
  cudaError_t e = launch<T, PMODE, BWD, kPartials>(a, batch, n_cblk, threads, 1, s);
  if (e != cudaSuccess) return e;
  return launch<T, MODE, BWD, kApply>(a, batch, n_cblk, threads, 1, s);
}

template <bool BWD>
cudaError_t dispatch(const Args& a, long long batch, int n_cblk, int threads, int cluster,
                     int geometry, int mode, int dtype, cudaStream_t s) {
#define OSM_GN_CASE(TY, MD)                                                   \
  if (mode == MD) return run<TY, MD, BWD>(a, batch, n_cblk, threads, cluster, geometry, s);
  if (dtype == 0) {
    OSM_GN_CASE(float, kNone)
    OSM_GN_CASE(float, kSilu)
    OSM_GN_CASE(float, kFilm)
  } else if (dtype == 1) {
    OSM_GN_CASE(__nv_bfloat16, kNone)
    OSM_GN_CASE(__nv_bfloat16, kSilu)
    OSM_GN_CASE(__nv_bfloat16, kFilm)
  }
#undef OSM_GN_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int MODE, bool BWD>
cudaError_t max_clusters(int cluster, int threads, int cblk, int px, int sums, int* out) {
  cudaError_t e = prepare<T, MODE, BWD, kResident>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes =
      (size_t)smem_bytes(kResident, BWD ? 2 : 1, cblk, Lanes<T>::n, threads, px, sums);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, gn_kernel<T, MODE, BWD, kResident>, &cfg);
}

}  // namespace

// x, y: [B, HW, C] (NHWC); mean_c, inv_c: [B, C] fp32 outputs; w, bias: [C]
// fp32; fs, ft: [B, >= C] in x's dtype with row stride fs_ld (FiLM only);
// scratch: [2, B, chunks, C] fp32 (geometry 1 only). mode: 0 none, 1 SiLU,
// 2 FiLM + SiLU; dtype: 0 float32, 1 bfloat16. C * itemsize and cblk *
// itemsize are multiples of 16, the pointers 16-byte aligned, and threads a
// multiple of cblk / lanes (checked by the caller).
extern "C" int osm_gn_forward(const void* x, void* y, float* mean_c, float* inv_c,
                              const float* w, const float* bias, const void* fs,
                              const void* ft, long long fs_ld, float* scratch, long long B,
                              long long HW, long long C, int cpg, int cblk, int px, int chunks,
                              int threads, int cluster, int geometry, int mode, int dtype,
                              float eps, void* stream) {
  if (B * HW * C == 0) return 0;
  Args a = {x, nullptr, y, mean_c, inv_c, w, bias, fs, ft, scratch, nullptr,
            HW, C, fs_ld, cpg, cblk, px, chunks, 2, eps};
  return (int)dispatch<false>(a, B, (int)(C / cblk), threads, cluster, geometry, mode, dtype,
                              static_cast<cudaStream_t>(stream));
}

// dy, dx like x; mean_c, inv_c: the forward's statistics; pg: [4, B, C] fp32
// or null (then no parameter-gradient sums are written); sums: 2, or 4 to also
// take the FiLM sums (mode 2 with pg); scratch: [sums, B, chunks, C].
extern "C" int osm_gn_backward(const void* x, const void* dy, void* dx, const float* mean_c,
                               const float* inv_c, const float* w, const float* bias,
                               const void* fs, const void* ft, long long fs_ld, float* pg,
                               float* scratch, long long B, long long HW, long long C, int cpg,
                               int cblk, int px, int chunks, int threads, int cluster,
                               int geometry, int mode, int dtype, int sums, void* stream) {
  if (B * HW * C == 0) return 0;
  Args a = {x, dy, dx, const_cast<float*>(mean_c), const_cast<float*>(inv_c), w, bias, fs, ft,
            scratch, pg, HW, C, fs_ld, cpg, cblk, px, chunks, sums, 0.0f};
  return (int)dispatch<true>(a, B, (int)(C / cblk), threads, cluster, geometry, mode, dtype,
                             static_cast<cudaStream_t>(stream));
}

// How many clusters of the one-launch geometry can be resident at once (0:
// the launch would fail), for direction bwd (0/1), dtype and mode as above.
extern "C" int osm_gn_max_active_clusters(int bwd, int dtype, int mode, int cluster, int threads,
                                          int cblk, int px, int sums, int* out) {
  *out = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define OSM_GN_Q(TY, MD)                                                              \
  if (mode == MD)                                                                     \
    e = bwd ? max_clusters<TY, MD, true>(cluster, threads, cblk, px, sums, out)       \
            : max_clusters<TY, MD, false>(cluster, threads, cblk, px, sums, out);
  if (dtype == 0) {
    OSM_GN_Q(float, kNone)
    OSM_GN_Q(float, kSilu)
    OSM_GN_Q(float, kFilm)
  } else if (dtype == 1) {
    OSM_GN_Q(__nv_bfloat16, kNone)
    OSM_GN_Q(__nv_bfloat16, kSilu)
    OSM_GN_Q(__nv_bfloat16, kFilm)
  }
#undef OSM_GN_Q
  return (int)e;
}

extern "C" const char* osm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
