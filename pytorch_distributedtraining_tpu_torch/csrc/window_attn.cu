// Window attention for Swin-style models on Hopper (sm_90a), forward and
// backward, with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernels of pytorch_distributedtraining_tpu/ops/
// pallas_window_attn.py: `_fwd_kernel` (K1) and `_bwd_kernel` (K2).
//
//   K1: o = softmax(q.k^T * d^-1/2 + bias[h] + mask[w mod nW]) . v
//   K2: recompute p; dv = p^T.dO; ds = p*(dO.v^T - rowsum(dO.v^T * p));
//       dq = ds.k*scale; dk = ds^T.(q*scale); dbias[h] = sum_windows ds
//
// Shapes: q/k/v/o [bn, heads, n, d] (f32, bf16 or f16, contiguous), bias
// [heads, n, n] f32, mask [nW, n, n] f32 or null, n <= 128, d <= 32.
//
// Bound on an H100 SXM at SwinIR-S's shape (n=64, d=10, heads=6, bn=1152):
// K1 moves ~72 MB in f32 (~21 us at 3.35 TB/s) for 1.13 GFLOP; K2 moves
// ~125 MB (~37 us) for 2.83 GFLOP, which at the 67 TFLOP/s f32 rate of the
// CUDA cores (~42 us) makes K2 bound by operations in f32. d=10 is below
// any MMA depth, so both kernels run their products on FP32 CUDA cores;
// what the design buys is that the n x n scores never reach device memory.
//
// Design:
// - K1: one block per (window, head), four warps. q (pre-scaled), k and v
//   sit in shared memory as f32 with an odd row stride, so lanes reading
//   rows j = lane, lane+32, ... hit distinct banks. One warp owns one query
//   row at a time: each lane holds the scores of its keys in registers, the
//   row max and sum are warp shuffles, and p.v is a per-lane partial sum
//   followed by one warp reduction per output column. The mask is indexed
//   as window mod nW, so any window count works.
// - K2: one block per (group of windows, head), eight warps. Per window:
//   pass 1 recomputes p row by row, forms ds and dq (warp reductions) and
//   writes ds into an n x n shared tile; pass 2 reduces the tile against q
//   into dk; pass 3 recomputes p into the same tile; pass 4 reduces it
//   against dO into dv. Recomputing p (d FMAs per entry) keeps shared
//   memory at one n x n tile plus the dbias accumulator, which fits n=128,
//   d=32 in 196 KB.
// - dbias is deterministic: each block accumulates its windows' ds in
//   shared memory, always the same thread on the same entry, writes one
//   partial [heads, n, n] per group, and a second kernel sums the partials
//   in group order. No atomics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kReduceThreads = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// [n, d] rows of global memory -> f32 shared tile with row stride ld.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int n, int d,
                                          int ld, float scale) {
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int r = e / d;
    const int c = e - r * d;
    dst[r * ld + c] = to_f<T>(src[e]) * scale;
  }
}

// Scores of query row i against this lane's keys j = lane + 32*t, plus
// bias and mask; keys past n get -inf. Returns the row max (warp-wide).
template <int JPL, int DMAX>
__device__ __forceinline__ float row_scores(float (&s)[JPL], const float (&qi)[DMAX],
                                            const float* sk, const float* bias_row,
                                            const float* mask_row, int n, int d, int ld,
                                            int lane) {
  float mx = -INFINITY;
#pragma unroll
  for (int t = 0; t < JPL; ++t) {
    const int j = lane + 32 * t;
    float acc = -INFINITY;
    if (j < n) {
      acc = 0.f;
#pragma unroll
      for (int c = 0; c < DMAX; ++c) {
        if (c < d) acc = fmaf(qi[c], sk[j * ld + c], acc);
      }
      acc += bias_row[j];
      if (mask_row != nullptr) acc += mask_row[j];
    }
    s[t] = acc;
    mx = fmaxf(mx, acc);
  }
  return warp_max(mx);
}

// Softmax of the row in place (s becomes p); returns nothing, p sums to 1.
template <int JPL>
__device__ __forceinline__ void row_softmax(float (&s)[JPL], float mx) {
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < JPL; ++t) {
    const float e = expf(s[t] - mx);  // -inf -> 0 for keys past n
    s[t] = e;
    sum += e;
  }
  const float inv = 1.f / warp_sum(sum);
#pragma unroll
  for (int t = 0; t < JPL; ++t) s[t] *= inv;
}

// out[c] = sum_j w_j * tile[j][c] over the whole warp; every lane gets all d.
template <int JPL, int DMAX>
__device__ __forceinline__ void row_times_tile(float (&out)[DMAX], const float (&w)[JPL],
                                               const float* tile, int n, int d, int ld,
                                               int lane) {
#pragma unroll
  for (int c = 0; c < DMAX; ++c) out[c] = 0.f;
#pragma unroll
  for (int t = 0; t < JPL; ++t) {
    const int j = lane + 32 * t;
    if (j < n) {
#pragma unroll
      for (int c = 0; c < DMAX; ++c) {
        if (c < d) out[c] = fmaf(w[t], tile[j * ld + c], out[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < DMAX; ++c) {
    if (c < d) out[c] = warp_sum(out[c]);
  }
}

// Lane c (< d) writes out[c] * scale to dst[c].
template <typename T, int DMAX>
__device__ __forceinline__ void write_row(T* __restrict__ dst, const float (&out)[DMAX], int d,
                                          float scale, int lane) {
  float mine = 0.f;
#pragma unroll
  for (int c = 0; c < DMAX; ++c) {
    if (c == lane) mine = out[c];
  }
  if (lane < d) dst[lane] = from_f<T>(mine * scale);
}

template <int DMAX>
__device__ __forceinline__ void load_row(float (&r)[DMAX], const float* tile, int i, int d,
                                         int ld) {
#pragma unroll
  for (int c = 0; c < DMAX; ++c) r[c] = c < d ? tile[i * ld + c] : 0.f;
}

template <typename T, int JPL, int DMAX>
__global__ void __launch_bounds__(kFwdThreads)
    window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ mask, T* __restrict__ o, int heads, int n,
                           int d, int nw_mask, float scale) {
  extern __shared__ float smem[];
  const int ld = d | 1;
  float* sq = smem;
  float* sk = sq + n * ld;
  float* sv = sk + n * ld;

  const int w = blockIdx.x / heads;
  const int h = blockIdx.x - w * heads;
  const size_t base = ((size_t)w * heads + h) * (size_t)n * d;
  load_tile<T>(sq, q + base, n, d, ld, scale);
  load_tile<T>(sk, k + base, n, d, ld, 1.f);
  load_tile<T>(sv, v + base, n, d, ld, 1.f);
  __syncthreads();

  const float* bias_h = bias + (size_t)h * n * n;
  const float* mask_w = mask != nullptr ? mask + (size_t)(w % nw_mask) * n * n : nullptr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = warp; i < n; i += nwarps) {
    float qi[DMAX];
    load_row<DMAX>(qi, sq, i, d, ld);
    float s[JPL];
    const float mx = row_scores<JPL, DMAX>(s, qi, sk, bias_h + (size_t)i * n,
                                           mask_w != nullptr ? mask_w + (size_t)i * n : nullptr,
                                           n, d, ld, lane);
    row_softmax<JPL>(s, mx);
    float out[DMAX];
    row_times_tile<JPL, DMAX>(out, s, sv, n, d, ld, lane);
    write_row<T, DMAX>(o + base + (size_t)i * d, out, d, 1.f, lane);
  }
}

template <typename T, int JPL, int DMAX>
__global__ void __launch_bounds__(kBwdThreads)
    window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ mask, const T* __restrict__ dout,
                           T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ dbias_part, int bn, int heads, int n, int d,
                           int nw_mask, int group, float scale) {
  extern __shared__ float smem[];
  const int ld = d | 1;
  float* sq = smem;            // q * scale
  float* sk = sq + n * ld;
  float* sv = sk + n * ld;
  float* sdo = sv + n * ld;
  float* tile = sdo + n * ld;  // n x n: ds, then p
  float* sdb = tile + n * n;   // n x n: this block's sum of ds

  const int g = blockIdx.x / heads;
  const int h = blockIdx.x - g * heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* bias_h = bias + (size_t)h * n * n;

  for (int e = threadIdx.x; e < n * n; e += blockDim.x) sdb[e] = 0.f;

  const int w_end = min(bn, (g + 1) * group);
  for (int w = g * group; w < w_end; ++w) {
    const size_t base = ((size_t)w * heads + h) * (size_t)n * d;
    const float* mask_w = mask != nullptr ? mask + (size_t)(w % nw_mask) * n * n : nullptr;
    load_tile<T>(sq, q + base, n, d, ld, scale);
    load_tile<T>(sk, k + base, n, d, ld, 1.f);
    load_tile<T>(sv, v + base, n, d, ld, 1.f);
    load_tile<T>(sdo, dout + base, n, d, ld, 1.f);
    __syncthreads();

    // pass 1: p, ds, dq per row; ds into the tile and the dbias sum
    for (int i = warp; i < n; i += nwarps) {
      float qi[DMAX];
      load_row<DMAX>(qi, sq, i, d, ld);
      float p[JPL];
      const float* mrow = mask_w != nullptr ? mask_w + (size_t)i * n : nullptr;
      const float mx = row_scores<JPL, DMAX>(p, qi, sk, bias_h + (size_t)i * n, mrow, n, d, ld,
                                             lane);
      row_softmax<JPL>(p, mx);
      float doi[DMAX];
      load_row<DMAX>(doi, sdo, i, d, ld);
      float dp[JPL];
      float delta = 0.f;
#pragma unroll
      for (int t = 0; t < JPL; ++t) {
        const int j = lane + 32 * t;
        float acc = 0.f;
        if (j < n) {
#pragma unroll
          for (int c = 0; c < DMAX; ++c) {
            if (c < d) acc = fmaf(doi[c], sv[j * ld + c], acc);
          }
        }
        dp[t] = acc;
        delta = fmaf(acc, p[t], delta);
      }
      delta = warp_sum(delta);
      float ds[JPL];
#pragma unroll
      for (int t = 0; t < JPL; ++t) {
        const int j = lane + 32 * t;
        ds[t] = p[t] * (dp[t] - delta);
        if (j < n) {
          tile[i * n + j] = ds[t];
          sdb[i * n + j] += ds[t];
        }
      }
      float out[DMAX];
      row_times_tile<JPL, DMAX>(out, ds, sk, n, d, ld, lane);
      write_row<T, DMAX>(dq + base + (size_t)i * d, out, d, scale, lane);
    }
    __syncthreads();

    // pass 2: dk[j][c] = sum_i ds[i][j] * (q*scale)[i][c]
    for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
      const int j = e / d;
      const int c = e - j * d;
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc = fmaf(tile[i * n + j], sq[i * ld + c], acc);
      dk[base + e] = from_f<T>(acc);
    }
    __syncthreads();

    // pass 3: p back into the tile
    for (int i = warp; i < n; i += nwarps) {
      float qi[DMAX];
      load_row<DMAX>(qi, sq, i, d, ld);
      float p[JPL];
      const float* mrow = mask_w != nullptr ? mask_w + (size_t)i * n : nullptr;
      const float mx = row_scores<JPL, DMAX>(p, qi, sk, bias_h + (size_t)i * n, mrow, n, d, ld,
                                             lane);
      row_softmax<JPL>(p, mx);
#pragma unroll
      for (int t = 0; t < JPL; ++t) {
        const int j = lane + 32 * t;
        if (j < n) tile[i * n + j] = p[t];
      }
    }
    __syncthreads();

    // pass 4: dv[j][c] = sum_i p[i][j] * dO[i][c]
    for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
      const int j = e / d;
      const int c = e - j * d;
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc = fmaf(tile[i * n + j], sdo[i * ld + c], acc);
      dv[base + e] = from_f<T>(acc);
    }
    __syncthreads();  // the next window overwrites the tiles
  }

  float* part = dbias_part + ((size_t)g * heads + h) * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) part[e] = sdb[e];
}

// dbias[e] = sum over groups, in group order, of part[g][e].
__global__ void __launch_bounds__(kReduceThreads)
    dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias, int groups,
                        int entries) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  float acc = 0.f;
  for (int g = 0; g < groups; ++g) acc += part[(size_t)g * entries + e];
  dbias[e] = acc;
}

inline size_t fwd_smem_bytes(int n, int d) { return sizeof(float) * 3 * n * (d | 1); }

inline size_t bwd_smem_bytes(int n, int d) {
  return sizeof(float) * (4 * (size_t)n * (d | 1) + 2 * (size_t)n * n);
}

template <typename T, int JPL, int DMAX>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bias,
                       const float* mask, void* o, int bn, int heads, int n, int d, int nw_mask,
                       float scale, cudaStream_t stream) {
  auto kernel = window_attn_fwd_kernel<T, JPL, DMAX>;
  const size_t smem = fwd_smem_bytes(n, d);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<bn * heads, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(o), heads, n, d, nw_mask, scale);
  return cudaGetLastError();
}

template <typename T, int JPL, int DMAX>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* bias,
                       const float* mask, const void* dout, void* dq, void* dk, void* dv,
                       float* dbias_part, float* dbias, int bn, int heads, int n, int d,
                       int nw_mask, int group, float scale, cudaStream_t stream) {
  auto kernel = window_attn_bwd_kernel<T, JPL, DMAX>;
  const size_t smem = bwd_smem_bytes(n, d);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (bn + group - 1) / group;
  kernel<<<groups * heads, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), dbias_part, bn, heads, n, d, nw_mask, group, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int entries = heads * n * n;
  dbias_reduce_kernel<<<(entries + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                        stream>>>(dbias_part, dbias, groups, entries);
  return cudaGetLastError();
}

// dtype codes shared with the Python wrapper
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

bool shape_ok(int dtype, int bn, int heads, int n, int d, int nw_mask) {
  return dtype >= kF32 && dtype <= kF16 && bn > 0 && heads > 0 && n > 0 && n <= 128 && d > 0 &&
         d <= 32 && nw_mask > 0;
}

// Picks the instantiation: keys per lane (n <= 32, 64, 128) x head-dim cap.
#define WINDOW_ATTN_SIZES(T, LAUNCH, ...)                                   \
  do {                                                                      \
    if (d <= 16) {                                                          \
      if (n <= 32) return LAUNCH<T, 1, 16>(__VA_ARGS__);                    \
      if (n <= 64) return LAUNCH<T, 2, 16>(__VA_ARGS__);                    \
      return LAUNCH<T, 4, 16>(__VA_ARGS__);                                 \
    }                                                                       \
    if (n <= 32) return LAUNCH<T, 1, 32>(__VA_ARGS__);                      \
    if (n <= 64) return LAUNCH<T, 2, 32>(__VA_ARGS__);                      \
    return LAUNCH<T, 4, 32>(__VA_ARGS__);                                   \
  } while (0)

#define WINDOW_ATTN_DISPATCH(LAUNCH, ...)                                   \
  do {                                                                      \
    if (dtype == kF32) WINDOW_ATTN_SIZES(float, LAUNCH, __VA_ARGS__);       \
    if (dtype == kBF16) WINDOW_ATTN_SIZES(__nv_bfloat16, LAUNCH, __VA_ARGS__); \
    WINDOW_ATTN_SIZES(__half, LAUNCH, __VA_ARGS__);                         \
  } while (0)

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 means the launch was accepted.
int window_attn_forward(int dtype, const void* q, const void* k, const void* v,
                        const float* bias, const float* mask, void* o, int bn, int heads, int n,
                        int d, int nw_mask, float scale, void* stream) {
  if (!shape_ok(dtype, bn, heads, n, d, nw_mask)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_ATTN_DISPATCH((int)launch_fwd, q, k, v, bias, mask, o, bn, heads, n, d, nw_mask, scale,
                       st);
}

int window_attn_backward(int dtype, const void* q, const void* k, const void* v,
                         const float* bias, const float* mask, const void* dout, void* dq,
                         void* dk, void* dv, float* dbias_part, float* dbias, int bn, int heads,
                         int n, int d, int nw_mask, int group, float scale, void* stream) {
  if (!shape_ok(dtype, bn, heads, n, d, nw_mask) || group <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_ATTN_DISPATCH((int)launch_bwd, q, k, v, bias, mask, dout, dq, dk, dv, dbias_part,
                       dbias, bn, heads, n, d, nw_mask, group, scale, st);
}

const char* window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
