// Flash attention for causal language models on Hopper (sm_90a): forward,
// dq and dk/dv, with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernels of pytorch_distributedtraining_tpu/ops/
// pallas_attn.py: `_fwd_kernel` (K3), `_dq_kernel` (K4) and `_dkv_kernel`
// (K5), the FlashAttention-2 scheme:
//
//   K3: o = softmax(scale*q.k^T [causal]).v, lse = m + log(l) per row
//   K4: p = exp(scale*q.k^T - lse); ds = p*(dO.v^T - delta); dq = scale*ds.k
//   K5: dv = p^T.dO; dk = scale*ds^T.q
//
// with delta = rowsum(dO*O) computed by the caller (a plain torch op, as
// the JAX package leaves it to XLA). Scores, statistics and accumulators
// are f32; inputs f32, bf16 or f16, outputs in the input's type, lse f32.
//
// Layouts: q/k/v [B, T, H, D] read through strides (batch, time, head;
// the last dimension contiguous), shared by all three, so q/k/v can be
// views of a fused [B, T, 3*H*D] projection without copies. o, dO, dq, dk
// and dv are contiguous [B, T, H, D]; lse and delta contiguous [B, H, T]
// f32. D is 16, 32 or 64.
//
// Bound on an H100 SXM at GPT-2 125M's shape (B 8, T 512, H 12, D 64,
// bf16, causal): each q/k/v/o/dO tensor is 6.29 MB, so K3 moves ~25 MB
// (~7.5 us at 3.35 TB/s), K4 ~32 MB and K5 ~38 MB; the causal products
// are ~3.2 GFLOP (K3) to ~6.5 GFLOP (K5), ~3-7 us at the bf16 tensor-core
// rate. These first kernels run their products on the FP32 CUDA cores
// (67 TFLOP/s), where the FMAs alone need ~50-100 us; they measure several
// times that (PERF.md). With 143-208 registers a thread only three blocks
// of 128 threads fit on an SM, and each score waits on a shuffle and an
// exp, so latency with few warps in flight is the likely limit.
//
// Design (simple and right first; tensor cores, TMA and larger tiles are
// later work):
// - One block per (query tile of 64 rows, head, batch) for K3 and K4, and
//   per (key tile of 64 rows, head, batch) for K5. For D = 64 two threads
//   share a row, each owning 32 columns (lanes l and l+16 of a warp, one
//   shuffle to add the halves of a dot product); for D <= 32 one thread
//   owns a row. A thread keeps its row of q (K3, K4) or k and v (K5) and
//   its accumulators in registers.
// - The streamed operand (K/V for K3 and K4, Q/dO with their lse and delta
//   for K5) is staged 64 rows at a time in shared memory as f32. All lanes
//   of a warp read the same streamed row at once, so the reads are
//   broadcasts (float4, no bank conflicts), four FMAs per load.
// - K3's online softmax rescales once per chunk of 16 keys, not per key.
// - Causal skipping: K3 and K4 stop at the last key tile that reaches the
//   block's last query row; K5 starts at the query tile of its first key.
//   The TPU kernels run one masked tile past the diagonal; these do not.
//   Inside a diagonal tile the mask is per element.
// - Deterministic: K4 owns dq rows and K5 owns dk/dv rows, so no atomics.
// - The wrapper keeps the JAX block rule (bq and bk must divide T); these
//   kernels tile by their own 64-row tiles, which changes only the order
//   of the f32 sums. Rows and keys past T are masked, so any T works.
//
// Resources at D = 64 (ptxas of CUDA 12.8, sm_90a, -O3; the same for f32,
// bf16 and f16): K3 143, K4 166 and K5 208 registers a thread, no spills;
// dynamic shared memory 32 KB (K3, K4) and 32.5 KB (K5) a block, under the
// 48 KB that needs no opt-in. chip_smoke.py's build phase prints them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;   // query rows (K3, K4) or key rows (K5) per block
constexpr int kTile = 64;   // streamed rows per shared-memory stage
constexpr int kChunk = 16;  // K3: keys per online-softmax rescale

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

// How the threads of a block split rows of width D.
template <int D>
struct Split {
  static constexpr int kParts = D > 32 ? D / 32 : 1;  // threads per row
  static constexpr int kCols = D / kParts;            // columns per thread
  static constexpr int kRowsPerWarp = 32 / kParts;
  static constexpr int kThreads = kRows * kParts;
};

// This thread's row in the block's tile and its first column.
template <int D>
__device__ __forceinline__ void my_row(int& row, int& col0) {
  using S = Split<D>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  row = warp * S::kRowsPerWarp + lane % S::kRowsPerWarp;
  col0 = (lane / S::kRowsPerWarp) * S::kCols;
}

// Adds the partial sums of the threads that share a row (lanes l, l+16).
template <int D>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = Split<D>::kRowsPerWarp; o < 32; o <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

// a . b over N columns; b is 16-byte aligned shared memory.
template <int N>
__device__ __forceinline__ float dot(const float (&a)[N], const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 x = b4[i];
    s0 = fmaf(a[4 * i], x.x, s0);
    s1 = fmaf(a[4 * i + 1], x.y, s1);
    s2 = fmaf(a[4 * i + 2], x.z, s2);
    s3 = fmaf(a[4 * i + 3], x.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// acc += w * b over N columns; b as in dot.
template <int N>
__device__ __forceinline__ void axpy(float (&acc)[N], float w, const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 x = b4[i];
    acc[4 * i] = fmaf(w, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const T* __restrict__ src,
                                         float scale) {
#pragma unroll
  for (int c = 0; c < N; ++c) dst[c] = to_f<T>(src[c]) * scale;
}

template <typename T, int N>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const float (&src)[N],
                                          float scale) {
#pragma unroll
  for (int c = 0; c < N; ++c) dst[c] = from_f<T>(src[c] * scale);
}

// Rows r0 .. r0+kTile-1 of a [T, D] matrix whose row t starts at
// src + t*stride -> f32 shared [kTile][D]; rows at or past T are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long stride, int r0, int t_len) {
  for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e - r * D;
    const int t = r0 + r;
    dst[e] = t < t_len ? to_f<T>(src[(long long)t * stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::kThreads)
    flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          int t_len, int heads, long long sb, long long st, long long sh,
                          int causal, float scale) {
  using S = Split<D>;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + kTile * D;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  int r, c0;
  my_row<D>(r, c0);
  const int i = q0 + r;                // this thread's query row
  const int ic = min(i, t_len - 1);    // rows past T compute on and are dropped
  const long long base = (long long)b * sb + (long long)h * sh;

  float qr[S::kCols];
  load_row<T, S::kCols>(qr, q + base + (long long)ic * st + c0, scale);
  float acc[S::kCols];
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) acc[c] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  const int kend = causal ? min(t_len, q0 + kRows) : t_len;
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T, D>(sk, k + base, st, j0, t_len);
    load_tile<T, D>(sv, v + base, st, j0, t_len);
    __syncthreads();
    const int jn = min(kTile, kend - j0);
    for (int jc = 0; jc < jn; jc += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = jc + u;
        const float x = row_sum<D>(dot<S::kCols>(qr, sk + j * D + c0));
        const bool ok = j < jn && (!causal || j0 + j <= i);
        s[u] = ok ? x : -INFINITY;
        cmax = fmaxf(cmax, s[u]);
      }
      const float m_new = fmaxf(m, cmax);
      // m = -inf only before the row's first key: acc and l are 0 then
      const float corr = m == -INFINITY ? 0.f : expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < S::kCols; ++c) acc[c] *= corr;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float p = s[u] == -INFINITY ? 0.f : expf(s[u] - m_new);
        l += p;
        axpy<S::kCols>(acc, p, sv + (jc + u) * D + c0);
      }
      m = m_new;
    }
  }

  if (i < t_len) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* orow = o + (((long long)b * t_len + i) * heads + h) * D + c0;
#pragma unroll
    for (int c = 0; c < S::kCols; ++c) orow[c] = from_f<T>(acc[c] / l_safe);
    if (c0 == 0) lse[((long long)b * heads + h) * t_len + i] = m + logf(l_safe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::kThreads)
    flash_attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, int t_len, int heads, long long sb, long long st,
                         long long sh, int causal, float scale) {
  using S = Split<D>;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + kTile * D;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  int r, c0;
  my_row<D>(r, c0);
  const int i = q0 + r;
  const int ic = min(i, t_len - 1);
  const long long base = (long long)b * sb + (long long)h * sh;
  const long long row = ((long long)b * t_len + ic) * heads + h;  // [B, T, H] index
  const long long stat = ((long long)b * heads + h) * t_len + ic;  // [B, H, T] index

  float qr[S::kCols];
  float dor[S::kCols];
  load_row<T, S::kCols>(qr, q + base + (long long)ic * st + c0, 1.f);
  load_row<T, S::kCols>(dor, dout + row * D + c0, 1.f);
  const float lse_i = lse[stat];
  const float delta_i = delta[stat];
  float acc[S::kCols];
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) acc[c] = 0.f;

  const int kend = causal ? min(t_len, q0 + kRows) : t_len;
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();
    load_tile<T, D>(sk, k + base, st, j0, t_len);
    load_tile<T, D>(sv, v + base, st, j0, t_len);
    __syncthreads();
    const int jn = min(kTile, kend - j0);
    for (int j = 0; j < jn; ++j) {
      const float* kj = sk + j * D + c0;
      const float s = row_sum<D>(dot<S::kCols>(qr, kj));
      const float dp = row_sum<D>(dot<S::kCols>(dor, sv + j * D + c0));
      const bool ok = !causal || j0 + j <= i;
      const float p = ok ? expf(scale * s - lse_i) : 0.f;
      axpy<S::kCols>(acc, p * (dp - delta_i), kj);
    }
  }

  if (i < t_len) store_row<T, S::kCols>(dq + row * D + c0, acc, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::kThreads)
    flash_attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int t_len, int heads,
                          long long sb, long long st, long long sh, int causal, float scale) {
  using S = Split<D>;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + kTile * D;
  float* slse = sdo + kTile * D;
  float* sdelta = slse + kTile;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kRows;
  int r, c0;
  my_row<D>(r, c0);
  const int j = k0 + r;  // this thread's key row
  const int jc = min(j, t_len - 1);
  const long long base = (long long)b * sb + (long long)h * sh;
  const T* dout_bh = dout + ((long long)b * t_len * heads + h) * D;
  const float* lse_bh = lse + ((long long)b * heads + h) * t_len;
  const float* delta_bh = delta + ((long long)b * heads + h) * t_len;

  float kr[S::kCols];
  float vr[S::kCols];
  load_row<T, S::kCols>(kr, k + base + (long long)jc * st + c0, 1.f);
  load_row<T, S::kCols>(vr, v + base + (long long)jc * st + c0, 1.f);
  float dk_acc[S::kCols];
  float dv_acc[S::kCols];
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) {
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  // causal: queries before this tile's first key never attend it
  for (int i0 = causal ? k0 : 0; i0 < t_len; i0 += kTile) {
    __syncthreads();
    load_tile<T, D>(sq, q + base, st, i0, t_len);
    load_tile<T, D>(sdo, dout_bh, (long long)heads * D, i0, t_len);
    for (int e = threadIdx.x; e < kTile; e += blockDim.x) {
      const int t = i0 + e;
      slse[e] = t < t_len ? lse_bh[t] : 0.f;
      sdelta[e] = t < t_len ? delta_bh[t] : 0.f;
    }
    __syncthreads();
    const int in = min(kTile, t_len - i0);
    for (int ii = 0; ii < in; ++ii) {
      const float* qi = sq + ii * D + c0;
      const float* doi = sdo + ii * D + c0;
      const float s = row_sum<D>(dot<S::kCols>(kr, qi));
      const float dp = row_sum<D>(dot<S::kCols>(vr, doi));
      const bool ok = !causal || j <= i0 + ii;
      const float p = ok ? expf(scale * s - slse[ii]) : 0.f;
      axpy<S::kCols>(dv_acc, p, doi);
      axpy<S::kCols>(dk_acc, p * (dp - sdelta[ii]), qi);
    }
  }

  if (j < t_len) {
    const long long row = (((long long)b * t_len + j) * heads + h) * D + c0;
    store_row<T, S::kCols>(dk + row, dk_acc, scale);
    store_row<T, S::kCols>(dv + row, dv_acc, 1.f);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;  // o (K3), dq (K4), dk (K5)
  void* out1;  // dv (K5)
  float* lse_out;
  int batch, t_len, heads;
  long long sb, st, sh;
  int causal;
  float scale;
  cudaStream_t stream;
};

enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
cudaError_t launch(int which, const Args& a) {
  using S = Split<D>;
  const dim3 grid((a.t_len + kRows - 1) / kRows, a.heads, a.batch);
  const size_t tiles = 2 * kTile * D * sizeof(float);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (which == kFwd) {
    flash_attn_fwd_kernel<T, D><<<grid, S::kThreads, tiles, a.stream>>>(
        q, k, v, static_cast<T*>(a.out0), a.lse_out, a.t_len, a.heads, a.sb, a.st, a.sh,
        a.causal, a.scale);
  } else if (which == kDq) {
    flash_attn_dq_kernel<T, D><<<grid, S::kThreads, tiles, a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.out0), a.t_len, a.heads, a.sb,
        a.st, a.sh, a.causal, a.scale);
  } else {
    flash_attn_dkv_kernel<T, D><<<grid, S::kThreads, tiles + 2 * kTile * sizeof(float),
                                  a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1),
        a.t_len, a.heads, a.sb, a.st, a.sh, a.causal, a.scale);
  }
  return cudaGetLastError();
}

// dtype codes shared with the Python wrapper
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
cudaError_t launch_d(int which, int d, const Args& a) {
  if (d == 16) return launch<T, 16>(which, a);
  if (d == 32) return launch<T, 32>(which, a);
  return launch<T, 64>(which, a);
}

int dispatch(int which, int dtype, int d, const Args& a) {
  if (dtype < kF32 || dtype > kF16 || (d != 16 && d != 32 && d != 64) || a.batch <= 0 ||
      a.t_len <= 0 || a.heads <= 0 || a.batch > 65535 || a.heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kF32) return (int)launch_d<float>(which, d, a);
  if (dtype == kBF16) return (int)launch_d<__nv_bfloat16>(which, d, a);
  return (int)launch_d<__half>(which, d, a);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code; 0 means the launch was accepted.
// Strides (in elements) are q/k/v's batch, time and head strides.

int flash_attn_forward(int dtype, const void* q, const void* k, const void* v, void* o,
                       float* lse, int batch, int t_len, int heads, int d, long long sb,
                       long long st, long long sh, int causal, float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, batch, t_len, heads,
               sb, st, sh, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, dtype, d, a);
}

int flash_attn_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int batch, int t_len,
                  int heads, int d, long long sb, long long st, long long sh, int causal,
                  float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch, t_len, heads,
               sb, st, sh, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, dtype, d, a);
}

int flash_attn_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int batch,
                   int t_len, int heads, int d, long long sb, long long st, long long sh,
                   int causal, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, batch, t_len, heads,
               sb, st, sh, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(kDkv, dtype, d, a);
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
