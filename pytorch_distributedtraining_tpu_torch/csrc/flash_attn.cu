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
// rate. In f32, K3's 3.2 GFLOP take 19.6 us as 3xTF32 (three TF32
// products per product at 495 TFLOP/s) and its 50.5 MB 15.1 us; K4's 4.8
// GFLOP 29.3 us and its 63.3 MB 18.9 us; K5's 6.5 GFLOP 39.1 us and its
// 75.9 MB 22.7 us. At T = 512 neither bound is what sets the pace: a
// block streams at most eight 64-row tiles, so load latency, register
// pressure, instruction throughput and the warps in flight do.
//
// One kind of body for every kernel and type: FlashAttention-2 on the
// tensor cores, `mma.sync` with f32 accumulate, m16n8k16 for bf16/f16 and
// 3xTF32 on m16n8k8 for f32. A block holds 64 rows (query rows for K3 and
// K4, key rows for K5) in 4 warps of 16 rows. The resident operands (Q
// for K3; Q and dO for K4; K and V for K5) are loaded once into registers
// (`ldmatrix` in bf16/f16; in f32 K3's Q and K4's dO are split into tf32
// hi/lo fragments once a block, K4's Q and K5's K and V are kept raw and
// split at each use, which keeps their registers in bounds). The streamed
// 64-row tiles (K/V for K3 and K4; Q/dO with their lse and delta for K5)
// are staged in the input's type by 16-byte `cp.async` copies,
// double-buffered, zero-filled past T, in rows padded by 16 bytes (a row
// stride of 4 x odd words) so that `ldmatrix` and the tf32 fragment loads
// are free of bank conflicts. K3 keeps the online softmax in the
// accumulator fragments (a row's max and sum take two shuffles within its
// quad once per 64-key tile; exp2 with log2(e) folded into the scale) and
// feeds P straight from the score fragments into P.V as the A operand: in
// bf16/f16 converted pairwise, with V read by `ldmatrix.trans`; in f32
// under a permuted k index (slot tq is key 2tq, slot tq+4 key 2tq+1,
// which the sum over keys does not see), with V's rows read in that
// order. K4 computes S = Q.K^T and dP = dO.V^T, 16 keys at a time, P and
// dS in the accumulator fragments (lse and delta of a thread's two rows
// in registers, log2(e) folded into lse and the scale), then dQ += dS.K
// with dS from the C fragments as the A operand and K read by
// `ldmatrix.trans` (in f32 under K3's permuted k index, at rows 2tq and
// 2tq+1). K5 computes S^T = K.Q^T and dP^T = V.dO^T, P^T and dS^T in
// registers, then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T from
// the C fragments and Q and dO read as K4 reads K, 16 queries at a time
// to keep the registers in bounds. In f32, K4 and K5 sum each 16-row
// chunk's terms of their long sums (dQ over keys; dK and dV over queries)
// in a fresh fragment added in f32, because the tensor core truncates
// each sum it accumulates. The products live in `Fwd<T, D>`, `Dq<T, D>`
// and `Dkv<T, D>` (the f32 ones of K4 and K5 share `Tf32<D>`), so that
// each kernel has one skeleton for every type. Everything after the
// staging is warp-local. In bf16/f16 P and dS are rounded to the input's
// type before their second product (the JAX kernels keep them in f32):
// one step of the type at the largest entries (PERF.md). In f32 every
// operand, P and dS included, enters as x = hi + lo in tf32 and a.b =
// hi.hi + hi.lo + lo.hi in f32, about 1e-6 relative: plain TF32 (about
// 1e-3) would miss the f32 tolerance.
//
// Causal skipping: K3 and K4 stop at the last key tile that reaches the
// block's last query row, K5 starts at the query tile of its first key;
// the per-element mask runs only on the tile that crosses the diagonal or
// T, and there K4 and K5 skip the 16-row chunks that the mask covers
// whole. The grid is tile-major, (heads * batch, tiles), with the tiles
// that have the most causal work first (K3's and K4's last query tiles,
// K5's first key tiles): the card then starts every (batch, head)'s
// longest block before any short one, and the short ones fill the last
// wave; at GPT-2's shape that is faster than the (tiles, heads, batch)
// order of the first CUDA-core bodies (PERF.md). Deterministic: K4 owns dq
// rows and K5 owns dk/dv rows, no atomics. The wrapper keeps the JAX
// block rule (bq and bk divide T); these kernels tile by their own 64
// rows, which changes only the order of the f32 sums. Every q/k/v/dO row
// must be 16-byte aligned (cp.async); the wrapper guarantees it and the
// library refuses otherwise. Nothing falls back: a launch runs its body
// or returns the CUDA error.
//
// Out of scope here, for a later PR: wgmma, TMA and warp specialisation
// (at T = 512 these kernels are latency-bound, not FLOP-bound).
//
// Resources at D = 64 (ptxas of CUDA 12.8, sm_90a, -O3), no spills
// anywhere: K3 128 registers a thread in bf16/f16 and 227 in f32, K4 128
// and 249 (96 and 128 at D = 16 and 32), K5 167 and 255 (93 and 128),
// with 36 KB (K3, K4) and 37 KB (K5) of dynamic shared memory a block in
// bf16/f16, 69 632 B (K3, K4) and 70 656 B (K5) in f32 (above the 48 KB
// that needs no opt-in: the launch opts in). Two blocks a SM for every f32
// body (registers). chip_smoke.py's build phase prints every kernel's
// registers and spills with the HMMA instructions in its SASS (at D = 64:
// 64 in bf16/f16 K3, 96 in K4 and 128 in K5, the unrolled m16n8k16
// products; in f32 three m16n8k8 products for each product: 384 in K3
// (S's 64 and P.V's 64), 576 in K4 (the 64 of S, dP and dQ a 64-key tile;
// 144 and 288 at D = 16 and 32), 768 in K5 (the 64 of S^T, dP^T, dV and
// dK a 64-query tile; 192 and 384 at D = 16 and 32)), and fails if a
// kernel spills or a body has no HMMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows (K3, K4) or key rows (K5) per block
constexpr int kTile = 64;      // streamed rows per shared-memory stage
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kPadBytes = 16;  // padding per shared-memory row
constexpr size_t kNoOptInSmem = 48 * 1024;  // dynamic smem a block gets without opting in
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

// A stage tile: kTile rows of D elements in T, padded by 16 bytes (8
// bf16/f16 or 4 f32 elements: a row stride of 4 x odd words, so that
// ldmatrix and the tf32 fragment loads are free of bank conflicts).
template <typename T, int D>
struct Tiles {
  static constexpr int kStride = D + kPadBytes / (int)sizeof(T);  // elements
  static constexpr int kTileElems = kTile * kStride;
};

// The dynamic shared memory kernel K takes at (type, head dim): two stages
// of two tiles (K/V for K3 and K4, Q/dO for K5), K5 adding the stages'
// lse/delta. At D = 64, 36 KB (K3, K4) and 37 KB (K5) in bf16/f16, 69 632
// B (K3, K4) and 70 656 B (K5) in f32, above the 48 KB a launch gets
// without opting in.
template <typename T, int D, int K>
constexpr size_t kSmemBytes =
    4 * Tiles<T, D>::kTileElems * sizeof(T) + (K == kDkv ? 4 * kTile * sizeof(float) : 0);

// ---------------------------------------------------------------------------
// Fragments of mma.m16n8k16 for lane = 4*g + tq (g = lane/4, tq = lane%4):
// A (16x16, row-major) a0 = (g, 2tq..2tq+1), a1 = (g+8, same), a2 = (g,
// 2tq+8..), a3 = (g+8, 2tq+8..); B (16x8) b0 = (k 2tq..2tq+1, n g), b1 =
// (k 2tq+8.., n g); C (16x8 f32) c0,c1 = (g, 2tq..2tq+1), c2,c3 = (g+8,
// same). So a C fragment over 16 columns, converted pairwise to 16 bits,
// is an A fragment over the same 16 columns.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, or 4 zero bytes where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 16-bit matrices; lanes 8m..8m+7 give the row addresses of
// matrix m, and register m receives its fragment (.trans: transposed).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores, f32 accumulate. Registers only, so not
// volatile: the compiler may schedule it around the (volatile) loads.
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> two 16-bit values in one register, lo in the low half.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 x = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The A fragment (16 rows x 16 columns) of C fragments c[0] (columns 0-7)
// and c[1] (columns 8-15).
template <typename T>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// Two floats -> dst[0], dst[1] in T, one store.
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<T>(a, b);
}

template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// d += a . b in tf32, f32 accumulate (m16n8k8: A 16x8, B 8x8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to tf32, to nearest with ties away (half a
// tf32 step added to the bits, the 13 low bits cleared: what `cvt.rna.
// tf32.f32` gives for finite x, in two integer instructions where cvt.rna
// compiles to a compare-and-select chain on sm_90); lo = x - hi, exact in
// f32, which the tensor core reads truncated to tf32 (as CUTLASS's
// fast-accurate 3xTF32 rounds its small part toward zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b as 3xTF32: the small terms first, then hi . hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// Rows r0 .. r0+kTile-1 of a [T, D] matrix whose row t starts at
// src + t*stride -> shared [kTile][Tiles::kStride] in T by cp.async; rows
// at or past T are zero.
template <typename T, int D>
__device__ __forceinline__ void tile_async(T* dst, const T* __restrict__ src, long long stride,
                                           int r0, int t_len) {
  constexpr int kElems = 16 / (int)sizeof(T);  // elements a 16-byte piece
  constexpr int kPieces = D / kElems;           // pieces a row
  constexpr int kPer = kTile * kPieces / kThreads;
  static_assert(kPer * kThreads == kTile * kPieces, "pieces must split evenly");
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int r = e / kPieces;
    const int c = e - r * kPieces;
    const int t = r0 + r;
    const bool ok = t < t_len;
    cp_async16(dst + r * Tiles<T, D>::kStride + c * kElems,
               src + (long long)(ok ? t : 0) * stride + c * kElems, ok);
  }
}

// Row offset of lane's ldmatrix address for an A fragment (16x16 at row 0,
// column 0): matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15), column-major.
template <typename T, int D>
__device__ __forceinline__ int a_offset(int lane) {
  return (lane & 15) * Tiles<T, D>::kStride + (lane >> 4) * 8;
}

// ... for two B fragments (n-blocks 0-7 and 8-15 of 16 rows, k = columns
// 0-15) of a matrix stored [n][k]: matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
// (n 8-15, k 0-7), (n 8-15, k 8-15).
template <typename T, int D>
__device__ __forceinline__ int b_offset(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * Tiles<T, D>::kStride + ((lane >> 3) & 1) * 8;
}

// ... for two B fragments (n = columns 0-7 and 8-15, k = rows 0-15) of a
// matrix stored [k][n], read with .trans: matrices (k 0-7, n 0-7), (k 8-15,
// n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
template <typename T, int D>
__device__ __forceinline__ int bt_offset(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * Tiles<T, D>::kStride + (lane >> 4) * 8;
}

// K3's products for one warp's 16 query rows against one 64-key tile:
// - load_q: Q's A fragments from the stage tile at the warp's first row;
// - scores: s[kb] += Q . K[8kb .. 8kb+7]^T, the tile's 8-key blocks;
// - pv: acc += P . V with P straight from the C fragments s.
// 16-bit types: m16n8k16 from ldmatrix, P converted pairwise in registers.
template <typename T, int D>
struct Fwd {
  using B = Tiles<T, D>;
  static constexpr int kKS = D / 16;  // 16-wide steps over the head dim
  static constexpr int kNB = D / 8;   // 8-wide blocks of the head dim
  struct QFrag {
    uint32_t r[kKS][4];
  };

  static __device__ __forceinline__ void load_q(QFrag& f, const T* qs, int lane) {
    const T* p = qs + a_offset<T, D>(lane);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) ldsm_x4(f.r[ks], p + ks * 16);
  }

  static __device__ __forceinline__ void scores(float (&s)[kTile / 8][4], const QFrag& f,
                                                const T* ks_tile, int lane) {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int kb = 0; kb < kTile / 16; ++kb) {
        uint32_t kf[4];
        ldsm_x4(kf, ks_tile + kb * 16 * B::kStride + b_offset<T, D>(lane) + ks * 16);
        mma<T>(s[2 * kb], f.r[ks], kf[0], kf[1]);
        mma<T>(s[2 * kb + 1], f.r[ks], kf[2], kf[3]);
      }
    }
  }

  static __device__ __forceinline__ void pv(float (&acc)[kNB][4], const float (&s)[kTile / 8][4],
                                            const T* vs_tile, int lane) {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < kNB / 2; ++nd) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vs_tile + kk * 16 * B::kStride + bt_offset<T, D>(lane) + nd * 16);
        mma<T>(acc[2 * nd], pa, vf[0], vf[1]);
        mma<T>(acc[2 * nd + 1], pa, vf[2], vf[3]);
      }
    }
  }
};

// f32: 3xTF32 on m16n8k8 from plain 32-bit shared loads (the padded row
// stride keeps each fragment's loads on 32 distinct banks). Q is split
// into hi/lo once a block and kept; K, V and P are split where they are
// read. P is not rounded: it enters P.V as hi + lo like any f32 operand.
template <int D>
struct Fwd<float, D> {
  static constexpr int kLd = Tiles<float, D>::kStride;
  static constexpr int kKS = D / 8;  // 8-wide steps over the head dim
  static constexpr int kNB = D / 8;  // 8-wide blocks of the head dim
  struct QFrag {
    uint32_t hi[kKS][4], lo[kKS][4];
  };

  // a0 = (g, tq), a1 = (g+8, tq), a2 = (g, tq+4), a3 = (g+8, tq+4)
  static __device__ __forceinline__ void load_q(QFrag& f, const float* qs, int lane) {
    const float* p = qs + (lane >> 2) * kLd + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      split_tf32(p[ks * 8], f.hi[ks][0], f.lo[ks][0]);
      split_tf32(p[8 * kLd + ks * 8], f.hi[ks][1], f.lo[ks][1]);
      split_tf32(p[ks * 8 + 4], f.hi[ks][2], f.lo[ks][2]);
      split_tf32(p[8 * kLd + ks * 8 + 4], f.hi[ks][3], f.lo[ks][3]);
    }
  }

  // B = K^T: b0 = (k = column tq, n = key g), b1 = (column tq+4, key g)
  static __device__ __forceinline__ void scores(float (&s)[kTile / 8][4], const QFrag& f,
                                                const float* ks_tile, int lane) {
    const float* p = ks_tile + (lane >> 2) * kLd + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int kb = 0; kb < kTile / 8; ++kb) {
        uint32_t bh[2], bl[2];
        split_tf32(p[kb * 8 * kLd + ks * 8], bh[0], bl[0]);
        split_tf32(p[kb * 8 * kLd + ks * 8 + 4], bh[1], bl[1]);
        mma_3xtf32(s[kb], f.hi[ks], f.lo[ks], bh, bl);
      }
    }
  }

  // The C fragment of keys 8kb.. holds keys 2tq and 2tq+1 of rows g and
  // g+8; as an A fragment, k slot tq is key 2tq and slot tq+4 key 2tq+1
  // (a sum over k does not see the order), so B reads V's rows 2tq and
  // 2tq+1 in the same order.
  static __device__ __forceinline__ void pv(float (&acc)[kNB][4],
                                            const float (&s)[kTile / 8][4],
                                            const float* vs_tile, int lane) {
    const int g = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int kb = 0; kb < kTile / 8; ++kb) {
      uint32_t ah[4], al[4];
      split_tf32(s[kb][0], ah[0], al[0]);
      split_tf32(s[kb][2], ah[1], al[1]);
      split_tf32(s[kb][1], ah[2], al[2]);
      split_tf32(s[kb][3], ah[3], al[3]);
      const float* p = vs_tile + (kb * 8 + 2 * tq) * kLd + g;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        uint32_t bh[2], bl[2];
        split_tf32(p[nb * 8], bh[0], bl[0]);
        split_tf32(p[kLd + nb * 8], bh[1], bl[1]);
        mma_3xtf32(acc[nb], ah, al, bh, bl);
      }
    }
  }
};

template <typename T, int D>
__device__ __forceinline__ void fwd_mma(T* smem, const T* __restrict__ q,
                                        const T* __restrict__ k, const T* __restrict__ v,
                                        T* __restrict__ o, float* __restrict__ lse, int t_len,
                                        int heads, long long sb, long long st, long long sh,
                                        int causal, float scale) {
  using B = Tiles<T, D>;
  using F = Fwd<T, D>;
  constexpr int kNB = D / 8;        // 8-wide blocks of the head dim
  constexpr int kKB = kTile / 8;    // 8-wide blocks of a key tile
  // stage s holds K at smem + 2*s*kTileElems and V right after it
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // grid (heads * batch, query tiles), tile-major; causal: the longest
  // rows first, so the last wave is of short blocks
  const int h = blockIdx.x % heads;
  const int b = blockIdx.x / heads;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const long long base = (long long)b * sb + (long long)h * sh;
  const int kend = causal ? min(t_len, q0 + kRows) : t_len;
  const int n_kt = (kend + kTile - 1) / kTile;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  // Q through stage 1 into registers; K/V tile 0 into stage 0
  tile_async<T, D>(smem + 2 * B::kTileElems, q + base, st, q0, t_len);
  tile_async<T, D>(smem, k + base, st, 0, t_len);
  tile_async<T, D>(smem + B::kTileElems, v + base, st, 0, t_len);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  typename F::QFrag qf;
  F::load_q(qf, smem + 2 * B::kTileElems + warp * 16 * B::kStride, lane);
  __syncthreads();  // stage 1 is free

  float acc[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // row max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  const float sl2 = scale * kLog2e;

  for (int jt = 0; jt < n_kt; ++jt) {
    if (jt + 1 < n_kt) {
      T* next = smem + 2 * ((jt + 1) & 1) * B::kTileElems;
      tile_async<T, D>(next, k + base, st, (jt + 1) * kTile, t_len);
      tile_async<T, D>(next + B::kTileElems, v + base, st, (jt + 1) * kTile, t_len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile jt has landed
    __syncthreads();
    const T* ks_tile = smem + 2 * (jt & 1) * B::kTileElems;
    const T* vs_tile = ks_tile + B::kTileElems;
    const int j0 = jt * kTile;

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[kKB][4];
#pragma unroll
    for (int n = 0; n < kKB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
    F::scores(s, qf, ks_tile, lane);
    // scores in log2 units; the per-element mask only on the tile that
    // crosses the diagonal or T
    const bool edge = j0 + kTile > t_len || (causal && j0 + kTile - 1 > q0);
#pragma unroll
    for (int n = 0; n < kKB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int j = j0 + n * 8 + 2 * tq + (e & 1);
          const int i = row0 + (e >> 1) * 8;
          if (j >= t_len || (causal && j > i)) x = -INFINITY;
        }
        s[n][e] = x;
      }
    }
    // online softmax; a quad of lanes shares a row
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < kKB; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // mx = -inf only while a row has seen no key (acc and l are 0 then)
      const float mu = mx == -INFINITY ? 0.f : mx;
      corr[r] = exp2f(m[r] - mu);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kKB; ++n) {
        s[n][2 * r] = exp2f(s[n][2 * r] - mu);
        s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - mu);
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + sum;
    }
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V, P straight from the score fragments
    F::pv(acc, s, vs_tile, lane);
    __syncthreads();  // stage jt & 1 is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int i = row0 + r * 8;
    if (i < t_len) {
      const float l_safe = fmaxf(lr, 1e-30f);
      const float inv = 1.f / l_safe;
      T* orow = o + (((long long)b * t_len + i) * heads + h) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        store2<T>(orow + n * 8, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
      if (tq == 0) lse[((long long)b * heads + h) * t_len + i] = (m[r] + log2f(l_safe)) * kLn2;
    }
  }
}

// Keeps x as it is in a register: the compiler may neither reuse what an
// earlier use computed from it nor hoist that out of a loop.
__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

// f32 products of one warp's 16 rows against a chunk of 16 rows of a stage
// tile, as 3xTF32 on m16n8k8 from plain 32-bit shared loads, on K3's f32
// fragment layouts (the padded row stride keeps every load on 32 banks).
// K4 and K5 share them:
// - the warp's rows are the A operand (Q and dO for K4, K and V for K5):
//   a0 = (g, tq), a1 = (g+8, tq), a2 = (g, tq+4), a3 = (g+8, tq+4);
// - step: s[n] += A . B[8n .. 8n+7]^T, the chunk's rows read as K3 reads
//   K: b0 = (column tq, row g), bank 4g + tq at stride D + 4;
// - grad: acc += C . B over the chunk's rows, C (dS for K4, P^T and dS^T
//   for K5) straight from the C fragments under K3's permuted k index
//   (slot tq is row 2tq of the chunk, slot tq+4 row 2tq+1), so B is read
//   at rows 2tq and 2tq+1 (bank 8tq + g). C is split into hi/lo like any
//   f32 operand, not rounded.
// - A chunk's grad terms are summed in a fresh fragment and added to the
//   accumulators in f32 (round to nearest): the tensor core truncates each
//   sum it accumulates, and over a block's up to 32 chunks, three products
//   each, that biases the result toward zero (PERF.md).
template <int D>
struct Tf32 {
  static constexpr int kLd = Tiles<float, D>::kStride;
  static constexpr int kKS = D / 8;  // 8-wide steps over the head dim
  static constexpr int kNB = D / 8;  // 8-wide blocks of the head dim

  // the A fragments of the 16 rows at t, raw
  static __device__ __forceinline__ void load_a(float (&a)[kKS][4], const float* t, int lane) {
    const float* p = t + (lane >> 2) * kLd + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      a[ks][0] = p[ks * 8];
      a[ks][1] = p[8 * kLd + ks * 8];
      a[ks][2] = p[ks * 8 + 4];
      a[ks][3] = p[8 * kLd + ks * 8 + 4];
    }
  }

  // s[n] += A . B[8n .. 8n+7]^T over the head dim's 8-wide step ks, A as
  // hi/lo fragments; p = bt + g*kLd + tq for the chunk's rows at bt
  static __device__ __forceinline__ void step(float (&s)[2][4], const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4], const float* p, int ks) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32(p[n * 8 * kLd + ks * 8], bh[0], bl[0]);
      split_tf32(p[n * 8 * kLd + ks * 8 + 4], bh[1], bl[1]);
      mma_3xtf32(s[n], ah, al, bh, bl);
    }
  }

  // acc += c . B over the chunk's 16 rows at bt, c as C fragments
  static __device__ __forceinline__ void grad(float (&acc)[kNB][4], const float (&c)[2][4],
                                              const float* bt, int lane) {
    const int g = lane >> 2;
    const int tq = lane & 3;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      split_tf32(c[kb][0], ah[kb][0], al[kb][0]);
      split_tf32(c[kb][2], ah[kb][1], al[kb][1]);
      split_tf32(c[kb][1], ah[kb][2], al[kb][2]);
      split_tf32(c[kb][3], ah[kb][3], al[kb][3]);
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const float* p = bt + (kb * 8 + 2 * tq) * kLd + nb * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(p[0], bh[0], bl[0]);
        split_tf32(p[kLd], bh[1], bl[1]);
        mma_3xtf32(sum, ah[kb], al[kb], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] += sum[e];
    }
  }
};

// One warp's 16 rows as a resident A operand of Tf32's products, s[n] +=
// A . B[8n .. 8n+7]^T for the chunk's 16 rows at bt: split into hi/lo once
// (kSplit), or held raw and split at each use behind `opaque` (without it
// the compiler hoists the splits out of the loop, as if held split).
template <int D, bool kSplit>
struct Resident;

template <int D>
struct Resident<D, true> {
  using M = Tf32<D>;
  uint32_t hi[M::kKS][4], lo[M::kKS][4];

  __device__ __forceinline__ void load(const float* t, int lane) {
    float a[M::kKS][4];
    M::load_a(a, t, lane);
#pragma unroll
    for (int ks = 0; ks < M::kKS; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[ks][i], hi[ks][i], lo[ks][i]);
    }
  }

  __device__ __forceinline__ void product(float (&s)[2][4], const float* bt, int lane) const {
    const float* p = bt + (lane >> 2) * M::kLd + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < M::kKS; ++ks) M::step(s, hi[ks], lo[ks], p, ks);
  }
};

template <int D>
struct Resident<D, false> {
  using M = Tf32<D>;
  float a[M::kKS][4];

  __device__ __forceinline__ void load(const float* t, int lane) { M::load_a(a, t, lane); }

  __device__ __forceinline__ void product(float (&s)[2][4], const float* bt, int lane) const {
    const float* p = bt + (lane >> 2) * M::kLd + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < M::kKS; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(opaque(a[ks][i]), ah[i], al[i]);
      M::step(s, ah, al, p, ks);
    }
  }
};

// K4's products for one warp's 16 query rows against a chunk of 16 keys
// (kc, vc: the chunk's first K and V rows in the stage):
// - load_qdo: Q's and dO's A fragments from the warp's first rows;
// - scores: s[n] += Q . K[8n .. 8n+7]^T and dp[n] += dO . V[8n ..]^T;
// - grad: acc += dS . K, dS straight from the C fragments ds.
// 16-bit types: m16n8k16 from ldmatrix (K by .trans in grad), dS converted
// pairwise in registers.
template <typename T, int D>
struct Dq {
  static constexpr int kKS = D / 16;  // 16-wide steps over the head dim
  static constexpr int kNB = D / 8;   // 8-wide blocks of the head dim
  struct QdO {
    uint32_t q[kKS][4], dout[kKS][4];
  };

  static __device__ __forceinline__ void load_qdo(QdO& f, const T* qt, const T* dot, int lane) {
    const int off = a_offset<T, D>(lane);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      ldsm_x4(f.q[ks], qt + off + ks * 16);
      ldsm_x4(f.dout[ks], dot + off + ks * 16);
    }
  }

  static __device__ __forceinline__ void scores(float (&s)[2][4], float (&dp)[2][4], const QdO& f,
                                                const T* kc, const T* vc, int lane) {
    const int off = b_offset<T, D>(lane);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, kc + off + ks * 16);
      mma<T>(s[0], f.q[ks], b[0], b[1]);
      mma<T>(s[1], f.q[ks], b[2], b[3]);
      ldsm_x4(b, vc + off + ks * 16);
      mma<T>(dp[0], f.dout[ks], b[0], b[1]);
      mma<T>(dp[1], f.dout[ks], b[2], b[3]);
    }
  }

  static __device__ __forceinline__ void grad(float (&acc)[kNB][4], const float (&ds)[2][4],
                                              const T* kc, int lane) {
    uint32_t da[4];
    to_a<T>(da, ds[0], ds[1]);
    const int off = bt_offset<T, D>(lane);
#pragma unroll
    for (int nd = 0; nd < kNB / 2; ++nd) {
      uint32_t b[4];
      ldsm_x4_t(b, kc + off + nd * 16);
      mma<T>(acc[2 * nd], da, b[0], b[1]);
      mma<T>(acc[2 * nd + 1], da, b[2], b[3]);
    }
  }
};

// f32: Tf32's products, Q and dO the resident A operands. Both held split
// take 128 registers at D = 64 beside dQ's 32, and ptxas spills there;
// both held raw, it spills at D = 16, and every value is split again each
// chunk. So dO is held split and Q raw: 249 registers at D = 64, no spill
// at any D, and faster than either (PERF.md).
template <int D>
struct Dq<float, D> {
  using M = Tf32<D>;
  static constexpr int kNB = M::kNB;
  struct QdO {
    Resident<D, false> q;
    Resident<D, true> dout;
  };

  static __device__ __forceinline__ void load_qdo(QdO& f, const float* qt, const float* dot,
                                                  int lane) {
    f.q.load(qt, lane);
    f.dout.load(dot, lane);
  }

  static __device__ __forceinline__ void scores(float (&s)[2][4], float (&dp)[2][4], const QdO& f,
                                                const float* kc, const float* vc, int lane) {
    f.q.product(s, kc, lane);
    f.dout.product(dp, vc, lane);
  }

  static __device__ __forceinline__ void grad(float (&acc)[kNB][4], const float (&ds)[2][4],
                                              const float* kc, int lane) {
    M::grad(acc, ds, kc, lane);
  }
};

template <typename T, int D>
__device__ __forceinline__ void dq_mma(T* smem, const T* __restrict__ q,
                                       const T* __restrict__ k, const T* __restrict__ v,
                                       const T* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta, T* __restrict__ dq,
                                       int t_len, int heads, long long sb, long long st,
                                       long long sh, int causal, float scale) {
  using B = Tiles<T, D>;
  using P = Dq<T, D>;
  constexpr int kNB = D / 8;
  // stage s holds K at smem + 2*s*kTileElems and V right after it, as in K3
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // grid (heads * batch, query tiles), tile-major; causal: the longest
  // rows first, as in K3
  const int h = blockIdx.x % heads;
  const int b = blockIdx.x / heads;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const long long base = (long long)b * sb + (long long)h * sh;
  const T* dout_bh = dout + ((long long)b * t_len * heads + h) * D;
  const long long stat0 = ((long long)b * heads + h) * t_len;
  const int kend = causal ? min(t_len, q0 + kRows) : t_len;
  const int n_kt = (kend + kTile - 1) / kTile;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  // Q and dO through stage 1 into registers; K/V tile 0 into stage 0
  tile_async<T, D>(smem + 2 * B::kTileElems, q + base, st, q0, t_len);
  tile_async<T, D>(smem + 3 * B::kTileElems, dout_bh, (long long)heads * D, q0, t_len);
  tile_async<T, D>(smem, k + base, st, 0, t_len);
  tile_async<T, D>(smem + B::kTileElems, v + base, st, 0, t_len);
  cp_async_commit();
  // this thread's rows' lse (log2 units) and delta; a row past T takes 0
  // and its dq is dropped
  float lse_l2[2];
  float dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    lse_l2[r] = i < t_len ? lse[stat0 + i] * kLog2e : 0.f;
    dl[r] = i < t_len ? delta[stat0 + i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  typename P::QdO qd;
  P::load_qdo(qd, smem + 2 * B::kTileElems + warp * 16 * B::kStride,
              smem + 3 * B::kTileElems + warp * 16 * B::kStride, lane);
  __syncthreads();  // stage 1 is free

  float acc[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int jt = 0; jt < n_kt; ++jt) {
    if (jt + 1 < n_kt) {
      T* next = smem + 2 * ((jt + 1) & 1) * B::kTileElems;
      tile_async<T, D>(next, k + base, st, (jt + 1) * kTile, t_len);
      tile_async<T, D>(next + B::kTileElems, v + base, st, (jt + 1) * kTile, t_len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile jt has landed
    __syncthreads();
    const T* ks_tile = smem + 2 * (jt & 1) * B::kTileElems;
    const T* vs_tile = ks_tile + B::kTileElems;
    const int j0 = jt * kTile;
    // the per-element mask only on the tile that crosses the diagonal or T
    const bool edge = j0 + kTile > t_len || (causal && j0 + kTile - 1 > q0);
    const bool diag = causal && j0 == q0;

    // 16 keys at a time keeps S and dP at 8 registers each
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      // keys wholly past T, or on the diagonal wholly after this warp's
      // rows, add nothing
      if (j0 + c * 16 >= t_len || (diag && c > warp)) continue;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const T* kc = ks_tile + c * 16 * B::kStride;
      P::scores(s, dp, qd, kc, vs_tile + c * 16 * B::kStride, lane);
      // P = exp(scale S - lse), dS = P (dP - delta); element e of block n
      // is row row0 + 8 (e >> 1), key j0 + 16 c + 8 n + 2 tq + (e & 1)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2f(fmaf(s[n][e], sl2, -lse_l2[r]));
          if (edge) {
            const int j = j0 + c * 16 + n * 8 + 2 * tq + (e & 1);
            if (j >= t_len || (causal && j > row0 + 8 * r)) p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - dl[r]);
        }
      }
      // dQ += dS K, dS straight from the fragments
      P::grad(acc, dp, kc, lane);
    }
    __syncthreads();  // stage jt & 1 is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + r * 8;
    if (i < t_len) {
      T* row = dq + (((long long)b * t_len + i) * heads + h) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        store2<T>(row + n * 8, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
      }
    }
  }
}

// K5's products for one warp's 16 key rows against a chunk of 16 queries
// (qs, dos: the chunk's first Q and dO rows in the stage):
// - load_kv: K's and V's A fragments from the warp's first rows;
// - scores: s[n] += K . Q[8n .. 8n+7]^T and dp[n] += V . dO[8n ..]^T;
// - grads: dv += P^T . dO and dk += dS^T . Q, P^T and dS^T straight from
//   the C fragments p and ds.
// 16-bit types: m16n8k16 from ldmatrix (Q and dO by .trans in grads), P^T
// and dS^T converted pairwise in registers.
template <typename T, int D>
struct Dkv {
  static constexpr int kKS = D / 16;  // 16-wide steps over the head dim
  static constexpr int kNB = D / 8;   // 8-wide blocks of the head dim
  struct KV {
    uint32_t k[kKS][4], v[kKS][4];
  };

  static __device__ __forceinline__ void load_kv(KV& f, const T* kt, const T* vt, int lane) {
    const int off = a_offset<T, D>(lane);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      ldsm_x4(f.k[ks], kt + off + ks * 16);
      ldsm_x4(f.v[ks], vt + off + ks * 16);
    }
  }

  static __device__ __forceinline__ void scores(float (&s)[2][4], float (&dp)[2][4], const KV& f,
                                                const T* qs, const T* dos, int lane) {
    const int off = b_offset<T, D>(lane);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, qs + off + ks * 16);
      mma<T>(s[0], f.k[ks], b[0], b[1]);
      mma<T>(s[1], f.k[ks], b[2], b[3]);
      ldsm_x4(b, dos + off + ks * 16);
      mma<T>(dp[0], f.v[ks], b[0], b[1]);
      mma<T>(dp[1], f.v[ks], b[2], b[3]);
    }
  }

  static __device__ __forceinline__ void grads(float (&dv)[kNB][4], float (&dk)[kNB][4],
                                               const float (&p)[2][4], const float (&ds)[2][4],
                                               const T* qs, const T* dos, int lane) {
    uint32_t pa[4];
    uint32_t da[4];
    to_a<T>(pa, p[0], p[1]);
    to_a<T>(da, ds[0], ds[1]);
    const int off = bt_offset<T, D>(lane);
#pragma unroll
    for (int nd = 0; nd < kNB / 2; ++nd) {
      uint32_t b[4];
      ldsm_x4_t(b, dos + off + nd * 16);
      mma<T>(dv[2 * nd], pa, b[0], b[1]);
      mma<T>(dv[2 * nd + 1], pa, b[2], b[3]);
      ldsm_x4_t(b, qs + off + nd * 16);
      mma<T>(dk[2 * nd], da, b[0], b[1]);
      mma<T>(dk[2 * nd + 1], da, b[2], b[3]);
    }
  }
};

// f32: Tf32's products, K and V the resident A operands, held raw and
// split at each use. Held split they take 128 registers beside the 64 of
// the dK/dV accumulators, and ptxas spills at D = 64.
template <int D>
struct Dkv<float, D> {
  using M = Tf32<D>;
  static constexpr int kNB = M::kNB;
  struct KV {
    Resident<D, false> k, v;
  };

  static __device__ __forceinline__ void load_kv(KV& f, const float* kt, const float* vt,
                                                 int lane) {
    f.k.load(kt, lane);
    f.v.load(vt, lane);
  }

  static __device__ __forceinline__ void scores(float (&s)[2][4], float (&dp)[2][4], const KV& f,
                                                const float* qs, const float* dos, int lane) {
    f.k.product(s, qs, lane);
    f.v.product(dp, dos, lane);
  }

  static __device__ __forceinline__ void grads(float (&dv)[kNB][4], float (&dk)[kNB][4],
                                               const float (&p)[2][4], const float (&ds)[2][4],
                                               const float* qs, const float* dos, int lane) {
    M::grad(dv, p, dos, lane);
    M::grad(dk, ds, qs, lane);
  }
};

template <typename T, int D>
__device__ __forceinline__ void dkv_mma(T* smem, const T* __restrict__ q,
                                        const T* __restrict__ k, const T* __restrict__ v,
                                        const T* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, T* __restrict__ dk,
                                        T* __restrict__ dv, int t_len, int heads, long long sb,
                                        long long st, long long sh, int causal, float scale) {
  using B = Tiles<T, D>;
  using P = Dkv<T, D>;
  constexpr int kNB = D / 8;
  // stage s holds Q at smem + 2*s*kTileElems and dO right after it; the
  // stages' lse and delta follow, [stage][lse | delta][kTile] f32
  float* stats = reinterpret_cast<float*>(smem + 4 * B::kTileElems);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // grid (heads * batch, key tiles), tile-major: the first key tiles,
  // which see the most queries when causal, start first
  const int h = blockIdx.x % heads;
  const int b = blockIdx.x / heads;
  const int k0 = blockIdx.y * kRows;
  const long long base = (long long)b * sb + (long long)h * sh;
  const T* dout_bh = dout + ((long long)b * t_len * heads + h) * D;
  const long long stat0 = ((long long)b * heads + h) * t_len;
  // causal: queries before this block's first key never attend it
  const int i_first = causal ? k0 : 0;
  const int n_it = (t_len - i_first + kTile - 1) / kTile;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8

  // Q/dO rows i0.. and their lse/delta into stage s. Rows past T are zero
  // and so are their lse and delta: such a query then has p = 1 but dO = 0
  // and dP = 0, so it adds exactly nothing to dV or dK.
  auto load_stage = [&](int s, int i0) {
    T* dst = smem + 2 * s * B::kTileElems;
    tile_async<T, D>(dst, q + base, st, i0, t_len);
    tile_async<T, D>(dst + B::kTileElems, dout_bh, (long long)heads * D, i0, t_len);
    const int e = threadIdx.x & (kTile - 1);
    const int t = i0 + e;
    const float* src = (threadIdx.x < kTile ? lse : delta) + stat0;
    cp_async4(stats + (2 * s + (threadIdx.x < kTile ? 0 : 1)) * kTile + e,
              src + (t < t_len ? t : 0), t < t_len);
  };

  // K and V through stage 1 into registers; the first Q/dO tile into stage 0
  tile_async<T, D>(smem + 2 * B::kTileElems, k + base, st, k0, t_len);
  tile_async<T, D>(smem + 3 * B::kTileElems, v + base, st, k0, t_len);
  load_stage(0, i_first);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  typename P::KV kv;
  P::load_kv(kv, smem + 2 * B::kTileElems + warp * 16 * B::kStride,
             smem + 3 * B::kTileElems + warp * 16 * B::kStride, lane);
  __syncthreads();  // stage 1 is free

  float dka[kNB][4];
  float dva[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[n][e] = 0.f;
      dva[n][e] = 0.f;
    }
  }
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int i0 = i_first + it * kTile;
    if (it + 1 < n_it) load_stage((it + 1) & 1, i0 + kTile);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const T* qs = smem + 2 * (it & 1) * B::kTileElems;
    const T* dos = qs + B::kTileElems;
    const float* slse = stats + 2 * (it & 1) * kTile;
    const float* sdelta = slse + kTile;
    const bool diag = causal && i0 == k0;

    // 16 queries at a time keeps S^T and dP^T at 8 registers each
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      // on the diagonal, chunks wholly before this warp's keys are masked
      if (diag && c < warp) continue;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const T* qc = qs + c * 16 * B::kStride;
      const T* doc = dos + c * 16 * B::kStride;
      P::scores(s, dp, kv, qc, doc, lane);
      // P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta); a column
      // is a query
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = c * 16 + n * 8 + 2 * tq + e2;
          const float lse_l2 = slse[col] * kLog2e;
          const float dl = sdelta[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + e2;
            float p = exp2f(fmaf(s[n][e], sl2, -lse_l2));
            if (diag && key0 + 8 * r > i0 + col) p = 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - dl);
          }
        }
      }
      P::grads(dva, dka, s, dp, qc, doc, lane);
    }
    __syncthreads();  // stage it & 1 is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key0 + r * 8;
    if (j < t_len) {
      const long long row = (((long long)b * t_len + j) * heads + h) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        store2<T>(dk + row + n * 8, dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
        store2<T>(dv + row + n * 8, dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3, K4 and K5: one kernel each

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          int t_len, int heads, long long sb, long long st, long long sh,
                          int causal, float scale) {
  extern __shared__ float4 smem4[];
  fwd_mma<T, D>(reinterpret_cast<T*>(smem4), q, k, v, o, lse, t_len, heads, sb, st, sh, causal,
                scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, int t_len, int heads, long long sb, long long st,
                         long long sh, int causal, float scale) {
  extern __shared__ float4 smem4[];
  dq_mma<T, D>(reinterpret_cast<T*>(smem4), q, k, v, dout, lse, delta, dq, t_len, heads, sb, st,
               sh, causal, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int t_len, int heads,
                          long long sb, long long st, long long sh, int causal, float scale) {
  extern __shared__ float4 smem4[];
  dkv_mma<T, D>(reinterpret_cast<T*>(smem4), q, k, v, dout, lse, delta, dk, dv, t_len, heads, sb,
                st, sh, causal, scale);
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

// The bodies copy 16-byte pieces: every row they stage (q/k/v through the
// shared strides, dO contiguous) must start on 16 bytes.
template <typename T>
bool rows_aligned(int which, const Args& a) {
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const long long e = sizeof(T);
  bool ok = a16(a.q) && a16(a.k) && a16(a.v) && (a.sb * e) % 16 == 0 &&
            (a.st * e) % 16 == 0 && (a.sh * e) % 16 == 0;
  if (which != kFwd) ok = ok && a16(a.dout);
  return ok;
}

// Launches kernel K at (T, D) on the tile-major grid (heads * batch,
// tiles): refuses rows off 16 bytes and, above 48 KB of shared memory (f32
// at D = 64), opts in to it first, returning the error if either fails.
template <typename T, int D, int K, typename Kern, typename... A>
cudaError_t start(Kern kernel, const Args& a, A... args) {
  constexpr size_t smem = kSmemBytes<T, D, K>;
  if (!rows_aligned<T>(K, a)) return cudaErrorMisalignedAddress;
  if (smem > kNoOptInSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.heads * a.batch, (a.t_len + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, a.stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(int which, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (which == kFwd) {
    return start<T, D, kFwd>(flash_attn_fwd_kernel<T, D>, a, q, k, v, static_cast<T*>(a.out0),
                             a.lse_out, a.t_len, a.heads, a.sb, a.st, a.sh, a.causal, a.scale);
  }
  if (which == kDq) {
    return start<T, D, kDq>(flash_attn_dq_kernel<T, D>, a, q, k, v, dout, a.lse_in, a.delta,
                            static_cast<T*>(a.out0), a.t_len, a.heads, a.sb, a.st, a.sh,
                            a.causal, a.scale);
  }
  return start<T, D, kDkv>(flash_attn_dkv_kernel<T, D>, a, q, k, v, dout, a.lse_in, a.delta,
                           static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.t_len, a.heads,
                           a.sb, a.st, a.sh, a.causal, a.scale);
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
      a.t_len <= 0 || a.heads <= 0 || (long long)a.batch * a.heads > 0x7fffffffLL ||
      a.t_len > 65535 * kRows) {  // the grid's limits
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
