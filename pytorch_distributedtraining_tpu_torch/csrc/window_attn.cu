// Window attention for Swin-style models on Hopper (sm_90a), forward and
// backward, with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernels of pytorch_distributedtraining_tpu/ops/
// pallas_window_attn.py: `_fwd_kernel` (K1, reached through `_forward`) and
// `_bwd_kernel` (K2, reached through `_backward_impl`).
//
//   K1: o = softmax(q.k^T * d^-1/2 + bias[h] + mask[w mod nW]) . v
//   K2: recompute p; dv = p^T.dO; ds = p*(dO.v^T - rowsum(dO.v^T * p));
//       dq = ds.k*scale; dk = ds^T.(q*scale); dbias[h] = sum_windows ds
//
// Shapes: q/k/v/o [bn, heads, n, d] (f32, bf16 or f16, contiguous), bias
// [heads, n, n] f32, mask [nW, n, n] f32 or null, n <= 128, d <= 32.
//
// Both kernels run their products on the tensor cores in every type.
//
// What bounds them on an H100 SXM at SwinIR-S's bench shape (q/k/v [1152,
// 6, 64, 10], 64-window shift mask) is bytes:
// - K1: q/k/v in, o out, bias and mask: 36.5 MB in bf16/f16, 0.0109 ms at
//   3.35 TB/s; 71.9 MB in f32, 0.0215 ms. Its 1.13 GFLOP of products take
//   0.0011 ms at 989 TFLOP/s (bf16), 0.0069 ms as 3xTF32 (f32, below).
// - K2: q/k/v/dO in, dq/dk/dv out, bias, mask and dbias: 63 MB in
//   bf16/f16, 0.0189 ms; 125 MB in f32, 0.0374 ms. Its 2.83 GFLOP take
//   0.003 ms (bf16) and 0.0172 ms (f32 as 3xTF32: three TF32 products per
//   product, 8.5 GFLOP at 495 TFLOP/s). On the FP32 CUDA cores (67
//   TFLOP/s) the same work would be bound by operations at 0.0423 ms.
//
// One skeleton for both kernels and every type:
// - A block is (head h, mask class r = w mod nW, a chunk of that class's
//   windows), with NP/16 warps for the keys padded to NP = 32 (K1 only),
//   64 or 128. bias[h] + mask[r] is loaded once per block into shared
//   memory as f32 (times log2 e), with -inf in the padded key columns: no
//   score needs a bound check, and no bias or mask value is read from
//   device memory per window. ops/window_attn.py's forward_plan and
//   backward_plan pick the chunk from the card's SM count.
// - Tiles: q/k/v (and dO) of a (window, head) are n*d contiguous elements;
//   their rows (20 or 40 bytes at d = 10) go by cp.async, in the widest
//   pieces of 16, 8 or 4 bytes that divide a row, straight into rows of DP
//   = 16 or 32 columns whose padding was zeroed once: d = 10 is below the
//   MMA depth, and zero columns add nothing to any product. The next
//   window's copies run while the current one computes (two buffers). The
//   pointers must be aligned to the piece, or the library refuses with
//   cudaErrorMisalignedAddress. Rows of an odd number of 2-byte elements,
//   and K2's f32 at n > 64 with d > 16 (whose two buffers do not fit in
//   shared memory), are read element by element into one buffer instead.
// - Scores: warp w owns query rows 16w..16w+15. S = Q.K^T on the tensor
//   cores plus the bias tile, the softmax per row across a quad of lanes
//   (two shuffles for the max, two for the sum; exp2 of scores in log2
//   units).
// - K1, one pass: O = P.V on the tensor cores with P straight from the
//   score registers (never through shared memory), then scaled by 1 / row
//   sum and stored. No lse: K2 recomputes it.
// - K2, row pass: lse into shared memory; dP = dO.V^T 16 keys at a time
//   for delta = rowsum(P*dP), then dS = P*(dP - delta), dbias += dS (f32)
//   and dQ += dS.K from dS in registers.
// - K2, column pass, after one barrier: warp w owns keys 16w..16w+15 and,
//   16 queries at a time, recomputes S^T = K.Q^T and dP^T = V.dO^T, with
//   P^T = exp2(S^T - lse) and dS^T from the row pass's delta; dV += P^T.dO
//   and dK += dS^T.Q from registers. So P and dS never pass through shared
//   memory, and the pass holds no n-wide array.
// - K2's registers: f32 at n <= 64, d <= 16 (SwinIR's f32 path) keeps the
//   dbias sums and the row pass's dP in registers (168, three blocks a
//   SM); elsewhere the dbias sums live in shared memory and dP is computed
//   twice, so that no instantiation spills.
// - bf16/f16: mma.sync.m16n8k16 with f32 accumulate; ldmatrix reads tiles
//   whose rows are padded by 16 bytes (free of bank conflicts); a C
//   fragment, packed pairwise, is an A fragment. P (K1, K2) and dS (K2)
//   are rounded to the input type before the products that take them, as
//   in the flash-attention kernels; dbias sums them in f32.
// - f32: mma.sync.m16n8k8.tf32 as 3xTF32: each operand x = hi + lo with
//   hi = tf32(x), lo = tf32(x - hi), and a.b = hi.hi + hi.lo + lo.hi in
//   f32, about 1e-6 relative: plain TF32 (about 1e-3) would miss the f32
//   tolerance. Fragments come from f32 tiles by plain shared loads (row
//   stride 4 x odd words: no bank conflicts); a C fragment becomes an A
//   fragment by permuting the k index, which a sum over k does not see.
// - dbias: each K2 block writes one [n, n] partial for its head; a second
//   kernel sums the partials in a fixed order. Deterministic, no atomics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// ---------------------------------------------------------------------------
// The products on the tensor cores
//
// Fragments for lane = 4*g + tq (g = lane/4, tq = lane%4). mma.m16n8k16
// (16-bit): A (16x16, row-major) a0 = (g, 2tq..2tq+1), a1 = (g+8, same),
// a2 = (g, 2tq+8..), a3 = (g+8, 2tq+8..); B (16x8) b0 = (k 2tq..2tq+1, n g),
// b1 = (k 2tq+8.., n g). mma.m16n8k8 (tf32): a0 = (g, tq), a1 = (g+8, tq),
// a2 = (g, tq+4), a3 = (g+8, tq+4); b0 = (k tq, n g), b1 = (k tq+4, n g).
// C (16x8 f32, both) c0,c1 = (g, 2tq..2tq+1), c2,c3 = (g+8, same).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The A fragment (16 rows x 16 columns) of C fragments c0 (columns 0-7)
// and c1 (columns 8-15).
template <typename T>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// d += a . b in tf32, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both tf32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a . b as 3xTF32: the small terms first, then hi . hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// The products of K1 and K2 on tiles in shared memory ([NP][kLd] of T,
// zero past n rows and d columns), one warp, 16 rows of A:
// - load_a: A fragments of tile rows row0..row0+15 over all DP columns;
// - mma_nk: (acc0, acc1) += A . tile[n0..n0+15][:]^T, 16 output columns;
// - mma_kn: acc += C(c0 | c1) . tile[k0..k0+15][:], where c0, c1 are the C
//   fragments of 16 rows x 16 columns k0..k0+15 (P or dS in registers).
// 16-bit types: m16n8k16 from ldmatrix; rows padded by 16 bytes.
template <typename T, int DP>
struct Ops {
  static constexpr int kLd = DP + 8;
  static constexpr int kSteps = DP / 16;
  struct AFrag {
    uint32_t r[kSteps][4];
  };

  static __device__ __forceinline__ void load_a(AFrag& a, const T* tile, int row0, int lane) {
    const T* p = tile + (row0 + (lane & 15)) * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) ldsm_x4(a.r[s], p + s * 16);
  }

  static __device__ __forceinline__ void mma_nk(float (&acc0)[4], float (&acc1)[4],
                                                const AFrag& a, const T* tile, int n0,
                                                int lane) {
    // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
    const T* p = tile + (n0 + (lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t b[4];
      ldsm_x4(b, p + s * 16);
      mma<T>(acc0, a.r[s], b[0], b[1]);
      mma<T>(acc1, a.r[s], b[2], b[3]);
    }
  }

  static __device__ __forceinline__ void mma_kn(float (&acc)[DP / 8][4], const float (&c0)[4],
                                                const float (&c1)[4], const T* tile, int k0,
                                                int lane) {
    uint32_t a[4];
    to_a<T>(a, c0, c1);
    // .trans: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
    const T* p = tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int s = 0; s < DP / 16; ++s) {
      uint32_t b[4];
      ldsm_x4_t(b, p + s * 16);
      mma<T>(acc[2 * s], a, b[0], b[1]);
      mma<T>(acc[2 * s + 1], a, b[2], b[3]);
    }
  }
};

// f32: 3xTF32 on m16n8k8 from plain shared loads. Row stride 4 x odd
// words, so the loads of a fragment hit 32 distinct banks.
template <int DP>
struct Ops<float, DP> {
  static constexpr int kLd = DP + 4;
  static constexpr int kSteps = DP / 8;
  struct AFrag {
    uint32_t hi[kSteps][4], lo[kSteps][4];
  };

  static __device__ __forceinline__ void load_a(AFrag& a, const float* tile, int row0,
                                                int lane) {
    const float* p = tile + (row0 + (lane >> 2)) * kLd + (lane & 3);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      split_tf32(p[s * 8], a.hi[s][0], a.lo[s][0]);
      split_tf32(p[8 * kLd + s * 8], a.hi[s][1], a.lo[s][1]);
      split_tf32(p[s * 8 + 4], a.hi[s][2], a.lo[s][2]);
      split_tf32(p[8 * kLd + s * 8 + 4], a.hi[s][3], a.lo[s][3]);
    }
  }

  static __device__ __forceinline__ void mma_nk(float (&acc0)[4], float (&acc1)[4],
                                                const AFrag& a, const float* tile, int n0,
                                                int lane) {
    const float* p = tile + (n0 + (lane >> 2)) * kLd + (lane & 3);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        split_tf32(p[u * 8 * kLd + s * 8], bh[u][0], bl[u][0]);
        split_tf32(p[u * 8 * kLd + s * 8 + 4], bh[u][1], bl[u][1]);
      }
      mma_3xtf32(acc0, a.hi[s], a.lo[s], bh[0], bl[0]);
      mma_3xtf32(acc1, a.hi[s], a.lo[s], bh[1], bl[1]);
    }
  }

  // k index slot tq <-> column 2tq of the C fragment, slot tq+4 <-> 2tq+1
  static __device__ __forceinline__ void mma_kn(float (&acc)[DP / 8][4], const float (&c0)[4],
                                                const float (&c1)[4], const float* tile, int k0,
                                                int lane) {
    const int g = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float(&c)[4] = u == 0 ? c0 : c1;
      uint32_t ah[4], al[4];
      split_tf32(c[0], ah[0], al[0]);
      split_tf32(c[2], ah[1], al[1]);
      split_tf32(c[1], ah[2], al[2]);
      split_tf32(c[3], ah[3], al[3]);
      const float* p = tile + (k0 + 8 * u + 2 * tq) * kLd + g;
#pragma unroll
      for (int nb = 0; nb < DP / 8; ++nb) {
        uint32_t bh[2], bl[2];
        split_tf32(p[nb * 8], bh[0], bl[0]);
        split_tf32(p[kLd + nb * 8], bh[1], bl[1]);
        mma_3xtf32(acc[nb], ah, al, bh, bl);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// K1, and the tile copies K2 shares with it

// A block of NP / 16 warps takes head h and `count` windows of mask class
// r: windows r + nw * m for m in [m0, m0 + count). Blocks are (slot, h)
// with slot = r * chunks + c, c the chunk of class r.
template <int NP>
struct Block {
  static constexpr int kThreads = NP * 2;
  static constexpr int kLdb = NP + 8;  // bias rows: float2 reads of a fragment conflict-free
  int h, r, m0, count, heads, nw;

  __device__ __forceinline__ Block(int bn, int heads_, int nw_, int chunk, int chunks)
      : heads(heads_), nw(nw_) {
    h = blockIdx.x % heads;
    const int slot = blockIdx.x / heads;
    r = slot / chunks;
    m0 = (slot - r * chunks) * chunk;
    const int per_class = (bn - r + nw - 1) / nw;
    count = max(0, min(chunk, per_class - m0));
  }

  // offset of the block's window i in q/k/v/o (tile_elems = n * d)
  __device__ __forceinline__ size_t base(int i, size_t tile_elems) const {
    return ((size_t)(r + nw * (m0 + i)) * heads + h) * tile_elems;
  }

  // bias[h] + mask[r], times log2 e -> sb [NP][kLdb]: -inf in the key
  // columns past n, so no score needs a bound check; 0 in the query rows
  // past n, whose (unstored) softmax then stays finite.
  __device__ __forceinline__ void load_bias(float* sb, const float* __restrict__ bias,
                                            const float* __restrict__ mask, int n) const {
    const float* bh = bias + (size_t)h * n * n;
    const float* mr = mask != nullptr ? mask + (size_t)r * n * n : nullptr;
    if (n == NP && reinterpret_cast<uintptr_t>(bh) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(mr) % 16 == 0) {  // whole rows, by float4
      for (int e = threadIdx.x; e < NP * NP / 4; e += kThreads) {
        const int i = e / (NP / 4);
        const int j = (e - i * (NP / 4)) * 4;
        float4 x = *reinterpret_cast<const float4*>(bh + i * n + j);
        if (mr != nullptr) {
          const float4 m = *reinterpret_cast<const float4*>(mr + i * n + j);
          x.x += m.x;
          x.y += m.y;
          x.z += m.z;
          x.w += m.w;
        }
        *reinterpret_cast<float4*>(sb + i * kLdb + j) =
            make_float4(x.x * kLog2e, x.y * kLog2e, x.z * kLog2e, x.w * kLog2e);
      }
      return;
    }
    for (int e = threadIdx.x; e < NP * NP; e += kThreads) {
      const int i = e / NP;
      const int j = e % NP;
      float x = -INFINITY;
      if (j < n && i < n) x = (bh[i * n + j] + (mr != nullptr ? mr[i * n + j] : 0.f)) * kLog2e;
      else if (j < n) x = 0.f;
      sb[i * kLdb + j] = x;
    }
  }
};

template <int NP>
__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  uint4* t4 = reinterpret_cast<uint4*>(p);
  for (int e = threadIdx.x; e < bytes / 16; e += Block<NP>::kThreads) t4[e] = make_uint4(0, 0, 0, 0);
}

// 16, 8 or 4 bytes global -> shared.
template <int PIECE>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (PIECE == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(PIECE));
  }
}

// Rows of a contiguous [n, d] tile at src -> rows of kLd elements at dst by
// cp.async, PIECE bytes at a time (PIECE divides the row's d * esize bytes).
template <typename T, int NP, int DP, int PIECE>
__device__ __forceinline__ void tile_async(T* dst, const T* src, int n, int d) {
  constexpr int kRowBytes = Ops<T, DP>::kLd * (int)sizeof(T);
  const int row_bytes = d * (int)sizeof(T);
  const int per_row = row_bytes / PIECE;
  const float inv = 1.f / per_row;  // exact quotients: pieces < 2^12, per_row <= 32
  unsigned char* to = reinterpret_cast<unsigned char*>(dst);
  const unsigned char* from = reinterpret_cast<const unsigned char*>(src);
  for (int p = threadIdx.x; p < n * per_row; p += Block<NP>::kThreads) {
    const int r = (int)((p + 0.5f) * inv);
    const int off = (p - r * per_row) * PIECE;
    cp_async<PIECE>(to + r * kRowBytes + off, from + r * row_bytes + off);
  }
}

// The NT tiles (q, k, v[, dO]) of the window at `base` -> NT padded tiles
// at buf: by cp.async in `piece`-byte pieces, or element by element where
// piece is 0 (the caller waits or syncs).
template <typename T, int NP, int DP, int NT>
__device__ __forceinline__ void load_window(T* buf, const T* const (&src)[NT], size_t base, int n,
                                            int d, int piece) {
  constexpr int kLd = Ops<T, DP>::kLd;
#pragma unroll
  for (int a = 0; a < NT; ++a) {
    T* to = buf + a * NP * kLd;
    const T* from = src[a] + base;
    if (piece == 16) {
      tile_async<T, NP, DP, 16>(to, from, n, d);
    } else if (piece == 8) {
      tile_async<T, NP, DP, 8>(to, from, n, d);
    } else if (piece == 4) {
      tile_async<T, NP, DP, 4>(to, from, n, d);
    } else {
      for (int e = threadIdx.x; e < NP * DP; e += Block<NP>::kThreads) {
        const int rr = e / DP;
        const int c = e % DP;
        if (rr < n && c < d) to[rr * kLd + c] = from[rr * d + c];
      }
    }
  }
}

// body(buf, base) for each of the block's windows in turn, with the
// window's NT tiles at buf in shared memory (tile a at buf + a * NP * kLd)
// and `base` its offset in q/k/v. With a piece (two buffers at tiles), the
// next window's copies run while body computes; without, one buffer is
// filled element by element. The tiles' padding must be zero: the barrier
// at the start makes the caller's zeroing (and bias tile) visible first.
template <typename T, int NP, int DP, int NT, typename Body>
__device__ __forceinline__ void for_each_window(const Block<NP>& blk, T* tiles,
                                                const T* const (&src)[NT], int n, int d,
                                                int piece, Body&& body) {
  constexpr int kBuf = NT * NP * Ops<T, DP>::kLd;
  const size_t tile_elems = (size_t)n * d;
  __syncthreads();
  if (piece != 0) {
    if (blk.count > 0) load_window<T, NP, DP, NT>(tiles, src, blk.base(0, tile_elems), n, d, piece);
    cp_async_commit();
  }
  int stage = 0;  // i % 2: the buffer of window i
  for (int i = 0; i < blk.count; ++i) {
    const size_t base = blk.base(i, tile_elems);
    T* buf = tiles + stage * kBuf;
    if (piece != 0) {
      cp_async_wait<0>();  // window i's tiles have landed ...
      __syncthreads();     // ... for every thread, and window i - 1 is done with the other buffer
      if (i + 1 < blk.count) {
        load_window<T, NP, DP, NT>(tiles + (stage ^ 1) * kBuf, src, blk.base(i + 1, tile_elems),
                                   n, d, piece);
      }
      cp_async_commit();
      stage ^= 1;
    } else {
      __syncthreads();  // window i - 1 is done with the buffer
      load_window<T, NP, DP, NT>(buf, src, base, n, d, 0);
      __syncthreads();
    }
    body(static_cast<const T*>(buf), base);
  }
}

// Softmax numerators of this lane's query rows i0 + g and i0 + g + 8 (of a
// warp's 16) against all NP keys: S = Q.K^T from Q's A fragments fa on the
// tensor cores, times sl2 (the scale in log2 units) plus the bias tile sb;
// p = exp2(S - mx), mx and sum the rows' max and sum of p, each reduced
// across the quad of lanes that holds a row (C fragment layout).
template <typename T, int NP, int DP>
__device__ __forceinline__ void softmax_rows(float (&p)[NP / 8][4], float (&mx)[2],
                                             float (&sum)[2],
                                             const typename Ops<T, DP>::AFrag& fa, const T* sk,
                                             const float* sb, int i0, float sl2, int lane) {
  constexpr int kNT = NP / 8;
  constexpr int kLdb = Block<NP>::kLdb;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[t][e] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < kNT; t += 2) Ops<T, DP>::mma_nk(p[t], p[t + 1], fa, sk, 8 * t, lane);
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float2 b =
          *reinterpret_cast<const float2*>(sb + (i0 + g + 8 * hr) * kLdb + 8 * t + 2 * tq);
      p[t][2 * hr] = fmaf(p[t][2 * hr], sl2, b.x);
      p[t][2 * hr + 1] = fmaf(p[t][2 * hr + 1], sl2, b.y);
      mx[hr] = fmaxf(mx[hr], fmaxf(p[t][2 * hr], p[t][2 * hr + 1]));
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    sum[hr] = 0.f;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      p[t][2 * hr] = exp2f(p[t][2 * hr] - mx[hr]);
      p[t][2 * hr + 1] = exp2f(p[t][2 * hr + 1] - mx[hr]);
      sum[hr] += p[t][2 * hr] + p[t][2 * hr + 1];
    }
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
  }
}

// dst[0], dst[1] = a, b: one 8-byte (f32) or 4-byte (16-bit) store.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = pack2<T>(a, b);
  }
}

// A minimum of one block a SM at NP = 128, whose shared memory allows one
// or two anyway: without it ptxas held the f32 body at 128 registers and
// spilled. None below, where ptxas's own choice measured fastest.
template <typename T, int NP, int DP>
__global__ void __launch_bounds__(Block<NP>::kThreads, NP == 128 ? 1 : 0)
    window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ mask, T* __restrict__ o, int bn, int heads,
                           int n, int d, int nw, int chunk, int chunks, int piece, int pairs,
                           float scale) {
  using O = Ops<T, DP>;
  constexpr int kNT = NP / 8;  // 8-wide blocks of keys
  constexpr int kNB = DP / 8;  // 8-wide blocks of the head dim
  constexpr int kTile = NP * O::kLd;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  float* sb = reinterpret_cast<float*>(fwd_smem);                  // [NP][kLdb]
  T* tiles = reinterpret_cast<T*>(sb + NP * Block<NP>::kLdb);  // [1 or 2][q, k, v][NP][kLd]

  const Block<NP> blk(bn, heads, nw, chunk, chunks);
  blk.load_bias(sb, bias, mask, n);
  zero_smem<NP>(tiles, (piece != 0 ? 2 : 1) * 3 * kTile * (int)sizeof(T));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int i0 = warp * 16;  // this warp's query rows
  const float sl2 = scale * kLog2e;
  const T* src[3] = {q, k, v};
  for_each_window<T, NP, DP, 3>(blk, tiles, src, n, d, piece, [&](const T* buf, size_t base) {
    if (i0 >= n) return;  // every row of this warp is padding
    typename O::AFrag fa;
    O::load_a(fa, buf, i0, lane);
    float p[kNT][4], mx[2], sum[2];
    softmax_rows<T, NP, DP>(p, mx, sum, fa, buf + kTile, sb, i0, sl2, lane);
    float acc[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < kNT; t += 2) O::mma_kn(acc, p[t], p[t + 1], buf + 2 * kTile, 8 * t, lane);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = i0 + g + 8 * hr;
      if (row >= n) continue;
      const float inv = 1.f / sum[hr];
      T* out = o + base + (size_t)row * d;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const int c = 8 * nb + 2 * tq;
        const float x0 = acc[nb][2 * hr] * inv;
        const float x1 = acc[nb][2 * hr + 1] * inv;
        if (pairs && c + 1 < d) {
          store_pair<T>(out + c, x0, x1);
        } else {
          if (c < d) out[c] = from_f<T>(x0);
          if (c + 1 < d) out[c + 1] = from_f<T>(x1);
        }
      }
    }
  });
}

// ---------------------------------------------------------------------------
// K2
//
// Its block layout, bias tile and window loop are K1's, written out inline:
// built on K1's helpers (Block, for_each_window, softmax_rows), ptxas
// allocated its registers otherwise, spilled in the bf16 body at n = 64,
// d <= 16, and K2 ran slower on the H100.

template <typename T, int NP, int DP>
struct Bwd {
  static constexpr int kThreads = Block<NP>::kThreads;
  static constexpr int kLdb = Block<NP>::kLdb;
  // f32 at n <= 64, d <= 16 (SwinIR's f32 path): the dbias sums and the row
  // pass's dP stay in registers, where its 3xTF32 products would cost more
  // to redo, in 168 registers, three blocks a SM. Elsewhere the dbias sums
  // live in shared memory and dP is computed twice (for delta, then for
  // dS): the registers go to the fragments, and nothing spills.
  static constexpr bool kRegState = sizeof(T) == 4 && NP == 64 && DP == 16;
};

template <typename T, int NP, int DP>
__global__ void __launch_bounds__(Bwd<T, NP, DP>::kThreads)
    window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ mask, const T* __restrict__ dout,
                           T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ dbias_part, int bn, int heads, int n, int d,
                           int nw, int chunk, int chunks, int piece, float scale) {
  using O = Ops<T, DP>;
  using B = Bwd<T, NP, DP>;
  constexpr int kNT = NP / 8;  // 8-wide blocks of keys (row pass) or queries (column pass)
  constexpr int kNB = DP / 8;  // 8-wide blocks of the head dim
  constexpr int kLdb = B::kLdb;
  constexpr int kTile = NP * O::kLd;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* sb = reinterpret_cast<float*>(bwd_smem);  // [NP][kLdb] (bias + mask) * log2 e, -inf past n
  float* sdb = sb + NP * kLdb;                     // [NP][kLdb] dbias sum (!kRegState)
  float* slse = sdb + (B::kRegState ? 0 : NP * kLdb);  // [NP] lse of each query row, log2 units
  float* sdelta = slse + NP;                        // [NP] rowsum(P * dP)
  T* tiles = reinterpret_cast<T*>(sdelta + NP);     // [1 or 2][q, k, v, dO][NP][kLd]
  const int nbuf = piece != 0 ? 2 : 1;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int i0 = warp * 16;  // this warp's query rows, then its keys
  const float sl2 = scale * kLog2e;  // scores in log2 units

  // block = (slot, h), slot = r * chunks + c: class r's windows r + nw*m,
  // m in [c*chunk, (c+1)*chunk)
  const int h = blockIdx.x % heads;
  const int slot = blockIdx.x / heads;
  const int r = slot / chunks;
  const int m0 = (slot - r * chunks) * chunk;
  const int per_class = (bn - r + nw - 1) / nw;
  const int count = max(0, min(chunk, per_class - m0));

  {
    const float* bh = bias + (size_t)h * n * n;
    const float* mr = mask != nullptr ? mask + (size_t)r * n * n : nullptr;
    for (int e = threadIdx.x; e < NP * NP; e += B::kThreads) {
      const int i = e / NP;
      const int j = e % NP;
      float x = -INFINITY;
      if (j < n && i < n) x = (bh[i * n + j] + (mr != nullptr ? mr[i * n + j] : 0.f)) * kLog2e;
      else if (j < n) x = 0.f;
      sb[i * kLdb + j] = x;
      if (!B::kRegState) sdb[i * kLdb + j] = 0.f;
    }
    // the tiles' padding (rows past n, columns past d) stays zero
    uint4* t4 = reinterpret_cast<uint4*>(tiles);
    const int words = nbuf * 4 * kTile * (int)sizeof(T) / 16;
    for (int e = threadIdx.x; e < words; e += B::kThreads) t4[e] = make_uint4(0, 0, 0, 0);
  }
  float dbr[B::kRegState ? kNT : 1][4];
#pragma unroll
  for (int t = 0; t < (B::kRegState ? kNT : 1); ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dbr[t][e] = 0.f;
  }

  const size_t tile_elems = (size_t)n * d;
  auto window_base = [&](int i) {
    return ((size_t)(r + nw * (m0 + i)) * heads + h) * tile_elems;
  };
  // window i's tiles -> buffer i & 1 by cp.async
  auto prefetch = [&](int i) {
    const size_t base = window_base(i);
    T* buf = tiles + (i & 1) * 4 * kTile;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T* from = (a == 0 ? q : a == 1 ? k : a == 2 ? v : dout) + base;
      if (piece == 16) tile_async<T, NP, DP, 16>(buf + a * kTile, from, n, d);
      else if (piece == 8) tile_async<T, NP, DP, 8>(buf + a * kTile, from, n, d);
      else tile_async<T, NP, DP, 4>(buf + a * kTile, from, n, d);
    }
  };
  __syncthreads();  // the zeroed tiles, before any copy lands in them
  if (piece != 0 && count > 0) prefetch(0);
  cp_async_commit();

  for (int i = 0; i < count; ++i) {
    const size_t base = window_base(i);
    const T* buf = tiles + (nbuf == 2 ? (i & 1) : 0) * 4 * kTile;
    if (piece != 0) {
      cp_async_wait<0>();  // window i's tiles have landed ...
      __syncthreads();     // ... for every thread, and window i - 1 is done with the other buffer
      if (i + 1 < count) prefetch(i + 1);
      cp_async_commit();
    } else {
      __syncthreads();  // window i - 1 is done with the buffer
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const T* from = (a == 0 ? q : a == 1 ? k : a == 2 ? v : dout) + base;
        for (int e = threadIdx.x; e < NP * DP; e += B::kThreads) {
          const int rr = e / DP;
          const int c = e % DP;
          if (rr < n && c < d) tiles[a * kTile + rr * O::kLd + c] = from[rr * d + c];
        }
      }
      __syncthreads();
    }
    const T* sq = buf;
    const T* sk = buf + kTile;
    const T* sv = buf + 2 * kTile;
    const T* sdo = buf + 3 * kTile;

    // ---- row pass: query rows i0 .. i0+15
    {
      typename O::AFrag fa;
      O::load_a(fa, sq, i0, lane);
      float p[kNT][4];
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[t][e] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kNT; t += 2) O::mma_nk(p[t], p[t + 1], fa, sk, 8 * t, lane);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 b =
              *reinterpret_cast<const float2*>(sb + (i0 + g + 8 * hr) * kLdb + 8 * t + 2 * tq);
          p[t][2 * hr] = fmaf(p[t][2 * hr], sl2, b.x);
          p[t][2 * hr + 1] = fmaf(p[t][2 * hr + 1], sl2, b.y);
          mx[hr] = fmaxf(mx[hr], fmaxf(p[t][2 * hr], p[t][2 * hr + 1]));
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          p[t][2 * hr] = exp2f(p[t][2 * hr] - mx[hr]);
          p[t][2 * hr + 1] = exp2f(p[t][2 * hr + 1] - mx[hr]);
          sum[hr] += p[t][2 * hr] + p[t][2 * hr + 1];
        }
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
        const float inv = 1.f / sum[hr];
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          p[t][2 * hr] *= inv;
          p[t][2 * hr + 1] *= inv;
        }
        if (tq == 0) slse[i0 + g + 8 * hr] = mx[hr] + log2f(sum[hr]);
      }

      // delta = rowsum(P * dP), dP = dO . V^T 16 keys at a time
      O::load_a(fa, sdo, i0, lane);
      float delta[2] = {0.f, 0.f};
      float dpk[B::kRegState ? kNT : 1][4];  // dP, kept in kRegState
#pragma unroll
      for (int t = 0; t < kNT; t += 2) {
        float dp[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[u][e] = 0.f;
        }
        O::mma_nk(dp[0], dp[1], fa, sv, 8 * t, lane);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            delta[e >> 1] = fmaf(p[t + u][e], dp[u][e], delta[e >> 1]);
            if constexpr (B::kRegState) dpk[t + u][e] = dp[u][e];
          }
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        delta[hr] += __shfl_xor_sync(0xffffffffu, delta[hr], 1);
        delta[hr] += __shfl_xor_sync(0xffffffffu, delta[hr], 2);
        if (tq == 0) sdelta[i0 + g + 8 * hr] = delta[hr];
      }

      // dS = P * (dP - delta), dbias += dS, dQ += dS . K
      float acc[kNB][4];
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kNT; t += 2) {
        float ds[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (B::kRegState) {
              ds[u][e] = dpk[t + u][e];
            } else {
              ds[u][e] = 0.f;
            }
          }
        }
        if constexpr (!B::kRegState) O::mma_nk(ds[0], ds[1], fa, sv, 8 * t, lane);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[u][e] = p[t + u][e] * (ds[u][e] - delta[e >> 1]);
          if constexpr (B::kRegState) {
#pragma unroll
            for (int e = 0; e < 4; ++e) dbr[t + u][e] += ds[u][e];
          } else {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float2* db = reinterpret_cast<float2*>(sdb + (i0 + g + 8 * hr) * kLdb +
                                                     8 * (t + u) + 2 * tq);
              float2 x = *db;
              x.x += ds[u][2 * hr];
              x.y += ds[u][2 * hr + 1];
              *db = x;
            }
          }
        }
        O::mma_kn(acc, ds[0], ds[1], sk, 8 * t, lane);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = i0 + g + 8 * hr;
        if (row < n) {
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * nb + 2 * tq + e;
              if (c < d) dq[base + row * d + c] = from_f<T>(acc[nb][2 * hr + e] * scale);
            }
          }
        }
      }
    }
    __syncthreads();  // lse and delta of every row

    // ---- column pass: keys i0 .. i0+15, 16 queries at a time
    {
      typename O::AFrag fk, fv;
      O::load_a(fk, sk, i0, lane);
      O::load_a(fv, sv, i0, lane);
      float acc_v[kNB][4], acc_k[kNB][4];
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_v[nb][e] = acc_k[nb][e] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kNT; t += 2) {
        float p[2][4], ds[2][4];  // P^T and dS^T: 16 keys x 16 queries
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[u][e] = ds[u][e] = 0.f;
        }
        O::mma_nk(p[0], p[1], fk, sq, 8 * t, lane);    // S^T = K . Q^T
        O::mma_nk(ds[0], ds[1], fv, sdo, 8 * t, lane);  // dP^T = V . dO^T
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q0 = 8 * (t + u) + 2 * tq;
          const float2 lse = *reinterpret_cast<const float2*>(slse + q0);
          const float2 dl = *reinterpret_cast<const float2*>(sdelta + q0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + (e & 1);
            const int key = i0 + g + 8 * (e >> 1);
            p[u][e] = exp2f(fmaf(p[u][e], sl2, sb[qi * kLdb + key]) - ((e & 1) ? lse.y : lse.x));
            ds[u][e] = p[u][e] * (ds[u][e] - ((e & 1) ? dl.y : dl.x));
          }
        }
        O::mma_kn(acc_v, p[0], p[1], sdo, 8 * t, lane);
        O::mma_kn(acc_k, ds[0], ds[1], sq, 8 * t, lane);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key = i0 + g + 8 * hr;
        if (key < n) {
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * nb + 2 * tq + e;
              if (c < d) {
                dv[base + key * d + c] = from_f<T>(acc_v[nb][2 * hr + e]);
                dk[base + key * d + c] = from_f<T>(acc_k[nb][2 * hr + e] * scale);
              }
            }
          }
        }
      }
    }
  }

  float* part = dbias_part + ((size_t)slot * heads + h) * n * n;
  if constexpr (B::kRegState) {
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + g + 8 * (e >> 1);
        const int col = 8 * t + 2 * tq + (e & 1);
        if (row < n && col < n) part[row * n + col] = dbr[t][e];
      }
    }
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < n * n; e += B::kThreads) {
      const int row = e / n;
      part[e] = sdb[row * kLdb + e - row * n];
    }
  }
}

// dbias[e] = sum over partials, in order, of part[p][e].
__global__ void __launch_bounds__(kReduceThreads)
    dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias, int parts,
                        int entries) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p) acc += part[(size_t)p * entries + e];
  dbias[e] = acc;
}

// ---------------------------------------------------------------------------
// Launches

inline int max_dynamic_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Picks a kernel's tile path and sets its dynamic shared memory, `fixed`
// bytes plus `per_buf` a tile buffer: cp.async in the widest piece of 16, 8
// or 4 bytes that divides a row, into two buffers; element by element into
// one (piece 0) for rows of an odd number of 2-byte elements or where two
// buffers do not fit. Refuses a tile pointer that is off its piece.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, std::initializer_list<const void*> tiles, int row_bytes,
                    size_t fixed, size_t per_buf, int* piece, size_t* smem) {
  *piece = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : 0;
  for (const void* p : tiles) {
    if (*piece != 0 && reinterpret_cast<uintptr_t>(p) % *piece != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  *smem = fixed + (*piece != 0 ? 2 : 1) * per_buf;
  if (*smem > (size_t)max_dynamic_smem()) {
    *piece = 0;
    *smem = fixed + per_buf;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// Chunks of `chunk` windows in a mask class (class 0 has the most); a
// head takes classes * chunks blocks.
inline int chunks_per_class(int bn, int nw, int chunk) {
  return ((bn + nw - 1) / nw + chunk - 1) / chunk;
}

// K1 at NP = 32, 64 or 128 keys, DP columns; `chunk` windows of one mask
// class per block, as ops/window_attn.py's forward_plan picks it.
template <typename T, int NP, int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bias,
                       const float* mask, void* o, int bn, int heads, int n, int d, int nw_mask,
                       int chunk, float scale, cudaStream_t stream) {
  auto kernel = window_attn_fwd_kernel<T, NP, DP>;
  const int chunks = chunks_per_class(bn, nw_mask, chunk);
  const int classes = nw_mask < bn ? nw_mask : bn;
  int piece = 0;
  size_t smem = 0;
  cudaError_t err = prepare(kernel, {q, k, v}, d * (int)sizeof(T),
                            sizeof(float) * NP * Block<NP>::kLdb,
                            sizeof(T) * 3 * NP * Ops<T, DP>::kLd, &piece, &smem);
  if (err != cudaSuccess) return err;
  // o in pairs of elements where every pair (even offset) sits on its size
  const int pairs = d % 2 == 0 && reinterpret_cast<uintptr_t>(o) % (2 * sizeof(T)) == 0;
  kernel<<<heads * classes * chunks, Block<NP>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(o), bn, heads, n, d, nw_mask, chunk, chunks, piece, pairs, scale);
  return cudaGetLastError();
}

// K2 at NP = 64 or 128 keys (n <= 32 too: a 32-key body spilled), DP
// columns; `chunk` windows of one mask class per block, as
// ops/window_attn.py's backward_plan picks it.
template <typename T, int NP, int DP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* bias,
                       const float* mask, const void* dout, void* dq, void* dk, void* dv,
                       float* dbias_part, float* dbias, int bn, int heads, int n, int d,
                       int nw_mask, int chunk, float scale, cudaStream_t stream) {
  constexpr int NPB = NP < 64 ? 64 : NP;
  auto kernel = window_attn_bwd_kernel<T, NPB, DP>;
  const int chunks = chunks_per_class(bn, nw_mask, chunk);
  const int parts = (nw_mask < bn ? nw_mask : bn) * chunks;
  const size_t bias_floats = (size_t)NPB * Block<NPB>::kLdb * (Bwd<T, NPB, DP>::kRegState ? 1 : 2);
  int piece = 0;
  size_t smem = 0;
  cudaError_t err = prepare(kernel, {q, k, v, dout}, d * (int)sizeof(T),
                            sizeof(float) * (bias_floats + 2 * NPB),
                            sizeof(T) * 4 * NPB * Ops<T, DP>::kLd, &piece, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<heads * parts, Block<NPB>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), dbias_part, bn, heads, n, d, nw_mask, chunk, chunks, piece, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int entries = heads * n * n;
  dbias_reduce_kernel<<<(entries + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                        stream>>>(dbias_part, dbias, parts, entries);
  return cudaGetLastError();
}

// dtype codes shared with the Python wrapper
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

bool shape_ok(int dtype, int bn, int heads, int n, int d, int nw_mask, int chunk) {
  return dtype >= kF32 && dtype <= kF16 && bn > 0 && heads > 0 && n > 0 && n <= 128 && d > 0 &&
         d <= 32 && nw_mask > 0 && chunk > 0;
}

// Picks the instantiation: keys padded to NP = 32, 64 or 128 x columns
// padded to DP = 16 or 32.
#define WINDOW_ATTN_SIZES(T, LAUNCH, ...)                                   \
  do {                                                                      \
    if (d <= 16) {                                                          \
      if (n <= 32) return LAUNCH<T, 32, 16>(__VA_ARGS__);                   \
      if (n <= 64) return LAUNCH<T, 64, 16>(__VA_ARGS__);                   \
      return LAUNCH<T, 128, 16>(__VA_ARGS__);                               \
    }                                                                       \
    if (n <= 32) return LAUNCH<T, 32, 32>(__VA_ARGS__);                     \
    if (n <= 64) return LAUNCH<T, 64, 32>(__VA_ARGS__);                     \
    return LAUNCH<T, 128, 32>(__VA_ARGS__);                                 \
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
                        int d, int nw_mask, int chunk, float scale, void* stream) {
  if (!shape_ok(dtype, bn, heads, n, d, nw_mask, chunk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_ATTN_DISPATCH((int)launch_fwd, q, k, v, bias, mask, o, bn, heads, n, d, nw_mask, chunk,
                       scale, st);
}

int window_attn_backward(int dtype, const void* q, const void* k, const void* v,
                         const float* bias, const float* mask, const void* dout, void* dq,
                         void* dk, void* dv, float* dbias_part, float* dbias, int bn, int heads,
                         int n, int d, int nw_mask, int chunk, float scale, void* stream) {
  if (!shape_ok(dtype, bn, heads, n, d, nw_mask, chunk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_ATTN_DISPATCH((int)launch_bwd, q, k, v, bias, mask, dout, dq, dk, dv, dbias_part,
                       dbias, bn, heads, n, d, nw_mask, chunk, scale, st);
}

const char* window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
