// Tensor-core primitives shared by the port's mma-route kernels
// (paged_attention.cu's window kernel, flash_attention.cu's forward and
// backward): Ampere-style warp-level bf16 products, which Hopper keeps at
// sm_90a.
//
//   mma_bf16        mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32;
//   ldmatrix_x4     four 8x8 b16 matrices from shared memory (.trans for V);
//   cp_async16      a 16-byte cp.async.cg global -> shared copy, zero-filled
//                   when the source is out of range, with commit / wait
//                   (cp_async4: one 4-byte word, for f32 rows);
//   Swizzled<D>     the XOR-swizzled layout of a [rows, D] bf16 tile, so that
//                   ldmatrix's eight 16-byte row reads hit eight distinct
//                   bank groups;
//   mma_abt         S = A B^T for a warp's 16 rows over all of D;
//   a_terms, mma_av an f32 fragment as bf16 A-fragment terms, and acc +=
//                   (those terms) V;
//   Softmax<N>      the online-softmax state of one warp's 16 rows over an
//                   [16, 8 N] f32 score fragment: row max over the quad,
//                   explicitly zeroed masked weights, the rescale by alpha.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): an A fragment
// holds rows g and g + 8, columns 2t, 2t + 1 (regs 0, 1) and 2t + 8, 2t + 9
// (regs 2, 3); a B fragment holds k rows 2t, 2t + 1 and 2t + 8, 2t + 9 of
// column g; the f32 accumulator holds rows g (c0, c1) and g + 8 (c2, c3) at
// columns 2t, 2t + 1. Two adjacent 8-column accumulator blocks of S are
// therefore one A fragment of P, which never leaves registers.

#pragma once

#include "common.cuh"

namespace nos {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst`; zeros when !pred (the source
// is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

// One 4-byte word from global `src` to shared `dst`; zero when !pred.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: a 16x16 bf16 A fragment, a 16x8 bf16 B fragment, f32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two halves of a packed pair back in f32.
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// A [rows, D] bf16 tile in shared memory: row r's 16-byte chunk c lives at
// chunk (c ^ (r & 7)) of the row. D is a multiple of 64, so a row spans a
// whole number of 128-byte bank cycles and the eight rows that one 8x8
// ldmatrix reads at a logical chunk land on eight distinct bank groups.
template <int D>
struct Swizzled {
  static_assert(D % 64 == 0, "swizzled tiles take D a multiple of 64");
  static constexpr int kChunks = D / 8;  // 16-byte chunks per row
  // Element offset of (row, chunk) in the tile.
  __device__ __forceinline__ static int at(int row, int chunk) {
    return row * D + ((chunk ^ (row & 7)) << 3);
  }
};

// A fragment of the 16 rows row0 .. row0 + 15, columns 16 kk .. 16 kk + 15,
// of a swizzled [rows, D] tile (Q).
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int kk, int lane) {
  const int row = row0 + (lane & 15);
  const int chunk = 2 * kk + (lane >> 4);
  ldmatrix_x4(a, smem_addr(tile + Swizzled<D>::at(row, chunk)));
}

// B fragments of S = Q K^T for keys n0 .. n0 + 15 (two 8-key blocks), d
// columns 16 kk .. 16 kk + 15, from a swizzled [keys, D] K tile: b[0], b[1]
// for keys n0 .. n0 + 7, b[2], b[3] for n0 + 8 .. n0 + 15.
template <int D>
__device__ __forceinline__ void load_b_k(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                         int kk, int lane) {
  const int row = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int chunk = 2 * kk + ((lane >> 3) & 1);
  ldmatrix_x4(b, smem_addr(tile + Swizzled<D>::at(row, chunk)));
}

// B fragments of O += P V for keys k0 .. k0 + 15, d columns 8 c .. 8 c + 15
// (two 8-wide blocks), from a swizzled [keys, D] V tile, transposed on
// load: b[0], b[1] for d block c, b[2], b[3] for d block c + 1.
template <int D>
__device__ __forceinline__ void load_b_v(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0,
                                         int c, int lane) {
  const int row = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int chunk = c + (lane >> 4);
  ldmatrix_x4_trans(b, smem_addr(tile + Swizzled<D>::at(row, chunk)));
}

// s = (rows row0 .. row0 + 15 of the swizzled [rows, D] tile a) times (rows
// n0 .. n0 + 8 N - 1 of the swizzled [rows, D] tile b)^T, summed over all
// of D in f32: S = Q K^T for a warp's 16 rows and 8 N keys.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&s)[N][4], const __nv_bfloat16* a, int row0,
                                        const __nv_bfloat16* b, int n0, int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    load_a<D>(af, a, row0, kk, lane);
#pragma unroll
    for (int n = 0; n < N / 2; ++n) {
      uint32_t bk[4];
      load_b_k<D>(bk, b, n0 + 16 * n, kk, lane);
      mma_bf16(s[2 * n], af, bk[0], bk[1]);
      mma_bf16(s[2 * n + 1], af, bk[2], bk[3]);
    }
  }
}

// Keys 16 kk .. 16 kk + 15 of an f32 fragment x laid out as S (rows g and
// g + 8, 8 N keys) as the A fragments of kTerms bf16 terms: the first is
// the rounding of x, each next one the rounding of what the earlier terms
// left (an exact remainder), so three terms hold all 24 bits of x.
template <int kTerms, int N>
__device__ __forceinline__ void a_terms(uint32_t (&a)[kTerms][4], const float (&x)[N][4],
                                        int kk) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    float x0 = x[2 * kk + (h >> 1)][(h & 1) * 2];
    float x1 = x[2 * kk + (h >> 1)][(h & 1) * 2 + 1];
#pragma unroll
    for (int term = 0; term < kTerms; ++term) {
      const uint32_t w = pack_bf16(x0, x1);
      a[term][h] = w;
      x0 -= bf16_lo(w);  // exact: the remainder of a rounding
      x1 -= bf16_hi(w);
    }
  }
}

// acc += (the sum of the terms a) times rows k0 .. k0 + 15 of the swizzled
// [rows, D] tile b, transposed on load: O += P V over 16 keys, f32 sums.
template <int D, int kTerms>
__device__ __forceinline__ void mma_av(float (&acc)[D / 8][4], const uint32_t (&a)[kTerms][4],
                                       const __nv_bfloat16* b, int k0, int lane) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    uint32_t bv[4];
    load_b_v<D>(bv, b, k0, 2 * c, lane);
#pragma unroll
    for (int term = 0; term < kTerms; ++term) {
      mma_bf16(acc[2 * c], a[term], bv[0], bv[1]);
      mma_bf16(acc[2 * c + 1], a[term], bv[2], bv[3]);
    }
  }
}

// Rows 0 .. n_rows of a swizzled tile from global memory by 16-byte
// cp.async copies over the block's kThreads threads: row r from src_row(r),
// or zeros where that is nullptr (`any` then stands in as the unread source
// address). Thread tid copies chunk tid % (D / 8) of every (kThreads / (D /
// 8))-th row, so its chunk and the row step stay fixed. The caller commits.
template <int D, int kThreads, typename RowPtr>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* tile, int n_rows, int tid,
                                          const __nv_bfloat16* any, RowPtr src_row) {
  constexpr int kC = Swizzled<D>::kChunks;
  static_assert(kThreads % kC == 0, "a row's chunks split evenly over the threads");
  const int c = tid % kC;
  for (int r = tid / kC; r < n_rows; r += kThreads / kC) {
    const __nv_bfloat16* src = src_row(r);
    cp_async16(smem_addr(tile + Swizzled<D>::at(r, c)), src == nullptr ? any : src + c * 8,
               src != nullptr);
  }
}

// e^x as 2^(x log2 e): one ex2 instruction against expf's longer sequence,
// issued for every score of a tile; within a few f32 ulps of expf, far
// inside the bf16 rounding of the weights and the bound on the flash
// forward's lse.
__device__ __forceinline__ float exp_fast(float x) { return exp2f(x * 1.44269504088896341f); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax of one warp's 16 rows over score tiles of 8 N keys.
// Each thread keeps rows g (index 0) and g + 8 (index 1): the running max m
// (the same in the four threads of a quad) and its own share of the running
// sum l (summed over the quad once, at the end).
template <int N>
struct Softmax {
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  // s[n][e]: accumulator block n (keys 8 n + 2 t + (e & 1)), row g + 8 (e >> 1),
  // already scaled; ok(n, e) says whether the entry is a valid key for its
  // row. Masked scores do not enter the max, and their weights are set to
  // exactly 0 (never exp(-1e30 - m)). On return s holds the weights
  // exp(s - m_new), and alpha[i] = exp(m_old - m_new) rescales row i's
  // accumulator.
  template <typename Ok>
  __device__ __forceinline__ void update(float (&s)[N][4], Ok ok, float (&alpha)[2]) {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!ok(n, e)) s[n][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp_fast(m[i] - m_new[i]);
      m[i] = m_new[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ok(n, e) ? exp_fast(s[n][e] - m_new[e >> 1]) : 0.f;
        s[n][e] = p;
        l[e >> 1] += p;
      }
  }

  // The row sums over the quad (call once, after the last tile).
  __device__ __forceinline__ void finish() {
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }
};

// acc[c][e] *= alpha of its row.
template <int C>
__device__ __forceinline__ void rescale(float (&acc)[C][4], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c][0] *= alpha[0];
    acc[c][1] *= alpha[0];
    acc[c][2] *= alpha[1];
    acc[c][3] *= alpha[1];
  }
}

}  // namespace mma
}  // namespace nos
