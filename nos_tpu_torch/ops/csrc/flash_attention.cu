// Flash attention forward and backward, written by hand for Hopper (sm_90a).
// Four kernels, each with an extern "C" launcher:
//
//   nos_flash_fwd      replaces nos_tpu/ops/flash_attention.py::_flash_fwd_pallas
//                      (kernel :102, pallas_call :161): the simt route, for f32;
//   nos_flash_fwd_mma  the same forward on tensor cores: the mma route, for
//                      bf16 (the training main path);
//   nos_flash_bwd_dq   replaces _flash_bwd_pallas's dq_kernel (:234, pallas_call :269);
//   nos_flash_bwd_dkv  replaces _flash_bwd_pallas's dkv_kernel (:287, pallas_call :329).
//
// What they compute (the Pallas kernels' contract), on q, k, v, o, dO laid
// out [B*H, T, D] (contiguous) in f32 or bf16, lse and D = rowsum(dO * O)
// [B*H, T] in f32:
//   forward  s = (q * scale) k^T in f32, an online softmax over k tiles, the
//            weights rounded to v's dtype before the PV product (:136), o =
//            acc / max(l, 1e-30) (:153), lse = m + log(l), NEG_INF on a row
//            with no valid key (:157);
//   dq       p = exp(q k^T * scale - lse), zeroed where masked (:250);
//            dq = scale * sum (p * (dO v^T - D)) k (:267);
//   dkv      the same p and ds over q tiles from the diagonal on (:322);
//            dk = scale * sum ds^T q, dv = sum p^T dO (:326-327).
// Every product and every sum is f32, as in the Pallas kernels. The mask is
// k < T and q < T (a ragged last tile is masked by bounds, nothing is padded
// in device memory) and, when causal, q >= k. D = rowsum(dO * O) stays a
// torch op in the wrapper, as it is a jnp op outside the kernels in JAX
// (:213). The backward keeps FlashAttention-2's split into two kernels: dq
// is reduced over k tiles inside one CUDA block and dk/dv over q tiles
// inside another, so there are no atomics and the result is deterministic.
//
// What bounds them on an H100: operations. At the training shape
// [64, 2048, 256] bf16 causal the forward does 1.4e11 useful FLOPs against
// 0.27 GB of bytes, some 500 FLOPs per byte, above the card's ~295.
//
// The simt design (the backward kernels, and the forward in f32). The
// Pallas grid's sequential axis (k tiles for the forward and dq, q tiles for
// dkv) becomes a loop inside one CUDA block; the other two axes become the
// CUDA grid (blockIdx.x = b*h, blockIdx.y = the tile the block owns). A block
// owns kOwn = 64 rows (q rows for the forward and dq, k rows for dkv) and
// streams the other side in tiles of kStream = 32 rows. Tiles live in shared
// memory as f32 (converted once on load, rows padded to D + 1 floats so that
// both products read conflict-free). 256 threads form a 16 x 16 grid: thread
// (ty, tx) owns rows 4 ty .. 4 ty + 3 of the block's tile, streamed columns
// tx and tx + 16 of each score tile, and output columns tx + 16 e of the
// D-wide accumulators, which stay in registers (4 x D/16 floats each). A
// row's softmax reductions run over the 16 lanes of a half-warp with
// shuffles. At D = 256 a block needs 137-210 KB of dynamic shared memory, so
// one block runs per SM. It holds the Pallas kernels' f32 numerics in every
// dtype and is far from the operation bound (PERF.md).
//
// The mma route (flash_fwd_mma_kernel). The design is FlashAttention-2 on
// mma.sync (csrc/mma.cuh): four warps own 16 q rows each, Q in swizzled
// shared memory, K and V through a two-stage cp.async ring, S and O in f32
// registers, P rounded to bf16 in registers (the contract's own rounding)
// for PV, the heaviest causal tiles launched first. At D = 256 the 16 x 256
// accumulator takes 128 registers a thread, so K/V tiles are 32 keys (96 KB
// of shared memory, two blocks per SM) and no fragment can be loaded ahead:
// what bounds it now is the latency of the dependent ldmatrix -> mma chain
// and of issuing the cp.async copies, with two warps per scheduler. wgmma, TMA and warp
// specialisation are the next step.

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace nos;

constexpr int kThreads = 256;  // 16 x 16
constexpr int kOwn = 64;       // rows a CUDA block owns
constexpr int kStream = 32;    // rows of each streamed tile
constexpr int kTM = kOwn / 16;     // own rows per thread
constexpr int kTN = kStream / 16;  // streamed columns per thread
constexpr int kPS = kStream + 1;   // row stride of a score tile in shared memory

// Reductions over the 16 lanes of a half-warp (the tx of one row group).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows row0 .. row0 + n_rows of a [T, D] slab into shared memory as f32
// times `mul`, row stride D + 1; rows at or beyond T are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int t,
                                          int n_rows, float mul) {
  constexpr int kS = D + 1;
  const int chunks = n_rows * D / 8;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int e = c * 8;
    const int r = e / D;
    const int d = e % D;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + r < t) load8(src + static_cast<size_t>(row0 + r) * D + d, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * kS + d + i] = v[i] * mul;
  }
}

// acc[a][n] += sum_d A[4 ty + a][d] * B[tx + 16 n][d]: the A B^T product of
// an own tile (kOwn rows) and a streamed tile (kStream rows), stride D + 1.
template <int D>
__device__ __forceinline__ void abt(const float* a_s, const float* b_s, int ty, int tx,
                                    float (&acc)[kTM][kTN]) {
  constexpr int kS = D + 1;
  const float* a_row = a_s + ty * kTM * kS;
  const float* b_row = b_s + tx * kS;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[kTM], bv[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) av[i] = a_row[i * kS + d];
#pragma unroll
    for (int n = 0; n < kTN; ++n) bv[n] = b_row[n * 16 * kS + d];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) acc[i][n] = fmaf(av[i], bv[n], acc[i][n]);
  }
}

// acc[a][e] += sum_j P[4 ty + a][j] * B[j][tx + 16 e]: a [kOwn, kStream]
// score tile (stride kPS) times a streamed [kStream, D] tile.
template <int D>
__device__ __forceinline__ void pb(const float* p_s, const float* b_s, int ty, int tx,
                                   float (&acc)[kTM][D / 16]) {
  constexpr int kS = D + 1;
  constexpr int kTD = D / 16;
  const float* p_row = p_s + ty * kTM * kPS;
#pragma unroll 2
  for (int j = 0; j < kStream; ++j) {
    float bv[kTD];
#pragma unroll
    for (int e = 0; e < kTD; ++e) bv[e] = b_s[j * kS + tx + 16 * e];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float pv = p_row[i * kPS + j];
#pragma unroll
      for (int e = 0; e < kTD; ++e) acc[i][e] = fmaf(pv, bv[e], acc[i][e]);
    }
  }
}

__device__ __forceinline__ bool valid(int qp, int kp, int t, bool causal) {
  return qp < t && kp < t && (!causal || qp >= kp);
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((kOwn + 2 * kStream) * (D + 1) + kOwn * kPS);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * kOwn + 2 * kStream) * (D + 1) + kOwn * kPS);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * kOwn + 2 * kStream) * (D + 1) + 2 * kOwn * kPS + 2 * kStream);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int t, int causal, float scale) {
  constexpr int kS = D + 1;
  constexpr int kTD = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kOwn][kS], q * scale
  float* k_s = q_s + kOwn * kS;      // [kStream][kS]
  float* v_s = k_s + kStream * kS;   // [kStream][kS]
  float* p_s = v_s + kStream * kS;   // [kOwn][kPS], weights rounded to T
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.y * kOwn;
  const size_t base = static_cast<size_t>(blockIdx.x) * t * D;

  load_tile<T, D>(q_s, q + base, q0, t, kOwn, scale);  // q.astype(f32) * scale (:104)
  float acc[kTM][kTD];
  float m[kTM], l[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kTD; ++e) acc[i][e] = 0.f;
  }
  const int n_k = (t + kStream - 1) / kStream;
  // Causal: k tiles up to the one holding the block's last row (:149).
  const int upper = causal ? min(n_k, (q0 + kOwn - 1) / kStream + 1) : n_k;
  for (int kt = 0; kt < upper; ++kt) {
    const int k0 = kt * kStream;
    __syncthreads();  // the previous tile's k_s, v_s, p_s are consumed
    load_tile<T, D>(k_s, k + base, k0, t, kStream, 1.f);
    load_tile<T, D>(v_s, v + base, k0, t, kStream, 1.f);
    __syncthreads();
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) s[i][n] = 0.f;
    abt<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int qp = q0 + ty * kTM + i;
      bool ok[kTN];
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        ok[n] = valid(qp, k0 + tx + 16 * n, t, causal != 0);
        if (!ok[n]) s[i][n] = kNegInf;
        mx = fmaxf(mx, s[i][n]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const float p = ok[n] ? expf(s[i][n] - m_new) : 0.f;
        sum += p;
        // p.astype(v.dtype) (:136) is p itself: this kernel runs f32 only
        // (bf16 takes flash_fwd_mma_kernel).
        p_s[(ty * kTM + i) * kPS + tx + 16 * n] = p;
      }
      sum = row_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kTD; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();
    pb<D>(p_s, v_s, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int qp = q0 + ty * kTM + i;
    if (qp >= t) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + base + static_cast<size_t>(qp) * D;
#pragma unroll
    for (int e = 0; e < kTD; ++e) store(orow + tx + 16 * e, acc[i][e] / den);
    if (tx == 0) {
      lse[static_cast<size_t>(blockIdx.x) * t + qp] =
          l[i] > 0.f ? m[i] + logf(den) : kNegInf;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq, int t, int causal,
                    float scale) {
  constexpr int kS = D + 1;
  constexpr int kTD = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kOwn][kS]
  float* do_s = q_s + kOwn * kS;      // [kOwn][kS]
  float* k_s = do_s + kOwn * kS;      // [kStream][kS]
  float* v_s = k_s + kStream * kS;    // [kStream][kS]
  float* ds_s = v_s + kStream * kS;   // [kOwn][kPS]
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.y * kOwn;
  const size_t base = static_cast<size_t>(blockIdx.x) * t * D;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * t;

  load_tile<T, D>(q_s, q + base, q0, t, kOwn, 1.f);
  load_tile<T, D>(do_s, dout + base, q0, t, kOwn, 1.f);
  float lse_r[kTM], d_r[kTM];
  float acc[kTM][kTD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int qp = q0 + ty * kTM + i;
    lse_r[i] = qp < t ? lse[rbase + qp] : 0.f;
    d_r[i] = qp < t ? dvec[rbase + qp] : 0.f;
#pragma unroll
    for (int e = 0; e < kTD; ++e) acc[i][e] = 0.f;
  }
  const int n_k = (t + kStream - 1) / kStream;
  const int upper = causal ? min(n_k, (q0 + kOwn - 1) / kStream + 1) : n_k;
  for (int kt = 0; kt < upper; ++kt) {
    const int k0 = kt * kStream;
    __syncthreads();
    load_tile<T, D>(k_s, k + base, k0, t, kStream, 1.f);
    load_tile<T, D>(v_s, v + base, k0, t, kStream, 1.f);
    __syncthreads();
    float s[kTM][kTN], dp[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) s[i][n] = dp[i][n] = 0.f;
    abt<D>(q_s, k_s, ty, tx, s);
    abt<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int qp = q0 + ty * kTM + i;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const int j = tx + 16 * n;
        const float p = valid(qp, k0 + j, t, causal != 0)
                            ? expf(s[i][n] * scale - lse_r[i]) : 0.f;
        ds_s[(ty * kTM + i) * kPS + j] = p * (dp[i][n] - d_r[i]);
      }
    }
    __syncthreads();
    pb<D>(ds_s, k_s, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int qp = q0 + ty * kTM + i;
    if (qp >= t) continue;
    T* row = dq + base + static_cast<size_t>(qp) * D;
#pragma unroll
    for (int e = 0; e < kTD; ++e) store(row + tx + 16 * e, acc[i][e] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
                     int t, int causal, float scale) {
  constexpr int kS = D + 1;
  constexpr int kTD = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [kOwn][kS]
  float* v_s = k_s + kOwn * kS;       // [kOwn][kS]
  float* q_s = v_s + kOwn * kS;       // [kStream][kS]
  float* do_s = q_s + kStream * kS;   // [kStream][kS]
  float* p_s = do_s + kStream * kS;   // [kOwn][kPS], p^T
  float* ds_s = p_s + kOwn * kPS;     // [kOwn][kPS], ds^T
  float* lse_s = ds_s + kOwn * kPS;   // [kStream]
  float* d_s = lse_s + kStream;       // [kStream]
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int k0 = blockIdx.y * kOwn;
  const size_t base = static_cast<size_t>(blockIdx.x) * t * D;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * t;

  load_tile<T, D>(k_s, k + base, k0, t, kOwn, 1.f);
  load_tile<T, D>(v_s, v + base, k0, t, kOwn, 1.f);
  float dk_acc[kTM][kTD], dv_acc[kTM][kTD];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int e = 0; e < kTD; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  const int n_q = (t + kStream - 1) / kStream;
  // Causal: q tiles from the one holding the block's first row (:322).
  const int lower = causal ? k0 / kStream : 0;
  for (int qt = lower; qt < n_q; ++qt) {
    const int q0 = qt * kStream;
    __syncthreads();
    load_tile<T, D>(q_s, q + base, q0, t, kStream, 1.f);
    load_tile<T, D>(do_s, dout + base, q0, t, kStream, 1.f);
    if (tid < kStream) {
      const int qp = q0 + tid;
      lse_s[tid] = qp < t ? lse[rbase + qp] : 0.f;
      d_s[tid] = qp < t ? dvec[rbase + qp] : 0.f;
    }
    __syncthreads();
    // Transposed scores: own k rows x streamed q columns.
    float s[kTM][kTN], dp[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) s[i][n] = dp[i][n] = 0.f;
    abt<D>(k_s, q_s, ty, tx, s);
    abt<D>(v_s, do_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int kp = k0 + ty * kTM + i;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const int j = tx + 16 * n;
        const float p = valid(q0 + j, kp, t, causal != 0)
                            ? expf(s[i][n] * scale - lse_s[j]) : 0.f;
        p_s[(ty * kTM + i) * kPS + j] = p;
        ds_s[(ty * kTM + i) * kPS + j] = p * (dp[i][n] - d_s[j]);
      }
    }
    __syncthreads();
    pb<D>(p_s, do_s, ty, tx, dv_acc);
    pb<D>(ds_s, q_s, ty, tx, dk_acc);
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int kp = k0 + ty * kTM + i;
    if (kp >= t) continue;
    T* krow = dk + base + static_cast<size_t>(kp) * D;
    T* vrow = dv + base + static_cast<size_t>(kp) * D;
#pragma unroll
    for (int e = 0; e < kTD; ++e) {
      store(krow + tx + 16 * e, dk_acc[i][e] * scale);
      store(vrow + tx + 16 * e, dv_acc[i][e]);
    }
  }
}

// One launcher per kernel: Fwd, Dq and Dkv<T, D>::run(grid, stream, the
// kernel's arguments) opts the instantiation in to its shared memory once
// per device and launches it.
template <typename T, int D>
struct Fwd {
  static cudaError_t run(dim3 grid, cudaStream_t s, const void* q, const void* k,
                         const void* v, void* o, float* lse, int t, int causal, float scale) {
    static size_t granted[kMaxDevices] = {};
    auto kernel = flash_fwd_kernel<T, D>;
    const cudaError_t err = opt_in_smem(kernel, fwd_smem<D>(), granted);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, fwd_smem<D>(), s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, t, causal, scale);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct Dq {
  static cudaError_t run(dim3 grid, cudaStream_t s, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* dvec, void* dq, int t, int causal, float scale) {
    static size_t granted[kMaxDevices] = {};
    auto kernel = flash_bwd_dq_kernel<T, D>;
    const cudaError_t err = opt_in_smem(kernel, dq_smem<D>(), granted);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, dq_smem<D>(), s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, dvec, static_cast<T*>(dq), t, causal, scale);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct Dkv {
  static cudaError_t run(dim3 grid, cudaStream_t s, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* dvec, void* dk, void* dv, int t, int causal,
                         float scale) {
    static size_t granted[kMaxDevices] = {};
    auto kernel = flash_bwd_dkv_kernel<T, D>;
    const cudaError_t err = opt_in_smem(kernel, dkv_smem<D>(), granted);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, dkv_smem<D>(), s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv),
        t, causal, scale);
    return cudaGetLastError();
  }
};

// -- the forward's mma route: bf16, head_dim 64, 128 or 256 ---------------------
//
// One CUDA block of four warps per (b*h, 64-row q tile); warp w owns rows
// 16 w .. 16 w + 15 of the tile. Q stays in swizzled shared memory (at D =
// 256 its fragments would take 64 more registers beside the 128 of the
// accumulator); K and V tiles of kFwdKeys<D> rows stream through a
// two-stage cp.async ring, the next tile's copy in flight while this one's
// products run. S = (q k^T) * scale in f32 from bf16 fragments; the masked
// online softmax runs on the S fragment; P is rounded to bf16 in registers
// (the reference's p.astype(v.dtype), :136) and O += P V accumulates in f32.

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRows = 16 * kFwdWarps;  // q rows a block owns

// Keys per stage: 32 at D = 256 keeps S at 16 registers beside the
// accumulator's 128, and the block at 96 KB of shared memory (two per SM).
template <int D>
constexpr int kFwdKeys = D == 256 ? 32 : 64;

template <int D>
constexpr size_t fwd_mma_smem() {
  return sizeof(__nv_bfloat16) * (kFwdRows * D + 2 * 2 * kFwdKeys<D> * D);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int t, int causal, float scale) {
  using namespace nos::mma;
  using bf16 = __nv_bfloat16;
  constexpr int kK = kFwdKeys<D>;
  constexpr int kN = kK / 8;  // 8-key accumulator blocks of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kFwdRows][D]
  bf16* k_s = q_s + kFwdRows * D;                  // [2][kK][D]
  bf16* v_s = k_s + 2 * kK * D;                    // [2][kK][D]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The causal grid's heaviest tiles (the last rows) launch first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  const size_t base = static_cast<size_t>(blockIdx.x) * t * D;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  copy_rows<D, kFwdThreads>(q_s, kFwdRows, tid, qb, [&](int r) -> const bf16* {
    return q0 + r < t ? qb + static_cast<size_t>(q0 + r) * D : nullptr;
  });
  const int n_k = (t + kK - 1) / kK;
  // Causal: k tiles up to the one holding the block's last row (:149).
  const int upper = causal ? min(n_k, (q0 + kFwdRows - 1) / kK + 1) : n_k;
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kK;
    copy_rows<D, kFwdThreads>(k_s + stage * kK * D, kK, tid, kb, [&](int r) -> const bf16* {
      return k0 + r < t ? kb + static_cast<size_t>(k0 + r) * D : nullptr;
    });
    copy_rows<D, kFwdThreads>(v_s + stage * kK * D, kK, tid, vb, [&](int r) -> const bf16* {
      return k0 + r < t ? vb + static_cast<size_t>(k0 + r) * D : nullptr;
    });
  };
  load_kv(0, 0);
  cp_async_commit();  // Q and the first K/V tile

  const int qw = q0 + warp * 16;  // the warp's first row
  const int tq = lane & 3;
  const int rows[2] = {qw + (lane >> 2), qw + (lane >> 2) + 8};
  Softmax<kN> sm;
  float acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int kt = 0; kt < upper; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < upper) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    const int k0 = kt * kK;
    // Nothing to do where every row is padding or every key lies above the
    // warp's rows; m, l and acc are unchanged by a fully masked tile.
    if (qw >= t || (causal && k0 > qw + 15)) continue;
    const bf16* kt_s = k_s + (kt & 1) * kK * D;
    const bf16* vt_s = v_s + (kt & 1) * kK * D;
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a<D>(a, q_s, warp * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < kN / 2; ++n) {
        uint32_t bk[4];
        load_b_k<D>(bk, kt_s, 16 * n, kk, lane);
        mma_bf16(s[2 * n], a, bk[0], bk[1]);
        mma_bf16(s[2 * n + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    // Every entry valid: the tile lies inside T and, causal, at or below
    // the warp's first row.
    const bool full = k0 + kK <= t && qw + 15 < t && (!causal || k0 + kK - 1 <= qw);
    float alpha[2];
    sm.update(s, [&](int n, int e) {
      const int kp = k0 + 8 * n + 2 * tq + (e & 1);
      const int qp = rows[e >> 1];
      return full || (kp < t && qp < t && (!causal || qp >= kp));
    }, alpha);
    rescale(acc, alpha);
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t bv[4];
        load_b_v<D>(bv, vt_s, 16 * kk, 2 * c, lane);
        mma_bf16(acc[2 * c], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * c + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  sm.finish();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = rows[i];
    if (qp >= t) continue;
    const float den = fmaxf(sm.l[i], 1e-30f);
    bf16* orow = o + base + static_cast<size_t>(qp) * D + 2 * tq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(acc[c][2 * i] / den, acc[c][2 * i + 1] / den);
    }
    if (tq == 0) {
      lse[static_cast<size_t>(blockIdx.x) * t + qp] =
          sm.l[i] > 0.f ? sm.m[i] + logf(den) : kNegInf;
    }
  }
}

template <int D>
cudaError_t launch_fwd_mma(dim3 grid, cudaStream_t s, const void* q, const void* k,
                           const void* v, void* o, float* lse, int t, int causal, float scale) {
  static size_t granted[kMaxDevices] = {};
  auto kernel = flash_fwd_mma_kernel<D>;
  const cudaError_t err = opt_in_smem(kernel, fwd_mma_smem<D>(), granted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFwdThreads, fwd_mma_smem<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, t, causal,
      scale);
  return cudaGetLastError();
}

template <template <typename, int> class Launch, typename T, typename... Args>
cudaError_t by_head_dim(int head_dim, Args... args) {
  switch (head_dim) {
    case 64: return Launch<T, 64>::run(args...);
    case 128: return Launch<T, 128>::run(args...);
    case 256: return Launch<T, 256>::run(args...);
  }
  return cudaErrorInvalidValue;
}

// Launch<dtype, head_dim>::run over the grid (b*h, q or k tiles of kOwn rows);
// bf16 only where kWithBF16 (the simt forward is f32 only).
template <template <typename, int> class Launch, bool kWithBF16, typename... Args>
int dispatch(int dtype, int head_dim, int bh, int t, void* stream, Args... args) {
  if (bh <= 0 || t <= 0 || (t + kOwn - 1) / kOwn > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(bh, (t + kOwn - 1) / kOwn);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32) {
    err = by_head_dim<Launch, float>(head_dim, grid, s, args...);
  } else if (dtype == kBF16) {
    if constexpr (kWithBF16) err = by_head_dim<Launch, __nv_bfloat16>(head_dim, grid, s, args...);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q, k, v, o [bh, t, head_dim] in dtype (0 f32; bf16 takes nos_flash_fwd_mma
// and is refused here); lse [bh, t] f32. head_dim 64, 128 or 256. Returns
// cudaGetLastError() after the launch.
int nos_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int t, int head_dim, int dtype, int causal, float scale, void* stream) {
  return dispatch<Fwd, false>(dtype, head_dim, bh, t, stream, q, k, v, o, lse, t, causal,
                              scale);
}

// dq [bh, t, head_dim] from q, k, v, dO and the forward's lse and D =
// rowsum(dO * O) [bh, t] f32.
int nos_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* dvec, void* dq, int bh, int t,
                     int head_dim, int dtype, int causal, float scale, void* stream) {
  return dispatch<Dq, true>(dtype, head_dim, bh, t, stream, q, k, v, dout, lse, dvec, dq, t,
                      causal, scale);
}

// dk, dv [bh, t, head_dim] from the same inputs.
int nos_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dvec, void* dk, void* dv, int bh, int t,
                      int head_dim, int dtype, int causal, float scale, void* stream) {
  return dispatch<Dkv, true>(dtype, head_dim, bh, t, stream, q, k, v, dout, lse, dvec, dk, dv, t,
                       causal, scale);
}

// The forward's mma route: bf16 q, k, v, o [bh, t, head_dim], lse [bh, t]
// f32, head_dim 64, 128 or 256. Returns cudaGetLastError() after the launch.
int nos_flash_fwd_mma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                      int t, int head_dim, int causal, float scale, void* stream) {
  if (bh <= 0 || t <= 0 || (t + kFwdRows - 1) / kFwdRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(bh, (t + kFwdRows - 1) / kFwdRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (head_dim) {
    case 64: err = launch_fwd_mma<64>(grid, s, q, k, v, o, lse, t, causal, scale); break;
    case 128: err = launch_fwd_mma<128>(grid, s, q, k, v, o, lse, t, causal, scale); break;
    case 256: err = launch_fwd_mma<256>(grid, s, q, k, v, o, lse, t, causal, scale); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
