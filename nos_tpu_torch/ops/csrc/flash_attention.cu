// Flash attention forward and backward, written by hand for Hopper (sm_90a).
// Six kernels, each with an extern "C" launcher, two routes per Pallas kernel:
//
//   replaces                                     simt (f32)         mma (bf16)
//   _flash_fwd_pallas (kernel :102, call :161)   nos_flash_fwd      nos_flash_fwd_mma
//   _flash_bwd_pallas's dq_kernel (:234, :269)   nos_flash_bwd_dq   nos_flash_bwd_dq_mma
//   _flash_bwd_pallas's dkv_kernel (:287, :329)  nos_flash_bwd_dkv  nos_flash_bwd_dkv_mma
//
// (files and lines of nos_tpu/ops/flash_attention.py). The wrapper picks
// the route from the dtype alone (ops/flash_attention.py::_flash_route);
// the simt launchers refuse bf16, so the training main path (bf16) runs the
// mma kernels only.
//
// What they compute (the Pallas kernels' contract), on q, k, v, o, dO laid
// out [B*H, T, D] (contiguous), lse and D = rowsum(dO * O) [B*H, T] in f32:
//   forward  s = (q * scale) k^T in f32, an online softmax over k tiles, the
//            weights rounded to v's dtype before the PV product (:136), o =
//            acc / max(l, 1e-30) (:153), lse = m + log(l), NEG_INF on a row
//            with no valid key (:157);
//   dq       p = exp(q k^T * scale - lse), zeroed where masked (:250);
//            dq = scale * sum (p * (dO v^T - D)) k (:267);
//   dkv      the same p and ds over q tiles from the diagonal on (:322);
//            dk = scale * sum ds^T q, dv = sum p^T dO (:326-327).
// Every product and every sum is f32, as in the Pallas kernels; the mma
// route's products take bf16 operands (q, k, v, dO are bf16 already) and
// sum in f32, and its backward feeds p and ds to them as two bf16 terms
// each (see the mma backward's note). The mask is k < T and q < T (a ragged
// last tile is masked by bounds, nothing is padded in device memory) and,
// when causal, q >= k. D = rowsum(dO * O) stays a torch op in the wrapper,
// as it is a jnp op outside the kernels in JAX (:213). The backward keeps
// FlashAttention-2's split into two kernels: dq is reduced over k tiles
// inside one CUDA block and dk/dv over q tiles inside another, so there are
// no atomics and the result is deterministic.
//
// What bounds them on an H100: operations. At the training shape
// [64, 2048, 256] bf16 causal the forward does 1.4e11 useful FLOPs against
// 0.27 GB of bytes, some 500 FLOPs per byte, above the card's ~295; dq
// does 2.1e11 against 0.34 GB and dk/dv 2.7e11 against 0.40 GB.
//
// The simt design (f32). The Pallas grid's sequential axis (k tiles for the
// forward and dq, q tiles for dkv) becomes a loop inside one CUDA block; the
// other two axes become the CUDA grid (blockIdx.x = b*h, blockIdx.y = the
// tile the block owns). A block owns kOwn = 64 rows (q rows for the forward
// and dq, k rows for dkv) and streams the other side in tiles of kStream =
// 32 rows. Tiles live in shared memory as f32 (rows padded to D + 1 floats
// so that both products read conflict-free). 256 threads form a 16 x 16
// grid: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of the block's tile,
// streamed columns tx and tx + 16 of each score tile, and output columns tx
// + 16 e of the D-wide accumulators, which stay in registers (4 x D/16
// floats each). A row's softmax reductions run over the 16 lanes of a
// half-warp with shuffles. At D = 256 a block needs 137-210 KB of dynamic
// shared memory, so one block runs per SM. It is far from the operation
// bound (PERF.md).
//
// The mma route: FlashAttention-2 on mma.sync (csrc/mma.cuh). The forward:
// four warps own 16 q rows each, Q in swizzled shared memory, K and V
// through a two-stage cp.async ring, S and O in f32 registers, P rounded to
// bf16 in registers (the contract's own rounding) for PV, the heaviest
// causal tiles launched first. At D = 256 the 16 x 256 accumulator takes
// 128 registers a thread, so K/V tiles are 32 keys (96 KB of shared memory,
// two blocks per SM) and no fragment can be loaded ahead: what bounds it is
// the latency of the dependent ldmatrix -> mma chain and of issuing the
// cp.async copies, with two warps per scheduler. The backward (dq, dk, dv
// as three parts of one body, eight warps a block) is described where it
// is defined. wgmma, TMA and warp specialisation are the next step.

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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int t,
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int t, int causal, float scale) {
  constexpr int kS = D + 1;
  constexpr int kTD = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kOwn][kS], q * scale
  float* k_s = q_s + kOwn * kS;      // [kStream][kS]
  float* v_s = k_s + kStream * kS;   // [kStream][kS]
  float* p_s = v_s + kStream * kS;   // [kOwn][kPS], the weights
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.y * kOwn;
  const size_t base = static_cast<size_t>(blockIdx.x) * t * D;

  load_tile<D>(q_s, q + base, q0, t, kOwn, scale);  // q.astype(f32) * scale (:104)
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
    load_tile<D>(k_s, k + base, k0, t, kStream, 1.f);
    load_tile<D>(v_s, v + base, k0, t, kStream, 1.f);
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
    float* orow = o + base + static_cast<size_t>(qp) * D;
#pragma unroll
    for (int e = 0; e < kTD; ++e) store(orow + tx + 16 * e, acc[i][e] / den);
    if (tx == 0) {
      lse[static_cast<size_t>(blockIdx.x) * t + qp] =
          l[i] > 0.f ? m[i] + logf(den) : kNegInf;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    float* __restrict__ dq, int t, int causal,
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

  load_tile<D>(q_s, q + base, q0, t, kOwn, 1.f);
  load_tile<D>(do_s, dout + base, q0, t, kOwn, 1.f);
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
    load_tile<D>(k_s, k + base, k0, t, kStream, 1.f);
    load_tile<D>(v_s, v + base, k0, t, kStream, 1.f);
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
    float* row = dq + base + static_cast<size_t>(qp) * D;
#pragma unroll
    for (int e = 0; e < kTD; ++e) store(row + tx + 16 * e, acc[i][e] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dk, float* __restrict__ dv,
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

  load_tile<D>(k_s, k + base, k0, t, kOwn, 1.f);
  load_tile<D>(v_s, v + base, k0, t, kOwn, 1.f);
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
    load_tile<D>(q_s, q + base, q0, t, kStream, 1.f);
    load_tile<D>(do_s, dout + base, q0, t, kStream, 1.f);
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
    float* krow = dk + base + static_cast<size_t>(kp) * D;
    float* vrow = dv + base + static_cast<size_t>(kp) * D;
#pragma unroll
    for (int e = 0; e < kTD; ++e) {
      store(krow + tx + 16 * e, dk_acc[i][e] * scale);
      store(vrow + tx + 16 * e, dv_acc[i][e]);
    }
  }
}

// One launcher per kernel: Fwd, Dq and Dkv<D>::run(grid, stream, the
// kernel's arguments) opts the instantiation in to its shared memory once
// per device and launches it.
template <int D>
struct Fwd {
  static cudaError_t run(dim3 grid, cudaStream_t s, const void* q, const void* k,
                         const void* v, void* o, float* lse, int t, int causal, float scale) {
    static size_t granted[kMaxDevices] = {};
    auto kernel = flash_fwd_kernel<D>;
    const cudaError_t err = opt_in_smem(kernel, fwd_smem<D>(), granted);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, fwd_smem<D>(), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, t, causal, scale);
    return cudaGetLastError();
  }
};

template <int D>
struct Dq {
  static cudaError_t run(dim3 grid, cudaStream_t s, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* dvec, void* dq, int t, int causal, float scale) {
    static size_t granted[kMaxDevices] = {};
    auto kernel = flash_bwd_dq_kernel<D>;
    const cudaError_t err = opt_in_smem(kernel, dq_smem<D>(), granted);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, dq_smem<D>(), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, dvec,
        static_cast<float*>(dq), t, causal, scale);
    return cudaGetLastError();
  }
};

template <int D>
struct Dkv {
  static cudaError_t run(dim3 grid, cudaStream_t s, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* dvec, void* dk, void* dv, int t, int causal,
                         float scale) {
    static size_t granted[kMaxDevices] = {};
    auto kernel = flash_bwd_dkv_kernel<D>;
    const cudaError_t err = opt_in_smem(kernel, dkv_smem<D>(), granted);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, dkv_smem<D>(), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, dvec,
        static_cast<float*>(dk), static_cast<float*>(dv),
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
    mma_abt<D>(s, q_s, warp * 16, kt_s, 0, lane);
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
      uint32_t pa[1][4];
      a_terms<1>(pa, s, kk);
      mma_av<D, 1>(acc, pa, vt_s, 16 * kk, lane);
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

// -- the backward's mma route: bf16, head_dim 64, 128 or 256 --------------------
//
// One body serves three parts. A CUDA block of eight warps owns kBwdRows =
// 128 rows ("own" rows: q rows for dq, key rows for dk and dv); warp w owns
// 16 of them. Two own tiles stay in swizzled shared memory (A1, A2) and two
// streamed tiles of kBwdStream<D> rows pass through a two-stage cp.async
// ring (B1, B2):
//
//   part  A1  A2  B1  B2   products per streamed tile          (the Pallas kernel)
//   dq    Q   dO  K   V    S = A1 B1^T, dP = A2 B2^T, acc += dS B1   (:245-259)
//   dk    K   V   Q   dO   the same products, transposed: S^T, dP^T, dS^T Q (:300-318)
//   dv    K   -   Q   dO   S^T = A1 B1^T, acc += P^T B2          (:300-309)
//
// P = exp(s scale - lse) is recomputed as 2^(s scale log2 e - lse log2 e),
// zeroed where masked (:250, :305), and dS = P (dP - D) is formed in
// registers, so the S fragment becomes P and then dS in place. lse and D
// are per own row for dq (in registers), per streamed row for dk and dv
// (staged per stage beside B1 and B2). P and dS enter their product as two
// bf16 terms, hi + lo (a_terms): the reference keeps them in f32, and one
// bf16 rounding of P puts dv past its bound (the CPU emulation in
// tests/test_torch_flash_attention.py; PERF.md).
//
// dk/dv takes design (a) of the two the register file allows. At D = 256
// one 16 x 256 f32 accumulator is 128 registers a thread, so a warp cannot
// hold both dK and dV; instead every (b*h, key tile) has two blocks, one
// for dk and one for dv, each holding one accumulator. That costs a fifth
// product (S^T is formed twice) but no exchange between warps and no extra
// synchronisation, and it doubles the grid. The two blocks of a pair are
// neighbours in blockIdx.x (dk even, dv odd), so they stream the same Q and
// dO through L2 together. The grid launches the heaviest causal tiles first:
// the last q tiles for dq, the first key tiles for dk and dv.

enum class BwdPart { kDq, kDk, kDv };

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;  // own rows a block owns
constexpr int kBwdTerms = 2;              // bf16 terms of P and dS
constexpr float kLog2e = 1.44269504088896341f;

// Streamed rows per stage: 32 at D = 256 keeps S and dP at 16 registers
// each beside the accumulator's 128.
template <int D>
constexpr int kBwdStream = D == 256 ? 32 : 64;

// Two own tiles, the two-stage ring of two streamed tiles, and lse and D of
// the streamed rows per stage (197 KB at D = 256: one block per SM).
template <int D>
constexpr size_t bwd_mma_smem() {
  return sizeof(__nv_bfloat16) * (2 * kBwdRows * D + 2 * 2 * kBwdStream<D> * D) +
         sizeof(float) * 2 * 2 * kBwdStream<D>;
}

struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *dvec;
  __nv_bfloat16 *dq, *dk, *dv;
  int t, causal;
  float scale;
};

// Part kPart of the backward for (b*h) `bh`, own rows own0 .. own0 + 127.
template <int D, BwdPart kPart>
__device__ __forceinline__ void bwd_mma_part(const BwdArgs& p, int bh, int own0,
                                             unsigned char* smem_raw) {
  using namespace nos::mma;
  using bf16 = __nv_bfloat16;
  constexpr int kS = kBwdStream<D>;
  constexpr int kN = kS / 8;  // 8-row accumulator blocks of S
  constexpr bool kDq = kPart == BwdPart::kDq;
  constexpr bool kDs = kPart != BwdPart::kDv;  // the part needs dP and dS
  bf16* a1_s = reinterpret_cast<bf16*>(smem_raw);  // [kBwdRows][D]
  bf16* a2_s = a1_s + kBwdRows * D;                // [kBwdRows][D]
  bf16* b1_s = a2_s + kBwdRows * D;                // [2][kS][D]
  bf16* b2_s = b1_s + 2 * kS * D;                  // [2][kS][D]
  float* lse_s = reinterpret_cast<float*>(b2_s + 2 * kS * D);  // [2][kS]
  float* d_s = lse_s + 2 * kS;                                  // [2][kS]
  const int t = p.t;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t rbase = static_cast<size_t>(bh) * t;
  const bf16* a1 = (kDq ? p.q : p.k) + base;
  const bf16* a2 = (kDq ? p.dout : p.v) + base;
  const bf16* b1 = (kDq ? p.k : p.q) + base;
  const bf16* b2 = (kDq ? p.v : p.dout) + base;
  auto rows_of = [&](const bf16* src, int row0) {
    return [=](int r) -> const bf16* {
      return row0 + r < t ? src + static_cast<size_t>(row0 + r) * D : nullptr;
    };
  };
  copy_rows<D, kBwdThreads>(a1_s, kBwdRows, tid, a1, rows_of(a1, own0));
  if (kDs) copy_rows<D, kBwdThreads>(a2_s, kBwdRows, tid, a2, rows_of(a2, own0));
  const int n_s = (t + kS - 1) / kS;
  // Causal: dq reads the key tiles up to the one holding the block's last
  // row (:263), dk and dv the q tiles from the one holding its first (:322).
  const int first = (!kDq && p.causal) ? own0 / kS : 0;
  const int last = (kDq && p.causal) ? min(n_s, (own0 + kBwdRows - 1) / kS + 1) : n_s;
  auto load_stream = [&](int st, int stage) {
    const int r0 = st * kS;
    copy_rows<D, kBwdThreads>(b1_s + stage * kS * D, kS, tid, b1, rows_of(b1, r0));
    copy_rows<D, kBwdThreads>(b2_s + stage * kS * D, kS, tid, b2, rows_of(b2, r0));
    if (!kDq && tid < (kDs ? 2 : 1) * kS) {  // lse (and D) of the streamed rows
      const int r = tid % kS;
      const bool in = r0 + r < t;
      const float* src = (tid < kS ? p.lse : p.dvec) + rbase;
      float* dst = (tid < kS ? lse_s : d_s) + stage * kS + r;
      cp_async4(smem_addr(dst), in ? src + r0 + r : src, in);
    }
  };
  load_stream(first, 0);
  cp_async_commit();  // the own tiles and the first streamed tile

  const int rw = own0 + warp * 16;  // the warp's first own row
  const int tq = lane & 3;
  const int rows[2] = {rw + (lane >> 2), rw + (lane >> 2) + 8};
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};  // dq: lse log2 e and D per own row
  if (kDq) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < t) {
        lse_r[i] = p.lse[rbase + rows[i]] * kLog2e;
        d_r[i] = p.dvec[rbase + rows[i]];
      }
    }
  }
  const float c = p.scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int st = first; st < last; ++st) {
    const int stage = (st - first) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile st is in; every warp is done with tile st - 1
    if (st + 1 < last) load_stream(st + 1, stage ^ 1);
    cp_async_commit();
    const int s0 = st * kS;
    // Nothing to do where every own row is padding or the causal mask
    // removes the warp's whole [16, kS] tile.
    if (rw >= t || (p.causal && (kDq ? s0 > rw + 15 : s0 + kS - 1 < rw))) continue;
    const bf16* b1t = b1_s + stage * kS * D;
    const bf16* b2t = b2_s + stage * kS * D;
    const float* lse_t = lse_s + stage * kS;
    const float* d_t = d_s + stage * kS;
    // Every entry valid: inside T and, causal, every q at or after every key.
    const bool full = s0 + kS <= t && rw + 15 < t &&
                      (!p.causal || (kDq ? s0 + kS - 1 <= rw : s0 >= rw + 15));
    float s[kN][4];
    mma_abt<D>(s, a1_s, warp * 16, b1t, 0, lane);
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * tq + (e & 1);
        const int qp = kDq ? rows[e >> 1] : s0 + col;
        const int kp = kDq ? s0 + col : rows[e >> 1];
        const bool ok = full || (qp < t && kp < t && (!p.causal || qp >= kp));
        const float l2 = kDq ? lse_r[e >> 1] : lse_t[col] * kLog2e;
        s[n][e] = ok ? exp2f(fmaf(s[n][e], c, -l2)) : 0.f;  // P
      }
    if constexpr (kDs) {
      float dp[kN][4];
      mma_abt<D>(dp, a2_s, warp * 16, b2t, 0, lane);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dd = kDq ? d_r[e >> 1] : d_t[8 * n + 2 * tq + (e & 1)];
          s[n][e] *= dp[n][e] - dd;  // dS
        }
    }
#pragma unroll
    for (int kk = 0; kk < kS / 16; ++kk) {
      uint32_t pa[kBwdTerms][4];
      a_terms<kBwdTerms>(pa, s, kk);
      mma_av<D, kBwdTerms>(acc, pa, kDs ? b1t : b2t, 16 * kk, lane);
    }
  }
  cp_async_wait<0>();
  bf16* out = (kDq ? p.dq : kPart == BwdPart::kDk ? p.dk : p.dv) + base;
  const float mul = kPart == BwdPart::kDv ? 1.f : p.scale;  // (:267, :326-327)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= t) continue;
    bf16* row = out + static_cast<size_t>(rows[i]) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_mma_kernel(const BwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bwd_mma_part<D, BwdPart::kDq>(p, blockIdx.x, (gridDim.y - 1 - blockIdx.y) * kBwdRows,
                                smem_raw);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_mma_kernel(const BwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int own0 = blockIdx.y * kBwdRows;
  if (blockIdx.x & 1) {
    bwd_mma_part<D, BwdPart::kDv>(p, blockIdx.x >> 1, own0, smem_raw);
  } else {
    bwd_mma_part<D, BwdPart::kDk>(p, blockIdx.x >> 1, own0, smem_raw);
  }
}

// dq (kDkv false) or dk and dv (kDkv true) over the grid (bh, or 2 bh for
// the dk/dv pairs; own tiles of kBwdRows).
template <int D, bool kDkv>
cudaError_t launch_bwd_mma(int bh, cudaStream_t s, const BwdArgs& a) {
  static size_t granted[kMaxDevices] = {};
  const auto kernel = kDkv ? flash_bwd_dkv_mma_kernel<D> : flash_bwd_dq_mma_kernel<D>;
  const cudaError_t err = opt_in_smem(kernel, bwd_mma_smem<D>(), granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((kDkv ? 2 : 1) * bh, (a.t + kBwdRows - 1) / kBwdRows);
  kernel<<<grid, kBwdThreads, bwd_mma_smem<D>(), s>>>(a);
  return cudaGetLastError();
}

template <bool kDkv>
int bwd_mma(int head_dim, int bh, void* stream, const BwdArgs& a) {
  if (bh <= 0 || a.t <= 0 || bh > (1 << 29) || (a.t + kBwdRows - 1) / kBwdRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (head_dim) {
    case 64: err = launch_bwd_mma<64, kDkv>(bh, s, a); break;
    case 128: err = launch_bwd_mma<128, kDkv>(bh, s, a); break;
    case 256: err = launch_bwd_mma<256, kDkv>(bh, s, a); break;
  }
  return static_cast<int>(err);
}

template <template <int> class Launch, typename... Args>
cudaError_t by_head_dim(int head_dim, Args... args) {
  switch (head_dim) {
    case 64: return Launch<64>::run(args...);
    case 128: return Launch<128>::run(args...);
    case 256: return Launch<256>::run(args...);
  }
  return cudaErrorInvalidValue;
}

// Launch<head_dim>::run over the grid (b*h, q or k tiles of kOwn rows): the
// simt kernels take f32 only (bf16 takes the mma route).
template <template <int> class Launch, typename... Args>
int dispatch(int dtype, int head_dim, int bh, int t, void* stream, Args... args) {
  if (dtype != kF32 || bh <= 0 || t <= 0 || (t + kOwn - 1) / kOwn > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(bh, (t + kOwn - 1) / kOwn);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_head_dim<Launch>(head_dim, grid, s, args...));
}

}  // namespace

extern "C" {

// The simt route, f32 only (bf16 takes the mma entry points below and is
// refused here). q, k, v, o [bh, t, head_dim] in dtype (0 f32); lse [bh, t]
// f32. head_dim 64, 128 or 256. Each returns cudaGetLastError() after the
// launch.
int nos_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int t, int head_dim, int dtype, int causal, float scale, void* stream) {
  return dispatch<Fwd>(dtype, head_dim, bh, t, stream, q, k, v, o, lse, t, causal, scale);
}

// dq [bh, t, head_dim] from q, k, v, dO and the forward's lse and D =
// rowsum(dO * O) [bh, t] f32.
int nos_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* dvec, void* dq, int bh, int t,
                     int head_dim, int dtype, int causal, float scale, void* stream) {
  return dispatch<Dq>(dtype, head_dim, bh, t, stream, q, k, v, dout, lse, dvec, dq, t, causal,
                      scale);
}

// dk, dv [bh, t, head_dim] from the same inputs.
int nos_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dvec, void* dk, void* dv, int bh, int t,
                      int head_dim, int dtype, int causal, float scale, void* stream) {
  return dispatch<Dkv>(dtype, head_dim, bh, t, stream, q, k, v, dout, lse, dvec, dk, dv, t,
                       causal, scale);
}

// The mma route: bf16 q, k, v, o, dO, dq, dk, dv [bh, t, head_dim], lse
// and D [bh, t] f32, head_dim 64, 128 or 256. Each returns
// cudaGetLastError() after the launch.
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

int nos_flash_bwd_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* dvec, void* dq, int bh, int t,
                         int head_dim, int causal, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dvec,
                  static_cast<bf16*>(dq), nullptr, nullptr, t, causal, scale};
  return bwd_mma<false>(head_dim, bh, stream, a);
}

int nos_flash_bwd_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* dvec, void* dk, void* dv, int bh,
                          int t, int head_dim, int causal, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dvec,
                  nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, causal, scale};
  return bwd_mma<true>(head_dim, bh, stream, a);
}

}  // extern "C"
