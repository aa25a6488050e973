// Dense single-token decode attention, written by hand for Hopper (sm_90a).
//
//   nos_decode_attention  replaces nos_tpu/ops/decode_attention.py::_pallas (:46)
//
// What it computes (the Pallas kernel's contract): for every (sequence b, KV
// group g) the group's `rep` query heads attend the dense cache
// [B, nkv, max, hd] at positions < limit[b], with an f32 softmax and the
// weights kept in f32 against V read as f32 (they are not rounded to V's
// dtype); only the output is cast to q's dtype. Two edge cases follow from
// the reference's finite NEG_INF (-1e30): limit <= 0 masks every position
// with the same score, so the softmax is uniform and the output is the mean
// of V over all `max` rows; limit > max makes every position valid.
//
// What bounds it on an H100: bytes. The least time is K and V up to
// min(limit, max) read once (plus q and out) over HBM's 3.35 TB/s; the scores
// and the weighted sum are 4 * rep * hd flops a position, far below the
// card's arithmetic rate. The Pallas kernel loads a group's whole [max, hd]
// K and V into VMEM (1 MB each at max 8192, hd 64, bf16), more than a Hopper
// block's 227 KB of shared memory, so this kernel streams the cache instead:
// one CUDA block per (b, g, row tile) keeps the rows' queries, running max,
// normalizer and f32 accumulator in shared memory, walks the cache in tiles
// of 64 positions (16-byte vector loads, converted to f32 on the way into
// shared memory) with an online softmax, never writes scores to device
// memory, and stops at min(limit, max): the weights past the limit are
// exactly 0 in the reference, so reading them changes nothing. No atomics,
// so the sum order is fixed. This first version is the simple one that is
// right: one block per (b, g) leaves most SMs idle at a small batch, tile
// loads are not overlapped with compute and each score is a dependent FMA
// chain, so it is latency-bound far above the byte bound (PERF.md). A split
// over positions with a deterministic combine (flash-decoding) and
// double-buffered loads are later work.

#include "common.cuh"

namespace {

using namespace nos;

constexpr int kThreads = 256;     // eight warps per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;         // cache positions per shared-memory tile
constexpr int kMaxRowTile = 32;   // query rows one CUDA block owns
constexpr int kMaxHeadDim = 256;

struct Params {
  const void* q;          // [B, nh, hd]
  const void* k;          // [B, nkv, max, hd]
  const void* v;
  const int32_t* limit;   // [B]
  void* out;              // [B, nh, hd]
  int n_kv;
  int head_dim;
  int max_len;
  int rep;                // query heads per KV group
  int row_tile;           // rows one CUDA block owns (<= kMaxRowTile)
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int row_tile, int hd) {
  const size_t floats = static_cast<size_t>(row_tile) * hd        // q
                        + static_cast<size_t>(kTile) * (hd + 1)   // K (padded rows)
                        + static_cast<size_t>(kTile) * hd         // V
                        + static_cast<size_t>(row_tile) * kTile   // scores / weights
                        + static_cast<size_t>(row_tile) * hd      // accumulator
                        + 3 * static_cast<size_t>(row_tile);      // m, l, alpha
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bg = blockIdx.x;  // b * n_kv + g
  const int b = bg / p.n_kv;
  const int row0 = blockIdx.y * p.row_tile;
  const int rows = min(p.row_tile, p.rep - row0);
  const int hd = p.head_dim;
  const int kstride = hd + 1;  // pad K rows: neighbouring positions hit distinct banks

  float* q_s = smem;
  float* k_s = q_s + p.row_tile * hd;
  float* v_s = k_s + kTile * kstride;
  float* s_s = v_s + kTile * hd;
  float* acc_s = s_s + p.row_tile * kTile;
  float* m_s = acc_s + p.row_tile * hd;
  float* l_s = m_s + p.row_tile;
  float* a_s = l_s + p.row_tile;

  const size_t qbase = (static_cast<size_t>(bg) * p.rep + row0) * hd;
  const T* q = static_cast<const T*>(p.q) + qbase;
  for (int i = tid; i < rows * hd; i += kThreads) {
    q_s[i] = to_f32(q[i]);
    acc_s[i] = 0.0f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  // limit <= 0: every score is NEG_INF in the reference, so every weight is
  // equal over all max positions; score them all 0 instead.
  const int lim = p.limit[b];
  const bool uniform = lim <= 0;
  const int n = uniform ? p.max_len : min(lim, p.max_len);
  __syncthreads();

  const size_t cbase = static_cast<size_t>(bg) * p.max_len * hd;
  const T* kc = static_cast<const T*>(p.k) + cbase;
  const T* vc = static_cast<const T*>(p.v) + cbase;

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    // Stage the tile's K and V as f32.
    const T* kt = kc + static_cast<size_t>(base) * hd;
    const T* vt = vc + static_cast<size_t>(base) * hd;
    for (int c = tid; c < cnt * hd / 8; c += kThreads) {
      const int e = c * 8;
      const int j = e / hd;
      const int d = e % hd;
      float kf[8], vf[8];
      load8(kt + e, kf);
      load8(vt + e, vf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        k_s[j * kstride + d + i] = kf[i];
        v_s[j * hd + d + i] = vf[i];
      }
    }
    __syncthreads();
    // Scores [rows, kTile]; positions past the tile's end are never read.
    for (int i = tid; i < rows * kTile; i += kThreads) {
      const int r = i / kTile;
      const int j = i % kTile;
      float s = 0.0f;
      if (j < cnt && !uniform) {
        const float* qr = q_s + r * hd;
        const float* kj = k_s + j * kstride;
        float dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kj[d], dot);
        s = dot * p.scale;
      }
      s_s[i] = s;
    }
    __syncthreads();
    // Online softmax update, one warp per row.
    for (int r = warp; r < rows; r += kWarps) {
      float* sr = s_s + r * kTile;
      float mx = kNegInf;
      for (int j = lane; j < cnt; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < kTile; j += 32) {
        const float e = j < cnt ? expf(sr[j] - m_new) : 0.0f;
        sr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + weights @ V.
    for (int i = tid; i < rows * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i % hd;
      const float* wr = s_s + r * kTile;
      float a = acc_s[i] * a_s[r];
      for (int j = 0; j < cnt; ++j) a = fmaf(wr[j], v_s[j * hd + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out) + qbase;
  for (int i = tid; i < rows * hd; i += kThreads) {
    store(out + i, acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

template <typename T>
cudaError_t launch_typed(const Params& p, int groups, size_t smem, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T>;
  static size_t granted[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, (p.rep + p.row_tile - 1) / p.row_tile);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, nh, hd]; caches [B, nkv, max, hd] in q's dtype; limit [B] i32; out
// [B, nh, hd] in q's dtype. Returns cudaGetLastError() after the launch.
int nos_decode_attention(const void* q, const void* k, const void* v,
                         const int32_t* limit, void* out, int batch, int n_heads,
                         int n_kv, int head_dim, int max_len, int dtype, float scale,
                         void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || head_dim <= 0 || head_dim > kMaxHeadDim ||
      head_dim % 8 != 0 || max_len <= 0 || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaSuccess);
  Params p{};
  p.q = q; p.k = k; p.v = v; p.limit = limit; p.out = out;
  p.n_kv = n_kv; p.head_dim = head_dim; p.max_len = max_len;
  p.rep = n_heads / n_kv;
  p.row_tile = p.rep < kMaxRowTile ? p.rep : kMaxRowTile;
  p.scale = scale;
  const size_t smem = smem_bytes(p.row_tile, head_dim);
  const int groups = batch * n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32) {
    err = launch_typed<float>(p, groups, smem, s);
  } else if (dtype == kBF16) {
    err = launch_typed<__nv_bfloat16>(p, groups, smem, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
