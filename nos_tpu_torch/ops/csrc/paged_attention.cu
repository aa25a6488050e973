// Paged attention over a block-paged KV pool, written by hand for Hopper
// (sm_90a). Two entry points share one kernel body:
//
//   nos_paged_decode_attention  replaces nos_tpu/ops/paged_attention.py::_pallas
//                               (one query token per sequence);
//   nos_paged_window_attention  replaces nos_tpu/ops/paged_attention.py::_window_pallas
//                               (W query tokens per sequence, per-row causal limit).
//
// What it computes (the Pallas kernels' contract): for every (sequence b, KV
// group g) the `rep` query heads of the group (times W window rows, laid out
// group-major: row = r * W + w) attend the pages table[b, 0..] of the pool
// [T, nkv, bs, hd] up to a per-row limit, with an online f32 softmax across
// pages. Masked lanes are zeroed explicitly (never exp(-1e30 - m)), the
// output is divided by max(l, 1e-30), and an int8 pool is dequantized by its
// per-block scale right after each block load.
//
// What bounds it on an H100: bytes. The least time is the K and V pages under
// each limit read once over HBM's 3.35 TB/s; the scores are rows x bs dot
// products of length hd, far below the card's arithmetic rate. The design:
// one CUDA block per (b, g, row tile) keeps the row tile's queries, running
// max / normalizer and f32 accumulator in shared memory, streams one page at
// a time (16-byte vector loads, converted to f32 on the way into shared
// memory) and never writes scores to device memory. The loop stops at the
// page of the tile's largest limit, which is exact: a fully masked page
// leaves m, l and acc unchanged. No sublane padding of `rep` to 8 as on the
// TPU. This first version is the simple one that is right, and it is far
// from the byte bound (PERF.md): few blocks per SM, page loads not
// overlapped with compute, and each score a dependent FMA chain make it
// latency-bound, and one block walks a long sequence's pages alone.
// Split-page (flash-decoding), cp.async/TMA double buffering and tensor-core
// products are later work.

#include "common.cuh"

namespace {

using namespace nos;

constexpr int kThreads = 128;     // four warps per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowTile = 64;   // query rows one CUDA block owns
constexpr int kMaxHeadDim = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;    // [T] f32, int8 pools only
  const float* v_scale;
  const int32_t* table;    // [B, n_pages]
  const int32_t* limit;    // decode: [B]; window: nullptr
  const int32_t* pos;      // window: [B]
  const int32_t* lengths;  // window: [B]
  const uint8_t* mask;     // window: [B] bool
  void* out;
  int n_kv;
  int head_dim;
  int block_size;
  int n_pages;
  int rows_per_group;  // rep * W
  int window;          // W (1 for decode)
  int row_tile;        // rows one CUDA block owns (<= kMaxRowTile)
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The per-row attention limit: decode rows share limit[b]; a window row
// attends up to pos[b] + w + 1 while w < lengths[b] and the lane is active,
// else only the first position (the scratch guard of _window_pallas).
__device__ __forceinline__ int row_limit(const Params& p, int b, int row) {
  if (p.limit != nullptr) return p.limit[b];
  const int w = row % p.window;
  const bool in_window = (w < p.lengths[b]) && (p.mask[b] != 0);
  return in_window ? p.pos[b] + w + 1 : 1;
}

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

size_t smem_bytes(int row_tile, int hd, int bs) {
  const size_t floats = static_cast<size_t>(row_tile) * hd   // q
                        + static_cast<size_t>(bs) * (hd + 1)  // K (padded rows)
                        + static_cast<size_t>(bs) * hd        // V
                        + static_cast<size_t>(row_tile) * bs  // scores / weights
                        + static_cast<size_t>(row_tile) * hd  // accumulator
                        + 3 * static_cast<size_t>(row_tile);  // m, l, alpha
  return floats * sizeof(float) + static_cast<size_t>(row_tile) * sizeof(int);
}

template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bg = blockIdx.x;  // b * n_kv + g
  const int b = bg / p.n_kv;
  const int g = bg % p.n_kv;
  const int row0 = blockIdx.y * p.row_tile;
  const int rows = min(p.row_tile, p.rows_per_group - row0);
  const int hd = p.head_dim;
  const int bs = p.block_size;
  const int kstride = hd + 1;  // pad K rows: neighbouring j hit distinct banks

  float* q_s = smem;
  float* k_s = q_s + p.row_tile * hd;
  float* v_s = k_s + bs * kstride;
  float* s_s = v_s + bs * hd;
  float* acc_s = s_s + p.row_tile * bs;
  float* m_s = acc_s + p.row_tile * hd;
  float* l_s = m_s + p.row_tile;
  float* a_s = l_s + p.row_tile;
  int* lim_s = reinterpret_cast<int*>(a_s + p.row_tile);
  __shared__ int max_lim;

  const size_t qbase = (static_cast<size_t>(bg) * p.rows_per_group + row0) * hd;
  const TQ* q = static_cast<const TQ*>(p.q) + qbase;
  for (int i = tid; i < rows * hd; i += kThreads) {
    q_s[i] = to_f32(q[i]);
    acc_s[i] = 0.0f;
  }
  if (tid == 0) max_lim = 0;
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) {
    const int lim = row_limit(p, b, row0 + r);
    lim_s[r] = lim;
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
    atomicMax(&max_lim, lim);
  }
  __syncthreads();
  const int n_pages = min(p.n_pages, (max_lim + bs - 1) / bs);

  const TKV* kpool = static_cast<const TKV*>(p.k);
  const TKV* vpool = static_cast<const TKV*>(p.v);
  const int32_t* table = p.table + static_cast<size_t>(b) * p.n_pages;
  const int chunks = bs * hd / 8;

  for (int page = 0; page < n_pages; ++page) {
    const int blk = table[page];
    const size_t off = (static_cast<size_t>(blk) * p.n_kv + g) * bs * hd;
    float ks = 1.0f, vs = 1.0f;
    if (kQuant) {
      ks = p.k_scale[blk];
      vs = p.v_scale[blk];
    }
    // Stage the page's K and V as f32 (dequantized for an int8 pool).
    for (int c = tid; c < chunks; c += kThreads) {
      const int e = c * 8;
      const int j = e / hd;
      const int d = e % hd;
      float kf[8], vf[8];
      load8(kpool + off + e, kf);
      load8(vpool + off + e, vf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        k_s[j * kstride + d + i] = kQuant ? kf[i] * ks : kf[i];
        v_s[j * hd + d + i] = kQuant ? vf[i] * vs : vf[i];
      }
    }
    __syncthreads();
    // Scores [rows, bs], masked to NEG_INF beyond each row's limit.
    const int base = page * bs;
    for (int i = tid; i < rows * bs; i += kThreads) {
      const int r = i / bs;
      const int j = i % bs;
      const float* qr = q_s + r * hd;
      const float* kj = k_s + j * kstride;
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kj[d], dot);
      s_s[i] = (base + j < lim_s[r]) ? dot * p.scale : kNegInf;
    }
    __syncthreads();
    // Online softmax update, one warp per row.
    for (int r = warp; r < rows; r += kWarps) {
      float* sr = s_s + r * bs;
      const int lim = lim_s[r];
      float mx = kNegInf;
      for (int j = lane; j < bs; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < bs; j += 32) {
        const float e = (base + j < lim) ? expf(sr[j] - m_new) : 0.0f;
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
      const float* wr = s_s + r * bs;
      float a = acc_s[i] * a_s[r];
      for (int j = 0; j < bs; ++j) a = fmaf(wr[j], v_s[j * hd + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  TQ* out = static_cast<TQ*>(p.out) + qbase;
  for (int i = tid; i < rows * hd; i += kThreads) {
    store(out + i, acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

template <typename TQ, typename TKV, bool kQuant>
cudaError_t launch_typed(const Params& p, int groups, size_t smem, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<TQ, TKV, kQuant>;
  static size_t granted[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, (p.rows_per_group + p.row_tile - 1) / p.row_tile);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int launch(Params p, int batch, int q_dtype, int kv_dtype, void* stream) {
  if (p.head_dim <= 0 || p.head_dim > kMaxHeadDim || p.head_dim % 8 != 0 ||
      p.block_size <= 0 || p.n_kv <= 0 || p.rows_per_group <= 0 || p.n_pages <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaSuccess);
  p.row_tile = p.rows_per_group < kMaxRowTile ? p.rows_per_group : kMaxRowTile;
  const size_t smem = smem_bytes(p.row_tile, p.head_dim, p.block_size);
  const int groups = batch * p.n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == kF32 && kv_dtype == kF32) {
    err = launch_typed<float, float, false>(p, groups, smem, s);
  } else if (q_dtype == kBF16 && kv_dtype == kBF16) {
    err = launch_typed<__nv_bfloat16, __nv_bfloat16, false>(p, groups, smem, s);
  } else if (q_dtype == kF32 && kv_dtype == kI8) {
    err = launch_typed<float, int8_t, true>(p, groups, smem, s);
  } else if (q_dtype == kBF16 && kv_dtype == kI8) {
    err = launch_typed<__nv_bfloat16, int8_t, true>(p, groups, smem, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q [B, nh, hd]; pools [T, nkv, bs, hd]; table [B, P] i32; limit [B] i32;
// out [B, nh, hd] in q's dtype. Returns cudaGetLastError() after the launch.
int nos_paged_decode_attention(const void* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int32_t* table, const int32_t* limit, void* out,
                               int batch, int n_heads, int n_kv, int head_dim,
                               int block_size, int n_pages, int q_dtype, int kv_dtype,
                               float scale, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q; p.k = k; p.v = v; p.k_scale = k_scale; p.v_scale = v_scale;
  p.table = table; p.limit = limit; p.out = out;
  p.n_kv = n_kv; p.head_dim = head_dim; p.block_size = block_size; p.n_pages = n_pages;
  p.rows_per_group = n_heads / n_kv;
  p.window = 1;
  p.scale = scale;
  return launch(p, batch, q_dtype, kv_dtype, stream);
}

// q [B, nh, W, hd]; pools and table as above; pos/lengths [B] i32; mask [B]
// bool; out [B, nh, W, hd]. Returns cudaGetLastError() after the launch.
int nos_paged_window_attention(const void* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int32_t* table, const int32_t* pos,
                               const int32_t* lengths, const uint8_t* mask, void* out,
                               int batch, int n_heads, int n_kv, int window, int head_dim,
                               int block_size, int n_pages, int q_dtype, int kv_dtype,
                               float scale, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || window <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = q; p.k = k; p.v = v; p.k_scale = k_scale; p.v_scale = v_scale;
  p.table = table; p.pos = pos; p.lengths = lengths; p.mask = mask; p.out = out;
  p.n_kv = n_kv; p.head_dim = head_dim; p.block_size = block_size; p.n_pages = n_pages;
  p.rows_per_group = (n_heads / n_kv) * window;
  p.window = window;
  p.scale = scale;
  return launch(p, batch, q_dtype, kv_dtype, stream);
}

}  // extern "C"
