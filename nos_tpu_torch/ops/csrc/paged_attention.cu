// Paged attention over a block-paged KV pool, written by hand for Hopper
// (sm_90a). Three launchers over three kernel bodies:
//
//   nos_paged_decode_attention      replaces nos_tpu/ops/paged_attention.py::_pallas
//                                   (one query token per sequence): the "split"
//                                   route, split_decode.cuh's kernel, for every
//                                   dtype;
//   nos_paged_window_attention      replaces nos_tpu/ops/paged_attention.py::_window_pallas
//                                   (W query tokens per sequence, per-row causal
//                                   limit): the simt route, for f32, int8 pools and
//                                   head dims outside 64/128/256;
//   nos_paged_window_attention_mma  the same contract on tensor cores: the mma
//                                   route, bf16 q over a bf16 pool at head_dim 64,
//                                   128 or 256 (the serving main path).
// The wrapper (ops/paged_attention.py::_window_route) picks the window's
// route from dtypes and shapes alone.
//
// What they compute (the Pallas kernels' contract): for every (sequence b, KV
// group g) the `rep` query heads of the group (times W window rows, laid out
// group-major: row = r * W + w) attend the pages table[b, 0..] of the pool
// [T, nkv, bs, hd] up to a per-row limit, with an online f32 softmax across
// pages. Masked lanes are zeroed explicitly (never exp(-1e30 - m)), the
// output is divided by max(l, 1e-30), and an int8 pool is dequantized by its
// per-block scale right after each block load.
//
// The decode kernel splits each lane's keys into fixed 128-key splits
// spread over the card and combines them in split order (flash-decoding);
// split_decode.cuh holds its design, shared with the dense decode kernel.
//
// The simt body (the window's route for f32 and int8). One CUDA block per
// (b, g, row tile) keeps the row tile's queries, running max / normalizer
// and f32 accumulator in shared memory, streams one page at a time (16-byte
// vector loads, converted to f32 on the way into shared memory) and never
// writes scores to device memory. The loop stops at the page of the tile's
// largest limit, which is exact: a fully masked page leaves m, l and acc
// unchanged. Few blocks per SM, page loads not overlapped with compute, and
// each score a dependent FMA chain make it latency-bound (PERF.md).
//
// The mma route. A prefill window's rows x keys products make operations
// its bound (2.3 GFLOP for the serving wave of two 256-row chunks at
// position 2048, 2.3 us at 989 TFLOP/s against 2 us of bytes); as SIMT f32
// arithmetic it ran at 1 TFLOP/s. The design (FlashAttention-2 on
// mma.sync, csrc/mma.cuh): warps own 16 window rows of one head, so rows of
// a warp share positions and one K/V stream; S = q k^T comes from ldmatrix'd
// bf16 fragments in f32, then times the scale; the masked online softmax
// runs on the S fragment, each row held to its own limit; P stays in
// registers and enters PV as three bf16 terms (all of its f32 bits, so the
// window keeps the Pallas kernel's f32 weights); key rows, not pages, are
// gathered by cp.async into a two-stage ring, the next tile's copies in
// flight while this tile's products run, whatever the block size. What
// still bounds it is latency: the serving wave has 256 warp tiles of work
// for the card's 528 schedulers, so two warps split each tile's keys and
// merge at the end (window_mma_kernel below).

#include "common.cuh"
#include "mma.cuh"
#include "split_decode.cuh"

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
  const int32_t* pos;      // [B]
  const int32_t* lengths;  // [B]
  const uint8_t* mask;     // [B] bool
  void* out;
  int n_kv;
  int head_dim;
  int block_size;
  int n_pages;
  int rows_per_group;  // rep * W
  int window;          // W
  int row_tile;        // rows one CUDA block owns (<= kMaxRowTile)
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The per-row attention limit: a window row attends up to pos[b] + w + 1
// while w < lengths[b] and the lane is active, else only the first position
// (the scratch guard of _window_pallas).
__device__ __forceinline__ int row_limit(const Params& p, int b, int row) {
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

// -- the mma route: bf16 q over a bf16 pool, head_dim 64, 128 or 256 ------------
//
// One CUDA block per (sequence b, KV group g) and kWinUnits consecutive
// warp units of the group's (window tile, head) grid, unit u = the 16
// window positions from (u / rep) * 16 of head u % rep: at rep 4 a block is
// one 16-position tile of the group's four heads, at rep 1 four tiles of
// one head, at rep 8 half the heads of a tile. Every row of the block reads
// one K/V stream, key j at pool row (table[b, j / bs] * nkv + g) * bs +
// j % bs, staged kWinKeys keys at a time by cp.async into a two-stage ring
// whatever the block size. Each unit has two warps, each taking one half
// of every staged tile's keys with its own softmax state; they merge at the
// end. Two warps per unit put two warps on every scheduler the block
// occupies, which hides the latency of the dependent products.

constexpr int kWinUnits = 4;                  // 16-row warp units per block
constexpr int kWinWarps = 2 * kWinUnits;      // two warps per unit
constexpr int kWinThreads = 32 * kWinWarps;
constexpr int kWinKeys = 64;                  // keys per stage
constexpr int kWarpKeys = kWinKeys / 2;       // of which one warp takes
// P enters PV as hi + mid + lo, three bf16 terms that hold all 24 bits of
// the f32 weight. One bf16 rounding of P (2^-9) moves outputs near 1 by a
// bf16 step (2^-7), beyond the 5e-3 that the kernel is held to, and so can
// hi + lo (16 bits) on the card gate's shapes (tests/
// test_torch_paged_attention.py::test_window_two_bf16_terms_of_p_can_miss_the_bound).
constexpr int kPTerms = 3;

struct WindowMmaParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* table;
  const int32_t* pos;
  const int32_t* lengths;
  const uint8_t* mask;
  __nv_bfloat16* out;
  int n_heads;
  int n_kv;
  int rep;
  int window;
  int block_size;
  int n_pages;
  int units;  // ceil(window / 16) * rep
  float scale;
};

// Q, the K/V ring and the staged page table.
template <int D>
size_t window_mma_smem(int n_pages) {
  return sizeof(__nv_bfloat16) * (kWinUnits * 16 * D + 2 * 2 * kWinKeys * D) +
         sizeof(int) * static_cast<size_t>(n_pages);
}

template <int D>
__global__ void __launch_bounds__(kWinThreads) window_mma_kernel(WindowMmaParams p) {
  using namespace nos::mma;
  using bf16 = __nv_bfloat16;
  constexpr int kN = kWarpKeys / 8;  // 8-key accumulator blocks of a warp's S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kWinUnits * 16][D]
  bf16* k_s = q_s + kWinUnits * 16 * D;            // [2][kWinKeys][D]
  bf16* v_s = k_s + 2 * kWinKeys * D;              // [2][kWinKeys][D]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int slot = (tid >> 5) % kWinUnits;  // the warp's unit in the block
  const int part = (tid >> 5) / kWinUnits;  // and its share of each tile
  const int b = blockIdx.y / p.n_kv;
  const int g = blockIdx.y % p.n_kv;
  const int blk = gridDim.x - 1 - blockIdx.x;  // the last tiles (longest rows) first
  const int unit0 = blk * kWinUnits;
  const int pos_b = p.pos[b];
  const int len_b = p.lengths[b];
  const bool active = p.mask[b] != 0;
  const int n_stream = p.n_pages * p.block_size;  // keys the table can address
  // Row w's limit (row_limit above); a masked lane's rows all read key 0.
  auto limit_of = [&](int w) { return (active && w < len_b) ? pos_b + w + 1 : 1; };
  // The largest limit of unit u's rows (0 for no unit): limits grow with w
  // up to lengths[b] - 1 and are 1 past it.
  auto unit_max = [&](int u) {
    if (u >= p.units) return 0;
    const int w0 = (u / p.rep) * 16;
    return limit_of(min(min(w0 + 15, p.window - 1), max(len_b - 1, w0)));
  };
  int block_max = 0;
#pragma unroll
  for (int i = 0; i < kWinUnits; ++i) block_max = max(block_max, unit_max(unit0 + i));
  const int n_keys = min(block_max, n_stream);
  const int n_tiles = (n_keys + kWinKeys - 1) / kWinKeys;

  const size_t q_rows = static_cast<size_t>(b) * p.n_heads * p.window;  // b's first row
  copy_rows<D, kWinThreads>(q_s, kWinUnits * 16, tid, p.q, [&](int r) -> const bf16* {
    const int u = unit0 + r / 16;
    const int w = (u / p.rep) * 16 + r % 16;
    if (u >= p.units || w >= p.window) return nullptr;
    const int head = g * p.rep + u % p.rep;
    return p.q + (q_rows + static_cast<size_t>(head) * p.window + w) * D;
  });
  // The pages the stream spans, staged once: each key's page id is then a
  // shared-memory read, not a dependent global load ahead of its copy.
  int* table_s = reinterpret_cast<int*>(v_s + 2 * kWinKeys * D);  // [n_pages]
  {
    const int n_used = min(p.n_pages, (n_keys + p.block_size - 1) / p.block_size);
    const int32_t* table = p.table + static_cast<size_t>(b) * p.n_pages;
    for (int i = tid; i < n_used; i += kWinThreads) table_s[i] = table[i];
    __syncthreads();
  }
  const bool bs_pow2 = (p.block_size & (p.block_size - 1)) == 0;
  const int bs_shift = __ffs(p.block_size) - 1;
  auto load_kv = [&](int kt, int stage) {
    constexpr int kC = D / 8;  // as copy_rows: a fixed chunk, every (threads / kC)-th key
    bf16* kd = k_s + stage * kWinKeys * D;
    bf16* vd = v_s + stage * kWinKeys * D;
    const int c = tid % kC;
    for (int r = tid / kC; r < kWinKeys; r += kWinThreads / kC) {
      const int j = kt * kWinKeys + r;
      const bool in = j < n_keys;  // past every row's limit: zeros, nothing read
      size_t off = 0;
      if (in) {
        const int page = bs_pow2 ? j >> bs_shift : j / p.block_size;
        const int row = j - page * p.block_size;
        off = ((static_cast<size_t>(table_s[page]) * p.n_kv + g) * p.block_size + row) * D +
              c * 8;
      }
      const int at = Swizzled<D>::at(r, c);
      cp_async16(smem_addr(kd + at), p.k + off, in);
      cp_async16(smem_addr(vd + at), p.v + off, in);
    }
  };
  load_kv(0, 0);
  cp_async_commit();  // Q and the first K/V tile

  const int unit = unit0 + slot;
  const bool has_unit = unit < p.units;
  const int w0 = (unit / p.rep) * 16;
  const int warp_max = unit_max(unit);
  const int key0 = part * kWarpKeys;  // the warp's first key of each tile
  const int tq = lane & 3;
  int lim[2];  // the thread's rows w0 + lane / 4 and w0 + lane / 4 + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int w = w0 + (lane >> 2) + 8 * i;
    lim[i] = (has_unit && w < p.window) ? min(limit_of(w), n_stream) : 0;
  }
  Softmax<kN> sm;
  float acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < n_tiles) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    const int j0 = kt * kWinKeys + key0;
    if (j0 >= warp_max) continue;  // every key from here is past the warp's limits
    const bf16* kt_s = k_s + (kt & 1) * kWinKeys * D;
    const bf16* vt_s = v_s + (kt & 1) * kWinKeys * D;
    float s[kN][4];
    mma_abt<D>(s, q_s, slot * 16, kt_s, key0, lane);
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= p.scale;  // the unscaled product, then scale
    float alpha[2];
    sm.update(s, [&](int n, int e) { return j0 + 8 * n + 2 * tq + (e & 1) < lim[e >> 1]; },
              alpha);
    rescale(acc, alpha);
#pragma unroll
    for (int kk = 0; kk < kWarpKeys / 16; ++kk) {
      uint32_t pa[kPTerms][4];
      a_terms<kPTerms>(pa, s, kk);
      mma_av<D, kPTerms>(acc, pa, vt_s, key0 + 16 * kk, lane);
    }
  }
  cp_async_wait<0>();
  sm.finish();
  // The second warp of each unit hands (acc, m, l) to the first through
  // the K/V ring, which no warp reads any more; the first merges them.
  constexpr int kSlots = D / 8 + 1;  // float4s per thread: acc blocks, then m and l
  float4* xchg = reinterpret_cast<float4*>(k_s) + (slot * 32 + lane) * kSlots;
  __syncthreads();
  if (part == 1) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      xchg[c] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    }
    xchg[D / 8] = make_float4(sm.m[0], sm.m[1], sm.l[0], sm.l[1]);
  }
  __syncthreads();
  if (part == 1) return;
  const float4 ml = xchg[D / 8];
  const float m_o[2] = {ml.x, ml.y};
  const float l_o[2] = {ml.z, ml.w};
  float a_self[2], a_o[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(sm.m[i], m_o[i]);
    a_self[i] = expf(sm.m[i] - m_new);
    a_o[i] = expf(m_o[i] - m_new);
    sm.l[i] = sm.l[i] * a_self[i] + l_o[i] * a_o[i];
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const float4 o = xchg[c];
    acc[c][0] = acc[c][0] * a_self[0] + o.x * a_o[0];
    acc[c][1] = acc[c][1] * a_self[0] + o.y * a_o[0];
    acc[c][2] = acc[c][2] * a_self[1] + o.z * a_o[1];
    acc[c][3] = acc[c][3] * a_self[1] + o.w * a_o[1];
  }
  if (!has_unit) return;
  const int head = g * p.rep + unit % p.rep;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int w = w0 + (lane >> 2) + 8 * i;
    if (w >= p.window) continue;
    const float den = fmaxf(sm.l[i], 1e-30f);
    bf16* orow = p.out + (q_rows + static_cast<size_t>(head) * p.window + w) * D + 2 * tq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(acc[c][2 * i] / den, acc[c][2 * i + 1] / den);
    }
  }
}

template <int D>
cudaError_t launch_window_mma(const WindowMmaParams& p, int groups, cudaStream_t stream) {
  auto kernel = window_mma_kernel<D>;
  static size_t granted[kMaxDevices] = {};
  const size_t smem = window_mma_smem<D>(p.n_pages);
  const cudaError_t err = opt_in_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.units + kWinUnits - 1) / kWinUnits, groups);
  kernel<<<grid, kWinThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The decode kernel (split_decode.cuh) for each (q, pool) dtype pair.
cudaError_t launch_decode(const split::Params& p, int batch, int q_dtype, int kv_dtype,
                          long long part_floats, long long n_counters, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (q_dtype == kF32 && kv_dtype == kF32) {
    return split::launch<float, float, false, true>(p, batch, part_floats, n_counters, s);
  }
  if (q_dtype == kBF16 && kv_dtype == kBF16) {
    return split::launch<bf16, bf16, false, true>(p, batch, part_floats, n_counters, s);
  }
  if (q_dtype == kF32 && kv_dtype == kI8) {
    return split::launch<float, int8_t, true, true>(p, batch, part_floats, n_counters, s);
  }
  if (q_dtype == kBF16 && kv_dtype == kI8) {
    return split::launch<bf16, int8_t, true, true>(p, batch, part_floats, n_counters, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, nh, hd]; pools [T, nkv, bs, hd]; table [B, P] i32; limit [B] i32;
// out [B, nh, hd] in q's dtype; part (part_floats f32) and counters
// (n_counters i32, 0 between launches) the split kernel's scratch
// (split_decode.cuh). Returns cudaGetLastError() after the launch.
int nos_paged_decode_attention(const void* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int32_t* table, const int32_t* limit, void* out,
                               float* part, int* counters, int batch, int n_heads, int n_kv,
                               int head_dim, int block_size, int n_pages, int q_dtype,
                               int kv_dtype, float scale, long long part_floats,
                               long long n_counters, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || block_size <= 0 || n_pages <= 0 ||
      static_cast<long long>(block_size) * n_pages > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nos::split::Params p{};
  p.q = q; p.k = k; p.v = v; p.k_scale = k_scale; p.v_scale = v_scale;
  p.table = table; p.limit = limit; p.out = out; p.part = part; p.counters = counters;
  p.n_kv = n_kv; p.rep = n_heads / n_kv; p.head_dim = head_dim;
  p.keys = block_size * n_pages; p.block_size = block_size; p.n_pages = n_pages;
  p.scale = scale;
  return static_cast<int>(launch_decode(p, batch, q_dtype, kv_dtype, part_floats, n_counters,
                                         static_cast<cudaStream_t>(stream)));
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

// The window's mma route: bf16 q [B, nh, W, hd] over bf16 pools, head_dim
// 64, 128 or 256; the other arguments as nos_paged_window_attention's.
int nos_paged_window_attention_mma(const void* q, const void* k, const void* v,
                                   const int32_t* table, const int32_t* pos,
                                   const int32_t* lengths, const uint8_t* mask, void* out,
                                   int batch, int n_heads, int n_kv, int window, int head_dim,
                                   int block_size, int n_pages, float scale, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || window <= 0 || block_size <= 0 || n_pages <= 0 ||
      batch < 0 || batch * n_kv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaSuccess);
  WindowMmaParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.table = table; p.pos = pos; p.lengths = lengths; p.mask = mask;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.n_heads = n_heads; p.n_kv = n_kv; p.rep = n_heads / n_kv; p.window = window;
  p.block_size = block_size; p.n_pages = n_pages;
  p.units = ((window + 15) / 16) * p.rep;
  p.scale = scale;
  const int groups = batch * n_kv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (head_dim) {
    case 64: err = launch_window_mma<64>(p, groups, s); break;
    case 128: err = launch_window_mma<128>(p, groups, s); break;
    case 256: err = launch_window_mma<256>(p, groups, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
