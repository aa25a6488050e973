// Single-token decode attention split over keys (flash-decoding) for Hopper
// (sm_90a): the one kernel body behind
//
//   nos_paged_decode_attention  (paged_attention.cu)   replaces
//                               nos_tpu/ops/paged_attention.py::_pallas (:62);
//   nos_decode_attention        (decode_attention.cu)  replaces
//                               nos_tpu/ops/decode_attention.py::_pallas (:46).
//
// What it computes (the Pallas kernels' contract): for every (sequence b, KV
// group g) the group's `rep` query heads attend the lane's keys 0..n_keys-1
// with an f32 softmax; K and V are read as f32 (an int8 pool dequantized by
// its per-block scale right after the load), masked weights are zeroed
// explicitly and the output, divided by max(l, 1e-30), is cast to q's dtype.
// Paged: key j of lane b is row j % bs of page table[b, j / bs] of the pool
// [T, nkv, bs, hd]; n_keys = min(limit, n_pages * bs), and limit <= 0 leaves
// no key, so the output is 0 (as the Pallas kernel's, whose every weight is
// masked). Dense: key j is row j of the cache [B, nkv, max, hd]; n_keys =
// min(limit, max), and limit <= 0 scores every one of the `max` positions
// alike (the reference's finite NEG_INF), so the output is the mean of V.
//
// What bounds it on an H100: bytes, K and V under each limit read once over
// HBM's 3.35 TB/s (4.95 MB, 1.5 us, at the serving step's limits); the
// scores and the weighted sum are 4 rep hd flops a key. A decode step has
// few (b, g) pairs (16 at the serving shape), so one CUDA block per pair,
// the first design, left 116 of 132 SMs idle and walked a 4160-key lane
// alone, one dependent load after another. The design:
//
// - Grid (B nkv, n_split, row tiles). Split s holds keys [s K, (s + 1) K)
//   of its lane, K = kSplitKeys, n_split = ceil(keys / K) from the widths
//   the host knows (n_pages bs, or max); a split at or past the lane's
//   n_keys returns at once. The boundaries depend on the position alone,
//   not on nkv, B or the card, so a tensor-parallel shard computes every
//   head bit for bit as the whole kernel does.
// - A block keeps up to kMaxRows of the group's heads (a row tile), so K and
//   V are read once per group, the saving GQA exists for. Each lane holds
//   an 8-element chunk of every row's q in registers; kGroup lanes (8 at
//   head_dim 64) read one key row with 16-byte loads and reduce its dot
//   products with shuffles, so a warp takes 32 / kGroup keys a step. Each
//   lane keeps the online softmax (m warp-wide, l and acc its own keys')
//   in f32 registers. The raw loads of the next kDepth - 1 steps are in
//   flight while a step's math runs. No __syncthreads in the key loop: the
//   warps merge (m, l, acc) once, at the end of the split, in warp order.
// - A split that is its lane's only one writes the output. Otherwise each
//   writes (acc, m, l) in f32 to the scratch the wrapper allocates, and the
//   last of the lane's splits to arrive (a per-(b, g, tile) counter, which
//   that block sets back to 0, so the kernel needs no memset and can be
//   replayed in a CUDA graph) combines them in split order:
//   out = sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M} l_s, 1e-30),
//   M = max_s m_s. Atomics touch the counters only, never data, so two
//   launches give the same bits.
//
// kSplitKeys = 128. 128 and 256 were timed in turns on an NVIDIA H100 80GB
// HBM3 at 700 W (decode_split_sweep.py, device time from the profiler):
// at the serving step's limits 128 took 0.0179 ms against 0.0208, at the
// dense programs' 0.0134 against 0.0175, since twice the splits put twice
// the blocks on the card's 132 SMs; at 8192 keys a lane the two were within
// 3% (0.0469 and 0.0458 ms). PERF.md section 6 has the rest.

#pragma once

#include "common.cuh"

namespace nos {
namespace split {

constexpr int kSplitKeys = 128;  // keys of one split (see the header)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 8;      // query heads one block owns
constexpr int kMaxHeadDim = 256;

struct Params {
  const void* q;         // [B, nh, hd]
  const void* k;         // paged: pool [T, nkv, bs, hd]; dense: cache [B, nkv, max, hd]
  const void* v;
  const float* k_scale;  // [T] f32, int8 pools only
  const float* v_scale;
  const int32_t* table;  // paged: [B, n_pages]; dense: nullptr
  const int32_t* limit;  // [B]
  void* out;             // [B, nh, hd] in q's dtype
  float* part;           // [B nkv, n_split, rep, hd + 2] f32: acc, m, l of each split
  int* counters;         // [B nkv n_tiles], 0 between launches
  int n_kv;
  int rep;
  int head_dim;
  int keys;              // positions a lane can address: n_pages bs, or max
  int block_size;        // paged only
  int n_pages;           // paged only
  int n_split;           // ceil(keys / kSplitKeys)
  int n_tiles;           // ceil(rep / rows)
  float scale;
};

// Eight consecutive elements as loaded (16 bytes of bf16, 32 of f32, 8 of
// int8), converted to f32 only when used, so a prefetch holds no f32 copy.
template <typename T>
struct Raw;

template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void to_f32(float* o) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

template <>
struct Raw<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    a = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { a = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void to_f32(float* o) const {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);              // the low bf16
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // the high bf16
    }
  }
};

template <>
struct Raw<int8_t> {
  uint2 a;
  __device__ __forceinline__ void load(const int8_t* p) { a = *reinterpret_cast<const uint2*>(p); }
  __device__ __forceinline__ void zero() { a = make_uint2(0u, 0u); }
  __device__ __forceinline__ void to_f32(float* o) const {
    const uint32_t w[2] = {a.x, a.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
    }
  }
};

template <typename TQ, typename TKV, bool kQuant, bool kPaged, int kRows, int kGroup>
__global__ void __launch_bounds__(kThreads) split_decode_kernel(Params p) {
  constexpr int kKeysPerWarp = 32 / kGroup;       // key rows a warp reads a step
  constexpr int kStride = kWarps * kKeysPerWarp;  // and the block
  // Steps whose loads are in flight. Twice as many (all 8 steps of a
  // 128-key split at head_dim 64) took the serving shape's kernel from 165
  // to 227 registers, 2 blocks an SM instead of 3, and slowed it (PERF.md
  // section 6).
  constexpr int kDepth = sizeof(TKV) == 4 ? 2 : 4;
  __shared__ float acc_s[kWarps][kRows][8 * kGroup];
  __shared__ float m_s[kWarps][kRows];
  __shared__ float l_s[kWarps][kRows];
  __shared__ float big_m[kRows];
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane / kGroup;  // which of the warp's key rows this lane reads
  const int c = lane % kGroup;    // and which 8-element chunk of it
  const int hd = p.head_dim;
  const bool has_chunk = c * 8 < hd;
  const int bg = blockIdx.x;  // b * n_kv + g
  const int b = bg / p.n_kv;
  const int g = bg % p.n_kv;
  const int s = blockIdx.y;
  const int tile = blockIdx.z;
  const int row0 = tile * kRows;
  const int rows = min(kRows, p.rep - row0);
  const int lim = p.limit[b];
  const bool uniform = !kPaged && lim <= 0;
  const int n_keys = uniform ? p.keys : min(max(lim, 0), p.keys);
  const int n_work = (n_keys + kSplitKeys - 1) / kSplitKeys;  // the lane's working splits
  const size_t head0 = static_cast<size_t>(bg) * p.rep + row0;  // the tile's first head
  TQ* out = static_cast<TQ*>(p.out) + head0 * hd;
  if (n_work == 0) {  // paged limit <= 0: every weight masked
    if (s == 0) {
      for (int i = tid; i < rows * hd; i += kThreads) store(out + i, 0.f);
    }
    return;
  }
  if (s >= n_work) return;
  const int split0 = s * kSplitKeys;
  const int split_len = min(kSplitKeys, n_keys - split0);

  float q[kRows][8];
  {
    const TQ* qp = static_cast<const TQ*>(p.q) + head0 * hd + c * 8;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows && has_chunk) {
        load8(qp + static_cast<size_t>(r) * hd, q[r]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) q[r][i] = 0.f;
      }
    }
  }

  const bool bs_pow2 = kPaged && (p.block_size & (p.block_size - 1)) == 0;
  const int bs_shift = kPaged ? __ffs(p.block_size) - 1 : 0;
  const int32_t* table = kPaged ? p.table + static_cast<size_t>(b) * p.n_pages : nullptr;
  // Element offset of key j's row, and its block's scales (int8 pools).
  auto locate = [&](int j, float& ks, float& vs) -> size_t {
    if constexpr (kPaged) {
      const int page = bs_pow2 ? j >> bs_shift : j / p.block_size;
      const int blk = table[page];
      if constexpr (kQuant) {
        ks = p.k_scale[blk];
        vs = p.v_scale[blk];
      }
      const int row = j - page * p.block_size;
      return ((static_cast<size_t>(blk) * p.n_kv + g) * p.block_size + row) * hd;
    } else {
      return (static_cast<size_t>(bg) * p.keys + j) * hd;
    }
  };

  // Step t of this warp reads the split's key rows (t kWarps + warp)
  // kKeysPerWarp + sub: the block reads kStride consecutive rows a step.
  const int first = warp * kKeysPerWarp;
  const int n_steps = split_len > first ? (split_len - first + kStride - 1) / kStride : 0;
  const TKV* kbase = static_cast<const TKV*>(p.k) + c * 8;
  const TKV* vbase = static_cast<const TKV*>(p.v) + c * 8;
  Raw<TKV> kr[kDepth], vr[kDepth];
  float ksc[kDepth], vsc[kDepth];
  auto fetch = [&](int t, int d) {
    const int jj = (t * kWarps + warp) * kKeysPerWarp + sub;
    ksc[d] = vsc[d] = 1.f;
    if (t < n_steps && jj < split_len && has_chunk) {
      const size_t off = locate(split0 + jj, ksc[d], vsc[d]);
      kr[d].load(kbase + off);
      vr[d].load(vbase + off);
    } else {
      kr[d].zero();
      vr[d].zero();
    }
  };

  float m[kRows], l[kRows], acc[kRows][8];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < kDepth; ++d) fetch(d, d);
  for (int t0 = 0; t0 < n_steps; t0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int t = t0 + d;
      if (t >= n_steps) break;  // warp-uniform
      float kf[8], vf[8];
      kr[d].to_f32(kf);
      vr[d].to_f32(vf);
      if constexpr (kQuant) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          kf[i] *= ksc[d];
          vf[i] *= vsc[d];
        }
      }
      fetch(t + kDepth, d);  // refill this slot while the step's math runs
      const bool valid = (t * kWarps + warp) * kKeysPerWarp + sub < split_len;
      float sc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(q[r][i], kf[i], dot);
        sc[r] = dot;
      }
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float sr = uniform ? 0.f : sc[r] * p.scale;
        float mx = valid ? sr : kNegInf;
#pragma unroll
        for (int o = 16; o >= kGroup; o >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        const float m_new = fmaxf(m[r], mx);
        const float w = valid ? expf(sr - m_new) : 0.f;  // masked: zero, not exp(-1e30 - m)
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + w;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(w, vf[i], acc[r][i] * alpha);
        m[r] = m_new;
      }
    }
  }
  // Sum the warp's key rows (m is warp-wide already), then merge the warps
  // in warp order.
#pragma unroll
  for (int o = kGroup; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], o);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc_s[warp][r][c * 8 + i] = acc[r][i];
      if (c == 0) {
        m_s[warp][r] = m[r];
        l_s[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  const size_t rstride = static_cast<size_t>(hd) + 2;  // floats of one head's partial
  const size_t sstride = static_cast<size_t>(p.rep) * rstride;  // and of one split's
  float* lane_part = p.part + static_cast<size_t>(bg) * p.n_split * sstride;
  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    float mx = m_s[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_s[w][r] - mx);  // 0 for a warp that had no key
      den += e * l_s[w][r];
      num += e * acc_s[w][r][d];
    }
    if (n_work == 1) {
      store(out + i, num / fmaxf(den, 1e-30f));
    } else {
      float* pr = lane_part + s * sstride + (row0 + r) * rstride;
      pr[d] = num;
      if (d == 0) {
        pr[hd] = mx;
        pr[hd + 1] = den;
      }
    }
  }
  if (n_work == 1) return;

  // The last of the lane's splits to arrive combines them.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = p.counters + static_cast<size_t>(bg) * p.n_tiles + tile;
    last_s = atomicAdd(counter, 1) == n_work - 1;
    if (last_s) atomicExch(counter, 0);  // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int r = warp; r < rows; r += kWarps) {  // M per row (max: order-free)
    float mx = kNegInf;
    for (int t = lane; t < n_work; t += 32) {
      mx = fmaxf(mx, __ldcg(lane_part + t * sstride + (row0 + r) * rstride + hd));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) big_m[r] = mx;
  }
  __syncthreads();
  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const float* pr = lane_part + (row0 + r) * rstride;
    const float mr = big_m[r];
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int t = 0; t < n_work; ++t) {  // in split order
      const float* ps = pr + t * sstride;
      const float e = expf(__ldcg(ps + hd) - mr);
      num += e * __ldcg(ps + d);
      den += e * __ldcg(ps + hd + 1);
    }
    store(out + i, num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TKV, bool kQuant, bool kPaged, int kRows, int kGroup>
cudaError_t launch_shape(const Params& p, int groups, cudaStream_t stream) {
  const dim3 grid(groups, p.n_split, p.n_tiles);
  split_decode_kernel<TQ, TKV, kQuant, kPaged, kRows, kGroup><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool kQuant, bool kPaged, int kRows>
cudaError_t launch_rows(const Params& p, int groups, cudaStream_t stream) {
  if (p.head_dim <= 64) return launch_shape<TQ, TKV, kQuant, kPaged, kRows, 8>(p, groups, stream);
  if (p.head_dim <= 128) {
    return launch_shape<TQ, TKV, kQuant, kPaged, kRows, 16>(p, groups, stream);
  }
  return launch_shape<TQ, TKV, kQuant, kPaged, kRows, 32>(p, groups, stream);
}

// Checks the shape and the scratch, sets the split and tile counts, and
// launches. `part_floats` and `n_counters` are the sizes of p.part and
// p.counters; the launch is refused when either is short.
template <typename TQ, typename TKV, bool kQuant, bool kPaged>
cudaError_t launch(Params p, int batch, long long part_floats, long long n_counters,
                   cudaStream_t stream) {
  if (p.head_dim <= 0 || p.head_dim > kMaxHeadDim || p.head_dim % 8 != 0 || p.n_kv <= 0 ||
      p.rep <= 0 || p.keys <= 0 || batch < 0) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  const int rows = p.rep > 4 ? kMaxRows : p.rep > 2 ? 4 : p.rep;  // 1, 2, 4 or 8
  p.n_split = (p.keys + kSplitKeys - 1) / kSplitKeys;
  p.n_tiles = (p.rep + rows - 1) / rows;
  const long long groups = static_cast<long long>(batch) * p.n_kv;
  if (groups > 0x7fffffffLL || p.n_split > 65535 || p.n_tiles > 65535 ||
      part_floats < groups * p.n_split * p.rep * (p.head_dim + 2) ||
      n_counters < groups * p.n_tiles) {
    return cudaErrorInvalidValue;
  }
  const int n = static_cast<int>(groups);
  switch (rows) {
    case 1: return launch_rows<TQ, TKV, kQuant, kPaged, 1>(p, n, stream);
    case 2: return launch_rows<TQ, TKV, kQuant, kPaged, 2>(p, n, stream);
    case 4: return launch_rows<TQ, TKV, kQuant, kPaged, 4>(p, n, stream);
    default: return launch_rows<TQ, TKV, kQuant, kPaged, kMaxRows>(p, n, stream);
  }
}

}  // namespace split
}  // namespace nos
