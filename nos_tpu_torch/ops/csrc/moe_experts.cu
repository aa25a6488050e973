// The dropless top-k expert layer for serving, written by hand for Hopper
// (sm_90a): nos_moe_experts launches five kernels on the caller's stream.
//
// It replaces no TPU kernel: the JAX package's expert layer is the training
// one (nos_tpu/parallel/moe.py: capacity buffers, top-1/2, einsums), which
// a served model with 64 experts and 8 a token cannot use; the serving
// layer drops nothing. ops/moe.py holds its plain version and its contract.
//
//   moe_route_kernel    one warp per token: softmax over the float32 router
//                       logits (at most 64 experts, two a lane), the top_k
//                       by warp argmax with ties to the lowest index, the
//                       weights renormalized by their sum in that order;
//                       a masked token takes expert E (none), weight 0. Each
//                       chosen expert's counter takes one atomicAdd (counts
//                       are order-free).
//   moe_sort_kernel     one block: the counters into row and tile offsets
//                       (a prefix sum; the counters are cleared for the
//                       next launch, so no memset and graph replays stay
//                       clean), the work tally, then a counting sort of the
//                       (token, k) rows by expert in 1024-row rounds: a
//                       row's place is its expert's offset, the rows of
//                       that expert in earlier warps of the round
//                       (__match_any_sync counts per warp, summed in warp
//                       order) and its rank in its warp: the same order
//                       every launch.
//   moe_gemm_kernel     the grouped GEMMs on mma.sync (csrc/mma.cuh), one
//                       CUDA block per (row tile of one expert, column
//                       tile). Gate|up: A = the tile's rows of x gathered
//                       through the sort, B = 64 columns of W_gate[e] beside
//                       the same 64 of W_up[e], so each thread holds gate
//                       and up of the same entries and the epilogue writes
//                       silu(gate) * up (f32, then bf16). Down: A = the
//                       sorted rows of that product, B = 128 columns of
//                       W_down[e]; the epilogue writes bf16. The grid has
//                       the worst case's row tiles, ceil(T top_k / BM) + E;
//                       a block past the last tile exits at once.
//   moe_combine_kernel  one block per token: the sum over k = 0, 1, ... of
//                       weight k times its row's output, in f32, in that
//                       order; no atomics, so replay and eager give the same
//                       bits.
//
// What bounds it on an H100: at decode (48 tokens, 384 rows over 64
// experts) nearly every expert is hit, so each call reads almost all the
// layer's expert weights (793 MB at Mellum2's widths, 0.24 ms at 3.35
// TB/s) for little arithmetic: bytes. The decode tile is 16 rows (BM 16,
// four warps side by side over 128 columns) and a three-stage cp.async ring
// of 64-deep K tiles keeps about 50 KB of weights in flight a block. At a
// prefill chunk (2048 tokens, about 256 rows an expert) the products are
// bound by operations (2.77 GFLOP a token at those widths); the tile is 64
// rows (2 x 2 warps, each 32 rows by 64 columns), twice the mma work per
// ldmatrix. Each (row tile, column tile) reads its expert's weight columns
// once; an expert with more rows than a tile reads them once per tile,
// through L2.

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace nos;
using namespace nos::mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // four warps a GEMM or routing block
constexpr int kBK = 64;         // K depth of a ring stage
constexpr int kBN = 128;        // B tile columns (gate|up: 64 + 64)
constexpr int kStages = 3;
constexpr int kMaxExperts = 64;
constexpr int kMaxTopK = 32;
constexpr int kSortThreads = 1024;

struct Moe {
  const bf16* x;         // [T, h]
  const float* logits;   // [T, E]
  const uint8_t* valid;  // [T] bool, or null
  const bf16* w_gate;    // [E, h, f]
  const bf16* w_up;      // [E, h, f]
  const bf16* w_down;    // [E, f, h]
  int* ids;              // [T k] expert of row t k + j (E: none)
  float* wts;            // [T k]
  int* counts;           // [kMaxExperts], 0 between launches
  int* row_off;          // [E + 1] first sorted row of each expert
  int* tile_off;         // [E + 1] first row tile of each expert
  int* perm;             // [T k] sorted row -> (token, k) row
  int* slot_of;          // [T k] (token, k) row -> sorted row, -1: none
  bf16* mid;             // [T k, f] silu(gate) * up, sorted
  bf16* ys;              // [T k, h] expert outputs, sorted
  bf16* out;             // [T, h]
  unsigned long long* tally;  // [2] rows routed, experts hit; or null
  int T, h, f, E, k, norm, bm;
};

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

__global__ void __launch_bounds__(kThreads) moe_route_kernel(Moe p) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (t >= p.T) return;
  int* ids = p.ids + static_cast<size_t>(t) * p.k;
  float* wts = p.wts + static_cast<size_t>(t) * p.k;
  if (p.valid != nullptr && p.valid[t] == 0) {
    if (lane < p.k) {
      ids[lane] = p.E;
      wts[lane] = 0.f;
    }
    return;
  }
  const float* lg = p.logits + static_cast<size_t>(t) * p.E;
  float v[2], pr[2];
  bool used[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = lane + 32 * i;
    used[i] = j >= p.E;
    v[i] = used[i] ? kNegInf : lg[j];
  }
  const float m = warp_max(fmaxf(v[0], v[1]));
#pragma unroll
  for (int i = 0; i < 2; ++i) pr[i] = used[i] ? 0.f : expf(v[i] - m);
  const float s = warp_sum(pr[0] + pr[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) pr[i] = pr[i] / s;
  float total = 0.f, my_w = 0.f;
  int my_id = p.E;
  for (int r = 0; r < p.k; ++r) {
    float bp = -1.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!used[i] && pr[i] > bp) {  // i = 1 only on a strictly larger weight
        bp = pr[i];
        bi = lane + 32 * i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float op = __shfl_xor_sync(0xffffffffu, bp, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (op > bp || (op == bp && oi < bi)) {
        bp = op;
        bi = oi;
      }
    }
    if (lane == (bi & 31)) {  // the owner retires it (no dynamic register index)
      if (bi >= 32) {
        used[1] = true;
      } else {
        used[0] = true;
      }
    }
    if (lane == r) {
      my_id = bi;
      my_w = bp;
    }
    total += bp;  // the same on every lane, in selection order
  }
  if (lane < p.k) {
    ids[lane] = my_id;
    wts[lane] = p.norm ? my_w / total : my_w;
    atomicAdd(p.counts + my_id, 1);
  }
}

__global__ void __launch_bounds__(kSortThreads) moe_sort_kernel(Moe p) {
  __shared__ int cur[kMaxExperts];
  __shared__ int wcnt[kSortThreads / 32][kMaxExperts];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    int rows = 0, tiles = 0, hit = 0;
    for (int e = 0; e < p.E; ++e) {
      const int c = p.counts[e];
      p.counts[e] = 0;  // ready for the next launch
      cur[e] = rows;
      p.row_off[e] = rows;
      p.tile_off[e] = tiles;
      rows += c;
      tiles += (c + p.bm - 1) / p.bm;
      hit += c > 0;
    }
    p.row_off[p.E] = rows;
    p.tile_off[p.E] = tiles;
    if (p.tally != nullptr) {
      p.tally[0] += static_cast<unsigned long long>(rows);
      p.tally[1] += static_cast<unsigned long long>(hit);
    }
  }
  __syncthreads();
  const int n = p.T * p.k;
  for (int base = 0; base < n; base += kSortThreads) {
    const int r = base + tid;
    const int e = r < n ? p.ids[r] : p.E;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    for (int i = tid; i < (kSortThreads / 32) * kMaxExperts; i += kSortThreads) {
      (&wcnt[0][0])[i] = 0;
    }
    __syncthreads();
    if (e < p.E && rank == 0) wcnt[warp][e] = __popc(peers);
    __syncthreads();
    if (tid < p.E) {  // each expert's offsets over the round's warps, in warp order
      int run = cur[tid];
      for (int w = 0; w < kSortThreads / 32; ++w) {
        const int c = wcnt[w][tid];
        wcnt[w][tid] = run;
        run += c;
      }
      cur[tid] = run;
    }
    __syncthreads();
    if (r < n) {
      if (e < p.E) {
        const int at = wcnt[warp][e] + rank;
        p.perm[at] = r;
        p.slot_of[r] = at;
      } else {
        p.slot_of[r] = -1;
      }
    }
    __syncthreads();
  }
}

template <int MI, int WM>
__host__ __device__ constexpr int tile_m() {
  return 16 * MI * WM;
}

template <int MI, int WM>
size_t gemm_smem() {
  return sizeof(bf16) * static_cast<size_t>(kStages) * (tile_m<MI, WM>() * kBK + kBK * kBN);
}

// The grouped GEMM: kGateUp selects gate|up (K = h, 64 output columns a
// block) or down (K = f, 128). Warps are WM x (4 / WM); a warp owns MI
// 16-row fragments and kBN / (4 / WM) B tile columns.
template <bool kGateUp, int MI, int WM>
__global__ void __launch_bounds__(kThreads) moe_gemm_kernel(Moe p) {
  constexpr int WN = 4 / WM;
  constexpr int BM = tile_m<MI, WM>();
  constexpr int NB = kBN / WN / 8;  // 8-column blocks a warp owns
  constexpr int kARows = BM * (kBK / 8) / kThreads;  // A rows a thread copies (chunk fixed)
  static_assert(NB % 4 == 0, "gate and up pairs of 8-column blocks");
  static_assert((BM * (kBK / 8)) % kThreads == 0, "A copies split evenly");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // [kStages][BM][kBK]
  bf16* b_s = a_s + kStages * BM * kBK;             // [kStages][kBK][kBN]

  const int mt = blockIdx.x;
  if (mt >= p.tile_off[p.E]) return;  // past the last tile: nothing to do
  int lo = 0, hi = p.E;  // tile_off[lo] <= mt < tile_off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (p.tile_off[mid] <= mt) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int e = lo;
  const int row0 = p.row_off[e] + (mt - p.tile_off[e]) * BM;
  const int n_rows = min(BM, p.row_off[e + 1] - row0);
  const int K = kGateUp ? p.h : p.f;
  const int n_out = kGateUp ? p.f : p.h;  // width of the output rows
  const int n0 = blockIdx.y * (kGateUp ? kBN / 2 : kBN);
  const size_t wsz = static_cast<size_t>(p.h) * p.f;
  const bf16* w0 = (kGateUp ? p.w_gate : p.w_down) + e * wsz;
  const bf16* w1 = p.w_up + e * wsz;  // gate|up only

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp % WN;
  // The A rows this thread copies, and its fixed 16-byte chunk of them.
  const int a_chunk = tid % (kBK / 8);
  const bf16* a_src[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int r = tid / (kBK / 8) + i * (kThreads / (kBK / 8));
    a_src[i] = nullptr;
    if (r < n_rows) {
      a_src[i] = kGateUp ? p.x + static_cast<size_t>(p.perm[row0 + r] / p.k) * p.h
                         : p.mid + static_cast<size_t>(row0 + r) * p.f;
    }
  }
  auto load_stage = [&](int kt, int stage) {
    bf16* as = a_s + stage * BM * kBK;
    bf16* bs = b_s + stage * kBK * kBN;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int r = tid / (kBK / 8) + i * (kThreads / (kBK / 8));
      const bool in = a_src[i] != nullptr;
      cp_async16(smem_addr(as + Swizzled<kBK>::at(r, a_chunk)),
                 in ? a_src[i] + k0 + a_chunk * 8 : p.x, in);
    }
    constexpr int kC = kBN / 8;  // 16-byte chunks of a B row
#pragma unroll
    for (int i = tid; i < kBK * kC; i += kThreads) {
      const int r = i / kC;
      const int c = i % kC;
      const size_t row = static_cast<size_t>(k0 + r) * n_out;
      const bf16* src = kGateUp ? (c < kC / 2 ? w0 + row + n0 + c * 8
                                              : w1 + row + n0 + (c - kC / 2) * 8)
                                : w0 + row + n0 + c * 8;
      cp_async16(smem_addr(bs + Swizzled<kBN>::at(r, c)), src, true);
    }
  };
  // The B tile chunk (8-column block) of the warp's block j.
  auto chunk_of = [&](int j) {
    if constexpr (kGateUp) {
      return j < NB / 2 ? wn * (NB / 2) + j : kBN / 16 + wn * (NB / 2) + (j - NB / 2);
    } else {
      return wn * NB + j;
    }
  };

  float acc[MI][NB][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* as = a_s + (kt % kStages) * BM * kBK;
    const bf16* bs = b_s + (kt % kStages) * kBK * kBN;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) load_a<kBK>(af[i], as, (wm * MI + i) * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t bv[4];
        load_b_v<kBN>(bv, bs, 16 * kk, chunk_of(j), lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(acc[i][j], af[i], bv[0], bv[1]);
          mma_bf16(acc[i][j + 1], af[i], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = (wm * MI + i) * 16 + g + 8 * hh;
      if (r >= n_rows) continue;
      if constexpr (kGateUp) {
        bf16* dst = p.mid + static_cast<size_t>(row0 + r) * p.f + n0;
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) {
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float gate = acc[i][j][2 * hh + c];
            v[c] = gate / (1.f + expf(-gate)) * acc[i][j + NB / 2][2 * hh + c];
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * chunk_of(j) + 2 * tq) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      } else {
        bf16* dst = p.ys + static_cast<size_t>(row0 + r) * p.h + n0;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * chunk_of(j) + 2 * tq) =
              __floats2bfloat162_rn(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) moe_combine_kernel(Moe p) {
  const int t = blockIdx.x;
  const int* slot = p.slot_of + static_cast<size_t>(t) * p.k;
  const float* w = p.wts + static_cast<size_t>(t) * p.k;
  bf16* out = p.out + static_cast<size_t>(t) * p.h;
  for (int c = threadIdx.x; c < p.h / 8; c += kThreads) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < p.k; ++j) {  // in k order
      const int at = slot[j];
      if (at < 0) continue;
      float y[8];
      load8(p.ys + static_cast<size_t>(at) * p.h + c * 8, y);
      const float wj = w[j];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(wj, y[i], acc[i]);
    }
    uint4 packed;
    packed.x = pack_bf16(acc[0], acc[1]);
    packed.y = pack_bf16(acc[2], acc[3]);
    packed.z = pack_bf16(acc[4], acc[5]);
    packed.w = pack_bf16(acc[6], acc[7]);
    *reinterpret_cast<uint4*>(out + c * 8) = packed;
  }
}

template <bool kGateUp, int MI, int WM>
cudaError_t launch_gemm(const Moe& p, int row_tiles, cudaStream_t s) {
  auto kernel = moe_gemm_kernel<kGateUp, MI, WM>;
  static size_t granted[kMaxDevices] = {};
  const size_t smem = gemm_smem<MI, WM>();
  cudaError_t err = opt_in_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(row_tiles, kGateUp ? p.f / (kBN / 2) : p.h / kBN);
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int MI, int WM>
cudaError_t launch_gemms(const Moe& p, cudaStream_t s) {
  constexpr int BM = tile_m<MI, WM>();
  const long long tiles = (static_cast<long long>(p.T) * p.k + BM - 1) / BM + p.E;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = launch_gemm<true, MI, WM>(p, static_cast<int>(tiles), s);
  if (err != cudaSuccess) return err;
  return launch_gemm<false, MI, WM>(p, static_cast<int>(tiles), s);
}

}  // namespace

extern "C" {

// x [T, h] bf16; logits [T, E] f32; valid [T] bool or null; w_gate, w_up
// [E, h, f] and w_down [E, f, h] bf16; ids, wts, perm, slot_of [T k];
// counts [64] i32 (0 between launches); row_off, tile_off [E + 1]; mid [T
// k, f] and ys [T k, h] bf16 scratch; out [T, h] bf16; tally [2] u64 or
// null. bm is the GEMMs' row tile, 16 or 64. Returns cudaGetLastError()
// after the last launch, or the first launch's error.
int nos_moe_experts(const void* x, const float* logits, const uint8_t* valid,
                    const void* w_gate, const void* w_up, const void* w_down, int* ids,
                    float* wts, int* counts, int* row_off, int* tile_off, int* perm,
                    int* slot_of, void* mid, void* ys, void* out, unsigned long long* tally,
                    int T, int h, int f, int E, int k, int norm, int bm, void* stream) {
  if (T < 0 || E <= 0 || E > kMaxExperts || k <= 0 || k > E || k > kMaxTopK || h <= 0 ||
      h % kBN != 0 || f <= 0 || f % (kBN / 2) != 0 || (bm != 16 && bm != 64) ||
      static_cast<long long>(T) * k > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T == 0) return static_cast<int>(cudaSuccess);
  Moe p{};
  p.x = static_cast<const bf16*>(x);
  p.logits = logits;
  p.valid = valid;
  p.w_gate = static_cast<const bf16*>(w_gate);
  p.w_up = static_cast<const bf16*>(w_up);
  p.w_down = static_cast<const bf16*>(w_down);
  p.ids = ids; p.wts = wts; p.counts = counts; p.row_off = row_off; p.tile_off = tile_off;
  p.perm = perm; p.slot_of = slot_of;
  p.mid = static_cast<bf16*>(mid);
  p.ys = static_cast<bf16*>(ys);
  p.out = static_cast<bf16*>(out);
  p.tally = tally;
  p.T = T; p.h = h; p.f = f; p.E = E; p.k = k; p.norm = norm; p.bm = bm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  moe_route_kernel<<<(T + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_sort_kernel<<<1, kSortThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bm == 16 ? launch_gemms<1, 1>(p, s) : launch_gemms<2, 2>(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_combine_kernel<<<T, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
