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
// What bounds it on an H100: bytes, K and V up to min(limit, max) read once
// (plus q and out) over HBM's 3.35 TB/s. The Pallas kernel loads a group's
// whole [max, hd] K and V into VMEM (1 MB each at max 8192, hd 64, bf16),
// more than a Hopper block's 227 KB of shared memory. The kernel is the
// split-KV kernel of split_decode.cuh, shared with the paged decode kernel:
// the cache's positions are cut into fixed 128-key splits (n_split =
// ceil(max / 128) blocks per group and row tile; a split at or past the
// lane's min(limit, max) returns at once), each split streams its keys
// with registers holding q, the online softmax and the accumulator, and
// the last split of a lane to finish combines the splits' f32 partials in
// split order. No atomics on data, so the sum order is fixed. The first
// design, one CUDA block per (b, g) walking the cache alone, ran 16 blocks
// on 132 SMs at the dense programs' shape (PERF.md).

#include "common.cuh"
#include "split_decode.cuh"

extern "C" {

// q [B, nh, hd]; caches [B, nkv, max, hd] in q's dtype; limit [B] i32; out
// [B, nh, hd] in q's dtype; part (part_floats f32) and counters (n_counters
// i32, 0 between launches) the split kernel's scratch (split_decode.cuh).
// Returns cudaGetLastError() after the launch.
int nos_decode_attention(const void* q, const void* k, const void* v,
                         const int32_t* limit, void* out, float* part, int* counters,
                         int batch, int n_heads, int n_kv, int head_dim, int max_len, int dtype,
                         float scale, long long part_floats, long long n_counters,
                         void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || max_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nos::split::Params p{};
  p.q = q; p.k = k; p.v = v; p.limit = limit; p.out = out;
  p.part = part; p.counters = counters;
  p.n_kv = n_kv; p.rep = n_heads / n_kv; p.head_dim = head_dim; p.keys = max_len;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == nos::kF32) {
    err = nos::split::launch<float, float, false, false>(p, batch, part_floats, n_counters, s);
  } else if (dtype == nos::kBF16) {
    err = nos::split::launch<__nv_bfloat16, __nv_bfloat16, false, false>(
        p, batch, part_floats, n_counters, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
