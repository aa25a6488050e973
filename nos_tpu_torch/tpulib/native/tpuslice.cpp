// Port of nos_tpu/tpulib/native/tpuslice.cpp (:1-351), copied verbatim; only
// the comment below names the port's packing.py as the Python twin.
// nos_tpu_torch/tpulib/native_client.py compiles it with g++ at first use
// into _build/ beside this file (listed in .gitignore), as
// libtpuslice_torch-<digest>.so, a name of its own: the JAX package's shim
// may be loaded in the same process and neither picks up the other's file.
//
// tpuslice — native TPU sub-slice control shim.
//
// The C++ analog of the reference's cgo→NVML layer (pkg/gpu/nvml/client.go):
// where nos drives MIG GPU-instance creation through the NVIDIA driver, this
// library models ICI sub-slice lifecycle for a TPU chip mesh — occupancy-
// checked slice create/delete/in-use tracking — and implements the canonical
// guillotine packer natively (the planner's hot path). The packer is
// bit-for-bit equivalent to nos_tpu_torch/tpu/packing.py: placement must be a pure
// function of the geometry multiset so the central planner (Python) and node
// agents (native) always agree on chip assignment.
//
// Plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxRank = 4;

struct Block {
  int origin[kMaxRank];
  int dims[kMaxRank];
  int rank;

  long long chips() const {
    long long n = 1;
    for (int i = 0; i < rank; ++i) n *= dims[i];
    return n;
  }
};

// Comparison mirroring Python tuple order (chips, origin).
bool blockLess(const Block& a, const Block& b) {
  if (a.chips() != b.chips()) return a.chips() < b.chips();
  return std::lexicographical_compare(a.origin, a.origin + a.rank, b.origin,
                                      b.origin + b.rank);
}

bool fits(const Block& block, const int* want) {
  for (int i = 0; i < block.rank; ++i)
    if (want[i] > block.dims[i]) return false;
  return true;
}

// Distinct permutations of `dims`, in the order itertools.permutations yields
// them (lexicographic by index positions), first occurrence kept.
std::vector<std::vector<int>> orientations(const int* dims, int rank) {
  std::vector<int> idx(rank);
  for (int i = 0; i < rank; ++i) idx[i] = i;
  std::vector<std::vector<int>> out;
  // Enumerate index permutations in lexicographic order.
  std::vector<int> perm(idx);
  do {
    std::vector<int> cand(rank);
    for (int i = 0; i < rank; ++i) cand[i] = dims[perm[i]];
    if (std::find(out.begin(), out.end(), cand) == out.end()) out.push_back(cand);
  } while (std::next_permutation(perm.begin(), perm.end()));
  return out;
}

// Guillotine split (packing.py _split): carve `want` at block.origin, return
// remainders in fixed dim order.
void split(const Block& block, const int* want, Block* placed,
           std::vector<Block>* remainders) {
  for (int d = 0; d < block.rank; ++d) {
    if (block.dims[d] > want[d]) {
      Block rem;
      rem.rank = block.rank;
      for (int i = 0; i < block.rank; ++i) {
        rem.origin[i] = block.origin[i] + (i == d ? want[d] : 0);
        rem.dims[i] = (i == d)   ? block.dims[d] - want[d]
                      : (i < d)  ? want[i]
                                 : block.dims[i];
      }
      remainders->push_back(rem);
    }
  }
  placed->rank = block.rank;
  std::memcpy(placed->origin, block.origin, sizeof(int) * block.rank);
  std::memcpy(placed->dims, want, sizeof(int) * block.rank);
}

// Best-fit placement (packing.py _place_one). Returns false if nothing fits.
bool placeOne(std::vector<Block>* freeList, const int* profile_dims, int rank,
              Block* placed) {
  int best_idx = -1;
  std::vector<int> best_want;
  const Block* best_block = nullptr;
  for (size_t idx = 0; idx < freeList->size(); ++idx) {
    const Block& block = (*freeList)[idx];
    for (const auto& want : orientations(profile_dims, rank)) {
      if (!fits(block, want.data())) continue;
      // key = (block.chips, block.origin, idx, want); iteration order makes
      // idx ascending, so strict improvement only on (chips, origin).
      bool better = false;
      if (best_idx < 0) {
        better = true;
      } else if (block.chips() != best_block->chips()) {
        better = block.chips() < best_block->chips();
      } else {
        int cmp = 0;
        for (int i = 0; i < rank && cmp == 0; ++i)
          cmp = block.origin[i] - best_block->origin[i];
        better = cmp < 0;
      }
      if (better) {
        best_idx = static_cast<int>(idx);
        best_want = want;
        best_block = &(*freeList)[idx];
      }
      break;  // first fitting orientation per block (matches Python break)
    }
  }
  if (best_idx < 0) return false;
  Block block = (*freeList)[best_idx];
  freeList->erase(freeList->begin() + best_idx);
  std::vector<Block> remainders;
  split(block, best_want.data(), placed, &remainders);
  freeList->insert(freeList->end(), remainders.begin(), remainders.end());
  std::sort(freeList->begin(), freeList->end(), blockLess);
  return true;
}

struct Slice {
  int id;
  int origin[kMaxRank];
  int dims[kMaxRank];
  int in_use;
  int profile_idx;  // used by pack output only; -1 for live slices
};

}  // namespace

// ---------------------------------------------------------------------------
// Device-state context (the NVML-client analog).
// ---------------------------------------------------------------------------
struct tpuslice_ctx {
  int mesh[kMaxRank];
  int rank;
  int next_id;
  int healthy;
  std::vector<Slice> slices;
};

static bool overlaps(const Slice& s, const int* origin, const int* dims, int rank) {
  for (int i = 0; i < rank; ++i) {
    int lo = std::max(s.origin[i], origin[i]);
    int hi = std::min(s.origin[i] + s.dims[i], origin[i] + dims[i]);
    if (lo >= hi) return false;
  }
  return true;
}

extern "C" {

tpuslice_ctx* tpuslice_init(const int* mesh_dims, int rank) {
  if (rank < 1 || rank > kMaxRank) return nullptr;
  auto* ctx = new tpuslice_ctx();
  ctx->rank = rank;
  ctx->next_id = 1;
  ctx->healthy = 1;
  std::memcpy(ctx->mesh, mesh_dims, sizeof(int) * rank);
  return ctx;
}

void tpuslice_destroy(tpuslice_ctx* ctx) { delete ctx; }

// Returns new slice id (>0), or -1 out-of-bounds, -2 overlap, -3 bad args.
int tpuslice_create(tpuslice_ctx* ctx, const int* origin, const int* dims) {
  if (!ctx) return -3;
  for (int i = 0; i < ctx->rank; ++i) {
    if (dims[i] < 1 || origin[i] < 0 || origin[i] + dims[i] > ctx->mesh[i])
      return -1;
  }
  for (const auto& s : ctx->slices)
    if (overlaps(s, origin, dims, ctx->rank)) return -2;
  Slice s;
  s.id = ctx->next_id++;
  s.in_use = 0;
  s.profile_idx = -1;
  std::memcpy(s.origin, origin, sizeof(int) * ctx->rank);
  std::memcpy(s.dims, dims, sizeof(int) * ctx->rank);
  ctx->slices.push_back(s);
  return s.id;
}

// 0 ok, -1 no such slice, -2 in use.
int tpuslice_delete(tpuslice_ctx* ctx, int slice_id) {
  if (!ctx) return -1;
  for (size_t i = 0; i < ctx->slices.size(); ++i) {
    if (ctx->slices[i].id == slice_id) {
      if (ctx->slices[i].in_use) return -2;
      ctx->slices.erase(ctx->slices.begin() + i);
      return 0;
    }
  }
  return -1;
}

int tpuslice_set_in_use(tpuslice_ctx* ctx, int slice_id, int in_use) {
  if (!ctx) return -1;
  for (auto& s : ctx->slices) {
    if (s.id == slice_id) {
      s.in_use = in_use ? 1 : 0;
      return 0;
    }
  }
  return -1;
}

// Crash-recovery cleanup (migagent startup analog): delete every not-in-use
// slice whose id is absent from keep_ids. Returns number deleted.
int tpuslice_delete_all_except(tpuslice_ctx* ctx, const int* keep_ids, int n_keep) {
  if (!ctx) return 0;
  int deleted = 0;
  for (size_t i = ctx->slices.size(); i-- > 0;) {
    const Slice& s = ctx->slices[i];
    if (s.in_use) continue;
    bool keep = false;
    for (int k = 0; k < n_keep; ++k)
      if (keep_ids[k] == s.id) keep = true;
    if (!keep) {
      ctx->slices.erase(ctx->slices.begin() + i);
      ++deleted;
    }
  }
  return deleted;
}

int tpuslice_count(tpuslice_ctx* ctx) {
  return ctx ? static_cast<int>(ctx->slices.size()) : 0;
}

// Fills out_id, out_in_use, out_origin[rank], out_dims[rank] for slice #idx
// (sorted by id). Returns 0 ok, -1 bad idx.
int tpuslice_get(tpuslice_ctx* ctx, int idx, int* out_id, int* out_origin,
                 int* out_dims, int* out_in_use) {
  if (!ctx || idx < 0 || idx >= static_cast<int>(ctx->slices.size())) return -1;
  std::vector<const Slice*> sorted;
  sorted.reserve(ctx->slices.size());
  for (const auto& s : ctx->slices) sorted.push_back(&s);
  std::sort(sorted.begin(), sorted.end(),
            [](const Slice* a, const Slice* b) { return a->id < b->id; });
  const Slice* s = sorted[idx];
  *out_id = s->id;
  *out_in_use = s->in_use;
  std::memcpy(out_origin, s->origin, sizeof(int) * ctx->rank);
  std::memcpy(out_dims, s->dims, sizeof(int) * ctx->rank);
  return 0;
}

int tpuslice_health(tpuslice_ctx* ctx) { return ctx && ctx->healthy ? 1 : 0; }
void tpuslice_set_health(tpuslice_ctx* ctx, int healthy) {
  if (ctx) ctx->healthy = healthy;
}

// ---------------------------------------------------------------------------
// Canonical packer (packing.py pack). Caller passes profiles PRE-SORTED in
// canonical order (largest chips first, ties by name) with per-profile counts;
// occupied blocks (origin+dims pairs) may be empty. Output: for each placed
// instance, rank ints origin then rank ints dims, in placement order.
// Returns number of placements, or -1 if the geometry does not fit.
// ---------------------------------------------------------------------------
int tpuslice_pack(const int* mesh_dims, int rank, const int* occupied,
                  int n_occupied, const int* profile_dims, const int* counts,
                  int n_profiles, int* out) {
  if (rank < 1 || rank > kMaxRank) return -1;
  Block whole;
  whole.rank = rank;
  long long mesh_chips = 1;
  for (int i = 0; i < rank; ++i) {
    whole.origin[i] = 0;
    whole.dims[i] = mesh_dims[i];
    mesh_chips *= mesh_dims[i];
  }
  std::vector<Block> freeList{whole};

  // Subtract occupied blocks (packing.py _subtract_block).
  for (int o = 0; o < n_occupied; ++o) {
    const int* oc_origin = occupied + o * 2 * rank;
    const int* oc_dims = oc_origin + rank;
    std::vector<Block> next;
    for (const auto& block : freeList) {
      int lo[kMaxRank], hi[kMaxRank];
      bool disjoint = false;
      for (int i = 0; i < rank; ++i) {
        lo[i] = std::max(block.origin[i], oc_origin[i]);
        hi[i] = std::min(block.origin[i] + block.dims[i], oc_origin[i] + oc_dims[i]);
        if (lo[i] >= hi[i]) disjoint = true;
      }
      if (disjoint) {
        next.push_back(block);
        continue;
      }
      int cur_origin[kMaxRank], cur_dims[kMaxRank];
      std::memcpy(cur_origin, block.origin, sizeof(int) * rank);
      std::memcpy(cur_dims, block.dims, sizeof(int) * rank);
      for (int d = 0; d < rank; ++d) {
        int below = lo[d] - cur_origin[d];
        if (below > 0) {
          Block b;
          b.rank = rank;
          std::memcpy(b.origin, cur_origin, sizeof(int) * rank);
          std::memcpy(b.dims, cur_dims, sizeof(int) * rank);
          b.dims[d] = below;
          next.push_back(b);
        }
        int above = (cur_origin[d] + cur_dims[d]) - hi[d];
        if (above > 0) {
          Block b;
          b.rank = rank;
          std::memcpy(b.origin, cur_origin, sizeof(int) * rank);
          std::memcpy(b.dims, cur_dims, sizeof(int) * rank);
          b.origin[d] = hi[d];
          b.dims[d] = above;
          next.push_back(b);
        }
        cur_origin[d] = lo[d];
        cur_dims[d] = hi[d] - lo[d];
      }
    }
    freeList = next;
  }
  if (n_occupied > 0) std::sort(freeList.begin(), freeList.end(), blockLess);

  // Capacity early-exit (packing.py pack).
  long long want_chips = 0;
  for (int p = 0; p < n_profiles; ++p) {
    long long prof_chips = 1;
    for (int i = 0; i < rank; ++i) prof_chips *= profile_dims[p * rank + i];
    want_chips += prof_chips * counts[p];
  }
  if (n_occupied == 0 && want_chips > mesh_chips) return -1;

  int n_placed = 0;
  for (int p = 0; p < n_profiles; ++p) {
    for (int c = 0; c < counts[p]; ++c) {
      Block placed;
      if (!placeOne(&freeList, profile_dims + p * rank, rank, &placed)) return -1;
      for (int i = 0; i < rank; ++i) out[n_placed * 2 * rank + i] = placed.origin[i];
      for (int i = 0; i < rank; ++i)
        out[n_placed * 2 * rank + rank + i] = placed.dims[i];
      ++n_placed;
    }
  }
  return n_placed;
}

}  // extern "C"
