"""Int8 per-block quantization of the paged KV pool: the one write funnel and
the whole-block movers.

Port of `nos_tpu/ops/quantized_kv.py`: `QMAX` (:44), `safe_scale` (:47),
`quantize_rows` (:54), `dequantize` (:61), `scatter_tokens` (:68),
`extract_block` (:130), `revive_block` (:141) and `cow_copy_block` (:158).
The reference is plain XLA array math, not a Pallas kernel, and so is this:
plain PyTorch, the same on the CPU and the card. The paged-attention ops
dequantize inside their read (`ops/paged_attention.py`).

Format (the reference's invariants): K/V are int8 codes with one f32 scale
per (block, layer, k|v); code `q` of block `b` decodes as `q * scale[b]`,
and scale 0.0 (never written) decodes as zeros through `safe_scale`. A
write at block offset 0 resets the block's scale (a new occupancy); within
an occupancy the scale only grows, and growth requantizes the block's
existing rows, which is exactly idempotent when the scale holds.

Where the reference returns new arrays, every write here is IN PLACE
(`scatter_reduce_`, `index_put_`, `copy_`): the engine's captured decode
window holds the addresses of the pool and of the scales, so a write that
rebinds either would let a replay read a stale tensor. Nothing here reads
a value back to the host or makes a shape that depends on data, so the
funnel runs inside a CUDA graph capture.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

#: int8 code range. +-127 (not -128): symmetric, so dequantization is a
#: single multiply and negation round-trips exactly.
QMAX = 127.0


def safe_scale(scale: torch.Tensor) -> torch.Tensor:
    """`scale` with the never-written guard: 0.0 acts as 1.0, so untouched
    blocks stay exactly zero through a quantize/dequantize round trip."""
    return torch.where(scale > 0.0, scale, 1.0)


def quantize_rows(vals: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes of `vals` under `scale` (broadcast against vals). Rounds
    half to even, as `jnp.round` does."""
    q = torch.round(vals.float() / safe_scale(scale))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Codes under `scale` (broadcastable) as float32."""
    return q.float() * scale


def row_amax(vals: torch.Tensor) -> torch.Tensor:
    """max|row| of token rows [..., nkv, hd] in float32: [...]. Under
    tensor parallelism each shard takes it over its own heads and the
    caller hands `scatter_tokens` the elementwise max over the shards (the
    reference's `pmax` over its mesh axis, :93-98)."""
    return vals.float().abs().amax(dim=(-2, -1))


def scatter_tokens(pool_q: torch.Tensor, scale: torch.Tensor, pages: torch.Tensor,
                   offs: torch.Tensor, vals: torch.Tensor, amax=None) -> None:
    """The pool write funnel: token rows `vals` [N, nkv, hd] (any float
    dtype) into the int8 pool `pool_q` [T, nkv, bs, hd] at block `pages[n]`,
    offset `offs[n]` ([N] integer), and the per-block `scale` [T] f32, both
    in place. `amax` [N]: the rows' max|value| when the caller computed it
    across tensor-parallel shards (None: `row_amax(vals)`).

    Three steps, each deterministic under duplicate pages (min and max
    scatters commute; value scatters carry only identical rows for one
    block):
      1. reset the blocks written at offset 0, then scatter-max the rows'
         amax / QMAX into the scale;
      2. requantize every touched block's rows from the old scale to the
         new one, from a gather taken before any write;
      3. quantize the new rows under the new scale and write them last.
    Rows aimed at the scratch page (page 0) touch only scratch state."""
    vals_f = vals.float()
    if amax is None:
        amax = row_amax(vals_f)
    pages = pages.long()
    offs = offs.long()
    fresh = offs == 0
    s_old = scale[pages]  # [N], before the update: the requant ratio's numerator
    scale.scatter_reduce_(0, pages, torch.where(fresh, 0.0, math.inf), "amin")
    scale.scatter_reduce_(0, pages, amax / QMAX, "amax")
    s_new = scale[pages]  # [N], after it: duplicates agree
    ratio = safe_scale(s_old) / safe_scale(s_new)
    old_rows = pool_q[pages].float()  # [N, nkv, bs, hd]
    requant = torch.clamp(torch.round(old_rows * ratio[:, None, None, None]), -QMAX, QMAX)
    pool_q[pages] = requant.to(torch.int8)
    pool_q[pages, :, offs, :] = quantize_rows(vals_f, s_new[:, None, None])


# -- whole-block movement (spill copy-out, revive copy-in, COW) ---------------------
def extract_block(cache: Dict, block, layers: int) -> Tuple[torch.Tensor, ...]:
    """One block's codes and scales over every layer: (k [L, nkv, bs, hd]
    int8, v, k_scale [L] f32, v_scale [L]), on the pool's device. A slice
    or an index tensor for `block` keeps a block axis second (k [L, n,
    nkv, bs, hd], the scales [L, n])."""
    return tuple(torch.stack([cache[str(i)][name][block] for i in range(layers)])
                 for name in ("k", "v", "k_scale", "v_scale"))


def revive_block(cache: Dict, k, v, ks, vs, block: int) -> None:
    """Copy an extracted block into `block` verbatim, codes and scales, in
    place: spill then revive is bit-exact within the int8 tier."""
    for i in range(k.shape[0]):
        lc = cache[str(i)]
        lc["k"][block].copy_(k[i])
        lc["v"][block].copy_(v[i])
        lc["k_scale"][block].copy_(ks[i])
        lc["v_scale"][block].copy_(vs[i])


def cow_copy_block(cache: Dict, src: int, dst: int, length: int) -> None:
    """Copy-on-write of a block's head, in place: the first `length` rows of
    `src` into `dst` verbatim with the source's scales (no requantization),
    and the rest of `dst` ZEROED. Unlike the native pool's copy, which
    keeps the destination's tail, the tail's codes are reset, so the
    destination's later writes grow the copied scale through
    `scatter_tokens` like any append. `src` is only read."""
    for lc in cache.values():
        for name in ("k", "v"):
            t = lc[name]
            t[dst, :, :length].copy_(t[src, :, :length])
            t[dst, :, length:].zero_()
        lc["k_scale"][dst].copy_(lc["k_scale"][src])
        lc["v_scale"][dst].copy_(lc["v_scale"][src])
