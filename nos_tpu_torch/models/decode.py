"""The serving programs over a block-paged KV pool.

Port of `nos_tpu/models/decode.py`: `_attend_cache` (:33), `_embed` /
`_lm_logits` (:113, :117), `_block_core` (:123, single device),
`init_paged_cache` (:242, native pool), `paged_decode_step` (:322),
`paged_prefill_chunk` (:393), `_paged_window_core` (:469) and
`paged_prefill_window` (:603).

The JAX programs return a new pool; these write K/V IN PLACE (advanced-index
assignment, i.e. `index_put_`) and return the same tensors. Ordering on the
one CUDA stream takes the place of JAX's donation chain, which keeps the
composition contract of decode.py:574-593: the programs of one tick write
disjoint page sets, and masked-off lanes and padding write only the scratch
page (block 0). Several lanes may hit the same scratch offset; which write
lands there is unspecified, and nothing reads it past position 0 of an
invalid row, whose output is discarded.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nos_tpu_torch import constants
from nos_tpu_torch.device import resolve
from nos_tpu_torch.models.gpt import GPTConfig, _rmsnorm, project_qkv


def _attend_cache(q, cache_k, cache_v, n_rep: int, limit):
    """q [B,nh,T,hd] against the cache [B,nkv,max,hd]. `limit` is [T]
    (shared across the batch) or [B,T]; query (b,t) attends to cache
    positions < limit[(b,)t]. Query heads are grouped against the
    un-repeated cache."""
    b, nh, t, hd = q.shape
    qg = q.reshape(b, nh // n_rep, n_rep, t, hd)  # [B, nkv, rep, T, hd]
    scale = hd ** -0.5
    scores = torch.einsum("bgrtd,bgsd->bgrts", qg.float(), cache_k.float()) * scale
    idx = torch.arange(cache_k.shape[2], device=q.device)
    limit = torch.atleast_2d(limit)  # [B or 1, T]
    mask = idx[None, None, :] < limit[:, :, None]  # [B1, T, max]
    scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrts,bgsd->bgrtd", probs, cache_v.float())
    return out.reshape(b, nh, t, hd).to(cache_v.dtype)


def _embed(params, tokens):
    return params["tok_emb"][tokens.long()]


def _lm_logits(x, params):
    return (x @ params["lm_head"]).float()


def _block_core(x, p, cfg: GPTConfig, positions, attend):
    """The one copy of the cached transformer block math (norms, QKV
    projection, residuals, gated MLP); every cache layout supplies only
    its `attend(q, k_new, v_new) -> o [B, nh, T, hd]` strategy."""
    b, t, _ = x.shape
    y = _rmsnorm(x, p["ln1"])
    q, k_new, v_new = project_qkv(y, p, cfg, positions, repeat_kv=False)
    o = attend(q, k_new, v_new)
    o = o.transpose(1, 2).reshape(b, t, -1)
    x = x + o @ p["wo"]
    z = _rmsnorm(x, p["ln2"])
    z = (F.silu(z @ p["w_gate"]) * (z @ p["w_up"])) @ p["w_down"]
    return x + z


def init_paged_cache(cfg: GPTConfig, total_blocks: int, block_size: int,
                     kv_dtype: Optional[str] = None, device=None) -> Dict:
    """A shared pool of fixed-size KV blocks [total_blocks, n_kv, block,
    head_dim] per layer in `cfg.dtype` on `device` (None: CUDA); block 0 is
    the scratch page."""
    device = resolve(device, "init_paged_cache")
    if kv_dtype is not None and kv_dtype not in constants.KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r}; expected one of {constants.KV_DTYPES}"
        )
    if kv_dtype == constants.KV_DTYPE_INT8:
        raise NotImplementedError(
            "the int8 paged pool is not ported yet (ROADMAP: the int8 engine)"
        )
    shape = (total_blocks, cfg.n_kv, block_size, cfg.head_dim)
    return {
        str(i): {
            "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        }
        for i in range(cfg.layers)
    }


def _page_of(table, positions, block_size: int):
    """table[b, positions // block_size] with out-of-range pages clamped
    (JAX clamps its gathers; the callers mask those lanes to scratch)."""
    idx = torch.clamp(positions // block_size, 0, table.shape[1] - 1)
    return torch.gather(table, 1, idx.long())


def paged_decode_step(params, token, cfg: GPTConfig, pcache, table, pos, mask,
                      block_size: int):
    """One token [B] with per-row positions [B] against the paged pool.
    Lanes with mask[b]=False write to the scratch page and their logits are
    garbage the caller ignores. Returns (logits [B, vocab] f32, pool)."""
    from nos_tpu_torch.ops.paged_attention import paged_decode_attention

    x = _embed(params, token[:, None])
    positions = pos[:, None].to(torch.int32)
    off = (pos % block_size).long()
    page = _page_of(table, pos[:, None], block_size)[:, 0]
    page = torch.where(mask, page, torch.zeros_like(page)).long()
    limit = (pos + 1).to(torch.int32)
    for i in range(cfg.layers):
        lc = pcache[str(i)]

        def attend(q, k_new, v_new, lc=lc):
            lc["k"][page, :, off, :] = k_new[:, :, 0, :]
            lc["v"][page, :, off, :] = v_new[:, :, 0, :]
            return paged_decode_attention(
                q[:, :, 0, :].contiguous(), lc["k"], lc["v"], table, limit
            )[:, :, None, :]

        x = _block_core(x, params["layers"][str(i)], cfg, positions, attend)
    x = _rmsnorm(x, params["ln_f"])
    return _lm_logits(x, params)[:, 0, :], pcache


def paged_prefill_chunk(params, tokens, cfg: GPTConfig, pcache, table_row, start: int,
                        length: int, block_size: int, with_logits: bool = True):
    """One prompt chunk [1, C] for a single sequence, written into its pages
    at positions start..start+C-1 (positions >= start+length, the chunk
    padding, go to the scratch page). Returns (logits [C, vocab] or None,
    pool)."""
    from nos_tpu_torch.ops.paged_attention import paged_window_attention

    dev = tokens.device
    _, c = tokens.shape
    ar = torch.arange(c, dtype=torch.int32, device=dev)
    positions = start + ar
    valid = ar < length
    x = _embed(params, tokens)
    table = table_row[None, :].contiguous()  # [1, P]
    pages = _page_of(table, positions[None, :], block_size)[0]
    pages = torch.where(valid, pages, torch.zeros_like(pages)).long()
    offs = (positions % block_size).long()
    w_pos = torch.full((1,), start, dtype=torch.int32, device=dev)
    w_len = torch.full((1,), length, dtype=torch.int32, device=dev)
    w_mask = torch.ones((1,), dtype=torch.bool, device=dev)
    for i in range(cfg.layers):
        lc = pcache[str(i)]

        def attend(q, k_new, v_new, lc=lc):
            lc["k"][pages, :, offs, :] = k_new[0].transpose(0, 1)
            lc["v"][pages, :, offs, :] = v_new[0].transpose(0, 1)
            return paged_window_attention(
                q.contiguous(), lc["k"], lc["v"], table, w_pos, w_len, w_mask
            )

        x = _block_core(x, params["layers"][str(i)], cfg, positions[None, :], attend)
    if not with_logits:
        # Non-final chunks only feed the cache: skip the [C, vocab] head.
        return None, pcache
    x = _rmsnorm(x, params["ln_f"])
    return _lm_logits(x, params)[0], pcache


def _paged_window_core(params, tokens, cfg: GPTConfig, pcache, table, pos, lengths,
                       mask, block_size: int):
    """Shared body of the batched per-slot window programs: tokens [B, W]
    written at per-row positions pos[b]..pos[b]+lengths[b]-1 into each
    row's own pages, attending causally over the prefix plus the window.
    Returns (pre-final-norm activations [B, W, h], pool)."""
    from nos_tpu_torch.ops.paged_attention import paged_window_attention

    b, w = tokens.shape
    ar = torch.arange(w, dtype=torch.int32, device=tokens.device)
    positions = pos[:, None] + ar[None, :]  # [B, W]
    valid = (ar[None, :] < lengths[:, None]) & mask[:, None]
    x = _embed(params, tokens)
    pages = _page_of(table, positions, block_size)
    pages = torch.where(valid, pages, torch.zeros_like(pages)).long()  # [B, W]
    offs = (positions % block_size).long()
    for i in range(cfg.layers):
        lc = pcache[str(i)]

        def attend(q, k_new, v_new, lc=lc):
            lc["k"][pages, :, offs, :] = k_new.transpose(1, 2)
            lc["v"][pages, :, offs, :] = v_new.transpose(1, 2)
            return paged_window_attention(
                q.contiguous(), lc["k"], lc["v"], table, pos, lengths, mask
            )

        x = _block_core(x, params["layers"][str(i)], cfg, positions, attend)
    return x, pcache


def paged_prefill_window(params, tokens, cfg: GPTConfig, pcache, table, pos, lengths,
                         mask, block_size: int):
    """Multi-slot batched prefill chunk: `paged_prefill_chunk` batched
    across slots. Active row b writes its chunk's K/V at positions
    pos[b]..pos[b]+lengths[b]-1 into its own pages; inactive rows and
    window padding hit the scratch page. Mid-prompt chunks only feed the
    cache, so no head projection runs. Returns the pool."""
    _, pcache = _paged_window_core(
        params, tokens, cfg, pcache, table, pos, lengths, mask, block_size
    )
    return pcache
