"""The serving programs: over a dense KV cache and over a block-paged pool.

Port of `nos_tpu/models/decode.py`: the dense programs `init_cache` (:21),
`_block_with_cache` (:158), `_forward_with_cache` (:204), `prefill` (:222),
`decode_step` (:235), `decode_step_ragged` (:636) and `generate` (:648);
`_attend_cache` (:33), `_embed` / `_lm_logits` (:113, :117), `_block_core`
(:123, single device); and the paged ones, `init_paged_cache` (:242, native
pool), `paged_decode_step` (:322), `paged_prefill_chunk` (:393),
`_paged_window_core` (:469) and `paged_prefill_window` (:603).

The JAX programs return a new cache; these write K/V IN PLACE (`index_copy_`
or advanced-index assignment, i.e. `index_put_`) and return the same tensors.
Ordering on the one CUDA stream takes the place of JAX's donation chain,
which keeps the composition contract of decode.py:574-593: the programs of
one tick write disjoint page sets, and masked-off lanes and padding write
only the scratch page (block 0). Several lanes may hit the same scratch
offset; which write lands there is unspecified, and nothing reads it past
position 0 of an invalid row, whose output is discarded.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nos_tpu_torch import constants, prng
from nos_tpu_torch.device import resolve
from nos_tpu_torch.models.gpt import GPTConfig, _rmsnorm, project_qkv
from nos_tpu_torch.ops.decode_attention import decode_attention


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


def greedy(logits):
    """The LOWEST index among the exact maxima of the last axis (int32), not
    argmax: argmax's tie-break is not stable across program shapes, and the
    dense `generate` and the engine must agree token for token
    (decode.py:678-685, decode_server.py:999)."""
    vocab = logits.shape[-1]
    top = logits.max(dim=-1, keepdim=True).values
    idx = torch.arange(vocab, dtype=torch.int32, device=logits.device)
    return torch.where(logits == top, idx, vocab).min(dim=-1).values


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


# -- the dense contiguous cache ------------------------------------------------
def init_cache(cfg: GPTConfig, batch: int, max_len: int, device=None) -> Dict:
    """Per-layer K/V buffers [B, n_kv, max_len, head_dim] in `cfg.dtype` on
    `device` (None: CUDA)."""
    device = resolve(device, "init_cache")
    shape = (batch, cfg.n_kv, max_len, cfg.head_dim)
    return {
        str(i): {
            "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        }
        for i in range(cfg.layers)
    }


def _is_lockstep(start) -> bool:
    """A scalar start (a Python int or a 0-d tensor: the whole batch at one
    offset) rather than a [B] vector of per-row offsets (decode.py:168)."""
    return not isinstance(start, torch.Tensor) or start.dim() == 0


def _block_with_cache(x, p, cfg: GPTConfig, layer_cache, positions, start):
    """One transformer block writing its new K/V into the cache at `start`
    and attending over everything cached so far. x: [B, T, h]. `start` is a
    scalar (prefill, lockstep decode) or a [B] tensor (ragged decode). The
    write start is clamped to [0, max - T] as `dynamic_update_slice` clamps
    it; the attention limits use the unclamped start, as in JAX."""
    b, t, _ = x.shape
    dev = x.device
    max_len = layer_cache["k"].shape[2]
    ar = torch.arange(t, dtype=torch.int32, device=dev)

    def attend(q, k_new, v_new):
        ck, cv = layer_cache["k"], layer_cache["v"]
        if _is_lockstep(start):
            if isinstance(start, torch.Tensor):
                s0 = torch.clamp(start, 0, max_len - t)
            else:
                s0 = min(max(int(start), 0), max_len - t)
            idx = (s0 + ar).long()
            ck.index_copy_(2, idx, k_new)
            cv.index_copy_(2, idx, v_new)
            limit = start + ar + 1  # [T]: causal within the new chunk
            limit_b = (start + torch.ones((b,), dtype=torch.int32, device=dev)).to(torch.int32)
        else:
            rows = torch.arange(b, device=dev)[:, None]
            idx = (torch.clamp(start, 0, max_len - t)[:, None] + ar).long()  # [B, T]
            ck[rows, :, idx, :] = k_new.transpose(1, 2)
            cv[rows, :, idx, :] = v_new.transpose(1, 2)
            limit = start[:, None] + ar + 1  # [B, T]
            limit_b = (start + 1).to(torch.int32)
        if t == 1:
            # Every single-token step (lockstep and ragged) goes through the
            # cached-attention op: the kernel on CUDA, the plain version on
            # the CPU.
            return decode_attention(
                q[:, :, 0, :].contiguous(), ck, cv, limit_b.contiguous()
            )[:, :, None, :]
        return _attend_cache(q, ck, cv, cfg.heads // cfg.n_kv, limit)

    return _block_core(x, p, cfg, positions, attend)


def _forward_with_cache(params, tokens, cfg: GPTConfig, cache, start):
    """tokens [B, T] at `start` through every block -> (logits [B, T,
    vocab] f32, the cache written in place)."""
    b, t = tokens.shape
    x = _embed(params, tokens)
    ar = torch.arange(t, dtype=torch.int32, device=tokens.device)
    if _is_lockstep(start):
        positions = (start + ar).expand(b, t)
    else:
        positions = start[:, None] + ar
    for i in range(cfg.layers):
        x = _block_with_cache(x, params["layers"][str(i)], cfg, cache[str(i)],
                              positions, start)
    x = _rmsnorm(x, params["ln_f"])
    return _lm_logits(x, params), cache


def prefill(params, tokens, cfg: GPTConfig, max_len: int):
    """Run the prompt [B, T] through the model in one batched pass, filling a
    fresh cache for `max_len` on the tokens' device. Returns (last-position
    logits [B, vocab], cache)."""
    if tokens.shape[1] > max_len:
        raise ValueError(
            f"prompt length {tokens.shape[1]} exceeds cache max_len {max_len}"
        )
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    logits, cache = _forward_with_cache(params, tokens, cfg, cache, 0)
    return logits[:, -1, :], cache


def decode_step(params, token, cfg: GPTConfig, cache, pos):
    """One token [B] at position `pos` (a scalar) -> (logits [B, vocab],
    cache)."""
    logits, cache = _forward_with_cache(params, token[:, None], cfg, cache, pos)
    return logits[:, 0, :], cache


def decode_step_ragged(params, token, cfg: GPTConfig, cache, pos):
    """One token [B] with per-row positions [B] -> (logits [B, vocab],
    cache), against the dense cache. Row b writes its K/V at pos[b] and
    attends to cache[:pos[b]+1]."""
    logits, cache = _forward_with_cache(params, token[:, None], cfg, cache, pos)
    return logits[:, 0, :], cache


def generate(params, prompt, cfg: GPTConfig, steps: int, temperature: float = 0.0,
             rng: Optional[torch.Tensor] = None, max_len: Optional[int] = None):
    """Greedy (temperature 0) or sampled continuation of `prompt` [B, T].
    Returns int32 tokens [B, steps]. The keys are `split(rng, steps)` (rng
    None: PRNGKey(0)), as in JAX: key 0 samples from the prefill's logits,
    keys 1.. drive the steps-1 decode steps, a Python loop where JAX scans."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    b, t = prompt.shape
    max_len = max_len or (t + steps)
    # The cache holds the prompt plus every generated token but the last
    # (sampled, never re-attended): the loop writes positions t..t+steps-2.
    if t + steps - 1 > max_len:
        raise ValueError(
            f"prompt ({t}) + steps ({steps}) exceed cache max_len {max_len}"
        )
    if rng is None:
        rng = prng.PRNGKey(0)
    keys = prng.split(rng.to(prompt.device), steps)

    def pick(logits, key):
        if temperature > 0.0:
            return prng.categorical(key, logits / temperature).to(torch.int32)
        return greedy(logits)

    logits, cache = prefill(params, prompt, cfg, max_len)
    token = pick(logits, keys[0])
    out = [token]
    for i in range(1, steps):
        logits, cache = decode_step(params, token, cfg, cache, t + i - 1)
        token = pick(logits, keys[i])
        out.append(token)
    return torch.stack(out, dim=1)


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
