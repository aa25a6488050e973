"""The serving programs: over a dense KV cache and over a block-paged pool.

Port of `nos_tpu/models/decode.py`: the dense programs `init_cache` (:21),
`_block_with_cache` (:158), `_forward_with_cache` (:204), `prefill` (:222),
`decode_step` (:235), `decode_step_ragged` (:636) and `generate` (:648);
`_attend_cache` (:33), `TPLocal` (:54), `_embed` / `_lm_logits` (:113,
:117), `_block_core` (:123); and the paged ones, `init_paged_cache` (:242,
native pool), `paged_decode_step` (:322), `paged_prefill_chunk` (:393;
with `paged_prefill_last`, its head on the last row only),
`_paged_window_core` (:469), `paged_verify_window` (:545) and
`paged_prefill_window` (:603).

Each layer takes its own RoPE, and a sliding layer bounds its keys below
(`window=` to the paged kernels); with experts every layer's MLP is the expert layer
(`ops/moe.py`), which routes only the rows a program holds valid (active
lanes, rows inside a chunk's length) and adds its work into the engine's
device tally (`moe_tally`). The dense-cache programs refuse sliding layers.

Tensor parallelism (docs/sharded-decode.md) runs under one controller: where
JAX runs a `shard_map`'d body once per device, the paged programs here take
`tp` (a `TPLocal`) and loop over its shards. Params, pool and per-shard
activations are then lists in shard order; replicated activations are one
tensor per shard (the same tensor where shards share a device). `tp=None`
is the single-device path, unchanged.

The JAX programs return a new cache; these write K/V IN PLACE (`index_copy_`
or advanced-index assignment, i.e. `index_put_`; over an int8 pool, the
`ops/quantized_kv.py` funnel, `_write_kv`) and return the same tensors.
Ordering on the one CUDA stream takes the place of JAX's donation chain,
which keeps the composition contract of decode.py:574-593: the programs of
one tick write disjoint page sets, and masked-off lanes and padding write
only the scratch page (block 0). Several lanes may hit the same scratch
offset; which write lands there is unspecified, and nothing reads it past
position 0 of an invalid row, whose output is discarded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nos_tpu_torch import constants, prng
from nos_tpu_torch.device import resolve
from nos_tpu_torch.models.gpt import GPTConfig, _rmsnorm, project_qkv, tp_local_config
from nos_tpu_torch.ops.decode_attention import decode_attention
from nos_tpu_torch.ops.moe import moe_experts


def _attend_cache(q, cache_k, cache_v, n_rep: int, limit, window: int = 0):
    """q [B,nh,T,hd] against the cache [B,nkv,max,hd]. `limit` is [T]
    (shared across the batch) or [B,T]; query (b,t) attends to cache
    positions < limit[(b,)t], and with a `window` > 0 only to those >=
    limit[(b,)t] - window. Query heads are grouped against the un-repeated
    cache."""
    b, nh, t, hd = q.shape
    qg = q.reshape(b, nh // n_rep, n_rep, t, hd)  # [B, nkv, rep, T, hd]
    scale = hd ** -0.5
    scores = torch.einsum("bgrtd,bgsd->bgrts", qg.float(), cache_k.float()) * scale
    idx = torch.arange(cache_k.shape[2], device=q.device)
    limit = torch.atleast_2d(limit)  # [B or 1, T]
    mask = idx[None, None, :] < limit[:, :, None]  # [B1, T, max]
    if window:
        mask &= idx[None, None, :] >= limit[:, :, None] - window
    scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrts,bgsd->bgrtd", probs, cache_v.float())
    return out.reshape(b, nh, t, hd).to(cache_v.dtype)


class TPLocal:
    """The tensor-parallel context of the paged programs (decode.py:54) in
    the all-column-parallel layout of `parallel/sharding.py::
    decode_param_rules`: every weight shard holds output columns, so no
    contraction is split across shards, and the only collective is
    `gather`, an exact concatenation in shard order. `devices` are the
    shards' devices in shard order (tp = their count); a device may
    repeat."""

    def __init__(self, cfg: GPTConfig, devices, emb_sharded: bool, head_sharded: bool):
        self.devices = [torch.device(d) for d in devices]
        self.tp = len(self.devices)
        self.cfg = cfg
        #: The per-shard config view (heads/tp, n_kv/tp, hidden/tp).
        self.lcfg = tp_local_config(cfg, self.tp)
        #: Whether tok_emb rows / lm_head columns are sharded (a vocabulary
        #: that tp does not divide stays replicated, sharding.py's guard).
        self.emb_sharded = bool(emb_sharded)
        self.head_sharded = bool(head_sharded)

    def replicate(self, x):
        """x on every shard's device (no copy where it already lies); a
        per-shard list passes through."""
        if isinstance(x, (list, tuple)):
            return list(x)
        return [x.to(d) for d in self.devices]

    def _cat(self, parts, dim):
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=dim)

    def gather(self, parts, dim=-1):
        """All-gather: the shards' parts concatenated along `dim` in shard
        order, replicated to every shard. Exact, and in the parts' dtype."""
        return self.replicate(self._cat(parts, dim))

    def embed(self, params, tokens):
        """The token embedding, replicated. Over vocab-row-sharded tables
        each shard looks up the rows it holds, zeros elsewhere, and the
        parts are summed in shard order: one real row plus zeros, exact."""
        toks = self.replicate(tokens.long())
        if not self.emb_sharded:
            return [p["tok_emb"][t] for p, t in zip(params, toks)]
        total = None
        for s, (p, t) in enumerate(zip(params, toks)):
            emb = p["tok_emb"]
            vshard = emb.shape[0]
            local = t - s * vshard
            ok = (local >= 0) & (local < vshard)
            rows = emb[local.clamp(0, vshard - 1)]
            part = torch.where(ok[..., None], rows, torch.zeros_like(rows)).to(self.devices[0])
            total = part if total is None else total + part
        return self.replicate(total)

    def head(self, xs, lm_heads):
        """Logits [.., vocab] f32 on the first shard's device, from the
        final-normed activations: over vocab-column-sharded heads the local
        logits are cast to f32, then gathered; a replicated head is shard
        0's product alone."""
        if not self.head_sharded:
            return (xs[0] @ lm_heads[0]).float()
        return self._cat([(x @ w).float() for x, w in zip(xs, lm_heads)], -1)


def place_tp(params, cfg: GPTConfig, mesh, tp_axis: str = "tp"):
    """Params placed for tensor-parallel decode over `mesh`'s `tp_axis` by
    `decode_param_rules` (decode_server.py:676-689): (one param tree per
    shard, the spec of every leaf, the TPLocal of the shards)."""
    from nos_tpu_torch.parallel.sharding import (decode_param_rules, param_partition_specs,
                                                 shard_params)

    rules = decode_param_rules(tp_axis)
    specs = param_partition_specs(params, mesh, rules)
    tp = TPLocal(cfg, mesh.axis_devices(tp_axis), emb_sharded=specs["tok_emb"] != (),
                 head_sharded=specs["lm_head"] != ())
    return shard_params(params, mesh, rules, tp_axis), specs, tp


def _embed(params, tokens, tp=None):
    if tp is not None:
        return tp.embed(params, tokens)
    return params["tok_emb"][tokens.long()]


def _lm_logits(x, params, tp=None):
    """Head logits f32. With `tp`, x and params are per-shard lists and the
    final norm runs here, per shard, on the shards the head reads."""
    if tp is not None:
        n = tp.tp if tp.head_sharded else 1
        xs = [_rmsnorm(x[s], params[s]["ln_f"]) for s in range(n)]
        return tp.head(xs, [p["lm_head"] for p in params[:n]])
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


def _block_core(x, p, cfg: GPTConfig, positions, attend, tp=None, layer: int = 0,
                valid=None, moe_tally=None):
    """The one copy of the cached transformer block math (norms, QKV
    projection with layer `layer`'s RoPE, residuals, gated MLP or the
    expert layer); every cache layout supplies only its `attend(q, k_new,
    v_new) -> o [B, nh, T, hd]` strategy. `valid` [B, T] marks the rows the
    expert layer routes (None: all), `moe_tally` its device tally
    (`ops/moe.py`). With `tp` see `_block_core_tp`."""
    if tp is not None:
        return _block_core_tp(x, p, positions, attend, tp)
    b, t, _ = x.shape
    y = _rmsnorm(x, p["ln1"])
    q, k_new, v_new = project_qkv(y, p, cfg, positions, repeat_kv=False, layer=layer)
    o = attend(q, k_new, v_new)
    o = o.transpose(1, 2).reshape(b, t, -1)
    x = x + o @ p["wo"]
    z = _rmsnorm(x, p["ln2"])
    if cfg.n_experts:
        rows = None if valid is None else valid.reshape(b * t)
        z = moe_experts(z.reshape(b * t, -1), p["router"], p["expert_gate"], p["expert_up"],
                        p["expert_down"], cfg.top_k, cfg.norm_topk_prob, valid=rows,
                        tally=moe_tally).reshape(b, t, -1)
    else:
        z = (F.silu(z @ p["w_gate"]) * (z @ p["w_up"])) @ p["w_down"]
    return x + z


def _block_core_tp(xs, ps, positions, attend, tp: TPLocal):
    """`_block_core` over tensor-parallel shards (decode.py:144-155): xs is
    the replicated activation, one tensor per shard, ps the shards' layer
    params. Each shard projects its heads' q, k, v from its column shard;
    `attend(qs, ks, vs)` takes and returns per-shard lists; `tp.gather`
    stands exactly where the reference puts `g_`, so every product
    consumes its full contraction operand."""
    b, t, _ = xs[0].shape
    shards = range(tp.tp)
    pos = tp.replicate(positions)
    qs, ks, vs = [], [], []
    for s in shards:
        y = _rmsnorm(xs[s], ps[s]["ln1"])
        q, k_new, v_new = project_qkv(y, ps[s], tp.lcfg, pos[s], repeat_kv=False)
        qs.append(q)
        ks.append(k_new)
        vs.append(v_new)
    o = tp.gather([o.transpose(1, 2).reshape(b, t, -1) for o in attend(qs, ks, vs)])
    a = tp.gather([o[s] @ ps[s]["wo"] for s in shards])
    xs = [xs[s] + a[s] for s in shards]
    zs = [_rmsnorm(xs[s], ps[s]["ln2"]) for s in shards]
    h = tp.gather([F.silu(zs[s] @ ps[s]["w_gate"]) * (zs[s] @ ps[s]["w_up"]) for s in shards])
    d = tp.gather([h[s] @ ps[s]["w_down"] for s in shards])
    return [xs[s] + d[s] for s in shards]


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


def _block_with_cache(x, p, cfg: GPTConfig, layer_cache, positions, start, layer: int = 0):
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

    return _block_core(x, p, cfg, positions, attend, layer=layer)


def _forward_with_cache(params, tokens, cfg: GPTConfig, cache, start):
    """tokens [B, T] at `start` through every block -> (logits [B, T,
    vocab] f32, the cache written in place). Sliding layers are served by
    the paged programs only."""
    if any(cfg.window(i) for i in range(cfg.layers)):
        raise ValueError("the dense cache has no sliding window: serve this config through "
                         "the paged programs (DecodeServer)")
    b, t = tokens.shape
    x = _embed(params, tokens)
    ar = torch.arange(t, dtype=torch.int32, device=tokens.device)
    if _is_lockstep(start):
        positions = (start + ar).expand(b, t)
    else:
        positions = start[:, None] + ar
    for i in range(cfg.layers):
        x = _block_with_cache(x, params["layers"][str(i)], cfg, cache[str(i)],
                              positions, start, layer=i)
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
                     kv_dtype: Optional[str] = None, device=None, mesh=None,
                     tp_axis: str = "tp"):
    """A shared pool of fixed-size KV blocks [total_blocks, n_kv, block,
    head_dim] per layer in `cfg.dtype` on `device` (None: CUDA); block 0 is
    the scratch page. `kv_dtype` "int8" (decode.py:282-320) stores the K/V
    leaves as int8 codes and adds `k_scale`/`v_scale` [total_blocks] f32
    per layer, one scale per (block, layer, k|v); None or "fp16" is the
    native pool. On a `mesh` whose `tp_axis` is wider than 1 the pool
    is partitioned on KV heads: a list in shard order of per-layer pools
    [total_blocks, n_kv/tp, block, head_dim], each on its shard's device
    (`device` is not used), and every shard holds its own copy of the
    scales (the reference's replicated `P(None)`), which the funnel keeps
    equal. Block ids and page tables mean the same at every width; only a
    block's bytes per shard shrink."""
    from nos_tpu_torch.ops.paged_attention import _tp_width

    width = _tp_width(mesh, tp_axis)
    if width > 1:
        if cfg.n_kv % width:
            raise ValueError(f"tp={width} must divide kv_heads={cfg.n_kv}")
        local = dataclasses.replace(cfg, kv_heads=cfg.n_kv // width)
        return [init_paged_cache(local, total_blocks, block_size, kv_dtype, device=d)
                for d in mesh.axis_devices(tp_axis)]
    device = resolve(device, "init_paged_cache")
    if kv_dtype is not None and kv_dtype not in constants.KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r}; expected one of {constants.KV_DTYPES}"
        )
    quant = kv_dtype == constants.KV_DTYPE_INT8
    shape = (total_blocks, cfg.n_kv, block_size, cfg.head_dim)
    dtype = torch.int8 if quant else cfg.torch_dtype

    def _zeros():
        return torch.zeros(shape, dtype=dtype, device=device)

    def _scales():
        return torch.zeros((total_blocks,), dtype=torch.float32, device=device)

    if not quant:
        return {str(i): {"k": _zeros(), "v": _zeros()} for i in range(cfg.layers)}
    return {
        str(i): {
            "k": _zeros(),
            "v": _zeros(),
            "k_scale": _scales(),
            "v_scale": _scales(),
        }
        for i in range(cfg.layers)
    }


def _page_of(table, positions, block_size: int):
    """table[b, positions // block_size] with out-of-range pages clamped
    (JAX clamps its gathers; the callers mask those lanes to scratch)."""
    idx = torch.clamp(positions // block_size, 0, table.shape[1] - 1)
    return torch.gather(table, 1, idx.long())


def _write_kv(lc, pages, offs, k_rows, v_rows, amax=(None, None)) -> dict:
    """Write token rows k_rows/v_rows [..., nkv, hd] at block pages[...],
    offset offs[...] of one layer's pool `lc`, in place: a native pool by
    indexed assignment, an int8 pool (`"k_scale" in lc`) through the
    `ops/quantized_kv.py` funnel, flattened to rows, with `amax` the (K, V)
    row maxima [...] when taken across tensor-parallel shards. Returns the
    keyword arguments that hand the scales to the attention op (none for a
    native pool)."""
    if "k_scale" not in lc:
        lc["k"][pages, :, offs, :] = k_rows
        lc["v"][pages, :, offs, :] = v_rows
        return {}
    from nos_tpu_torch.ops.quantized_kv import scatter_tokens

    pages, offs = pages.reshape(-1), offs.reshape(-1)
    for name, rows, m in (("k", k_rows, amax[0]), ("v", v_rows, amax[1])):
        scatter_tokens(lc[name], lc[name + "_scale"], pages, offs,
                       rows.reshape(-1, *rows.shape[-2:]),
                       amax=None if m is None else m.reshape(-1))
    return {"k_scale": lc["k_scale"], "v_scale": lc["v_scale"]}


def paged_decode_step(params, token, cfg: GPTConfig, pcache, table, pos, mask,
                      block_size: int, tp: Optional[TPLocal] = None, moe_tally=None):
    """One token [B] with per-row positions [B] against the paged pool.
    Lanes with mask[b]=False write to the scratch page, take no expert, and
    their logits are garbage the caller ignores. A sliding layer attends
    its window's keys only. `moe_tally`: the expert layers' device tally
    (`ops/moe.py`). Returns (logits [B, vocab] f32, pool).

    `tp`: params and pool are per-shard lists; each shard writes and reads
    its own head slices of the pool through `paged_decode_attention_sharded`,
    and the logits come back gathered on the first shard's device."""
    from nos_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_sharded,
    )

    if tp is not None:
        tables = tp.replicate(table)
        page = _page_of(tables[0], pos[:, None], block_size)
        page = torch.where(mask[:, None], page, torch.zeros_like(page)).long()
        limits = tp.replicate((pos + 1).to(torch.int32))

        def read(qs, pool_k, pool_v, **scales):
            out = paged_decode_attention_sharded(
                [q[:, :, 0, :].contiguous() for q in qs], pool_k, pool_v, tables, limits,
                **scales)
            return [o[:, :, None, :] for o in out]

        xs = _tp_forward(params, token[:, None], pcache, pos[:, None].to(torch.int32),
                         page, (pos % block_size).long()[:, None], read, tp)
        return _lm_logits(xs, params, tp)[:, 0, :], pcache
    x = _embed(params, token[:, None])
    positions = pos[:, None].to(torch.int32)
    off = (pos % block_size).long()
    page = _page_of(table, pos[:, None], block_size)[:, 0]
    page = torch.where(mask, page, torch.zeros_like(page)).long()
    limit = (pos + 1).to(torch.int32)
    for i in range(cfg.layers):
        lc = pcache[str(i)]

        def attend(q, k_new, v_new, lc=lc, window=cfg.window(i)):
            scales = _write_kv(lc, page, off, k_new[:, :, 0, :], v_new[:, :, 0, :])
            return paged_decode_attention(
                q[:, :, 0, :].contiguous(), lc["k"], lc["v"], table, limit, **scales,
                window=window,
            )[:, :, None, :]

        x = _block_core(x, params["layers"][str(i)], cfg, positions, attend, layer=i,
                        valid=mask[:, None], moe_tally=moe_tally)
    x = _rmsnorm(x, params["ln_f"])
    return _lm_logits(x, params)[:, 0, :], pcache


def _lane(v, device) -> torch.Tensor:
    """A one-lane int32 vector [1]: a tensor as it is, an int on `device`."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((1,), int(v), dtype=torch.int32, device=device)


def _chunk_layers(params, tokens, cfg: GPTConfig, pcache, table_row, start, length,
                  block_size: int, tp: Optional[TPLocal] = None, moe_tally=None):
    """The layers of the batch-1 prompt chunk: `_paged_window_core` over
    one lane. `start` and `length` are ints or [1] int32 tensors on the
    tokens' device (a captured graph's inputs); `table_row` is the
    sequence's page-table row [P] (per shard with `tp`). Returns the
    pre-final-norm activations [1, C, h] (per shard with `tp`)."""
    dev = tokens.device
    if tp is not None:
        table = [r[None, :].contiguous() for r in tp.replicate(table_row)]
    else:
        table = table_row[None, :].contiguous()  # [1, P]
    x, _ = _paged_window_core(params, tokens, cfg, pcache, table, _lane(start, dev),
                              _lane(length, dev), torch.ones((1,), dtype=torch.bool, device=dev),
                              block_size, tp=tp, moe_tally=moe_tally)
    return x


def _head(x, params, tp: Optional[TPLocal] = None):
    """Logits f32 from pre-final-norm activations: the final norm, then
    the head (with `tp`, both per shard in `_lm_logits`)."""
    if tp is not None:
        return _lm_logits(x, params, tp)
    return _lm_logits(_rmsnorm(x, params["ln_f"]), params)


def paged_prefill_chunk(params, tokens, cfg: GPTConfig, pcache, table_row, start, length,
                        block_size: int, with_logits: bool = True,
                        tp: Optional[TPLocal] = None, moe_tally=None):
    """One prompt chunk [1, C] for a single sequence, written into its pages
    at positions start..start+C-1 (positions >= start+length, the chunk
    padding, go to the scratch page). Returns (logits [C, vocab] or None,
    pool): every row's, as the verify pass reads them; the engine's final
    chunk takes `paged_prefill_last`. `start` and `length` are ints or [1]
    int32 tensors on the tokens' device. `tp`, `moe_tally`: see
    `paged_decode_step`."""
    x = _chunk_layers(params, tokens, cfg, pcache, table_row, start, length, block_size, tp,
                      moe_tally)
    if not with_logits:
        # Non-final chunks only feed the cache: skip the [C, vocab] head.
        return None, pcache
    return _head(x, params, tp)[0], pcache


def paged_prefill_last(params, tokens, cfg: GPTConfig, pcache, table_row, start, length,
                       block_size: int, tp: Optional[TPLocal] = None, moe_tally=None):
    """A prompt's final chunk, as `paged_prefill_chunk` writes it, with the
    head on its last row only: the logits [1, vocab] f32 of row
    `length - 1`, gathered from the activations by a device index (the
    norm and the head act row by row, so the row is the full head's row;
    only the product's shape changes). `length` 0 writes nothing but the
    scratch page and reads row 0 (a warm-up). Returns (logits, pool)."""
    x = _chunk_layers(params, tokens, cfg, pcache, table_row, start, length, block_size, tp,
                      moe_tally)
    last = (_lane(length, tokens.device).long() - 1).clamp(min=0)  # [1]
    if tp is not None:
        x = [xs.index_select(1, at) for xs, at in zip(x, tp.replicate(last))]
    else:
        x = x.index_select(1, last)  # [1, 1, h]
    return _head(x, params, tp)[0], pcache


def _paged_window_core(params, tokens, cfg: GPTConfig, pcache, table, pos, lengths,
                       mask, block_size: int, tp: Optional[TPLocal] = None, moe_tally=None):
    """Shared body of the batched per-slot window programs: tokens [B, W]
    written at per-row positions pos[b]..pos[b]+lengths[b]-1 into each
    row's own pages, attending causally over the prefix plus the window (a
    sliding layer over its window's keys only); rows past a lane's length
    and masked lanes take no expert. Returns (pre-final-norm activations
    [B, W, h], pool); with `tp` the activations are per shard (see
    `paged_decode_step`)."""
    from nos_tpu_torch.ops.paged_attention import paged_window_attention

    if tp is not None:
        return _paged_window_tp(params, tokens, pcache, table, pos, lengths, mask,
                                block_size, tp), pcache
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

        def attend(q, k_new, v_new, lc=lc, window=cfg.window(i)):
            scales = _write_kv(lc, pages, offs, k_new.transpose(1, 2), v_new.transpose(1, 2))
            return paged_window_attention(
                q.contiguous(), lc["k"], lc["v"], table, pos, lengths, mask, **scales,
                window=window,
            )

        x = _block_core(x, params["layers"][str(i)], cfg, positions, attend, layer=i,
                        valid=valid, moe_tally=moe_tally)
    return x, pcache


def paged_verify_window(params, tokens, cfg: GPTConfig, pcache, table, pos, lengths, mask,
                        block_size: int, tp: Optional[TPLocal] = None, moe_tally=None):
    """Batched speculative-verify window (decode.py:545): tokens [B, W] are
    per-slot draft windows (window[0] = the slot's last accepted token),
    each slot writing K/V at pos[b]..pos[b]+lengths[b]-1 into its own pages
    and attending causally over its confirmed prefix plus the window. Rows
    past lengths[b] and lanes with mask[b]=False write the scratch page and
    yield logits the caller ignores. Returns (logits [B, W, vocab] f32,
    pool). Rejected rows leave stale K/V past the accepted position; the
    next round's window starts there and overwrites it before anything
    attends that far. Within a tick this program, the prefill waves and
    the decode window write disjoint page sets (masked lanes write only
    the scratch page), as `paged_decode_step` does."""
    x, pcache = _paged_window_core(
        params, tokens, cfg, pcache, table, pos, lengths, mask, block_size, tp=tp,
        moe_tally=moe_tally,
    )
    return _head(x, params, tp), pcache


def paged_prefill_window(params, tokens, cfg: GPTConfig, pcache, table, pos, lengths,
                         mask, block_size: int, tp: Optional[TPLocal] = None, moe_tally=None):
    """Multi-slot batched prefill chunk: `paged_prefill_chunk` batched
    across slots. Active row b writes its chunk's K/V at positions
    pos[b]..pos[b]+lengths[b]-1 into its own pages; inactive rows and
    window padding hit the scratch page. Mid-prompt chunks only feed the
    cache, so no head projection runs. Returns the pool."""
    _, pcache = _paged_window_core(
        params, tokens, cfg, pcache, table, pos, lengths, mask, block_size, tp=tp,
        moe_tally=moe_tally,
    )
    return pcache


# -- the tensor-parallel paged programs ----------------------------------------
def _tp_forward(params, tokens, pcache, positions, pages, offs, read, tp: TPLocal):
    """The layers of a tensor-parallel paged program: tokens [B, T] at
    positions [B, T], whose K/V rows go to pool page pages[b, t] at offset
    offs[b, t] (scratch page 0 for masked rows), on every shard's own head
    slices; `read(qs, pool_k, pool_v, **scales)` is the sharded attention
    over the written pools. Over an int8 pool each shard takes its rows'
    max|value| over its heads, the max over the shards is taken on the
    first shard's device and handed back to every shard's funnel (the
    reference's `pmax`), so the shards' scale copies stay equal. Returns
    the per-shard pre-final-norm activations."""
    from nos_tpu_torch.ops.quantized_kv import row_amax

    xs = _embed(params, tokens, tp)
    pages, offs = tp.replicate(pages), tp.replicate(offs)
    for i in range(tp.cfg.layers):
        lcs = [pc[str(i)] for pc in pcache]

        def attend(qs, ks, vs, lcs=lcs):
            k_rows = [k.transpose(1, 2) for k in ks]  # [B, T, nkv/tp, hd]
            v_rows = [v.transpose(1, 2) for v in vs]
            amax = [None] * tp.tp, [None] * tp.tp
            if "k_scale" in lcs[0]:
                amax = tuple(tp.replicate(torch.stack([row_amax(r).to(tp.devices[0])
                                                       for r in rows]).amax(dim=0))
                             for rows in (k_rows, v_rows))
            writes = [_write_kv(lc, pages[s], offs[s], k_rows[s], v_rows[s],
                                (amax[0][s], amax[1][s])) for s, lc in enumerate(lcs)]
            scales = {name: [w[name] for w in writes] for name in writes[0]}
            return read(qs, [lc["k"] for lc in lcs], [lc["v"] for lc in lcs], **scales)

        xs = _block_core(xs, [p["layers"][str(i)] for p in params], tp.lcfg, positions,
                         attend, tp=tp)
    return xs


def _paged_window_tp(params, tokens, pcache, table, pos, lengths, mask, block_size: int,
                     tp: TPLocal):
    """`_paged_window_core` over tensor-parallel shards, reading through
    `paged_window_attention_sharded`. Returns per-shard activations."""
    from nos_tpu_torch.ops.paged_attention import paged_window_attention_sharded

    w = tokens.shape[1]
    tables = tp.replicate(table)
    ar = torch.arange(w, dtype=torch.int32, device=tokens.device)
    positions = pos[:, None] + ar[None, :]  # [B, W]
    valid = (ar[None, :] < lengths[:, None]) & mask[:, None]
    pages = _page_of(tables[0], positions, block_size)
    pages = torch.where(valid, pages, torch.zeros_like(pages)).long()
    pos_s, len_s, mask_s = tp.replicate(pos), tp.replicate(lengths), tp.replicate(mask)

    def read(qs, pool_k, pool_v, **scales):
        return paged_window_attention_sharded(
            [q.contiguous() for q in qs], pool_k, pool_v, tables, pos_s, len_s, mask_s,
            **scales)

    return _tp_forward(params, tokens, pcache, positions, pages,
                       (positions % block_size).long(), read, tp)
