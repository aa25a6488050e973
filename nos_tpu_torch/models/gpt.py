"""Decoder-only transformer LM: configuration, initialization, the block
math the serving programs share, and the training forward.

Port of `nos_tpu/models/gpt.py`: `GPTConfig` (:24), `_rmsnorm` (:98),
`_rope` (:104), `tp_local_config` (:117), `project_qkv` (:143),
`init_gpt` (:72), and the training forward `_attention` (:184), `_block`
(:197), `gpt_hidden` (:209), `gpt_forward` (:224) and the chunked
`gpt_loss` (:230), whose attention runs through the flash kernels
(`ops/flash_attention.py`). Parameters are a plain nested dict of tensors
with the reference's keys and shapes, so `models/params.py` can carry a
JAX param tree across unchanged.

With `mesh=` (:193-213) the three entry points run the SPMD program that
GSPMD derives from the reference's shardings, one loop over the mesh
positions (the port's single controller): the params as a `MeshTree` under
`transformer_param_rules` (a plain tree is placed first), the tokens split
as P(dp, sp). Each (dp, tp) position runs the flash kernel on its own batch
rows and heads, [B/dp, H/tp, T, hd], causal; the row-parallel `wo` and
`w_down` are followed by a sum across the tp shards, the feature-sharded
embedding by a gather. With sp in the mesh, `attention="ring"` or
`"ulysses"` routes attention through `parallel/ring_attention.py`; other
settings gather the sequence and run the flash kernel over all of it.
Activations stay replicated over tp, one copy per shard: the loss is read
at each tp group's first shard, so the gradient of a replicated leaf is
the sum of its copies' gradients (`models/train.py` sums them).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nos_tpu_torch.device import resolve
from nos_tpu_torch.ops.flash_attention import flash_attention
from nos_tpu_torch.parallel import collectives as col
from nos_tpu_torch.parallel.ring_attention import (ring_attention_shards,
                                                   ulysses_attention_shards)
from nos_tpu_torch.parallel.sharding import (MeshTree, batch_sharding, param_shardings,
                                             shard_tensor, unshard_tensor)


@dataclass(frozen=True)
class GPTConfig:
    vocab: int = 32000
    hidden: int = 512
    layers: int = 4
    heads: int = 8
    kv_heads: Optional[int] = None  # < heads => grouped-query attention
    max_seq: int = 2048
    mlp_ratio: int = 4
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    attention: str = "flash"  # "flash" | "ring" | "ulysses" | "reference"
    # One matmul over concatenated QKV (and gate/up) weights: same math,
    # same param tree.
    fuse_projections: bool = False
    remat_blocks: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def n_kv(self) -> int:
        nkv = self.kv_heads or self.heads
        if self.heads % nkv != 0:
            raise ValueError(f"heads {self.heads} not divisible by kv_heads {nkv}")
        return nkv

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_gpt(cfg: GPTConfig, generator: Optional[torch.Generator] = None,
             device=None) -> Dict:
    """Random weights with the reference's shapes and init scales
    (gpt.py:67-95): normal * 0.02 for the embedding, normal *
    fan_in**-0.5 for every projection, ones for the norm scales. Drawn on
    the CPU from `generator` (not JAX's RNG, so not the reference's
    numbers), then moved to `device` (None: CUDA) in `cfg.dtype`."""
    device = resolve(device, "init_gpt")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dt = cfg.torch_dtype
    h = cfg.hidden

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32) * scale
        return w.to(device=device, dtype=dt)

    def dense(shape):
        return normal(shape, (1.0 / shape[0]) ** 0.5)

    def ones():
        return torch.ones((h,), dtype=dt, device=device)

    kv_dim = cfg.n_kv * cfg.head_dim
    params: Dict = {
        "tok_emb": normal((cfg.vocab, h), 0.02),
        "layers": {},
        "ln_f": {"scale": ones()},
        "lm_head": dense((h, cfg.vocab)),
    }
    for i in range(cfg.layers):
        params["layers"][str(i)] = {
            "ln1": {"scale": ones()},
            "wq": dense((h, h)),
            "wk": dense((h, kv_dim)),
            "wv": dense((h, kv_dim)),
            "wo": dense((h, h)),
            "ln2": {"scale": ones()},
            "w_up": dense((h, h * cfg.mlp_ratio)),
            "w_gate": dense((h, h * cfg.mlp_ratio)),
            "w_down": dense((h * cfg.mlp_ratio, h)),
        }
    return params


def _rmsnorm(x, p):
    x32 = x.float()
    out = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (out * p["scale"].float()).to(x.dtype)


_ROPE_FREQS: Dict[Tuple[torch.device, int, float], torch.Tensor] = {}


def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """theta ** -(i / half) for i < half, f32, computed on `device` on first
    use and kept (per device, width and theta): the same bits every call,
    and no host copy on the decode path, which a CUDA graph captures."""
    key = (device, half, float(theta))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
        freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)
        _ROPE_FREQS[key] = freqs
    return freqs


def _rope(x, positions, theta: float):
    """x: [B, H, T, D]; rotate half-pairs by position-dependent angles."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, x.device)
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, None, :, :]  # [B,1,T,half]
    sin = torch.sin(angles)[:, None, :, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def tp_local_config(cfg: GPTConfig, tp: int) -> GPTConfig:
    """The per-device view of a tensor-parallel decode config: heads/tp
    query heads, n_kv/tp KV heads, hidden/tp feature columns, head_dim
    unchanged. tp=1 returns `cfg` itself."""
    if tp <= 1:
        return cfg
    if cfg.heads % tp or cfg.n_kv % tp or cfg.hidden % tp:
        raise ValueError(
            f"tp={tp} must divide heads={cfg.heads}, kv_heads={cfg.n_kv}, "
            f"hidden={cfg.hidden}"
        )
    return dataclasses.replace(
        cfg,
        hidden=cfg.hidden // tp,
        heads=cfg.heads // tp,
        kv_heads=cfg.n_kv // tp,
    )


def project_qkv(x, p, cfg: GPTConfig, positions, repeat_kv: bool = True):
    """QKV projections with RoPE: x [B, T, h] -> q [B, nh, T, hd], k/v
    [B, nkv, T, hd]. With `repeat_kv`, grouped KV heads are repeated up to
    the query head count; cached decode passes False and attends grouped."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.heads, cfg.n_kv, cfg.head_dim

    def split_heads(y, n):
        return y.reshape(b, t, n, hd).transpose(1, 2)

    if cfg.fuse_projections:
        wqkv = torch.cat([p["wq"], p["wk"], p["wv"]], dim=1)
        q_flat, k_flat, v_flat = torch.split(x @ wqkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
        q = _rope(split_heads(q_flat, nh), positions, cfg.rope_theta)
        k = _rope(split_heads(k_flat, nkv), positions, cfg.rope_theta)
        v = split_heads(v_flat, nkv)
    else:
        q = _rope(split_heads(x @ p["wq"], nh), positions, cfg.rope_theta)
        k = _rope(split_heads(x @ p["wk"], nkv), positions, cfg.rope_theta)
        v = split_heads(x @ p["wv"], nkv)
    if repeat_kv and nkv != nh:
        k = torch.repeat_interleave(k, nh // nkv, dim=1)
        v = torch.repeat_interleave(v, nh // nkv, dim=1)
    return q, k, v


def _attention(x, p, cfg: GPTConfig, positions):
    b, t, h = x.shape
    q, k, v = project_qkv(x, p, cfg, positions)
    o = flash_attention(q, k, v, causal=True)
    return o.transpose(1, 2).reshape(b, t, h) @ p["wo"]


def _mlp(y, p, cfg: GPTConfig):
    """The gated MLP on normed `y` (one matmul over gate|up when fused)."""
    if cfg.fuse_projections:
        g, u = torch.chunk(y @ torch.cat([p["w_gate"], p["w_up"]], dim=1), 2, dim=-1)
        return (F.silu(g) * u) @ p["w_down"]
    return (F.silu(y @ p["w_gate"]) * (y @ p["w_up"])) @ p["w_down"]


def _block(x, p, cfg: GPTConfig, positions):
    x = x + _attention(_rmsnorm(x, p["ln1"]), p, cfg, positions)
    return x + _mlp(_rmsnorm(x, p["ln2"]), p, cfg)


def gpt_hidden(params, tokens, cfg: GPTConfig, mesh=None):
    """tokens [B, T] int -> final hidden states [B, T, H] (pre-head). With
    `remat_blocks` each block runs under activation checkpointing: the
    backward recomputes its activations instead of storing them. With a
    mesh: the global hidden states on the first position's device."""
    if mesh is not None:
        params, toks = _on_mesh(params, tokens, mesh)
        return unshard_tensor(_mesh_hidden(params, toks, cfg, mesh), mesh,
                              _batch_spec(mesh) + (None,))
    b, t = tokens.shape
    x = params["tok_emb"][tokens.long()]
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device).expand(b, t)
    for i in range(cfg.layers):
        p = params["layers"][str(i)]
        if cfg.remat_blocks:
            x = checkpoint(_block, x, p, cfg, positions, use_reentrant=False)
        else:
            x = _block(x, p, cfg, positions)
    return _rmsnorm(x, params["ln_f"])


def gpt_forward(params, tokens, cfg: GPTConfig, mesh=None):
    """tokens [B, T] int -> logits [B, T, vocab] f32 (with a mesh, global,
    on the first position's device)."""
    if mesh is not None:
        params, toks = _on_mesh(params, tokens, mesh)
        hs = _mesh_hidden(params, toks, cfg, mesh)
        logits: List[torch.Tensor] = [None] * len(hs)  # type: ignore[list-item]
        for group in mesh.groups("tp"):
            xs, heads = _head_shards(params, hs, group)
            full = _logits(xs, heads)
            for p in group:
                logits[p] = full
        return unshard_tensor(logits, mesh, _batch_spec(mesh) + (None,))
    return (gpt_hidden(params, tokens, cfg, mesh) @ params["lm_head"]).float()


def _chunk_nll(x_c, tgt_c, mask_c, lm_head):
    """Summed masked next-token NLL of one chunk: x_c [B, C, H], tgt_c
    [B, C], mask_c [C]; f32 logsumexp."""
    return _nll((x_c @ lm_head).float(), tgt_c, mask_c)


def _nll(logits, tgt_c, mask_c):
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tgt_c[..., None])[..., 0]
    return ((lse - tgt) * mask_c[None, :]).sum()


def gpt_loss(params, tokens, cfg: GPTConfig, mesh=None, loss_chunk: int = 256):
    """Next-token cross-entropy (mean over B x (T-1)) with the vocabulary
    projection chunked over the sequence: the reference's math (pad to a
    chunk multiple, mask, f32 logsumexp, a running f32 sum), as a loop over
    checkpointed chunks where JAX scans a `jax.checkpoint`ed body, so the
    backward recomputes one chunk's [B, C, vocab] logits at a time. With a
    mesh, each (dp, sp) block sums its own positions' NLL (its last
    position's target comes from the next sp shard) and the loss is their
    sum over the global count, on the first position's device."""
    if mesh is not None:
        params, toks = _on_mesh(params, tokens, mesh)
        return _mesh_loss(params, toks, cfg, mesh, loss_chunk)
    b, t = tokens.shape
    x = gpt_hidden(params, tokens, cfg, mesh)
    xs = x[:, :-1, :]
    targets = tokens[:, 1:].long()
    n = t - 1
    chunk = max(1, min(loss_chunk, n))
    pad = (-n) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
    mask = (torch.arange(n + pad, device=tokens.device) < n).float()
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for c in range(0, n + pad, chunk):
        total = total + checkpoint(_chunk_nll, xs[:, c:c + chunk], targets[:, c:c + chunk],
                                   mask[c:c + chunk], params["lm_head"], use_reentrant=False)
    return total / (b * n)


# -- the mesh path ----------------------------------------------------------------
_COLUMN = ("wq", "wk", "wv", "w_up", "w_gate")
_ROW = ("wo", "w_down")


def _batch_spec(mesh) -> Tuple:
    return batch_sharding(mesh, "dp", "sp")


def _on_mesh(params, tokens, mesh):
    """(MeshTree, per-position token blocks): a plain param tree is placed
    by `transformer_param_rules`, a global token tensor split as P(dp, sp);
    a list of blocks (`prefetch_to_mesh`) is taken as it is."""
    if not isinstance(params, MeshTree):
        params = param_shardings(params, mesh)
    if not isinstance(tokens, (list, tuple)):
        tokens = shard_tensor(tokens, mesh, _batch_spec(mesh))
    return params, list(tokens)


def _over(groups, xs: List, fn) -> List:
    """fn applied to each group's list of `xs`, the results put back by
    position."""
    out = [None] * len(xs)
    for group in groups:
        for p, y in zip(group, fn([xs[p] for p in group])):
            out[p] = y
    return out


def _sharded_on(spec, axis: str) -> bool:
    return any(axis == e or (isinstance(e, tuple) and axis in e) for e in spec)


_SEQUENCE_PARALLEL = {"ring": ring_attention_shards, "ulysses": ulysses_attention_shards}


def _mesh_attention(q, k, v, mesh, attention: str):
    """Causal attention at every position: over each sp group by ring or
    Ulysses, else through the flash kernel (with sp, over the gathered
    sequence, each position keeping its own rows)."""
    if mesh.shape.get("sp", 1) == 1:
        return [flash_attention(a, b, c, causal=True) for a, b, c in zip(q, k, v)]

    def full_sequence(qs, ks, vs, causal):
        t = qs[0].shape[2]
        qs, ks, vs = (col.all_gather(list(x), axis=2) for x in (qs, ks, vs))
        return [flash_attention(a, b, c, causal=causal).narrow(2, i * t, t)
                for i, (a, b, c) in enumerate(zip(qs, ks, vs))]

    fn = _SEQUENCE_PARALLEL.get(attention, full_sequence)
    return _over(mesh.groups("sp"), list(zip(q, k, v)),
                 lambda qkv: fn(*map(list, zip(*qkv)), causal=True))


def _mesh_block(x, lp, cfg: GPTConfig, positions, mesh, attention: str):
    """One block at every position: x[p] [B/dp, T/sp, H] replicated over
    tp, lp[p] position p's layer params; `cfg` is the tp-local view."""
    tp_groups = mesh.groups("tp")
    n = len(x)
    h = [_rmsnorm(x[p], lp[p]["ln1"]) for p in range(n)]
    qkv = [project_qkv(h[p], lp[p], cfg, positions[p]) for p in range(n)]
    o = _mesh_attention(*map(list, zip(*qkv)), mesh, attention)
    part = [o[p].transpose(1, 2).reshape(o[p].shape[0], o[p].shape[2], -1) @ lp[p]["wo"]
            for p in range(n)]
    y = _over(tp_groups, part, col.all_reduce_sum)
    x = [x[p] + y[p] for p in range(n)]
    part = [_mlp(_rmsnorm(x[p], lp[p]["ln2"]), lp[p], cfg) for p in range(n)]
    y = _over(tp_groups, part, col.all_reduce_sum)
    return [x[p] + y[p] for p in range(n)]


def _mesh_hidden(params: MeshTree, toks: List[torch.Tensor], cfg: GPTConfig,
                 mesh) -> List[torch.Tensor]:
    """Final hidden states at every position, [B/dp, T/sp, H] each."""
    tp = mesh.shape.get("tp", 1)
    local = tp_local_config(cfg, tp)
    if tp > 1:
        for name in _COLUMN + _ROW:
            want = (None, "tp") if name in _COLUMN else ("tp", None)
            got = params.specs["layers"]["0"][name]
            if got != want:
                raise ValueError(f"tp={tp} needs {name} sharded as {want}, got {got}")
    shards = params.shards
    x = [s["tok_emb"][t.long()] for s, t in zip(shards, toks)]
    if tp > 1 and _sharded_on(params.specs["tok_emb"], "tp"):
        x = _over(mesh.groups("tp"), x, lambda xs: col.all_gather(xs, axis=-1))
    positions = []
    for p, t in enumerate(toks):
        b, t_l = t.shape
        start = mesh.coords(p).get("sp", 0) * t_l
        positions.append((start + torch.arange(t_l, dtype=torch.int32, device=t.device))
                         .expand(b, t_l))
    for i in range(cfg.layers):
        lp = [s["layers"][str(i)] for s in shards]
        if cfg.remat_blocks:
            x = checkpoint(_mesh_block, x, lp, local, positions, mesh, cfg.attention,
                           use_reentrant=False)
        else:
            x = _mesh_block(x, lp, local, positions, mesh, cfg.attention)
    return [_rmsnorm(x[p], s["ln_f"]) for p, s in enumerate(shards)]


def _head_shards(params: MeshTree, hs, group):
    """The hidden states and lm_head blocks one tp group's logits take:
    every shard's when the head is vocab-sharded, else the first's."""
    if len(group) > 1 and _sharded_on(params.specs["lm_head"], "tp"):
        return [hs[p] for p in group], [params.shards[p]["lm_head"] for p in group]
    return [hs[group[0]]], [params.shards[group[0]]["lm_head"]]


def _logits(xs, heads):
    """The vocab shards' logits joined on the first shard's device, f32."""
    dev = xs[0].device
    return torch.cat([(x @ h).to(dev) for x, h in zip(xs, heads)], dim=-1).float()


def _chunk_nll_sharded(tgt_c, mask_c, n, *tensors):
    return _nll(_logits(tensors[:n], tensors[n:]), tgt_c, mask_c)


def _mesh_loss(params: MeshTree, toks, cfg: GPTConfig, mesh, loss_chunk: int):
    hs = _mesh_hidden(params, toks, cfg, mesh)
    sp = mesh.shape.get("sp", 1)
    nxt = _over(mesh.groups("sp"), toks, lambda xs: col.ring_pass(xs, shift=-1))
    global_b = toks[0].shape[0] * mesh.shape.get("dp", 1)
    global_t = toks[0].shape[1] * sp
    parts = []
    for group in mesh.groups("tp"):
        p0 = group[0]
        tok = toks[p0]
        last = mesh.coords(p0).get("sp", 0) == sp - 1
        n = tok.shape[1] - 1 if last else tok.shape[1]
        if n == 0:
            continue
        targets = torch.cat([tok[:, 1:], nxt[p0][:, :1].to(tok.device)], dim=1)[:, :n].long()
        xs, heads = _head_shards(params, hs, group)
        xs = [x[:, :n] for x in xs]
        chunk = max(1, min(loss_chunk, n))
        pad = (-n) % chunk
        if pad:
            xs = [F.pad(x, (0, 0, 0, pad)) for x in xs]
            targets = F.pad(targets, (0, pad))
        mask = (torch.arange(n + pad, device=tok.device) < n).float()
        total = torch.zeros((), dtype=torch.float32, device=tok.device)
        for c in range(0, n + pad, chunk):
            total = total + checkpoint(
                _chunk_nll_sharded, targets[:, c:c + chunk], mask[c:c + chunk], len(xs),
                *[x[:, c:c + chunk] for x in xs], *heads, use_reentrant=False)
        parts.append(total)
    total = parts[0].to(mesh.devices[0])
    for part in parts[1:]:  # in position order
        total = total + part.to(total.device)
    return total / (global_b * (global_t - 1))
