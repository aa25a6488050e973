"""Decoder-only transformer LM: configuration, initialization, the block
math the serving programs share, and the training forward.

Port of `nos_tpu/models/gpt.py`: `GPTConfig` (:24), `_rmsnorm` (:98),
`_rope` (:104), `tp_local_config` (:117), `project_qkv` (:143),
`init_gpt` (:72), and the training forward `_attention` (:184), `_block`
(:197), `gpt_hidden` (:209), `gpt_forward` (:224) and the chunked
`gpt_loss` (:230), whose attention runs through the flash kernels
(`ops/flash_attention.py`). Parameters are a plain nested dict of tensors
with the reference's keys and shapes, so `models/params.py` can carry a
JAX param tree across unchanged. Sharded training over a mesh (ring and
Ulysses attention, sharded params) is a later slice (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nos_tpu_torch.device import resolve
from nos_tpu_torch.ops.flash_attention import flash_attention


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


def _block(x, p, cfg: GPTConfig, positions):
    x = x + _attention(_rmsnorm(x, p["ln1"]), p, cfg, positions)
    y = _rmsnorm(x, p["ln2"])
    if cfg.fuse_projections:
        g, u = torch.chunk(y @ torch.cat([p["w_gate"], p["w_up"]], dim=1), 2, dim=-1)
        y = (F.silu(g) * u) @ p["w_down"]
    else:
        y = (F.silu(y @ p["w_gate"]) * (y @ p["w_up"])) @ p["w_down"]
    return x + y


def gpt_hidden(params, tokens, cfg: GPTConfig, mesh=None):
    """tokens [B, T] int -> final hidden states [B, T, H] (pre-head). With
    `remat_blocks` each block runs under activation checkpointing: the
    backward recomputes its activations instead of storing them."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded training over a mesh (ring/ulysses attention, sharded "
            "params) is not ported yet: ROADMAP A9"
        )
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
    """tokens [B, T] int -> logits [B, T, vocab] f32."""
    return (gpt_hidden(params, tokens, cfg, mesh) @ params["lm_head"]).float()


def _chunk_nll(x_c, tgt_c, mask_c, lm_head):
    """Summed masked next-token NLL of one chunk: x_c [B, C, H], tgt_c
    [B, C], mask_c [C]; f32 logsumexp."""
    logits = (x_c @ lm_head).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tgt_c[..., None])[..., 0]
    return ((lse - tgt) * mask_c[None, :]).sum()


def gpt_loss(params, tokens, cfg: GPTConfig, mesh=None, loss_chunk: int = 256):
    """Next-token cross-entropy (mean over B x (T-1)) with the vocabulary
    projection chunked over the sequence: the reference's math (pad to a
    chunk multiple, mask, f32 logsumexp, a running f32 sum), as a loop over
    checkpointed chunks where JAX scans a `jax.checkpoint`ed body, so the
    backward recomputes one chunk's [B, C, vocab] logits at a time."""
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
