"""Decoder-only transformer LM: configuration, initialization and the block
math the serving programs share.

Port of `nos_tpu/models/gpt.py`: `GPTConfig` (:24), `_rmsnorm` (:98),
`_rope` (:104), `tp_local_config` (:117), `project_qkv` (:143) and
`init_gpt` (:72). Parameters are a plain nested dict of tensors with the
reference's keys and shapes, so `models/params.py` can carry a JAX param
tree across unchanged. The training forward (flash / ring attention) is a
later slice of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from nos_tpu_torch.device import resolve


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


def _rope(x, positions, theta: float):
    """x: [B, H, T, D]; rotate half-pairs by position-dependent angles."""
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
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
