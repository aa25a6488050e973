"""The plain reference: the decoder's forward pass in float32, plain
PyTorch, no kernel, no cache, no batching. It imports nothing of the
program under test.

The layout is LlamaForCausalLM's, as the configuration files state it:
token embedding; per layer x += Wo . attn(RoPE(Wq n1(x)), RoPE(Wk n1(x)),
Wv n1(x)) with causal softmax over grouped KV heads, then x += W_down
(silu(W_gate n2(x)) * W_up n2(x)); a final RMSNorm (eps as the
configuration runs it: `rms_norm_eps_as_run` where the program departs
from the published `rms_norm_eps`) and the head. RoPE rotates the two halves
of each head (theta ** -(i / half)), angles taken in float64. Matrix
products run in float32 with TF32 off.

`logits_at(params, config, tokens, first)` returns the logits of rows
first .. T-1 of one sequence. It goes layer by layer, each layer's
weights widened to float32 on the fly, so the peak is one layer's
weights, the sequence's activations and one [heads, T, T] score block.
`quant`, when given, is applied to both operands of every matrix product
(activations per row, weights per output column; K and V per token):
`control.py` passes a lower-precision rounding there, and the benchmark
never does."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [H, T, D], rotate-half pairs, positions 0 .. T-1."""
    t, d = x.shape[1], x.shape[2]
    half = d // 2
    inv = theta ** -(torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[Callable]) -> torch.Tensor:
    if quant is not None:
        a, w = quant(a, -1), quant(w, 0)
    return a @ w


@torch.no_grad()
def logits_at(params: Dict, config: Dict, tokens, first: int,
              quant: Optional[Callable] = None) -> torch.Tensor:
    """Logits [T - first, vocab] f32 of `tokens` (one sequence) at rows
    first .. T-1."""
    _no_tf32()
    gpt = config["gpt"]
    eps = float(config.get("rms_norm_eps_as_run", config.get("rms_norm_eps", 1e-6)))
    theta = float(gpt["rope_theta"])
    h, nh = int(gpt["hidden"]), int(gpt["heads"])
    nkv = int(gpt.get("kv_heads") or nh)
    hd = h // nh
    emb = params["tok_emb"]
    dev = emb.device
    ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    t = ids.shape[0]
    x = emb[ids].float()
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    for i in range(int(gpt["layers"])):
        p = {k: (v["scale"] if isinstance(v, dict) else v).float()
             for k, v in params["layers"][str(i)].items()}
        y = _rmsnorm(x, p["ln1"], eps)
        q = _mm(y, p["wq"], quant).reshape(t, nh, hd).transpose(0, 1)
        k = _mm(y, p["wk"], quant).reshape(t, nkv, hd).transpose(0, 1)
        v = _mm(y, p["wv"], quant).reshape(t, nkv, hd).transpose(0, 1)
        q, k = _rope(q, theta), _rope(k, theta)
        if quant is not None:
            k, v = quant(k, -1), quant(v, -1)
        k = k.repeat_interleave(nh // nkv, dim=0)
        v = v.repeat_interleave(nh // nkv, dim=0)
        scores = (q @ k.transpose(1, 2)) * hd ** -0.5
        scores = scores.masked_fill_(~causal, float("-inf"))
        o = torch.softmax(scores, dim=-1) @ v
        del scores
        x = x + _mm(o.transpose(0, 1).reshape(t, h), p["wo"], quant)
        z = _rmsnorm(x, p["ln2"], eps)
        gate = _mm(z, p["w_gate"], quant)
        z = torch.nn.functional.silu(gate) * _mm(z, p["w_up"], quant)
        x = x + _mm(z, p["w_down"], quant)
        del p, y, q, k, v, o, z, gate
    x = _rmsnorm(x[first:], params["ln_f"]["scale"], eps)
    return _mm(x, params["lm_head"].float(), quant)

