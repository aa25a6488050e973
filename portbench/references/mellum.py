"""The plain reference of the Mellum 2 layout: the decoder's forward pass in
float32, plain PyTorch, no kernel, no cache, no batching. It imports
nothing of the program under test, and reads the configuration file's
published keys (`hidden_size`, `layer_types`, `rope_parameters`, ...),
not the port's config.

The layout, as the published config describes it: token embedding; per
layer, pre-norm RMSNorm, then x += Wo . attn(RoPE(Wq n1(x)), RoPE(Wk
n1(x)), Wv n1(x)) with grouped KV heads (`num_key_value_heads`) of
`head_dim`, the q width heads x head_dim, not the hidden size; a
`sliding_attention` layer's query at p attends the keys p - sliding_window
< j <= p, a `full_attention` layer's every j <= p. RoPE by kind
(`rope_parameters`): rotate-half pairs, "default" theta ** -(i / half),
"yarn" transformers' `_compute_yarn_parameters` (the correction range of
beta_fast and beta_slow at original_max_position_embeddings, truncated;
inv_freq blended between interpolated and extrapolated; cos and sin times
`attention_factor`), angles in float64. Then x += the expert layer on
n2(x): router logits, softmax over all `num_experts`, the
`num_experts_per_tok` largest with ties to the lowest index, renormalized
over them (`norm_topk_prob`), each chosen expert's SwiGLU (silu(z Wg) * (z
Wu)) Wd of width `moe_intermediate_size` weighted and summed (a layer
that `mlp_layer_types` names "dense" has the gated MLP instead). A final
RMSNorm and the untied head. Matrix products run in float32 with TF32 off.

`logits_at(params, config, tokens, first)` returns the logits of rows
first .. T-1 of one sequence. It goes layer by layer, each layer's weights
widened to float32 on the fly (the peak is one layer's, 1.6 GB at
Mellum2's widths), computes each expert over the rows routed to it only,
and attention in blocks of `QUERY_BLOCK` query rows over the keys they
can see, so that 8 requests of 13k tokens fit beside the weights.
`quant`, when given, is applied to both operands of every matrix product
(activations per row, weights per output column; K and V per token):
`control.py` passes a lower-precision rounding there, and the benchmark
never does."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

#: Query rows of one attention block.
QUERY_BLOCK = 1024


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale.float()


def inv_freq(rope: Dict, dim: int, device) -> torch.Tensor:
    """The kind's rotation frequencies [dim / 2], float64."""
    base = float(rope["rope_theta"])
    half = dim // 2
    extrap = base ** -(torch.arange(half, dtype=torch.float64, device=device) / half)
    if rope.get("rope_type", "default") == "default":
        return extrap
    if rope["rope_type"] != "yarn":
        raise ValueError(f"rope_type {rope['rope_type']!r} is not in this reference")
    factor = float(rope["factor"])
    original = float(rope["original_max_position_embeddings"])

    def correction_dim(rotations: float) -> float:
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(float(rope["beta_fast"]))), 0)
    high = min(math.ceil(correction_dim(float(rope["beta_slow"]))), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float64, device=device) - low) / (high - low))
    extrap_share = 1.0 - ramp.clamp(0.0, 1.0)
    return extrap / factor * (1.0 - extrap_share) + extrap * extrap_share


def _rope(x: torch.Tensor, rope: Dict) -> torch.Tensor:
    """x [H, T, D], rotate-half pairs, positions 0 .. T-1."""
    t, d = x.shape[1], x.shape[2]
    half = d // 2
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv_freq(
        rope, d, x.device)[None, :]
    factor = rope.get("attention_factor")
    if factor is None:  # transformers' default: none, or YaRN's 0.1 ln(factor) + 1
        factor = 0.1 * math.log(rope["factor"]) + 1 if rope.get("rope_type") == "yarn" else 1.0
    cos, sin = (torch.cos(ang) * factor).float(), (torch.sin(ang) * factor).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[Callable]) -> torch.Tensor:
    if quant is not None:
        a, w = quant(a, -1), quant(w, 0)
    return a @ w


def _attention(q, k, v, window: int) -> torch.Tensor:
    """q [H, T, D] against k, v [H, T, D] (KV heads already repeated),
    causal, and with a window > 0 over the keys p - window < j <= p only;
    in blocks of query rows."""
    nh, t, hd = q.shape
    out = torch.empty_like(q)
    for q0 in range(0, t, QUERY_BLOCK):
        q1 = min(t, q0 + QUERY_BLOCK)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        cols = torch.arange(k0, q1, device=q.device)[None, :]
        see = cols <= rows
        if window > 0:
            see &= cols > rows - window
        scores = (q[:, q0:q1] @ k[:, k0:q1].transpose(1, 2)) * hd ** -0.5
        scores = scores.masked_fill_(~see, float("-inf"))
        out[:, q0:q1] = torch.softmax(scores, dim=-1) @ v[:, k0:q1]
    return out


def _experts(z, p, config: Dict, quant) -> torch.Tensor:
    """The expert layer on normed z [T, h]: each expert over its rows only."""
    n_exp, top = int(config["num_experts"]), int(config["num_experts_per_tok"])
    probs = torch.softmax(_mm(z, p["router"], quant), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top], ids[:, :top]
    if config.get("norm_topk_prob", True):
        w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(z)
    for e in range(n_exp):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        ze = z[tok]
        gate = _mm(ze, p["expert_gate"][e].float(), quant)
        mid = torch.nn.functional.silu(gate) * _mm(ze, p["expert_up"][e].float(), quant)
        out.index_add_(0, tok, w[tok, slot, None] * _mm(mid, p["expert_down"][e].float(), quant))
    return out


@torch.no_grad()
def logits_at(params: Dict, config: Dict, tokens, first: int,
              quant: Optional[Callable] = None) -> torch.Tensor:
    """Logits [T - first, vocab] f32 of `tokens` (one sequence) at rows
    first .. T-1."""
    _no_tf32()
    eps = float(config.get("rms_norm_eps", 1e-6))
    nh, nkv = int(config["num_attention_heads"]), int(config["num_key_value_heads"])
    hd = int(config.get("head_dim") or int(config["hidden_size"]) // nh)
    kinds = config["layer_types"]
    ropes = config["rope_parameters"]
    window = int(config["sliding_window"])
    emb = params["tok_emb"]
    ids = torch.as_tensor(tokens, dtype=torch.long, device=emb.device)
    t = ids.shape[0]
    x = emb[ids].float()
    for i in range(int(config["num_hidden_layers"])):
        layer = params["layers"][str(i)]
        p = {k: (v["scale"] if isinstance(v, dict) else v).float()
             for k, v in layer.items() if not k.startswith("expert_")}
        p.update({k: v for k, v in layer.items() if k.startswith("expert_")})
        kind = kinds[i]
        y = _rmsnorm(x, p["ln1"], eps)
        q = _mm(y, p["wq"], quant).reshape(t, nh, hd).transpose(0, 1)
        k = _mm(y, p["wk"], quant).reshape(t, nkv, hd).transpose(0, 1)
        v = _mm(y, p["wv"], quant).reshape(t, nkv, hd).transpose(0, 1)
        q, k = _rope(q, ropes[kind]), _rope(k, ropes[kind])
        if quant is not None:
            k, v = quant(k, -1), quant(v, -1)
        k = k.repeat_interleave(nh // nkv, dim=0)
        v = v.repeat_interleave(nh // nkv, dim=0)
        o = _attention(q, k, v, window if kind == "sliding_attention" else 0)
        x = x + _mm(o.transpose(0, 1).reshape(t, nh * hd), p["wo"], quant)
        del q, k, v, o
        z = _rmsnorm(x, p["ln2"], eps)
        if config["mlp_layer_types"][i] == "sparse":
            x = x + _experts(z, p, config, quant)
        else:
            mid = torch.nn.functional.silu(_mm(z, p["w_gate"], quant)) * _mm(z, p["w_up"], quant)
            x = x + _mm(mid, p["w_down"], quant)
        del p, y, z
    x = _rmsnorm(x[first:], params["ln_f"]["scale"], eps)
    return _mm(x, params["lm_head"].float(), quant)
