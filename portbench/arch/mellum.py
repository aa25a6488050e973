"""The Mellum 2 layout (the catalog's Mellum2-12B-A2.5B-Instruct) as the
benchmark serves it through the port: every layer's MLP an expert layer
(`num_experts` SwiGLU experts of `moe_intermediate_size`, the top
`num_experts_per_tok` by a softmax router), GQA heads of `head_dim` whose q
width is not the hidden size, and `layer_types` of sliding layers (a
window of `sliding_window` keys, default RoPE) and full ones (YaRN), as
`rope_parameters` gives them. The configuration file holds the published
keys; this file reads them in one place.

The interface `arch/llama.py` describes:

- `make_params(config, seed, device)`: the weights on the card from the
  run's seed, one `randn` call per kind of matrix for all layers at once,
  in bf16, in the port's layout: `tok_emb`, `layers.<i>.{ln1, wq, wk, wv,
  wo, ln2, router, expert_gate, expert_up, expert_down}` (expert weights
  [E, h, f], [E, h, f], [E, f, h]), `ln_f`, `lm_head` (untied). Scales
  follow the port's `init_gpt`: normal x 0.02 for the embedding, normal x
  fan_in**-0.5 for every projection, the router and each expert's
  matrices, ones for the norm scales.
- `engine_config(config)`: the port's GPTConfig.
- `KERNEL_LIBRARIES`: the paged attention kernels and the expert chain.
- `shape(config)`: the work of one token, each layer counting its own
  keys (a sliding layer min(p + 1, window) at position p, and only its
  in-window keys and pages in the bytes) and 8 of 64 experts plus the
  router; and `expert_flops(rows)` / `expert_bytes(hit, rows)`, the expert
  layers' least work for `rows` routed (token, expert) rows and `hit`
  (layer, call, expert) triples with a row: each hit expert's weights read
  once, each token's activations read once and its output written once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

#: The libraries `drivers/serve.py` builds before the weights.
KERNEL_LIBRARIES = ("paged_attention", "moe_experts")


def make_params(config: Dict, seed: int, device) -> Dict:
    s = shape(config)
    dt = getattr(torch, s.dtype)
    h, L, e, f = s.hidden, s.layers, s.experts, s.expert_ffn
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))

    def normal(shape, scale):
        t = torch.randn(shape, generator=g, device=device, dtype=dt)
        return t.mul_(scale)

    tok_emb = normal((s.vocab, h), 0.02)
    wq, wo = normal((L, h, q), h ** -0.5), normal((L, q, h), q ** -0.5)
    wk, wv = normal((L, h, kv), h ** -0.5), normal((L, h, kv), h ** -0.5)
    router = normal((L, h, e), h ** -0.5)
    gate, up = normal((L, e, h, f), h ** -0.5), normal((L, e, h, f), h ** -0.5)
    down = normal((L, e, f, h), f ** -0.5)
    ones = torch.ones((h,), dtype=dt, device=device)
    return {
        "tok_emb": tok_emb,
        "layers": {
            str(i): {"ln1": {"scale": ones}, "wq": wq[i], "wk": wk[i], "wv": wv[i],
                     "wo": wo[i], "ln2": {"scale": ones}, "router": router[i],
                     "expert_gate": gate[i], "expert_up": up[i], "expert_down": down[i]}
            for i in range(L)
        },
        "ln_f": {"scale": ones},
        "lm_head": normal((h, s.vocab), h ** -0.5),
    }


def engine_config(config: Dict):
    """The port's `GPTConfig` from the published keys. The port's layout
    has every layer sparse, every layer rotating at one theta, and YaRN
    on the full layers only; a config outside it is refused."""
    from nos_tpu_torch.models.gpt import GPTConfig, YaRN

    if any(k != "sparse" for k in config["mlp_layer_types"]):
        raise ValueError("every layer of this layout is sparse; a dense layer's width "
                         "(intermediate_size) is not an integer mlp_ratio of the hidden size")
    full, sliding = (config["rope_parameters"][k] for k in ("full_attention",
                                                            "sliding_attention"))
    if sliding.get("rope_type", "default") != "default" or \
            float(sliding["rope_theta"]) != float(full["rope_theta"]):
        raise ValueError("the sliding layers rotate by default RoPE at the full layers' theta")
    yarn = None
    if full.get("rope_type", "default") == "yarn":
        yarn = YaRN(factor=float(full["factor"]),
                    original_max_position=int(full["original_max_position_embeddings"]),
                    beta_fast=float(full.get("beta_fast", 32.0)),
                    beta_slow=float(full.get("beta_slow", 1.0)),
                    attention_factor=full.get("attention_factor"))
    elif full.get("rope_type", "default") != "default":
        raise ValueError(f"unknown RoPE type {full['rope_type']!r}")
    return GPTConfig(
        vocab=int(config["vocab_size"]), hidden=int(config["hidden_size"]),
        layers=int(config["num_hidden_layers"]), heads=int(config["num_attention_heads"]),
        kv_heads=int(config["num_key_value_heads"]),
        max_seq=int(config["max_position_embeddings"]), rope_theta=float(full["rope_theta"]),
        dtype=config.get("torch_dtype", "bfloat16"), head_size=int(config["head_dim"]),
        layer_types=tuple("sliding" if k == "sliding_attention" else "full"
                          for k in config["layer_types"]),
        sliding_window=int(config["sliding_window"]), rope_yarn=yarn,
        n_experts=int(config["num_experts"]), top_k=int(config["num_experts_per_tok"]),
        expert_ffn=int(config["moe_intermediate_size"]),
        norm_topk_prob=bool(config.get("norm_topk_prob", True)))


def shape(config: Dict) -> "Shape":
    dtype = config.get("torch_dtype", "bfloat16")
    return Shape(vocab=int(config["vocab_size"]), hidden=int(config["hidden_size"]),
                 heads=int(config["num_attention_heads"]),
                 kv_heads=int(config["num_key_value_heads"]), head_dim=int(config["head_dim"]),
                 kinds=tuple(config["layer_types"]), window=int(config["sliding_window"]),
                 experts=int(config["num_experts"]), top_k=int(config["num_experts_per_tok"]),
                 expert_ffn=int(config["moe_intermediate_size"]),
                 itemsize={"bfloat16": 2, "float16": 2, "float32": 4}[dtype], dtype=dtype)


def _pos_sum(lo: int, hi: int) -> int:
    """sum of (p + 1) for p in [lo, hi)."""
    return (hi * (hi + 1) - lo * (lo + 1)) // 2


def _clipped_sum(lo: int, hi: int, window: int) -> int:
    """sum of min(p + 1, window) for p in [lo, hi)."""
    edge = min(hi, max(lo, window))  # positions below it see fewer than `window` keys
    return _pos_sum(lo, edge) + window * (hi - edge)


@dataclass(frozen=True)
class Shape:
    vocab: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    kinds: Tuple[str, ...]
    window: int
    experts: int
    top_k: int
    expert_ffn: int
    itemsize: int = 2
    dtype: str = "bfloat16"

    @property
    def layers(self) -> int:
        return len(self.kinds)

    @property
    def sliding(self) -> int:
        return sum(k == "sliding_attention" for k in self.kinds)

    @property
    def full(self) -> int:
        return self.layers - self.sliding

    def linear_flops(self) -> float:
        """One token through every layer's projections, the router and its
        top_k experts."""
        q = self.heads * self.head_dim
        kv = self.kv_heads * self.head_dim
        per_layer = (2 * (self.hidden * q + 2 * self.hidden * kv + q * self.hidden
                          + self.hidden * self.experts)
                     + self.top_k * 6 * self.hidden * self.expert_ffn)
        return float(self.layers * per_layer)

    def logits_flops(self) -> float:
        return float(2 * self.hidden * self.vocab)

    def attention_flops(self, lo: int, hi: int) -> float:
        """Causal attention of the query tokens at positions lo .. hi-1: QK^T
        and PV over each layer's own keys (p + 1 in a full layer, min(p + 1,
        window) in a sliding one)."""
        keys = self.full * _pos_sum(lo, hi) + self.sliding * _clipped_sum(lo, hi, self.window)
        return float(4 * self.heads * self.head_dim * keys)

    def window_bytes(self, lo: int, hi: int) -> float:
        """The window kernel's least traffic for queries lo .. hi-1: each
        layer's keys and values that some query reads (a full layer 0 ..
        hi-1, a sliding one from lo + 1 - window), read once; q read and
        the output written once."""
        kv_row = 2 * self.kv_heads * self.head_dim
        io = (hi - lo) * 2 * self.heads * self.head_dim
        sliding_keys = hi - max(0, lo + 1 - self.window)
        total = self.full * (hi * kv_row + io) + self.sliding * (sliding_keys * kv_row + io)
        return float(total * self.itemsize)

    def decode_flops(self, limit: int) -> float:
        """One decode step's attention at `limit` keys, each layer over its
        own (a sliding layer min(limit, window))."""
        keys = self.full * limit + self.sliding * min(limit, self.window)
        return 4.0 * self.heads * self.head_dim * keys

    def decode_bytes(self, limit: int, block: int) -> float:
        """`arch/llama.py`'s decode bytes for one lane at `limit` keys, each
        layer over its own pages: a sliding layer's from the page holding
        limit - window."""
        def per_layer(pages: int) -> int:
            return (pages * self.kv_heads * block * self.head_dim * 2 * self.itemsize
                    + 2 * self.heads * self.head_dim * self.itemsize + 4 * (pages + 1))

        last = -(-int(limit) // block)
        first = max(0, int(limit) - self.window) // block
        return float(self.full * per_layer(last) + self.sliding * per_layer(last - first))

    def expert_flops(self, rows: int) -> float:
        """The expert GEMMs of `rows` (token, expert) rows: gate, up and
        down, 2 h f each."""
        return 6.0 * self.hidden * self.expert_ffn * rows

    def expert_bytes(self, hit: int, rows: int) -> float:
        """`hit` experts' three matrices read once, and each token's
        activations (rows / top_k of them) read once and written once."""
        weights = 3 * self.hidden * self.expert_ffn * self.itemsize
        return float(hit * weights + rows / self.top_k * 2 * self.hidden * self.itemsize)
