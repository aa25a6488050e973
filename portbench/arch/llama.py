"""The dense Llama layout (LlamaForCausalLM) as the benchmark serves it
through the port: the configuration's `gpt` group (GPTConfig's keys) read
in one place.

An architecture module `arch/<arch>.py`, found by the `arch` a
configuration file names, gives the serve driver and the work count what
they need of a model:

- `make_params(config, seed, device)`: the weights, made on the card from
  the run's seed. One `torch.Generator` on the device, one `randn` call
  per kind of matrix for all layers at once, in the dtype the model is
  served in, laid out as the port's param dict (`tok_emb`,
  `layers.<i>.{ln1, wq, wk, wv, wo, ln2, w_up, w_gate, w_down}`, `ln_f`,
  `lm_head`; norms as `{"scale": ...}`). Scales follow the port's
  `init_gpt`: normal x 0.02 for the embedding, normal x fan_in**-0.5 for
  every projection, ones for the norm scales. A tied head
  (`tie_word_embeddings`) is a copy of the embedding's transpose. The
  benchmark hands these same tensors to the engine and, once the window
  has closed, to the plain reference (`references/<arch>.py`).
- `engine_config(config)`: the port's model config for `DecodeServer`.
- `KERNEL_LIBRARIES`: the port's kernel libraries the serving path loads,
  built in the `kernels` part of set-up.
- `shape(config)`: the work of one token (`work.py` sums it over the
  window's requests): `vocab`, `dtype`, `linear_flops()`,
  `logits_flops()`, `attention_flops(lo, hi)`, `window_bytes(lo, hi)`,
  `decode_flops(limit)`, `decode_bytes(limit, block)`.

The counts below are a frozen copy of the arithmetic behind PERF.md's
kernel table and `decode_bytes` of chip_smoke.py. Every layer is dense
and attends over every key before it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

#: The libraries `drivers/serve.py` builds before the weights: the paged
#: decode and window kernels.
KERNEL_LIBRARIES = ("paged_attention",)


def make_params(config: Dict, seed: int, device) -> Dict:
    gpt = config["gpt"]
    dt = getattr(torch, gpt.get("dtype", "bfloat16"))
    vocab, h, layers = int(gpt["vocab"]), int(gpt["hidden"]), int(gpt["layers"])
    heads = int(gpt["heads"])
    kv = int(gpt.get("kv_heads") or heads) * (h // heads)
    f = h * int(gpt.get("mlp_ratio", 4))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))

    def normal(shape, scale):
        t = torch.randn(shape, generator=g, device=device, dtype=dt)
        return t.mul_(scale)

    tok_emb = normal((vocab, h), 0.02)
    wq, wo = normal((layers, h, h), h ** -0.5), normal((layers, h, h), h ** -0.5)
    wk, wv = normal((layers, h, kv), h ** -0.5), normal((layers, h, kv), h ** -0.5)
    w_up, w_gate = normal((layers, h, f), h ** -0.5), normal((layers, h, f), h ** -0.5)
    w_down = normal((layers, f, h), f ** -0.5)
    ones = torch.ones((h,), dtype=dt, device=device)
    if config.get("tie_word_embeddings", False):
        lm_head = tok_emb.t().contiguous()
    else:
        lm_head = normal((h, vocab), h ** -0.5)
    return {
        "tok_emb": tok_emb,
        "layers": {
            str(i): {"ln1": {"scale": ones}, "wq": wq[i], "wk": wk[i], "wv": wv[i],
                     "wo": wo[i], "ln2": {"scale": ones}, "w_up": w_up[i],
                     "w_gate": w_gate[i], "w_down": w_down[i]}
            for i in range(layers)
        },
        "ln_f": {"scale": ones},
        "lm_head": lm_head,
    }


def engine_config(config: Dict):
    """The port's `GPTConfig` from the `gpt` group."""
    from nos_tpu_torch.models.gpt import GPTConfig

    gpt = config["gpt"]
    return GPTConfig(**{k: gpt[k] for k in ("vocab", "hidden", "layers", "heads", "kv_heads",
                                           "max_seq", "mlp_ratio", "rope_theta", "dtype")})


def shape(config: Dict) -> "Shape":
    return Shape.from_gpt(config["gpt"])


@dataclass(frozen=True)
class Shape:
    vocab: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    itemsize: int = 2
    dtype: str = "bfloat16"

    @classmethod
    def from_gpt(cls, gpt: Dict) -> "Shape":
        """From a configuration file's `gpt` group (GPTConfig's keys)."""
        hidden, heads = int(gpt["hidden"]), int(gpt["heads"])
        dtype = gpt.get("dtype", "bfloat16")
        itemsize = {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]
        return cls(vocab=int(gpt["vocab"]), hidden=hidden, layers=int(gpt["layers"]),
                   heads=heads, kv_heads=int(gpt.get("kv_heads") or heads),
                   head_dim=hidden // heads, ffn=hidden * int(gpt.get("mlp_ratio", 4)),
                   itemsize=itemsize, dtype=dtype)

    @property
    def kv_bytes_per_token(self) -> int:
        """K and V of one token over every layer."""
        return self.layers * 2 * self.kv_heads * self.head_dim * self.itemsize

    def linear_flops(self) -> float:
        """One token through every layer's projections and gated MLP."""
        q = self.heads * self.head_dim
        kv = self.kv_heads * self.head_dim
        per_layer = 2 * (self.hidden * q + 2 * self.hidden * kv + q * self.hidden
                         + 3 * self.hidden * self.ffn)
        return float(self.layers * per_layer)

    def logits_flops(self) -> float:
        return float(2 * self.hidden * self.vocab)

    def attention_flops(self, lo: int, hi: int) -> float:
        """Causal attention of the query tokens at positions lo .. hi-1, each
        over the keys 0 .. p: QK^T and PV, every layer."""
        return float(4 * self.layers * self.heads * self.head_dim * _pos_sum(lo, hi))

    def window_bytes(self, lo: int, hi: int) -> float:
        """The window kernel's least traffic for queries lo .. hi-1: every key
        and value 0 .. hi-1 read once, q read and the output written once."""
        per_layer = (hi * 2 * self.kv_heads * self.head_dim
                     + (hi - lo) * 2 * self.heads * self.head_dim)
        return float(self.layers * per_layer * self.itemsize)

    def decode_flops(self, limit: int) -> float:
        """One decode step's attention at `limit` keys: QK^T and PV, every
        layer."""
        return 4.0 * self.layers * self.heads * self.head_dim * limit

    def decode_bytes(self, limit: int, block: int) -> float:
        """chip_smoke.py's `decode_bytes` for one lane at `limit` keys, every
        layer: the K and V pages under the limit, q and the output once, the
        table entries and the limit."""
        pages = -(-int(limit) // block)
        per_layer = (pages * self.kv_heads * block * self.head_dim * 2 * self.itemsize
                     + 2 * self.heads * self.head_dim * self.itemsize + 4 * (pages + 1))
        return float(self.layers * per_layer)


def _pos_sum(lo: int, hi: int) -> int:
    """sum of (p + 1) for p in [lo, hi)."""
    return (hi * (hi + 1) - lo * (lo + 1)) // 2


#: The counts as functions of a shape.
linear_flops, logits_flops = Shape.linear_flops, Shape.logits_flops
attention_flops, window_bytes, decode_bytes = (Shape.attention_flops, Shape.window_bytes,
                                               Shape.decode_bytes)
