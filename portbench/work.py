"""The work a served request needs, counted from the traffic alone.

`Work.add` sums, over the benchmark's own requests, the per-token counts
of the configuration's architecture (`arch/<arch>.py`, its `shape(config)`:
`linear_flops()`, `logits_flops()`, `attention_flops(lo, hi)`,
`window_bytes(lo, hi)`, `decode_flops(limit)`, `decode_bytes(limit,
block)`), and turns them into bounds on one H100 (the bound = max(bytes /
3.35 TB/s, FLOPs / 989 TFLOP/s)). Nothing here reads a counter of the
program, so the count is the same whatever implements the model. Peaks are
one NVIDIA H100 SXM's published dense rates.

Per request with prompt length P, of which the first `cached` tokens were
already held by an earlier request (the benchmark's own `PrefixTrie`), and
n served tokens:

- prefill: the tokens at positions cached .. P-1, each one pass through the
  linear layers and attention over its keys (`attention_flops(cached, P)`);
- one logits row for the first served token, sampled at position P-1;
- decode: n-1 steps at positions P .. P+n-2, each one pass through the
  linear layers, attention at the kernel's limit p+1, and one logits row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

#: One H100 SXM: dense bf16 tensor-core FLOP/s and HBM3 bytes/s (data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time one H100 can take: the larger of the two limits."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


@dataclass
class Work:
    """Totals over a set of requests."""
    model_flops: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prompt_tokens: int = 0
    cached_tokens: int = 0
    decode_attn_bound_s: float = 0.0
    window_attn_bound_s: float = 0.0

    def add(self, s, prompt_len: int, cached: int, n_out: int, block: int) -> None:
        """One request under the architecture's shape `s`: prompt of
        `prompt_len` tokens, `cached` of them held before it, `n_out` tokens
        served."""
        cached = min(int(cached), prompt_len - 1) if prompt_len else 0
        self.prompt_tokens += prompt_len
        self.cached_tokens += cached
        new = prompt_len - cached
        self.prefill_tokens += new
        self.model_flops += new * s.linear_flops() + s.attention_flops(cached, prompt_len)
        if new:
            self.window_attn_bound_s += bound_s(s.attention_flops(cached, prompt_len),
                                                s.window_bytes(cached, prompt_len))
        if n_out <= 0:
            return
        self.model_flops += s.logits_flops()
        steps = n_out - 1
        self.decode_tokens += steps
        lo, hi = prompt_len, prompt_len + steps
        self.model_flops += steps * (s.linear_flops() + s.logits_flops()) + s.attention_flops(lo, hi)
        for p in range(lo, hi):
            self.decode_attn_bound_s += bound_s(s.decode_flops(p + 1), s.decode_bytes(p + 1, block))


class PrefixTrie:
    """Token sequences already held by earlier requests, token by token."""

    def __init__(self):
        self._root: Dict[int, dict] = {}

    def match(self, tokens: Sequence[int]) -> int:
        """Length of the longest prefix of `tokens` already held."""
        node, n = self._root, 0
        for t in tokens:
            node = node.get(int(t))
            if node is None:
                break
            n += 1
        return n

    def insert(self, tokens: Sequence[int]) -> None:
        node = self._root
        for t in tokens:
            node = node.setdefault(int(t), {})
