"""The bounded-divergence oracle of the int8 KV pool.

Port of `nos_tpu/runtime/divergence.py`: the pinned bounds
`MAX_ABS_LOGIT_DELTA` (:43) and `MIN_TOP1_AGREEMENT` (:48), copied as they
are, `DivergenceReport` (:51), `measure_divergence` (:96) and
`compare_output_streams` (:170).

The rest of the port is held to bit-exactness; the int8 pool is lossy by
design, so it is held to a measured, bounded divergence instead. The
oracle runs the paged programs (`paged_prefill_chunk`, then
`paged_decode_step`) on a native pool and an int8 pool over the same
traffic, TEACHER-FORCED: the native arm's greedy picks (lowest index on
exact ties) feed both arms, so each step compares the two arms' logits at
the same position over the same history. It reports the max and mean
per-token max|dlogit| and the greedy top-1 agreement, and the per-token
deltas in order, so a regression shows where divergence grows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from nos_tpu_torch.device import resolve

#: Pinned per-token max|dlogit| bound (the reference's, measured on its
#: tier-1 model shapes with headroom).
MAX_ABS_LOGIT_DELTA = 0.5

#: Pinned greedy top-1 agreement floor (the reference's).
MIN_TOP1_AGREEMENT = 0.98


@dataclass(frozen=True)
class DivergenceReport:
    """One oracle run: the quantized arm against the native arm over the
    same teacher-forced traffic."""

    tokens_compared: int
    max_abs_logit_delta: float
    mean_abs_logit_delta: float
    top1_agreement: float
    #: Per-token max|dlogit| in generation order (the prefill's last-token
    #: logits first, then each decode step).
    per_token_delta: List[float] = field(default_factory=list)

    def within(self, max_delta: float = MAX_ABS_LOGIT_DELTA,
               min_agreement: float = MIN_TOP1_AGREEMENT) -> bool:
        """True when this run sits inside the pinned bounds."""
        return (self.max_abs_logit_delta <= max_delta
                and self.top1_agreement >= min_agreement)

    def summary(self) -> str:
        return (
            f"divergence: n={self.tokens_compared} "
            f"max|dlogit|={self.max_abs_logit_delta:.4f} "
            f"mean|dlogit|={self.mean_abs_logit_delta:.4f} "
            f"top1_agree={self.top1_agreement:.4f}"
        )


def measure_divergence(params, cfg, prompt: Sequence[int], steps: int, block_size: int = 8,
                       total_blocks: Optional[int] = None, quant_dtype: str = "int8",
                       device=None) -> DivergenceReport:
    """One prompt through a native-pool arm and a `quant_dtype`-pool arm
    on `device` (None: CUDA; "cpu" runs the kernels' plain versions), the
    native arm's greedy tokens teacher-forced into both, their logits
    compared token by token. The programs alone: no engine, no scheduler,
    so the measurement holds the quantization error and nothing else."""
    from nos_tpu_torch.models import decode as D

    device = resolve(device, "measure_divergence")
    prompt = [int(t) for t in prompt]
    n = len(prompt)
    n_pages = (n + steps + block_size - 1) // block_size
    if total_blocks is None:
        total_blocks = 2 + n_pages
    table = torch.zeros((1, max(n_pages, 1)), dtype=torch.int32, device=device)
    table[0, :n_pages] = torch.arange(1, n_pages + 1, dtype=torch.int32)
    toks = torch.tensor([prompt], dtype=torch.int32, device=device)

    def prefill(kv_dtype):
        cache = D.init_paged_cache(cfg, total_blocks, block_size, kv_dtype=kv_dtype,
                                   device=device)
        logits, cache = D.paged_prefill_chunk(params, toks, cfg, cache, table[0], 0, n,
                                              block_size)
        return logits[n - 1][None, :], cache  # [1, vocab]

    lg_n, cache_n = prefill(None)
    lg_q, cache_q = prefill(quant_dtype)

    deltas: List[float] = []
    agree = total = 0
    mass = 0.0
    mask = torch.ones((1,), dtype=torch.bool, device=device)
    pos = torch.tensor([n], dtype=torch.int32, device=device)
    for step in range(steps + 1):
        diff = (lg_n - lg_q).abs()
        deltas.append(float(diff.max()))
        mass += float(diff.mean())
        pick_n, pick_q = D.greedy(lg_n), D.greedy(lg_q)
        agree += int(pick_n[0] == pick_q[0])
        total += 1
        if step == steps:
            break
        # Teacher-force the NATIVE pick into both arms.
        lg_n, cache_n = D.paged_decode_step(params, pick_n, cfg, cache_n, table, pos, mask,
                                            block_size)
        lg_q, cache_q = D.paged_decode_step(params, pick_n, cfg, cache_q, table, pos, mask,
                                            block_size)
        pos = pos + 1

    return DivergenceReport(
        tokens_compared=total,
        max_abs_logit_delta=max(deltas) if deltas else 0.0,
        mean_abs_logit_delta=(mass / total) if total else 0.0,
        top1_agreement=(agree / total) if total else 1.0,
        per_token_delta=deltas,
    )


def compare_output_streams(native: Sequence[int], quant: Sequence[int]) -> float:
    """Positionwise token agreement of two FREE-RUNNING output streams (an
    engine-level A/B, each arm sampling its own tokens). Divergence
    compounds after the first disagreement, so this is a blunter signal
    than the teacher-forced oracle."""
    if not native or len(native) != len(quant):
        return 0.0
    hits = sum(1 for a, b in zip(native, quant) if int(a) == int(b))
    return hits / len(native)
