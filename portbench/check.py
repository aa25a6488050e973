"""Whether the served tokens are right: the widest gap by which a served
token's logit lies below the plain reference's best.

Once the window has closed and the engine's state is freed, a sample of
the finished requests (the cell's `requests`), drawn from the seed and
always holding the longest request (prompt plus reply), is run once
through the configuration's reference (`references/<arch>.py`, its
`logits_at`) over each prompt and all its served tokens. At each position that chose a served token the
gap is the reference's best logit less the served token's; the run's
number is the widest gap over the sample. Greedy serving in the
configuration's bf16 leaves gaps only where the reference's top two lie
within the program's rounding; `limit` in the cell's `check` group was set
between that reading over a dozen seeds and the control's (`control.py`),
as PERF.md records.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def sample(records, seed: int, requests: int) -> List:
    """The finished requests to compare, every served token of each: the
    longest, then `requests - 1` others drawn from the seed, so the sample
    spans lanes and requests admitted all through the window."""
    done = [r for r in records if r.error is None and r.out is not None and r.n_out > 0]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (len(done[i].prompt) + done[i].n_out, -i))
    rng = np.random.default_rng([int(seed), 2])
    order = [longest] + [i for i in rng.permutation(len(done)).tolist() if i != longest]
    return [done[i] for i in order[:max(1, int(requests))]]


def served_gaps(logits_at: Callable, params: Dict, config: Dict, prompt, served,
                quant: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """For one request: the reference's logits (`logits_at`) at the
    positions that chose each served token (the prompt's last position,
    then each fed token), and how far each served token's logit lies below
    the reference's best. With `quant`, also the gaps of the tokens the
    quantized forward puts first (the control's reading), under the float32
    reference."""
    seq = list(prompt) + list(served[:-1])
    ref = logits_at(params, config, seq, len(prompt) - 1)
    idx = torch.as_tensor(list(served), dtype=torch.long, device=ref.device)
    best = ref.max(dim=-1).values
    out = {"served": best - ref.gather(1, idx[:, None])[:, 0]}
    if quant is not None:
        low = logits_at(params, config, seq, len(prompt) - 1, quant=quant)
        pick = low.argmax(dim=-1)
        out["control"] = best - ref.gather(1, pick[:, None])[:, 0]
    return out


def compare(logits_at: Callable, params, config, picked, quant=None) -> Dict[str, float]:
    """Widest gap over `picked` (and the control's, with `quant`), under the
    reference `logits_at`."""
    worst = {"served": 0.0, "control": 0.0}
    tokens = 0
    for r in picked:
        gaps = served_gaps(logits_at, params, config, r.prompt.tolist(), r.out.tolist(),
                           quant=quant)
        for key, g in gaps.items():
            worst[key] = max(worst[key], float(g.max().item()))
        tokens += r.n_out
    out = {"max_logit_gap": worst["served"], "tokens_compared": tokens,
           "requests_compared": len(picked)}
    if quant is not None:
        out["control_max_logit_gap"] = worst["control"]
    return out
