"""Port of `nos_tpu/util/churn.py` (:1-57): `ChurnLedger` (:16). Copied
verbatim; only the imports point at the port, which imports nothing of the
JAX package.

Per-workload eviction churn ledger, shared by every checkpoint-aware
preemption path (the partitioner's consolidation fallback and the
scheduler's reservation drain).

The bound it enforces: a workload is never checkpoint-evicted twice within
`cooldown_s`, nor more than `budget` times per sliding `window_s` — keyed
by namespaced name, which resumption reuses under every controller that
resumes from checkpoint. Without this bound an all-checkpointable trace
degenerates into an eviction storm (the round-3 live-lock)."""

from __future__ import annotations

from typing import Dict, List


class ChurnLedger:
    def __init__(self, cooldown_s: float, budget: int, window_s: float):
        self.cooldown_s = cooldown_s
        self.budget = budget
        self.window_s = window_s
        # key -> recent eviction timestamps (pruned lazily on write; readers
        # must tolerate fully-aged-out non-empty entries).
        self.history: Dict[str, List[float]] = {}

    def eligible_at(self, key: str, now: float) -> float:
        """Earliest time `key` may be evicted again (<= now means now)."""
        history = self.history.get(key)
        if history:
            history = [t for t in history if now - t < self.window_s]
        if not history:
            return now
        eligible = history[-1] + self.cooldown_s
        if len(history) >= self.budget:
            # The oldest of the last `budget` evictions must age out of the
            # window before another is allowed.
            eligible = max(eligible, history[-self.budget] + self.window_s)
        return eligible

    def note(self, key: str, now: float) -> None:
        history = [
            t for t in self.history.get(key, []) if now - t < self.window_s
        ]
        history.append(now)
        self.history[key] = history
        if len(self.history) > 4096:
            # Bound the map on long-lived controllers: drop fully-aged-out
            # workloads (their eligibility is `now` anyway). Pruned IN
            # PLACE — callers hold aliases to this dict (the partitioner's
            # `_ckpt_evictions` escape hatch); reassignment would silently
            # detach them.
            keep = {
                k: h
                for k, h in self.history.items()
                if any(now - t < self.window_s for t in h)
            }
            self.history.clear()
            self.history.update(keep)
