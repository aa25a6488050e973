"""Prompt-lookup speculative decoding: greedy-exact multi-token steps.

Port of `nos_tpu/models/speculative.py`: the draft sources' names (:49-50),
`AdaptiveSpec` (:61), `find_prompt_lookup_draft` (:177), `_LookupIndex`
(:200), `accept_prefix` (:253) and `speculative_generate` (:266). The host
parts are copied near-verbatim; `speculative_generate` runs the port's
paged programs where the params lie.

Speculative decoding VERIFIES k drafted tokens in one forward pass and keeps
the longest correct prefix. The draft here is prompt-lookup: the
continuation after the most recent earlier occurrence of the current n-gram
suffix. A draft token is kept only when it EQUALS the model's argmax given
every previously accepted token, so the output is one-token-at-a-time
greedy decoding's; each round emits between 1 and k+1 tokens. "The model's
argmax" comes from a differently shaped program than the single-step path,
so where two logits tie EXACTLY the tie may break differently; equality is
exact wherever the argmax is decisive.

The verify pass is the chunked-prefill program (`paged_prefill_chunk`): a
window of W tokens written into the paged pool at pos..pos+W-1, attending
over the confirmed prefix plus itself, causally. Rejected rows leave stale
K/V beyond the accepted position; the next round starts there and
overwrites them before anything attends that far.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from nos_tpu_torch.models.decode import greedy, init_paged_cache, paged_prefill_chunk
from nos_tpu_torch.models.gpt import GPTConfig

#: Draft-source names: the slot's own generated history (prompt-lookup)
#: and the radix tree's stored continuation.
SOURCE_HISTORY = "history"
SOURCE_TREE = "tree"

#: source -> (rate attr, denied_until attr) on AdaptiveSpec.
_SOURCE_ATTRS = {
    SOURCE_HISTORY: ("rate", "denied_until"),
    SOURCE_TREE: ("tree_rate", "tree_denied_until"),
}


@dataclass
class AdaptiveSpec:
    """Per-slot, per-source adaptive speculation controller (the engine's).

    Keeps an EWMA of each source's draft acceptance rate (accepted drafted
    tokens / drafted tokens per resolved round): `cap(k)` shrinks the draft
    window with it, and `observe(...)` demotes the source (drafting denied
    for `cooldown` generated tokens) when it falls below `demote_below`,
    re-entering with fresh optimism afterwards. The two sources (the radix
    tree's continuation and the slot's own prompt-lookup index) keep their
    own EWMA and cooldown. Everything is a pure function of the slot's own
    acceptance history, so a request's draft schedule never depends on its
    co-tenants."""

    alpha: float = 0.5  # EWMA weight of the newest round
    demote_below: float = 0.2  # EWMA floor; crossing it demotes the source
    cooldown: int = 32  # generated tokens drafting stays denied after demotion
    rate: float = 1.0  # history source: optimistic start (full first window)
    denied_until: int = 0  # history source: drafting allowed at this count
    tree_rate: float = 1.0  # tree source EWMA (same dynamics, own state)
    tree_denied_until: int = 0  # tree source cooldown threshold

    def observe(self, drafted: int, accepted: int, generated: int,
                source: str = SOURCE_HISTORY) -> bool:
        """Fold one resolved verify round (`drafted` draft tokens sent,
        `accepted` of them kept; `generated` = the slot's tokens so far)
        into `source`'s EWMA. Returns True when this round demoted the
        source."""
        if drafted <= 0:
            return False
        r_attr, d_attr = _SOURCE_ATTRS[source]
        rate = getattr(self, r_attr)
        rate += self.alpha * (accepted / drafted - rate)
        if rate < self.demote_below:
            setattr(self, d_attr, generated + self.cooldown)
            setattr(self, r_attr, 1.0)  # fresh optimism after the cooldown
            return True
        setattr(self, r_attr, rate)
        return False

    def allowed(self, generated: int, source: str = SOURCE_HISTORY) -> bool:
        _, d_attr = _SOURCE_ATTRS[source]
        return generated >= getattr(self, d_attr)

    def cap(self, k: int, source: str = SOURCE_HISTORY) -> int:
        """Effective draft window: full `k` at rate 1.0, shrinking with the
        source's EWMA, never below 1."""
        r_attr, _ = _SOURCE_ATTRS[source]
        return max(1, min(k, int(round(k * getattr(self, r_attr)))))

    def denial_margin(self, generated: int, sources: Sequence[str]) -> int:
        """Tokens this slot can generate before the first of `sources`
        leaves demotion cooldown; 0 when any of them is allowed now. The
        engine's burst gate uses it to prove a burst cannot skip a draft
        probe."""
        margin: Optional[int] = None
        for source in sources:
            _, d_attr = _SOURCE_ATTRS[source]
            m = getattr(self, d_attr) - generated
            margin = m if margin is None else min(margin, m)
        return max(0, margin) if margin is not None else 0

    def snapshot(self, generated: int) -> Dict[str, float]:
        """The controller's state as a flat str->float dict, cooldowns
        relative to the slot's current generated count."""
        return {
            "rate": self.rate,
            "denied_for": max(0, self.denied_until - generated),
            "tree_rate": self.tree_rate,
            "tree_denied_for": max(0, self.tree_denied_until - generated),
        }

    @classmethod
    def restore(cls, snap: Dict[str, float]) -> "AdaptiveSpec":
        """Rebuild the controller from `snapshot()` output, cooldowns
        re-anchored at a fresh generated count; absent tree keys restore
        the tree source's defaults."""
        spec = cls()
        spec.rate = float(snap.get("rate", 1.0))
        spec.denied_until = int(snap.get("denied_for", 0))
        spec.tree_rate = float(snap.get("tree_rate", 1.0))
        spec.tree_denied_until = int(snap.get("tree_denied_for", 0))
        return spec


def find_prompt_lookup_draft(history: Sequence[int], ngram: int = 3, k: int = 8) -> List[int]:
    """The k tokens that followed the most recent EARLIER occurrence of
    history's final n-gram; empty when there is none or history is too
    short. The O(n) scan `_LookupIndex` matches."""
    n = len(history)
    if n <= ngram:
        return []
    suffix = tuple(history[-ngram:])
    for start in range(n - ngram - 1, -1, -1):
        if tuple(history[start: start + ngram]) == suffix:
            return list(history[start + ngram: start + ngram + k])
    return []


class _LookupIndex:
    """ngram-tuple -> latest start position, maintained incrementally.

    The ngram ending at history's final token is inserted on the next
    extend, so a lookup never matches the suffix occurrence itself: the
    semantics of `find_prompt_lookup_draft` at O(ngram) per lookup. The map
    holds at most `max_entries` ngrams; each insertion re-seats its key at
    the back and overflow evicts the front (the ngram seen longest ago)."""

    def __init__(self, history: List[int], ngram: int, max_entries: int = 4096):
        self.history = history  # shared alias; extend() appends to it
        self.ngram = ngram
        self.max_entries = max_entries
        self.index: Dict[tuple, int] = {}
        self._indexed_through = 0  # ngrams ending strictly before this idx
        self._catch_up(len(history) - 1)

    def _catch_up(self, end_exclusive: int) -> None:
        """Insert every ngram ending at positions [..end_exclusive)."""
        h, g, idx = self.history, self.ngram, self.index
        for j in range(max(self._indexed_through, g - 1), end_exclusive):
            key = tuple(h[j - g + 1: j + 1])
            if key in idx:
                del idx[key]  # re-seat at the back: recency order
            idx[key] = j - g + 1
            if len(idx) > self.max_entries:
                del idx[next(iter(idx))]  # evict the least-recent ngram
        self._indexed_through = max(self._indexed_through, end_exclusive)

    def extend(self, tokens: Sequence[int]) -> None:
        self.history.extend(tokens)
        self._catch_up(len(self.history) - 1)

    def draft(self, k: int) -> List[int]:
        h, g = self.history, self.ngram
        if len(h) <= g:
            return []
        start = self.index.get(tuple(h[-g:]))
        if start is None:
            return []
        return list(h[start + g: start + g + k])


def accept_prefix(window: Sequence[int], preds: Sequence[int]) -> List[int]:
    """Greedy-exact acceptance: preds[j] is the true greedy token iff every
    earlier window token was correct; draft window[j+1] is correct iff it
    equals preds[j]. Returns the accepted tokens (1..len(window))."""
    m = 0
    L = len(window)
    while m < L - 1 and window[m + 1] == preds[m]:
        m += 1
    return [int(t) for t in preds[: m + 1]]


def speculative_generate(params, cfg: GPTConfig, prompt: Sequence[int], max_new: int,
                         ngram: int = 3, draft_k: int = 8, eos_id: Optional[int] = None,
                         block_size: int = 64, prompt_chunk: int = 256,
                         return_stats: bool = False,
                         ) -> List[int] | Tuple[List[int], Dict[str, float]]:
    """Generate `max_new` greedy tokens after `prompt` on the params'
    device, matching plain greedy decoding (see the module docstring on
    exact ties), in about max_new / (accepted per round) forward passes.
    `draft_k` bounds the window (W = draft_k + 1 rows per verify pass);
    `ngram` is the lookup key length; `draft_k=0` makes every round a plain
    single-token step through the same programs."""
    if max_new <= 0:
        return ([], {"rounds": 0, "accepted_per_round": 0.0}) if return_stats else []
    prompt = list(prompt)
    if not prompt:
        raise ValueError("speculative_generate needs a non-empty prompt")
    device = params["tok_emb"].device
    W = draft_k + 1
    # Capacity: prompt + generated + one full window of scratch rows, in
    # whole blocks, plus the shared scratch page at block 0.
    max_len = len(prompt) + max_new + W
    max_pages = -(-max_len // block_size)
    cache = init_paged_cache(cfg, 1 + max_pages, block_size, device=device)
    table_row = torch.arange(1, 1 + max_pages, dtype=torch.int32, device=device)

    def run(window: List[int], width: int, start: int, with_logits: bool = True):
        tokens = torch.zeros((1, width), dtype=torch.int32)
        tokens[0, : len(window)] = torch.tensor(window, dtype=torch.int32)
        logits, _ = paged_prefill_chunk(params, tokens.to(device), cfg, cache, table_row,
                                        start, len(window), block_size,
                                        with_logits=with_logits)
        return logits

    # -- prompt prefill, chunked at one width; only the last chunk's logits
    pos = 0
    starts = list(range(0, len(prompt), prompt_chunk))
    for start in starts:
        piece = prompt[start: start + prompt_chunk]
        logits = run(piece, prompt_chunk, start, with_logits=start == starts[-1])
        pos = start + len(piece)
    first = int(greedy(logits[len(piece) - 1]))

    out: List[int] = [first]
    history: List[int] = prompt + [first]
    lookup = _LookupIndex(history, ngram)
    rounds = 0

    # -- verify loop: one host read of L ints per round
    while len(out) < max_new and (eos_id is None or out[-1] != eos_id):
        draft = lookup.draft(draft_k)[: max_new - len(out)]  # never overshoot
        window = [history[-1]] + draft
        L = len(window)
        preds = greedy(run(window, W, pos)[:L]).tolist()
        rounds += 1
        accepted = accept_prefix(window, preds)
        if eos_id is not None and eos_id in accepted:
            accepted = accepted[: accepted.index(eos_id) + 1]
        # A fully accepted final round's bonus token would overshoot max_new.
        accepted = accepted[: max_new - len(out)]
        out.extend(accepted)
        lookup.extend(accepted)  # appends to `history` (shared alias)
        pos += len(accepted)  # rows pos..pos+m came from correct tokens
        if eos_id is not None and out and out[-1] == eos_id:
            break
    out = out[:max_new]
    if return_stats:
        return out, {
            "rounds": rounds,
            "accepted_per_round": (len(out) - 1) / rounds if rounds else 0.0,
        }
    return out
