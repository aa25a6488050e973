"""Port of `nos_tpu/runtime/spill.py`, copied verbatim apart from
references to the reference's change history in the comments (host-only
code; the port imports nothing of the JAX package).

SpillTier: the host-RAM tier of the paged KV cache.

Under HBM pressure the BlockManager's only lever without it is LRU
eviction of refcount-0 cached blocks — destroying prefix KV it may need
seconds later (a deployed system prompt cycling in and out of cache is
the common case at production fan-out). This module adds the standard
next tier (vLLM/SGLang-style CPU KV offload): a refcount-0 block about
to lose its device residency first copies its K/V contents into a host
buffer keyed by the SAME chain key the device index uses, so a later
admission that misses the device index can still hit HOST and revive
the block with a copy-in instead of a forward pass. A revived block is
bit-identical to a recomputed one — the payload was produced by the
very prefill programs a cold run would execute, and the host round-trip
preserves bytes — so the exactness oracles (spilled-hit == cold) hold
by construction.

The tier also backs SLOT PREEMPTION (runtime/quota.py): a preempted
slot's keyed blocks are released straight to host, so the guaranteed
tenant gets HBM immediately while the borrower's prefix stays one
copy-in away.

Host payloads are plain numpy — they do NOT die with the device pool.
They are also FULL-WIDTH by contract (docs/sharded-decode.md):
under tensor-parallel serving the engine's copy-out gathers the
KV-head shards into one `[layers, n_kv, block, head_dim]` payload and
the copy-in slices it back per shard, so a payload spilled at one tp
width revives — or ships to another replica — at ANY width, and
`host_bytes` gauges the same quantity everywhere.
After a device-lost recovery the engine resets the BlockManager (device
index, free lists) but keeps the tier: checkpoint replays can revive
spilled prefixes into the fresh pool, which is exactly when recompute
is most expensive.

Every mutation of the tier's state (`_spill_store`, `_spill_bytes`)
lives inside this class — enforced by the NOS013 checker
(docs/static-analysis.md), mirroring NOS011's pool-state discipline:
spill bookkeeping scattered into the engine or the BlockManager is a
lint finding in the reference package.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Iterator, Optional, Sequence, Tuple


class SpillTier:
    """Host-side store of spilled KV blocks: chain key -> payload.

    A payload is opaque to the tier (the engine stores per-layer
    (k, v) numpy stacks; pure host-side tests store anything with an
    ``nbytes``-measurable shape via the ``nbytes_of`` hook). Capacity is
    byte-bounded: `put` retires the LRU entries beyond
    ``capacity_bytes`` (a *drop* — host content lost, the block costs a
    recompute like any cold miss)."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be > 0 (use no tier to disable)")
        self.capacity_bytes = int(capacity_bytes)
        # LRU: oldest first. key -> (payload, nbytes).
        self._spill_store: "OrderedDict[str, Tuple[object, int]]" = OrderedDict()
        self._spill_bytes = 0
        # Counters (monotonic; the engine mirrors them into metrics).
        self.spills = 0
        self.revives = 0
        self.drops = 0

    # -- queries -------------------------------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._spill_store

    def __len__(self) -> int:
        return len(self._spill_store)

    @property
    def host_bytes(self) -> int:
        """Bytes currently resident in the host tier."""
        return self._spill_bytes

    def keys(self) -> Iterator[str]:
        return iter(self._spill_store)

    def conserved(self) -> bool:
        """The host-tier byte conservation law: the running byte gauge
        equals the sum of resident payload sizes, and never exceeds
        capacity. Asserted by the randomized pool-invariant test after
        every spill/revive/preempt-shaped op."""
        return (
            self._spill_bytes == sum(n for _, n in self._spill_store.values())
            and self._spill_bytes <= self.capacity_bytes
        )

    # -- tier-interface parity (serving/kv_store.StoreTier) ------------------
    # A private tier has no cross-replica retirement race, so stage
    # pins are no-ops here; the shared tier makes them real. Keeping
    # the methods on both tiers lets BlockManager/DecodeServer speak
    # ONE host-tier surface without isinstance branches.
    is_shared = False

    def stage(self, keys: Iterable[str]) -> None:
        return None

    def unstage(self, keys: Iterable[str]) -> None:
        return None

    def unstage_all(self) -> None:
        return None

    # -- mutation (the only sanctioned sites — NOS013) -----------------------
    def put(
        self,
        key: str,
        payload: object,
        nbytes: int,
        parent: str = "",
        tokens: Sequence[int] = (),
    ) -> None:
        """Admit one spilled block's contents under its chain key,
        retiring LRU entries beyond capacity. Re-putting a key refreshes
        its payload and recency (the content is identical by key
        construction, so this is bookkeeping, not data loss). The
        ``parent``/``tokens`` prefix metadata is accepted for interface
        parity with the fleet store's prewarm planner and ignored — a
        private tier serves only its owner's radix tree, which already
        knows its chains."""
        del parent, tokens
        nbytes = int(nbytes)
        if key in self._spill_store:
            _, old = self._spill_store.pop(key)
            self._spill_bytes -= old
        if nbytes > self.capacity_bytes:
            # A single payload larger than the whole tier: refuse it
            # outright instead of evicting residents it cannot fit
            # behind anyway.
            self.spills += 1
            self.drops += 1
            return
        self._spill_store[key] = (payload, nbytes)
        self._spill_bytes += nbytes
        self.spills += 1
        while self._spill_bytes > self.capacity_bytes:
            _, (_, n) = self._spill_store.popitem(last=False)
            self._spill_bytes -= n
            self.drops += 1

    def get(self, key: str) -> Optional[object]:
        """Read one payload WITHOUT removing it — the radix COW's
        source read: the copy consumes only the block's head,
        and the full block stays valid host content for future
        full-prefix hits, so popping it (take) would destroy residency
        the copy never used. Deliberately no recency touch, mirroring
        `__contains__`: a partial read must not change which entry the
        next capacity drop takes (the peek-must-not-perturb property)."""
        entry = self._spill_store.get(key)
        return None if entry is None else entry[0]

    def take(self, key: str) -> Optional[object]:
        """Pop one payload for revival (copy-in to a fresh device block).
        Returns None when the key was dropped under host pressure or
        already revived by a concurrent slot — the caller falls back to
        recompute, which is bit-identical by the exactness argument."""
        entry = self._spill_store.pop(key, None)
        if entry is None:
            return None
        payload, n = entry
        self._spill_bytes -= n
        self.revives += 1
        return payload

    def discard(self, key: str) -> None:
        """Drop one entry without counting a revive (index hygiene)."""
        entry = self._spill_store.pop(key, None)
        if entry is not None:
            self._spill_bytes -= entry[1]

    def reset(self) -> None:
        """Forget everything. NOT called on device loss — host payloads
        are device-independent and exactly what replays want to hit —
        only when the tier's contents are invalidated wholesale (e.g.
        model/params swap)."""
        self._spill_store = OrderedDict()
        self._spill_bytes = 0
