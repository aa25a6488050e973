"""Port of `nos_tpu/serving/kv_store.py`: `FleetKVStore` (:82),
`StoreTier` (:301), the `put` outcomes `PUT_*` (:77-79) and
`_readonly_view` (:56), copied near verbatim (host-only code; the port
imports nothing of the JAX package).

One difference, in what a payload is: the port's engines ship CPU torch
tensors (`DecodeServer._extract_block`: `(k, v)`, or the tagged int8
5-tuple), not numpy arrays. Torch has no read-only flag and bf16 has no
numpy dtype, so `_readonly_view` keeps the reference's rule as it is
(ndarray leaves become `writeable=False` views, tuples and lists map
recursively, anything else passes through) and a tensor leaf passes
through unchanged: `take` stays zero-copy and returns the stored
tensors themselves. What keeps the shared copy intact is that the
engine only reads a taken payload (`HostStage.to_device` uploads a copy
and the copy-in writes the pool, never the payload);
tests/test_torch_kv_store.py holds the stored bytes equal to what was
put after revives by several engines, and `take`'s tensors to the
stored storage (`data_ptr`).

FleetKVStore: ONE fleet-scope content-addressed KV cold tier.

The SpillTier makes the host-RAM tier real but PRIVATE: every engine
owns its own store, so at fleet scale the same system-prompt KV is held
(or recomputed) once per replica, a freshly created or drain-destination
replica starts stone cold, and a dead replica's host cache dies with it
while failover replays by recompute. That is exactly the static-
ownership waste the paper targets (PAPER.md §1), replayed one tier down:
capacity stranded by per-device ownership becomes capacity reclaimed by
making it fleet-visible. ROADMAP item 3 names the industry shape — the
MemServe/Mooncake-style disaggregated KV cache — and this module is that
promotion: chain key -> full-width K/V payload, shared by every replica.

Why sharing is sound, in two already-paid-for properties:

* **Content addressing.** Keys are `runtime/radix_tree.chain_key`
  digests — a key commits to the exact token path from the root, so two
  engines that compute the same key hold bit-identical KV by the
  exactness oracles (spilled-hit == cold). A `put` of a present key is
  therefore a *dedup hit*, not a conflict: N replicas serving the same
  prefix hold ONE host copy.
* **Full-width payloads.** Tensor-parallel serving (docs/sharded-decode.md) makes every
  spill payload device-independent: copy-out gathers KV-head shards
  into one `[layers, 2, n_kv, block, head_dim]` stack and copy-in
  slices it back per shard. A payload written by a tp=2 engine revives
  on a tp=1 engine unchanged — so one store serves a mixed-width fleet
  by construction.

The store is byte-capacity-bounded with LRU retirement, like SpillTier,
plus one fleet-scale necessity: **pinning**. An engine that stages a
revive at admit time may not pump the copy-in for many ticks; without a
pin, another replica's put burst could retire the entry in between and
turn a promised hit into a recompute. `take_pinned`/`unpin` bracket the
in-flight window; pinned entries are skipped by LRU retirement and
refused by `discard`.

Single-mutator discipline: every mutation of `_store`, `_store_bytes`
and `_pins` lives inside FleetKVStore (the reference package's lint
enforces it there), the pool's and the spill tier's discipline at fleet
scope.
Engines never touch the store directly: they go through `StoreTier`,
a per-engine adapter presenting SpillTier's exact duck surface so
BlockManager plugs in either tier behind one interface.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["FleetKVStore", "StoreTier"]


def _readonly_view(payload: object) -> object:
    """Zero-copy read-only view of a shared payload. ndarray leaves
    become `writeable=False` VIEWS of the stored buffer — the consumer
    slices/uploads them as before, and an accidental in-place write
    raises instead of silently corrupting the one host copy every other
    replica revives from. Tuples/lists (the engine's `(k, v)` stacks)
    map recursively; anything else — the unit tests' immutable string
    stand-ins — passes through unchanged. Copy-on-demand: a consumer
    that truly needs a private mutable buffer copies it itself, paying
    for the duplicate only when one is actually required."""
    if isinstance(payload, np.ndarray):
        view = payload.view()
        view.flags.writeable = False
        return view
    if isinstance(payload, tuple):
        return tuple(_readonly_view(p) for p in payload)
    if isinstance(payload, list):
        return [_readonly_view(p) for p in payload]
    return payload

# put() outcomes (StoreTier turns these into per-engine counters).
PUT_STORED = "stored"
PUT_DEDUP = "dedup"
PUT_REFUSED = "refused"


class FleetKVStore:
    """Thread-safe, byte-bounded, content-addressed host KV store.

    One instance is shared by every replica in the fleet; all methods
    take the store lock, so concurrent engines (and the supervisor's
    failover thread) interleave at operation granularity. Payloads are
    opaque full-width host stacks (see module docstring); `nbytes` is
    caller-measured like SpillTier's.

    Entries carry prefix metadata (`parent` chain key + the block's
    token tuple) so a cold replica can reconstruct ancestor-closed
    chains for prewarm without consulting any engine's radix tree.
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be > 0 (use no store to disable)")
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.RLock()
        # LRU: oldest first. key -> (payload, nbytes, parent_key, tokens).
        self._store: "OrderedDict[str, Tuple[object, int, str, Tuple[int, ...]]]" = (
            OrderedDict()
        )
        self._store_bytes = 0
        # key -> pin refcount (>0 entries only; pinned entries are
        # immune to LRU retirement and discard).
        self._pins: Dict[str, int] = {}
        # Counters (monotonic; telemetry mirrors them fleet-wide).
        self.puts = 0
        self.dedup_hits = 0
        self.hits = 0
        self.misses = 0
        self.drops = 0

    # -- queries -------------------------------------------------------------
    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._store

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    @property
    def host_bytes(self) -> int:
        """Bytes currently resident in the shared store."""
        with self._lock:
            return self._store_bytes

    @property
    def entries(self) -> int:
        with self._lock:
            return len(self._store)

    @property
    def pinned_entries(self) -> int:
        with self._lock:
            return len(self._pins)

    def keys(self) -> Iterator[str]:
        with self._lock:
            return iter(list(self._store))

    def meta(self, key: str) -> Optional[Tuple[str, Tuple[int, ...]]]:
        """(parent chain key, block token tuple) for a resident entry —
        the prewarm planner's chain-reconstruction read."""
        with self._lock:
            entry = self._store.get(key)
            return None if entry is None else (entry[2], entry[3])

    def hot_keys(self, limit: Optional[int] = None) -> List[str]:
        """MRU-first resident keys whose ENTIRE ancestor chain is also
        resident — the prewarm candidate set. Ancestor closure matters:
        reviving a block whose parent was retired would index a radix
        path the store cannot back, so broken chains are skipped."""
        with self._lock:
            resident = set(self._store)
            out: List[str] = []
            for key in reversed(self._store):
                node, closed = key, True
                while node:
                    entry = self._store.get(node)
                    if entry is None:
                        closed = False
                        break
                    node = entry[2]
                if closed:
                    out.append(key)
                    if limit is not None and len(out) >= limit:
                        break
            return out

    def conserved(self) -> bool:
        """The conservation law, fleet scope: the byte gauge equals the
        sum of resident payload sizes; pin counts only cover resident
        entries; and bytes stay within capacity UNLESS every resident
        entry is pinned (pins block retirement, the one sanctioned
        overshoot). Asserted by the hammer/pool tests after every op."""
        with self._lock:
            if self._store_bytes != sum(e[1] for e in self._store.values()):
                return False
            if any(k not in self._store or c <= 0 for k, c in self._pins.items()):
                return False
            return self._store_bytes <= self.capacity_bytes or all(
                k in self._pins for k in self._store
            )

    # -- mutation (the only sanctioned sites) ---------------------------------
    def put(
        self,
        key: str,
        payload: object,
        nbytes: int,
        parent: str = "",
        tokens: Sequence[int] = (),
    ) -> str:
        """Admit one block's contents under its chain key.

        Present key: a dedup hit — refresh recency and payload (content
        is identical by key construction; byte bookkeeping still
        replaces, never leaks — the SpillTier overwrite law). Oversized
        payload: refused outright, like SpillTier. Otherwise insert and
        retire LRU *non-pinned* entries beyond capacity; if pins leave
        nothing retirable the newest non-pinned entry (possibly this
        one) goes first, so capacity is only ever exceeded by pins.
        Returns one of "stored" / "dedup" / "refused"."""
        nbytes = int(nbytes)
        with self._lock:
            self.puts += 1
            dedup = key in self._store
            if dedup:
                self.dedup_hits += 1
                _, old, _, _ = self._store.pop(key)
                self._store_bytes -= old
            if nbytes > self.capacity_bytes:
                if dedup and key in self._pins:
                    del self._pins[key]
                self.drops += 1
                return PUT_REFUSED
            self._store[key] = (payload, nbytes, str(parent), tuple(tokens))
            self._store_bytes += nbytes
            while self._store_bytes > self.capacity_bytes:
                victim = next(
                    (k for k in self._store if k not in self._pins), None
                )
                if victim is None:
                    break  # everything pinned: sanctioned overshoot
                _, n, _, _ = self._store.pop(victim)
                self._store_bytes -= n
                self.drops += 1
                if victim == key:
                    return PUT_REFUSED
            return PUT_DEDUP if dedup else PUT_STORED

    def get(self, key: str) -> Optional[object]:
        """Peek WITHOUT pin or recency touch — the COW source read and
        the router's probe. Peek-must-not-perturb, as in SpillTier."""
        with self._lock:
            entry = self._store.get(key)
            return None if entry is None else entry[0]

    def pin(self, key: str) -> bool:
        """Pin a resident entry against retirement (stage-time hold for
        a revive promised at admit). False when the key is absent."""
        with self._lock:
            if key not in self._store:
                return False
            self._pins[key] = self._pins.get(key, 0) + 1
            return True

    def take_pinned(self, key: str) -> Optional[object]:
        """Read one payload for revival: pin + recency touch + hit
        count. The entry STAYS resident (unlike SpillTier.take — the
        whole point is that other replicas keep hitting it); the caller
        unpins once its copy-in lands. None counts a miss (entry
        retired under pressure before any pin landed) — the caller
        falls back to recompute, bit-identical by the exactness
        argument."""
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self._pins[key] = self._pins.get(key, 0) + 1
            self.hits += 1
            return entry[0]

    def unpin(self, key: str) -> None:
        """Release one pin. Tolerant of unknown keys (a pinned entry's
        holder may race a reset) — but never drives a count negative."""
        with self._lock:
            c = self._pins.get(key, 0)
            if c > 1:
                self._pins[key] = c - 1
            elif c == 1:
                del self._pins[key]

    def discard(self, key: str) -> None:
        """Drop one entry (index hygiene). Refused for pinned entries:
        a pin is a promise that an in-flight revive will read the key."""
        with self._lock:
            if key in self._pins:
                return
            entry = self._store.pop(key, None)
            if entry is not None:
                self._store_bytes -= entry[1]

    def reset(self) -> None:
        """Forget everything, pins included — only for wholesale
        invalidation (model/params swap), never device loss: host
        payloads are device-independent and exactly what recovering
        replicas want to hit."""
        with self._lock:
            self._store = OrderedDict()
            self._store_bytes = 0
            self._pins = {}


class StoreTier:
    """Per-engine adapter: SpillTier's duck surface over a shared
    FleetKVStore.

    BlockManager and DecodeServer speak one host-tier interface
    (`put`/`get`/`take`/`discard`/`stage`/`reset`/containment/gauges);
    this class maps it onto the fleet store with three semantic shifts:

    * `take` READS instead of popping — shared content survives one
      replica's revive so the next replica still hits it. The revive
      counter stays per-engine.
    * `discard` and `reset` never remove shared content: another
      replica's radix tree may be one admit away from the same key.
      They only release THIS engine's staged pins (so a dying or
      resetting engine cannot leak pins and wedge retirement).
    * `stage`/`unstage` bracket admit-promised revives with store pins,
      the window SpillTier never needed (its entries had one owner).

    Counters mirror SpillTier's (`spills`/`revives`/`drops`) plus the
    shared-tier split (`store_hits`/`store_misses`/`store_puts`/
    `store_dedup_hits`) telemetry reports per engine.
    """

    is_shared = True

    def __init__(self, store: FleetKVStore):
        self._fleet = store
        # key -> this engine's staged-pin count (admit-time holds not
        # yet consumed by take()). Single-threaded per engine.
        self._staged: Dict[str, int] = {}
        self.spills = 0
        self.revives = 0
        self.drops = 0
        self.store_hits = 0
        self.store_misses = 0
        self.store_puts = 0
        self.store_dedup_hits = 0

    # -- queries (delegated) -------------------------------------------------
    @property
    def capacity_bytes(self) -> int:
        return self._fleet.capacity_bytes

    @property
    def host_bytes(self) -> int:
        return self._fleet.host_bytes

    @property
    def store(self) -> FleetKVStore:
        return self._fleet

    def __contains__(self, key: str) -> bool:
        return key in self._fleet

    def __len__(self) -> int:
        return len(self._fleet)

    def keys(self) -> Iterator[str]:
        return self._fleet.keys()

    def conserved(self) -> bool:
        return self._fleet.conserved()

    # -- SpillTier surface ---------------------------------------------------
    def put(
        self,
        key: str,
        payload: object,
        nbytes: int,
        parent: str = "",
        tokens: Sequence[int] = (),
    ) -> None:
        status = self._fleet.put(key, payload, nbytes, parent=parent, tokens=tokens)
        self.spills += 1
        self.store_puts += 1
        if status == PUT_DEDUP:
            self.store_dedup_hits += 1
        elif status == PUT_REFUSED:
            self.drops += 1

    def get(self, key: str) -> Optional[object]:
        return self._fleet.get(key)

    def take(self, key: str) -> Optional[object]:
        """Revive read: consume this engine's staged pin (if any) and
        return the payload WITHOUT removing it from the store. The
        copy-in is synchronous in the caller, so the momentary
        take-pin closes immediately after.

        The returned payload is a READ-ONLY zero-copy view
        (`writeable=False` on ndarray leaves): the old eager
        full-payload duplicate is gone — consumers slice/upload the
        shared buffer directly and copy only on demand, while the view
        flag keeps one replica's revive from ever mutating the host
        copy the rest of the fleet hits. Dedup and pin accounting are
        untouched by the change (pinned by the byte-balance tests)."""
        payload = self._fleet.take_pinned(key)
        self._drop_stage(key)
        if payload is None:
            self.store_misses += 1
            return None
        self._fleet.unpin(key)  # the take-pin; copy-in is synchronous
        self.revives += 1
        self.store_hits += 1
        return _readonly_view(payload)

    def discard(self, key: str) -> None:
        # Shared content stays (see class docstring); only release any
        # stage hold this engine had on it.
        self._drop_stage(key)

    def reset(self) -> None:
        self.unstage_all()

    # -- stage pins (admit-promised revives) ---------------------------------
    def stage(self, keys: Iterable[str]) -> None:
        for key in keys:
            if self._fleet.pin(key):
                self._staged[key] = self._staged.get(key, 0) + 1

    def unstage(self, keys: Iterable[str]) -> None:
        for key in keys:
            self._drop_stage(key)

    def unstage_all(self) -> None:
        for key, count in list(self._staged.items()):
            for _ in range(count):
                self._fleet.unpin(key)
        self._staged = {}

    def _drop_stage(self, key: str) -> None:
        c = self._staged.get(key, 0)
        if c <= 0:
            return
        if c == 1:
            del self._staged[key]
        else:
            self._staged[key] = c - 1
        self._fleet.unpin(key)

    @property
    def staged_pins(self) -> int:
        return sum(self._staged.values())
