"""Port of `nos_tpu/runtime/block_manager.py:108`, copied near-verbatim: only
the imports point at the port, and references to the reference's change
history are dropped from the comments.

BlockManager: refcounted, content-addressed bookkeeping for the paged
KV pool — shared-prefix block reuse for the DecodeServer.

The serving engine pages its KV cache into fixed-size blocks with per-slot
page tables (models/decode.py `init_paged_cache`); without sharing every
admitted request prefilled its full prompt from scratch, so 8 concurrent
streams sharing one 512-token system prompt recomputed identical K/V
blocks 8 times. This module is the standard next lever (PagedAttention's
cross-request block sharing, SGLang-RadixAttention's hash-chained prefix
lookup): every FULL prompt block is keyed by a hash CHAINED over
(parent key, the block's token ids), so a key identifies the block's
entire token prefix, not just its own tokens. Admission walks the chain,
maps the longest run of cached blocks straight into the new slot's page
table with refcount bumps, and the engine starts the prefill cursor at
the first miss boundary — the request is charged (budget, pool, dispatch)
only for the blocks it actually misses.

Sharing stays safe because shared blocks are IMMUTABLE by construction:
the block holding the prompt's LAST token is always recomputed privately
(never served from cache), so every write a slot dispatches after
admission — tail prefill, decode steps, verify windows — lands at
positions `>= prefill_cursor` inside the slot's private pages. A hit
block appears in many page tables but is only ever READ, which preserves
the disjoint-page-SET composition contract of the per-tick
prefill/verify/macro split (paged_verify_window's docstring): programs
compose over disjoint WRITE sets; read sharing is free.

Lifecycle: `release()` decrements instead of freeing. A block reaching
refcount 0 retires to the LRU `cached-free` list — still indexed, its
K/V intact in the pool — where a later admission can revive it (hit) or
allocation pressure can evict it (index entry dropped, block reused).
Unkeyed blocks (partial tails, decode pages) return to the plain free
list. `reset()` drops everything: after an engine failure the device
pool is reallocated, so cached content is garbage by definition.

TIERED under pressure (runtime/spill.py): with a SpillTier
attached, a cached block about to be evicted first copies its K/V
contents to a host buffer under the same chain key ("spill before
eviction"), and its device block joins the `spilled` state — reusable
like free, but with a host twin one copy-in away. Admission extends the
hit walk into the host tier: keys missing on device but resident on
host become PENDING REVIVES — fresh private blocks whose contents the
engine copies in, charged against the per-tick prefill budget, instead
of recomputing. `release(spill=True)` (slot preemption) retires keyed
refcount-0 blocks straight to host, freeing HBM immediately. Host
payloads are device-independent: `reset()` rebuilds the device pool but
leaves the tier intact, so post-recovery replays still hit.

RADIX-TREE GENERALIZATION (docs/radix-cache.md): with
`radix=True` the flat chain-key index becomes the residency layer UNDER
a radix tree over token-block edges (runtime/radix_tree.py — same
chain_key space, so router keys, flat keys, and tree keys agree by
construction). The tree buys three reuse shapes the flat walk cannot
see: (a) PARTIAL-BLOCK SHARING — a prompt diverging mid-block takes the
deepest resident node's child sharing the longest token prefix and
stages a COPY-ON-WRITE: the shared block's head is copied into the
requester's private page (charged to its prefill budget, staged via
`claim_cow`, source pinned with a refcount until `cow_done`), shared
nodes stay immutable; (b) MULTI-TURN RE-ADMISSION — `register_output`
keys the full blocks a finished request's generated tokens produced
(decode-derived KV is bit-identical to the prefill replay of the same
tokens — the replay-exactness property), so a follow-up turn
re-submitting `history + new tokens` walks the tree to the end of the
history instead of re-prefilling turn N-1's output; (c) SUBTREE-LRU
EVICTION — `_alloc_one` evicts the oldest refcount-0 block whose node
has no device-resident child (leaves before trunks), and the
spill tier is the tree's cold storage (the hit walk continues into
host node by node and stages revives as before). `radix=False` keeps
the flat-chain behavior bit-for-bit — the A/B baseline.

DEVICE-COUNT-AGNOSTIC by contract (docs/sharded-decode.md):
everything here is bookkeeping over LOGICAL block ids. Under
tensor-parallel serving the pool's device arrays are partitioned on the
KV-head axis — each device holds n_kv/tp head-slices of every block —
but a block id means the same thing at any width, so refcounts, chain
keys, the prefix index, spill staging, and `conserved()` never mention
a device. Keep it that way: anything per-device belongs in the engine's
mesh plumbing, not here (NOS016 polices the engine side).

Every mutation of the pool state (`_free_blocks`, `_slot_blocks`,
`_refcount`, `_cached_free`, `_prefix_index`, `_block_key`, `_spilled`)
lives inside this class — enforced by the NOS011 checker
(docs/static-analysis.md): bookkeeping scattered back into the engine
is a lint finding in the reference package. The spill tier's own state has
the same discipline under NOS013 (mutations only inside SpillTier).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from nos_tpu_torch import constants

# The key scheme and the cap helper live with the tree (the walk needs
# both); re-exported here because this module is their historical home —
# the router and the tests import them from either, and both resolve to
# ONE implementation.
from nos_tpu_torch.runtime.radix_tree import (  # noqa: F401  (re-exports)
    RadixTree,
    cacheable_block_cap,
    chain_key,
    prompt_chain_keys,
)
from nos_tpu_torch.runtime.spill import SpillTier


class BlockManager:
    """Host-side accounting for the paged KV pool: free/cached/owned
    block sets, per-block refcounts, per-slot block lists, and the
    content-addressed prefix index. Block 0 is the scratch page and is
    never managed here."""

    def __init__(
        self,
        total_blocks: int,
        block_size: int,
        n_slots: int,
        fault_injector=None,
        radix: bool = False,
        key_salt: str = "",
    ):
        if total_blocks < 2:
            raise ValueError("total_blocks must be >= 2 (scratch + 1)")
        self.total_blocks = int(total_blocks)
        self.block_size = int(block_size)
        self.n_slots = int(n_slots)
        #: chain-key root salt (runtime/radix_tree.prompt_chain_keys):
        #: a quantized-pool engine salts its key space with the payload
        #: dtype so fp16 and int8 bytes can never alias in a shared
        #: store (docs/quantized-kv.md).
        self.key_salt = str(key_salt)
        # Deterministic chaos harness (runtime/faults.py FaultInjector):
        # the `block_admit` site fires at admission ENTRY, before any pool
        # mutation, so an injected fault can never leave half-taken state
        # — conservation under injection is by construction, and the
        # randomized invariant test exercises exactly that.
        self._faults = fault_injector
        # Pool state. A managed block is in exactly ONE of: the plain
        # free list, the cached-free LRU (refcount 0, content indexed),
        # or in use (refcount == number of page tables mapping it).
        self._free_blocks: List[int] = list(range(1, self.total_blocks))
        self._cached_free: "OrderedDict[int, str]" = OrderedDict()  # LRU: oldest first
        self._refcount: List[int] = [0] * self.total_blocks
        self._slot_blocks: List[List[int]] = [[] for _ in range(self.n_slots)]
        # Content index: chain key -> block, and its inverse for the
        # blocks that are indexed (full prompt blocks only).
        self._prefix_index: Dict[str, int] = {}
        self._block_key: Dict[int, str] = {}
        # Per-slot chain state for incremental registration: the prompt's
        # full-block keys, and how many of them are already indexed.
        self._slot_keys: List[List[str]] = [[] for _ in range(self.n_slots)]
        self._slot_indexed: List[int] = [0] * self.n_slots
        # Radix mode (runtime/radix_tree.py): the structural tree
        # over the same chain-key space, the prompt's block token tuples
        # per slot (node edges need content, not just hashes), whether
        # the slot's admission used the cache (gates output
        # registration), the staged copy-on-write match per slot —
        # (token offset, dst block, src block or None, src chain key,
        # copy length), claimed one-shot by the engine — and the pinned
        # COW source block per slot (an extra refcount not backed by a
        # page table, held until `cow_done`/release so eviction cannot
        # reuse the source before the copy dispatches).
        self._tree: Optional[RadixTree] = (
            RadixTree(key_salt=self.key_salt) if radix else None
        )
        self._slot_blocks_tokens: List[List[Tuple[int, ...]]] = [
            [] for _ in range(self.n_slots)
        ]
        self._slot_use_cache: List[bool] = [False] * self.n_slots
        self._slot_cow: List[Optional[Tuple[int, int, Optional[int], str, int]]] = [
            None
        ] * self.n_slots
        self._cow_pins: List[Optional[int]] = [None] * self.n_slots
        # Host spill tier (optional, runtime/spill.py): `_spilled` holds
        # device blocks whose contents live on host — allocatable like
        # free, preferred after it (reusing one destroys nothing the
        # host does not hold). `_slot_revives` stages each admission's
        # host hits for the engine to claim: (token offset, block, key).
        self._spill: Optional[SpillTier] = None
        self._spill_reader: Optional[Callable[[int], Tuple[object, int]]] = None
        self._spilled: List[int] = []
        self._slot_revives: List[List[Tuple[int, int, str]]] = [
            [] for _ in range(self.n_slots)
        ]
        # Counters (monotonic; the engine mirrors them into metrics).
        self.lookups = 0
        self.hit_blocks = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.spill_hit_blocks = 0
        # Radix-tree counters: staged copy-on-write matches, the tokens
        # they copied instead of recomputing, and the generated-token
        # blocks keyed at request completion (the multi-turn enabler).
        self.cow_hits = 0
        self.cow_hit_tokens = 0
        self.output_blocks = 0
        # Optional flight recorder (nos_tpu/tracing.py): pool-pressure
        # events (spill/evict) recorded through its API — block ids and
        # counts only, never chain keys or content.
        self._recorder = None

    def attach_spill(
        self,
        tier: SpillTier,
        reader: Callable[[int], Tuple[object, int]],
    ) -> None:
        """Arm the host tier. `reader(block)` extracts the block's K/V
        contents from the device pool as (payload, nbytes) — supplied by
        the engine, which owns the device arrays; the manager decides
        WHEN content moves between tiers, never touches device state
        itself."""
        self._spill = tier
        self._spill_reader = reader

    def attach_recorder(self, recorder) -> None:
        """Arm the engine's flight recorder (tracing.FlightRecorder) for
        pool-pressure events. Recording goes through the recorder's own
        API (NOS014); the manager never touches its ring."""
        self._recorder = recorder

    def _spill_out(self, block: int, key: str) -> None:
        """Move one indexed refcount-0 block's contents to the host tier
        and drop its device index entry. The caller owns the block's
        next state (`_spilled` or immediate reuse).

        In radix mode the put carries the node's prefix metadata
        (parent chain key + the block's token tuple) so a SHARED tier
        (serving/kv_store.py) can rebuild ancestor-closed chains for
        cold-replica prewarm without consulting any engine's tree; a
        private SpillTier ignores it."""
        payload, nbytes = self._spill_reader(block)
        parent, tokens = "", ()
        if self._tree is not None:
            node = self._tree.node(key)
            if node is not None:
                tokens = node.tokens
                parent = node.parent.key if node.parent is not None else ""
        self._spill.put(key, payload, nbytes, parent=parent, tokens=tokens)
        del self._prefix_index[key]
        del self._block_key[block]
        if self._recorder is not None:
            self._recorder.record(
                constants.FLIGHT_EV_SPILL, block=block, nbytes=nbytes
            )

    # -- queries -------------------------------------------------------------
    def available(self) -> int:
        """Blocks an allocation could obtain right now (plain free +
        host-backed spilled + evictable cached)."""
        return len(self._free_blocks) + len(self._spilled) + len(self._cached_free)

    def slot_blocks(self, idx: int) -> Tuple[int, ...]:
        return tuple(self._slot_blocks[idx])

    def counts(self) -> Dict[str, int]:
        """Pool-state gauge snapshot: free / cached (refcount-0, content
        retained on device) / spilled (refcount-0, content retained on
        HOST, device block reusable) / in_use (distinct blocks mapped by
        >= 1 table) / shared (mapped by >= 2)."""
        in_use = sum(1 for rc in self._refcount if rc > 0)
        shared = sum(1 for rc in self._refcount if rc > 1)
        return {
            "free": len(self._free_blocks),
            "cached": len(self._cached_free),
            "spilled": len(self._spilled),
            "in_use": in_use,
            "shared": shared,
        }

    def conserved(self) -> bool:
        """The pool conservation law, as one cheap predicate: every managed
        block in exactly one of in-use / free / cached-free / spilled
        (the four summing to total - 1, scratch excluded), no duplicates
        on the free or spilled lists, and the host tier's bytes balance.
        The recovery paths assert this after every restore — a leaked or
        double-freed block surfaces at the recovery that caused it, not
        as cross-request KV corruption under later load."""
        c = self.counts()
        free = set(self._free_blocks)
        spilled = set(self._spilled)
        return (
            len(free) == len(self._free_blocks)
            and len(spilled) == len(self._spilled)
            and not free & set(self._cached_free)
            and not spilled & (free | set(self._cached_free))
            and c["in_use"] + c["free"] + c["cached"] + c["spilled"]
            == self.total_blocks - 1
            and (self._spill is None or self._spill.conserved())
        )

    def prompt_keys(self, prompt: Sequence[int]) -> List[str]:
        """Chain keys for every block FULLY covered by the prompt."""
        return prompt_chain_keys(prompt, self.block_size, self.key_salt)

    def device_resident(self, key: str) -> bool:
        """Whether a chain key is already indexed on device — the
        prewarm pump's skip test (a resident key needs no copy-in)."""
        return key in self._prefix_index

    def peek_prefix(self, prompt: Sequence[int]) -> Tuple[int, int]:
        """READ-ONLY prefix probe: how many leading full blocks of
        `prompt` would be served without recompute, as (device_blocks,
        spilled_blocks) — the device run first, then its contiguous
        continuation on the host tier, under the same below-the-last-
        token cap `admit()` applies (so a router prediction built on
        this probe matches what admission will actually take).

        Deliberately side-effect free, for router shadow reconciliation
        (nos_tpu/serving/): no refcount bump, no cached-free LRU touch
        or revival, no counter increments, no revive staging — probing a
        replica's cache must not change which block the next allocation
        evicts, or the probe itself would perturb the very recency order
        it reports on (pinned by the LRU-no-touch property test)."""
        if self._tree is not None:
            dev_keys, host_keys, _ = self._tree.match(
                prompt, self.block_size, self._on_device, self._on_host
            )
            return len(dev_keys), len(host_keys)
        cap = cacheable_block_cap(len(prompt), self.block_size)
        keys = prompt_chain_keys(prompt, self.block_size, self.key_salt)[:cap]
        dev = 0
        for key in keys:
            if key not in self._prefix_index:
                break
            dev += 1
        host = 0
        if self._spill is not None:
            for key in keys[dev:]:
                # SpillTier.__contains__ is a plain membership test —
                # it never reorders the tier's LRU.
                if key not in self._spill:
                    break
                host += 1
        return dev, host

    def has_tree(self) -> bool:
        """Whether the radix tree is armed — the engine's source-
        availability test for cache-fed drafting (a flat-chain manager
        has no continuation structure to probe)."""
        return self._tree is not None

    def draft_continuation(self, tokens: Sequence[int], k: int) -> List[int]:
        """READ-ONLY draft probe: up to `k` tokens the radix tree stores
        past the deepest node matching `tokens` — the cache-fed draft
        source of docs/speculation.md. Empty in flat-chain mode.

        Same no-touch contract as `peek_prefix`: no refcount bump, no
        LRU reorder, no revive staging, no payload read. Continuation
        nodes must be device-resident (`_on_device` is a plain dict
        membership test); a spilled node ends the draft rather than
        pulling tier traffic onto the speculation path."""
        if self._tree is None or k <= 0:
            return []
        return self._tree.continuation(tokens, self.block_size, self._on_device, k)

    def _on_device(self, key: str) -> bool:
        return key in self._prefix_index

    def _on_host(self, key: str) -> bool:
        # SpillTier.__contains__ is a plain membership test — residency
        # probes never reorder the tier's LRU.
        return self._spill is not None and key in self._spill

    def _resident(self, key: str) -> bool:
        """Either tier holds the node's data — the tree's prune guard."""
        return self._on_device(key) or self._on_host(key)

    def radix_nodes(self) -> int:
        """Tree size (0 in flat-chain mode) — a telemetry gauge."""
        return 0 if self._tree is None else len(self._tree)

    def index_keys(self) -> frozenset:
        """Snapshot of every chain key currently resident — device index
        plus host tier. Host-side dict reads only (no device traffic);
        used by the router to reconcile its per-replica shadow index.
        The engine thread may be mutating the index concurrently: a
        mid-iteration resize raises, so retry a couple of times and fall
        back to an empty snapshot — the shadow is advisory (a stale or
        empty shadow only costs routing quality, never correctness)."""
        for _ in range(3):
            try:
                keys = set(self._prefix_index)
                if self._spill is not None:
                    keys.update(self._spill.keys())
                return frozenset(keys)
            except RuntimeError:
                continue  # dict changed size mid-iteration: retry
        return frozenset()

    # -- admission -----------------------------------------------------------
    def admit(
        self, idx: int, prompt: Sequence[int], n_blocks: int, use_cache: bool = True
    ) -> Optional[Tuple[List[int], int]]:
        """Reserve `n_blocks` for slot `idx`, serving the longest cached
        prefix of `prompt` from the index first. Returns (blocks, n_hit)
        — blocks[:n_hit] are shared cache hits in prefix order, the rest
        fresh private pages — or None when the pool cannot host the
        misses, in which case NOTHING is retained: the hit blocks'
        refcount bumps are rolled back (resting blocks rejoin the cached
        LRU) before returning, so repeated rejected admissions cannot
        leak pool capacity.

        The hit run is capped BELOW the block holding the prompt's last
        token: that block is always recomputed privately, which (a)
        guarantees the final prefill chunk is non-empty (the first-token
        sample needs logits at the true last position) and (b) keeps
        every post-admission write inside private pages, so shared
        blocks stay immutable.

        With a spill tier attached, the hit walk CONTINUES past the
        device run into the host tier (same cap): host-resident keys
        become fresh private blocks staged as pending revives
        (`claim_revives`) — the engine copies their contents in, charged
        against the prefill budget, instead of recomputing them.

        In radix mode the walk is the TREE's (radix_tree.py `match`):
        device run, host continuation, then at most one copy-on-write
        match at the divergence block — staged via `claim_cow`, its
        device source pinned with a refcount until `cow_done`, its
        copied tokens charged like the revives they resemble."""
        if self._slot_blocks[idx]:
            raise RuntimeError(f"slot {idx} already holds blocks")
        if self._faults is not None:
            self._faults.check("block_admit", slot=idx)
        keys = self.prompt_keys(prompt) if use_cache else []
        hits: List[int] = []
        spill_keys: List[str] = []
        cow = None  # (src_key, copy_len, src_on_device) from the tree walk
        if use_cache:
            self.lookups += 1
            if self._tree is not None:
                dev_keys, spill_keys, cow = self._tree.match(
                    prompt, self.block_size, self._on_device, self._on_host
                )
                hits = [self._prefix_index[key] for key in dev_keys]
                if (
                    self._spill is not None
                    and getattr(self._spill, "is_shared", False)
                    and cow is None
                ):
                    # A SHARED tier holds chains this engine's tree has
                    # never walked (another replica computed them — the
                    # cold-replica case is ALL of them): extend the host
                    # continuation by direct chain-key membership, the
                    # flat-chain walk the tree sits on. Sound because
                    # the keys are content-addressed — membership IS
                    # bit-identical KV for exactly this prefix — and the
                    # revives' note_progress re-indexing ensure_path's
                    # the missing nodes. Skipped past a staged COW: the
                    # divergence already owns the next block.
                    cap = cacheable_block_cap(len(prompt), self.block_size)
                    spill_keys = list(spill_keys)
                    for key in keys[len(hits) + len(spill_keys) : cap]:
                        if key not in self._spill:
                            break
                        spill_keys.append(key)
            else:
                cap = cacheable_block_cap(len(prompt), self.block_size)
                for key in keys[:cap]:
                    block = self._prefix_index.get(key)
                    if block is None:
                        break
                    hits.append(block)
                if self._spill is not None:
                    # Contiguous extension of the hit run on the host tier.
                    for key in keys[len(hits) : cap]:
                        if key not in self._spill:
                            break
                        spill_keys.append(key)
        # Take the hits: refcount bumps; a resting block leaves the LRU.
        for block in hits:
            if self._refcount[block] == 0:
                self._cached_free.pop(block)
            self._refcount[block] += 1
        # Pin a device-resident COW source the same way: the copy
        # dispatches ticks later, and an unpinned source could be
        # evicted (and its device block REUSED) in between.
        pin: Optional[int] = None
        if cow is not None and cow[2]:
            pin = self._prefix_index[cow[0]]
            if self._refcount[pin] == 0:
                self._cached_free.pop(pin)
            self._refcount[pin] += 1

        def _rollback(fresh: List[int]) -> None:
            # Return every block already taken — fresh allocations back
            # to the plain free list (a spill-evicted one's content is
            # already host-resident, nothing is lost), hit bumps dropped,
            # resting blocks restored to the cached LRU (MRU end: they
            # were just touched), the COW pin released — so repeated
            # rejected admissions cannot leak pool capacity.
            for block in fresh:
                self._refcount[block] -= 1
                self._free_blocks.append(block)
            if pin is not None:
                self._refcount[pin] -= 1
                if self._refcount[pin] == 0:
                    self._cached_free[pin] = self._block_key[pin]
            for block in reversed(hits):
                self._refcount[block] -= 1
                if self._refcount[block] == 0:
                    self._cached_free[block] = self._block_key[block]

        if n_blocks - len(hits) > self.available():
            # Leak-guard: the pool cannot host the misses. Checked BEFORE
            # any fresh allocation, so the failure path never evicts
            # cache either.
            _rollback([])
            return None
        blocks = list(hits)
        fresh: List[int] = []
        try:
            for _ in range(n_blocks - len(hits)):
                block = self._alloc_one()
                self._refcount[block] += 1
                fresh.append(block)
        except Exception:
            # A fault mid-allocation (the `spill` injection site, or a
            # real extraction error) must leave the pool exactly as it
            # found it — conservation under injection is the randomized
            # invariant test's contract.
            _rollback(fresh)
            raise
        blocks.extend(fresh)
        self._slot_blocks[idx] = blocks
        self._slot_keys[idx] = keys
        self._slot_indexed[idx] = len(hits)
        self._slot_use_cache[idx] = bool(use_cache)
        # Stage the host hits: blocks[len(hits) : len(hits)+len(spill_keys)]
        # are the revive targets, in prefix order.
        self._slot_revives[idx] = [
            ((len(hits) + j) * self.block_size, blocks[len(hits) + j], key)
            for j, key in enumerate(spill_keys)
        ]
        if spill_keys:
            # Pin the promised host hits against retirement until the
            # engine's revive pump consumes (or abandons) them — on a
            # SHARED tier another replica's put burst could otherwise
            # retire the entry mid-promise. No-op on a private tier.
            self._spill.stage(spill_keys)
        if self._tree is not None:
            # Node edges need token content, not just hashes: remember
            # the prompt's full-block tuples for registration.
            self._slot_blocks_tokens[idx] = [
                tuple(prompt[b * self.block_size : (b + 1) * self.block_size])
                for b in range(len(keys))
            ]
            for key in self._slot_keys[idx][: len(hits)]:
                self._tree.ref(key)
            covered = len(hits) + len(spill_keys)
            if cow is not None:
                # The COW lands in the first block AFTER the covered
                # run — a fresh private page by construction.
                self._slot_cow[idx] = (
                    covered * self.block_size,
                    blocks[covered],
                    pin,
                    cow[0],
                    cow[1],
                )
                self._cow_pins[idx] = pin
                self.cow_hits += 1
                self.cow_hit_tokens += cow[1]
        self.hit_blocks += len(hits)
        self.hit_tokens += len(hits) * self.block_size
        self.spill_hit_blocks += len(spill_keys)
        return blocks, len(hits)

    def claim_cow(
        self, idx: int
    ) -> Optional[Tuple[int, int, Optional[int], str, int]]:
        """Hand the engine slot `idx`'s staged copy-on-write match,
        one-shot: (token offset, destination block, pinned source block
        or None when the source is host-resident, source chain key,
        tokens to copy). The engine performs the copy (budget-charged,
        like a revive) and calls `cow_done` — or lets release() drop
        the pin if the slot dies first."""
        cow = self._slot_cow[idx]
        self._slot_cow[idx] = None
        return cow

    def cow_done(self, idx: int, spill: bool = False) -> None:
        """The engine finished (or abandoned) slot `idx`'s COW copy:
        release the pinned source block. Idempotent; host-sourced COWs
        have no pin and this is a no-op for them."""
        pin = self._cow_pins[idx]
        self._cow_pins[idx] = None
        if pin is None:
            return
        self._refcount[pin] -= 1
        if self._refcount[pin] == 0:
            key = self._block_key[pin]
            if spill and self._spill is not None:
                self._spill_out(pin, key)
                self._spilled.append(pin)
            else:
                self._cached_free[pin] = key

    def claim_revives(self, idx: int) -> List[Tuple[int, int, str]]:
        """Hand the engine slot `idx`'s staged host hits, one-shot:
        (token offset, destination block, chain key) in prefix order.
        The engine performs the copy-ins (budget-charged) and falls back
        to recompute for any key the tier dropped meanwhile."""
        revives = self._slot_revives[idx]
        self._slot_revives[idx] = []
        return revives

    def admit_prewarm_block(
        self,
        key: str,
        chain_tokens: Sequence[Tuple[int, ...]],
        chain_keys: Sequence[str],
        reserve_free: int = 0,
    ) -> Optional[int]:
        """Admit one host-tier block into the device cache AHEAD of any
        request — the cold-replica prewarm path (serving/kv_store.py):
        a freshly created or drain-destination replica pulls the fleet
        store's hot subtree into its own radix cache so turn-one traffic
        hits instead of recomputing.

        Strictly additive by design: allocates ONLY from the plain free
        list (never evicts or reuses existing cache — prewarm must not
        degrade a warm pool), refuses when fewer than ``reserve_free``
        plain blocks would remain (headroom for real admissions), and
        skips keys already device-resident. The block lands refcount-0
        on the cached-free LRU (MRU end: it was judged hot), indexed
        under its chain key with its node chain ensured, exactly as if
        a request had computed and released it. Returns the device
        block for the engine's copy-in, or None (resident / no
        headroom). All pool-state writes stay in this class (NOS011)."""
        if key in self._prefix_index:
            return None
        if len(self._free_blocks) <= reserve_free:
            return None
        block = self._free_blocks.pop()
        self._prefix_index[key] = block
        self._block_key[block] = key
        self._cached_free[block] = key
        if self._tree is not None:
            self._tree.ensure_path(chain_tokens, chain_keys)
        return block

    def publish_to_tier(self, max_blocks: int = 0) -> int:
        """WRITE-THROUGH publish: copy up to ``max_blocks`` indexed
        device blocks (0 = all) into the host tier WITHOUT dropping
        their device residency — the shared-store complement of
        `_spill_out` (which MOVES). A fleet store wants cached content
        visible before this replica dies, drains, or is asked to seed a
        prewarm, not only when HBM pressure happens to demote it; a
        private tier gains nothing from eager copies, so the engine
        only calls this when the tier `is_shared`. Keys already
        host-resident are skipped (the store would just dedup), so the
        steady-state sweep is cheap. Runs on the engine thread — the
        reader's device copy-out must never race the donated cache
        chain. Returns the number of blocks actually put."""
        if self._spill is None:
            return 0
        published = 0
        for key, block in list(self._prefix_index.items()):
            if key in self._spill:
                continue
            payload, nbytes = self._spill_reader(block)
            parent, tokens = "", ()
            if self._tree is not None:
                node = self._tree.node(key)
                if node is not None:
                    tokens = node.tokens
                    parent = node.parent.key if node.parent is not None else ""
            self._spill.put(key, payload, nbytes, parent=parent, tokens=tokens)
            published += 1
            if max_blocks and published >= max_blocks:
                break
        return published

    def publish_slot_chain(self, idx: int) -> int:
        """Targeted write-through publish of ONE slot's indexed prompt
        chain — the handoff-export fast path (serving/disagg.py). The
        per-tick `publish_to_tier` sweep would get these blocks to the
        store eventually; a handoff needs them there NOW, before the
        destination replica's admission stages its revives, or the
        decode side recomputes exactly the prefill this slot just paid
        for. Only blocks `note_progress` has indexed are published
        (completely written by construction); chain metadata comes from
        the slot's own key/token chain, so a tier-less tree or a pruned
        node cannot hole the parent links. Keys already host-resident
        are skipped (the store would dedup). Runs on the engine thread
        like every spill copy-out. Returns the number of blocks put."""
        if self._spill is None:
            return 0
        published = 0
        keys = self._slot_keys[idx][: self._slot_indexed[idx]]
        for b, key in enumerate(keys):
            if key in self._spill:
                continue
            block = self._prefix_index.get(key)
            if block is None:
                # Lost the indexing race to a concurrent same-prefix
                # slot whose copy was since evicted: this slot's private
                # duplicate holds identical bytes (content addressing).
                block = self._slot_blocks[idx][b]
            payload, nbytes = self._spill_reader(block)
            parent = keys[b - 1] if b > 0 else ""
            tokens = self._slot_blocks_tokens[idx][b]
            self._spill.put(key, payload, nbytes, parent=parent, tokens=tokens)
            published += 1
        return published

    def _alloc_one(self) -> int:
        """One block, cheapest casualty first: the plain free list, then
        a spilled block (its content already lives on host — reuse
        destroys nothing), then evict the LRU cached-free block. With a
        spill tier attached the evicted block's contents move to host
        FIRST ("spill before eviction" — the tentpole's graceful
        degradation: pressure demotes the prefix cache a tier instead of
        destroying it); without one the index entry dies as before.
        Callers check `available()` first; an empty pool here is a
        bookkeeping bug."""
        if self._free_blocks:
            return self._free_blocks.pop()
        if self._spilled:
            return self._spilled.pop()
        block = next(iter(self._cached_free))
        if self._tree is not None:
            # Subtree-LRU: the oldest resting block whose node has no
            # device-resident child — leaves evict before trunks, so a
            # hot path's device run is never holed by its own LRU (and
            # the walk's device-then-host shape stays prefix-closed).
            # Falls back to the plain oldest when every candidate is an
            # interior node (possible under COW pins).
            for cand, cand_key in self._cached_free.items():
                if not self._tree.has_resident_child(cand_key, self._on_device):
                    block = cand
                    break
        key = self._cached_free[block]
        if self._spill is not None:
            if self._faults is not None:
                # Injection BEFORE the extraction and index drop: a
                # raised spill leaves the cached entry fully intact.
                self._faults.check("spill")
            self._spill_out(block, key)
            self._cached_free.pop(block)
        else:
            self._cached_free.pop(block)
            del self._prefix_index[key]
            del self._block_key[block]
            if self._tree is not None:
                # Tier-less eviction destroys the node's only copy:
                # prune it (or leave a tombstone for resident
                # descendants — it ends hit runs, like a missing key).
                self._tree.note_nonresident(key, self._resident)
        self.evictions += 1
        if self._recorder is not None:
            self._recorder.record(constants.FLIGHT_EV_EVICT, block=block)
        return block

    # -- prefill progress ----------------------------------------------------
    def note_progress(self, idx: int, cursor: int) -> None:
        """The slot's prefill cursor advanced to `cursor` (dispatched):
        every full prompt block now completely written becomes
        shareable — index it under its chain key. Already-indexed keys
        (a concurrent slot won the race with identical content) keep
        their existing block; this slot's duplicate stays private and
        returns to the plain free list on release."""
        keys = self._slot_keys[idx]
        done = min(len(keys), cursor // self.block_size)
        for b in range(self._slot_indexed[idx], done):
            block = self._slot_blocks[idx][b]
            if keys[b] not in self._prefix_index and block not in self._block_key:
                self._prefix_index[keys[b]] = block
                self._block_key[block] = keys[b]
                if self._tree is not None:
                    # Find-or-create the node chain (an ancestor pruned
                    # by a tier-less eviction re-creates as a tombstone)
                    # and count this slot's table mapping on the node.
                    self._tree.ensure_path(
                        self._slot_blocks_tokens[idx][: b + 1], keys[: b + 1]
                    )
                    self._tree.ref(keys[b])
        self._slot_indexed[idx] = max(self._slot_indexed[idx], done)

    def register_output(self, idx: int, seq: Sequence[int]) -> None:
        """Multi-turn re-admission's enabler (radix mode only): key the
        full blocks slot `idx`'s GENERATED tokens completed. `seq` is
        the request's whole token sequence — original prompt + replay +
        generated output, exactly what a follow-up turn re-submits as
        its history. Every block fully covered by `seq[:-1]` (the last
        token's KV is never written — it was sampled, not re-attended)
        holds KV bit-identical to what a monolithic prefill of `seq`
        would write (the replay-exactness property: restored
        slots replay generated tokens through prefill and continue
        bit-identically, greedy AND temperature), so a later walk may
        serve them like any prompt block. Called at request completion,
        BEFORE the slot releases; blocks another slot already indexed
        stay private, like the note_progress race."""
        if self._tree is None or not self._slot_use_cache[idx]:
            return
        bs = self.block_size
        n_full = max(0, (len(seq) - 1) // bs)
        existing = len(self._slot_keys[idx])
        if n_full <= existing or n_full > len(self._slot_blocks[idx]):
            return
        keys = prompt_chain_keys(seq, bs, self.key_salt)[:n_full]
        blocks_tokens = [tuple(seq[b * bs : (b + 1) * bs]) for b in range(n_full)]
        for b in range(existing, n_full):
            block = self._slot_blocks[idx][b]
            if keys[b] in self._prefix_index or block in self._block_key:
                continue
            self._prefix_index[keys[b]] = block
            self._block_key[block] = keys[b]
            self._tree.ensure_path(blocks_tokens[: b + 1], keys[: b + 1])
            self._tree.ref(keys[b])
            self.output_blocks += 1

    # -- release / reset -----------------------------------------------------
    def release(self, idx: int, spill: bool = False) -> None:
        """Return slot `idx`'s references. Refcounts decrement instead
        of freeing; a block reaching 0 retires to the cached-free LRU if
        its content is indexed (reusable on a later hit) and to the
        plain free list otherwise.

        `spill=True` (slot preemption, runtime/quota.py): keyed
        refcount-0 blocks go straight to the HOST tier instead of the
        device LRU — their device blocks join the allocatable `spilled`
        state, so the preemption frees HBM immediately while the
        preempted prefix stays one copy-in away. No-op distinction when
        no tier is attached (falls back to the normal retirement)."""
        spill = spill and self._spill is not None
        if spill and self._faults is not None:
            # Entry-site injection: a raised preemption-spill leaves the
            # slot's references fully intact (the caller re-raises into
            # the engine's fault classification).
            self._faults.check("spill", slot=idx)
        # An unconsumed COW pin dies with the slot (the copy never
        # dispatched; the source just returns to rest/host).
        self.cow_done(idx, spill=spill)
        for block in self._slot_blocks[idx]:
            self._refcount[block] -= 1
            key = self._block_key.get(block)
            if key is not None and self._tree is not None:
                # This table's mapping of the node's indexed block ends
                # (private duplicates have no key and were never
                # counted). Residency keeps the node from pruning.
                self._tree.unref(key, self._resident)
            if self._refcount[block] == 0:
                if key is None:
                    self._free_blocks.append(block)
                elif spill:
                    self._spill_out(block, key)
                    self._spilled.append(block)
                else:
                    self._cached_free[block] = key
        self._slot_blocks[idx] = []
        self._slot_keys[idx] = []
        self._slot_indexed[idx] = 0
        if self._slot_revives[idx] and self._spill is not None:
            # Unclaimed staged revives die with the slot: release their
            # stage pins so a dead slot never wedges shared-tier
            # retirement. Claimed revives' pins are the engine's to
            # drop (take() consumes them; abandonment unstages).
            self._spill.unstage([key for _, _, key in self._slot_revives[idx]])
        self._slot_revives[idx] = []
        self._slot_blocks_tokens[idx] = []
        self._slot_use_cache[idx] = False
        self._slot_cow[idx] = None
        if self._tree is not None and len(self._tree) > 4 * self.total_blocks:
            # Amortized tombstone sweep: host-tier LRU drops lose
            # residency without a callback, so dead leaf chains only
            # disappear here. The bound keeps the tree O(pool + tier).
            self._tree.sweep(self._resident)

    def reset(self) -> None:
        """Forget the DEVICE pool — cached content included. Used when
        the engine reallocates the pool after a failure: the blocks' K/V
        no longer exists, so serving the device index would be serving
        zeros. The host spill tier is deliberately NOT reset: its
        payloads are plain host memory, valid regardless of device
        state, and post-recovery replays are exactly the traffic that
        wants to hit them."""
        self._free_blocks = list(range(1, self.total_blocks))
        self._cached_free = OrderedDict()
        self._refcount = [0] * self.total_blocks
        self._slot_blocks = [[] for _ in range(self.n_slots)]
        self._prefix_index = {}
        self._block_key = {}
        self._slot_keys = [[] for _ in range(self.n_slots)]
        self._slot_indexed = [0] * self.n_slots
        self._spilled = []
        self._slot_revives = [[] for _ in range(self.n_slots)]
        self._slot_blocks_tokens = [[] for _ in range(self.n_slots)]
        self._slot_use_cache = [False] * self.n_slots
        self._slot_cow = [None] * self.n_slots
        self._cow_pins = [None] * self.n_slots
        if self._spill is not None:
            # Stage pins promised against the dead pool are void; the
            # tier's CONTENT survives (see docstring) — only this
            # engine's holds on it are dropped.
            self._spill.unstage_all()
        if self._tree is not None:
            # Mirror the index/tier split structurally: device nodes die
            # with the pool, host-resident paths survive (with their
            # tombstone ancestors) for post-recovery replays to hit.
            self._tree.device_reset(self._on_host)
