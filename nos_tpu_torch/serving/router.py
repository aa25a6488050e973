"""Port of `nos_tpu/serving/router.py`: `PrefixRouter` (:62), with the
tenant `kv_dtype` pin filter (:281-300) and the store-continuation
scoring (:332-345), copied near verbatim (host-only code; only the
imports point at the port).

PrefixRouter: cache-aware load balancing over a ReplicaSet.

SGLang-style cache-aware routing on top of the engines' content-addressed
prefix index: `submit(prompt, tenant=...)` hashes the prompt's full-block
chain with the SAME sha256 chain-key scheme the engines index under
(runtime/block_manager.py `prompt_chain_keys` — one function, imported by
both sides, so router keys and engine keys agree by construction) and
scores every admitting replica by

    score = shadow_hit_tokens - load_penalty_tokens x load

i.e. the prefix tokens the replica is predicted to serve from cache,
minus a load penalty in the same token currency (`load` is the replica's
probe snapshot: active slots + queued requests + backlog blocks).
`shadow_hit_tokens` is DEEPEST-TREE-MATCH, not longest-chain:
each handle keeps a radix tree over its routed prompts' token-block
edges (the same RadixTree class — and the same walk — the engine's
BlockManager admits through, so the router's prediction and the
engine's admission agree by construction, down to the partial-block
COW match at a mid-block divergence and the below-the-last-token cap,
which both sides take from ONE shared helper,
`block_manager.cacheable_block_cap`). The
argmax wins; exact ties rotate round-robin, which also makes the
no-cache-signal case (cold fleet, disjoint traffic) degrade to plain
round-robin load balancing. `policy="round_robin"` disables the scoring
entirely — the bench A/B baseline.

Per-tenant STICKINESS (default on): the first request of a named tenant
is placed by score and the tenant is pinned to that replica while it
keeps admitting. Two reasons: (a) a tenant's traffic is exactly the
traffic that shares its system prompt, so stickiness IS prefix locality
after the first request; (b) QuotaPolicy accounting is per-engine —
splitting one tenant's stream across replicas would let it borrow N
ceilings' worth of capacity and make every replica's usage window a
partial, incoherent view. A drained/retired replica's pins dissolve:
the next request re-scores and re-pins.

Correctness is placement-independent by construction: every replica runs
the same bit-exact engine, a shadow miss or misroute only means a cold
prefill (performance, never output bytes). The router therefore treats
its shadow as advisory and never blocks on engine state
(docs/serving-cluster.md's staleness argument).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import logging

from nos_tpu_torch import constants
from nos_tpu_torch.runtime.block_manager import cacheable_block_cap, prompt_chain_keys
from nos_tpu_torch.runtime.faults import classify_fault
from nos_tpu_torch.serving.replica import ReplicaHandle, ReplicaSet

logger = logging.getLogger(__name__)


class PrefixRouter:
    """The cluster front end: clients submit here; replicas serve.

    Thread-safe: placement state (round-robin cursor, tenant pins,
    shadows, counters) mutates only under `self._lock`; the chosen
    engine's own queue is the cross-thread boundary for the request
    itself."""

    def __init__(
        self,
        replica_set: ReplicaSet,
        policy: str = constants.ROUTER_POLICY_PREFIX,
        load_penalty_tokens: Optional[float] = None,
        sticky_tenants: bool = True,
        tracer=None,
        kv_store=None,
        quota=None,
    ):
        """`load_penalty_tokens` prices one unit of replica load (an
        active slot / queued request) in prefix-hit tokens; default =
        one block. Higher values favor balance over cache locality.

        `tracer` (optional, nos_tpu/tracing.py Tracer — share the SAME
        instance the replicas' EngineTracing bundles use) opens each
        submitted request's lifecycle trace at the router: the trace
        starts with a `router.select` span (scoring duration + chosen
        replica) and its id is threaded into the engine, so one request
        is one trace from placement to finish — across restores,
        preemptions, and drain migrations.

        `kv_store` (optional, serving/kv_store.py FleetKVStore — the
        SAME instance the replicas' StoreTiers wrap) extends scoring
        one tier down: the device-shadow match's contiguous
        continuation in the shared store is scored at
        `constants.ROUTER_STORE_HIT_WEIGHT` tokens per token — a store
        hit (one host copy-in) beats recompute but loses to a
        device-resident hit, mirroring the engine-side cost order.
        Membership probes only (peek-must-not-perturb: no recency
        touch, no pins), so scoring never changes what the store
        retires next.

        `quota` (optional, duck-typed to runtime/quota.py QuotaPolicy —
        share the instance the replicas use) arms TENANT KV-QUALITY
        routing (docs/quantized-kv.md): a tenant whose TenantShare pins
        `kv_dtype` only ever routes to replicas whose pool matches the
        pin — the router-side half of the engine's ingress rejection,
        so a guaranteed-fp16 tenant simply never sees an int8 replica
        as a candidate. Tenants without a pin score every replica."""
        if policy not in constants.ROUTER_POLICIES:
            raise ValueError(
                f"unknown router policy {policy!r}; "
                f"expected one of {constants.ROUTER_POLICIES}"
            )
        self.replica_set = replica_set
        self.policy = policy
        self.block_size = replica_set.block_size
        self.load_penalty_tokens = float(
            load_penalty_tokens
            if load_penalty_tokens is not None
            else self.block_size
        )
        self.sticky_tenants = bool(sticky_tenants)
        self.tracer = tracer
        self.kv_store = kv_store
        self.quota = quota
        self._lock = threading.Lock()
        self._rr = 0
        self._sticky: Dict[str, str] = {}  # tenant -> replica_id
        # Router counters (fleet telemetry; counts only).
        self.routed_requests = 0
        self.prefix_routed = 0  # placements won by a shadow-hit score
        self.sticky_routed = 0  # placements decided by a tenant pin
        self.rr_routed = 0  # pure rotation (round_robin policy or no signal)
        self.store_routed = 0  # no device signal, but a store-hit score
        self.predicted_hit_tokens = 0
        self.predicted_store_tokens = 0

    # -- client side ----------------------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        max_new: int = 16,
        tenant: Optional[str] = None,
    ) -> Future:
        """Route one request and submit it to the chosen replica's
        engine. Returns that engine's Future — the client never sees
        which replica served it."""
        trace_id = None
        t0 = time.perf_counter()
        handle = self.select(prompt, tenant=tenant)
        if self.tracer is not None:
            trace_id = self.tracer.new_trace()
            self.tracer.event(
                trace_id,
                constants.TRACE_EV_ROUTER_SELECT,
                dur_s=time.perf_counter() - t0,
                replica=handle.replica_id,
            )
        return handle.engine.submit(
            prompt, max_new, tenant=tenant, trace_id=trace_id
        )

    def select(
        self,
        prompt: Sequence[int],
        tenant: Optional[str] = None,
        exclude=None,
        phase: Optional[str] = None,
    ) -> ReplicaHandle:
        """Pick (and account) the destination replica for `prompt`
        without submitting — the placement half of `submit`, also used
        by the drain controller and the fleet supervisor to re-home
        extracted/failed-over work. `exclude` masks one handle or an
        iterable of handles (the draining source before its state
        flips; the set of destinations a failover already saw fail).

        `phase` is the disaggregation axis (constants.ROUTER_PHASES,
        docs/disaggregation.md): the SECOND routing decision. With
        `phase="prefill"` only prefill/unified-role replicas are
        candidates and the scoring prefers free prefill budget (the
        backlog a new prompt would queue behind is double-weighted);
        with `phase="decode"` only decode/unified replicas are
        candidates under the existing device-then-store hit scoring (a
        handoff's KV is in the shared store, so decode placement lands
        where the radix shadow or store continuation says the bytes
        already are). `phase=None` is the pre-disaggregation select,
        byte-for-byte: every admitting replica, one scoring."""
        if phase is not None and phase not in constants.ROUTER_PHASES:
            raise ValueError(
                f"unknown routing phase {phase!r}; "
                f"expected one of {constants.ROUTER_PHASES} or None"
            )
        with self._lock:
            handle, keys, hit_tokens = self._select_locked(
                prompt, tenant, exclude, phase
            )
            handle.note_routed(keys, prompt)
            self.routed_requests += 1
            self.predicted_hit_tokens += hit_tokens
            if self.sticky_tenants and tenant is not None:
                self._sticky[tenant] = handle.replica_id
            return handle

    # -- placement ------------------------------------------------------------
    @staticmethod
    def _excluded_set(exclude) -> frozenset:
        """Normalize `exclude` (None, one handle, or an iterable of
        handles) into an identity set."""
        if exclude is None:
            return frozenset()
        if isinstance(exclude, ReplicaHandle):
            return frozenset({id(exclude)})
        return frozenset(id(h) for h in exclude)

    def _candidates(self, exclude=None, phase=None) -> List[ReplicaHandle]:
        excluded = self._excluded_set(exclude)
        active = [
            h
            for h in self.replica_set.handles
            if h.admitting
            and id(h) not in excluded
            and h.serves_phase(phase)
        ]
        if not active:
            if phase is not None:
                raise RuntimeError(
                    f"no admitting {phase}-capable replica "
                    f"({phase}/unified roles all draining/retired/"
                    "unhealthy/excluded): cannot route"
                )
            raise RuntimeError(
                "no admitting replica (all draining/retired/unhealthy): "
                "cannot route"
            )
        return active

    def _safe_load(
        self, handle: ReplicaHandle, phase: Optional[str] = None
    ) -> Optional[float]:
        """A candidate's load score, or None when its probe raises —
        an unreachable replica must not take scoring down with it (the
        supervisor's health machine will demote it on its own probe
        cadence; here it simply stops being a candidate).

        For `phase="prefill"` the prefill backlog is counted a second
        time: a prefill placement queues behind exactly that backlog
        before its own chunks run, so "free prefill budget" dominates
        the penalty where decode placement weighs backlog only as
        generic busyness. One probe either way — the phase changes the
        arithmetic, not the read."""
        try:
            p = handle.probe()
        except Exception as exc:
            logger.warning(
                "router: load probe of %s failed (%s); skipping candidate",
                handle.replica_id,
                classify_fault(exc),
            )
            return None
        backlog = p[constants.PROBE_KEY_PREFILL_BACKLOG]
        load = (
            p[constants.PROBE_KEY_ACTIVE_SLOTS]
            + p[constants.PROBE_KEY_QUEUED_REQUESTS]
            + backlog / max(1, self.block_size)
        )
        if phase == constants.ROUTER_PHASE_PREFILL:
            load += backlog / max(1, self.block_size)
        return load

    def _select_locked(
        self,
        prompt: Sequence[int],
        tenant: Optional[str],
        exclude,
        phase: Optional[str] = None,
    ) -> Tuple[ReplicaHandle, List[str], int]:
        """Returns (handle, the prompt's cacheable chain keys, predicted
        hit tokens — deepest-tree-match). Caller holds the lock."""
        active = self._candidates(exclude, phase)
        # Tenant KV-quality pin (TenantShare.kv_dtype): candidates whose
        # pool dtype contradicts the pin are not candidates at all —
        # the engine-side ingress check would reject them anyway; the
        # router just never sends the request there.
        pin = None
        if tenant and self.quota is not None:
            pin = getattr(self.quota.share_of(tenant), "kv_dtype", None)
        if pin is not None:
            matched = [
                h
                for h in active
                if getattr(h.engine, "kv_dtype", constants.KV_DTYPE_NATIVE)
                == pin
            ]
            if not matched:
                raise RuntimeError(
                    f"no admitting replica with kv_dtype={pin!r} for "
                    f"tenant {tenant!r} (pin via TenantShare.kv_dtype): "
                    "cannot route"
                )
            active = matched
        # The same below-the-last-token cap admission applies (ONE
        # shared helper — router and engine can never disagree on it):
        # the final block is always recomputed privately, so it can
        # never hit.
        cap = cacheable_block_cap(len(prompt), self.block_size)
        keys = prompt_chain_keys(prompt, self.block_size)[:cap]
        if self.policy == constants.ROUTER_POLICY_ROUND_ROBIN:
            handle = active[self._rr % len(active)]
            self._rr += 1
            self.rr_routed += 1
            return handle, keys, handle.shadow_hit_tokens(prompt)
        if self.sticky_tenants and tenant is not None:
            pinned = self._sticky.get(tenant)
            if pinned is not None:
                for h in active:
                    if h.replica_id == pinned:
                        self.sticky_routed += 1
                        return h, keys, h.shadow_hit_tokens(prompt)
                # Pin points at a draining/retired replica: dissolve it
                # and fall through to a fresh scored placement.
                del self._sticky[tenant]
        store_run = 0
        scored = []
        for h in active:
            load = self._safe_load(h, phase)
            if load is None:
                continue  # unreachable probe: not a candidate this round
            hit = h.shadow_hit_tokens(prompt)
            score = hit - self.load_penalty_tokens * load
            store_tokens = 0
            if self.kv_store is not None:
                # The device match's CONTIGUOUS continuation in the
                # shared store: blocks this replica would revive by
                # copy-in instead of recompute. Discounted (< 1 token
                # per token) so a genuine device hit elsewhere still
                # wins — store > recompute, device > store.
                run = 0
                for key in keys[hit // self.block_size :]:
                    if key not in self.kv_store:
                        break
                    run += 1
                store_tokens = run * self.block_size
                score += constants.ROUTER_STORE_HIT_WEIGHT * store_tokens
            scored.append((score, h, hit, store_tokens))
        if not scored:
            raise RuntimeError(
                "no admitting replica (all draining/retired/unhealthy): "
                "cannot route"
            )
        best = max(score for score, _, _, _ in scored)
        ties = [
            (h, hit, st) for score, h, hit, st in scored if score == best
        ]
        handle, hit_tokens, store_run = ties[self._rr % len(ties)]
        self._rr += 1
        self.predicted_store_tokens += store_run
        if hit_tokens > 0:
            self.prefix_routed += 1
        elif store_run > 0:
            self.store_routed += 1
        else:
            self.rr_routed += 1
        return handle, keys, hit_tokens

    # -- shadow maintenance ---------------------------------------------------
    def reconcile(self) -> None:
        """Replace every admitting replica's shadow with engine truth
        (device index + host tier — host-side reads, no device
        traffic). Optimistic routing entries for work that was evicted,
        spilled away, or never finished prefilling are corrected here;
        between reconciles, staleness costs routing quality only. An
        engine whose reconcile read raises (unreachable replica the
        supervisor has not yet demoted) keeps its stale shadow — a
        wrong shadow can only misroute."""
        with self._lock:
            for h in self.replica_set.active_handles():
                try:
                    h.reconcile_shadow()
                except Exception as exc:
                    logger.warning(
                        "router: shadow reconcile of %s failed (%s); "
                        "keeping the stale shadow",
                        h.replica_id,
                        classify_fault(exc),
                    )

    def dissolve_pins(self, replica_id: str) -> int:
        """Drop every tenant pin pointing at `replica_id` (a dead or
        retiring replica): the next request of each tenant re-scores
        and re-pins. Returns how many pins dissolved. (Pins also
        dissolve lazily at select time when the pinned replica stops
        admitting; the eager form exists so a failover leaves no
        dangling placement state behind at all.)"""
        with self._lock:
            stale = [t for t, rid in self._sticky.items() if rid == replica_id]
            for t in stale:
                del self._sticky[t]
            return len(stale)

    # -- telemetry ------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Router counters + per-replica rows, wire-format."""
        with self._lock:
            return {
                "policy": self.policy,
                "routed_requests": self.routed_requests,
                "prefix_routed": self.prefix_routed,
                "sticky_routed": self.sticky_routed,
                "rr_routed": self.rr_routed,
                "store_routed": self.store_routed,
                "predicted_hit_tokens": self.predicted_hit_tokens,
                "predicted_store_tokens": self.predicted_store_tokens,
                "replicas": self.replica_set.snapshot(),
            }
