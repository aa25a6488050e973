"""Port of `nos_tpu/serving/replica.py`: `ReplicaHandle` (:74) and
`ReplicaSet` (:225), with `add`'s prewarm (:288-327) and `fleet_report`
(:329), copied near verbatim (host-only code; only the imports point at
the port). The engines are the port's `DecodeServer`s: on one card the
replicas of a set share the device, each with its own pool and its own
captured decode window.

ReplicaSet/ReplicaHandle: the registry of the cluster serving plane.

This is the layer ROADMAP item 2 names: the repo's nos half (the
partitioning planner that carves ICI-contiguous sub-slices) and its
serving half (DecodeServer + BlockManager + QuotaPolicy) finally touch.
A `ReplicaSet` owns N serving replicas — in the intended deployment one
`DecodeServer` per planner-carved sub-slice, in tests and the CPU bench
N CPU-backed engines — and tracks, per replica:

  - **identity and lifecycle**: a stable id
    (`constants.REPLICA_ID_PREFIX + ordinal`) and a drain state
    (`active` -> `draining` -> `retired`, the serving port of the
    planner's create -> drain -> delete move protocol —
    nos_tpu/serving/drain.py);
  - **load**: the engine's `probe()` snapshot (active slots, queued
    requests, prefill backlog) — plain host reads, no device traffic;
  - a router-side **shadow of the replica's prefix index**: the chain
    keys (runtime/block_manager.py `chain_key` sha256 chain) the router
    believes are resident on that replica, PLUS a router-side
    RADIX TREE over the routed prompts' token-block edges — the same
    `RadixTree` class the engine's BlockManager walks, so
    deepest-tree-match scoring (`shadow_hit_tokens`: full resident run
    + the partial-block COW match the engine would stage) shares the
    engine's key and walk code BY CONSTRUCTION. The shadow is updated
    OPTIMISTICALLY at routing time (the routed prompt's full blocks will
    index as its prefill dispatches) and reconciled against engine truth
    (`DecodeServer.prefix_keys()`, again host-side dict reads) on
    demand: the key SET is replaced wholesale and the shadow tree's
    dead structure pruned against it. The tree deliberately
    under-predicts multi-turn hits (the router never sees generated
    tokens, so output-registered blocks are invisible until the same
    conversation re-routes — sticky tenants land it on the right
    replica anyway). Staleness is safe by construction: a wrong shadow
    can only misroute, and a misrouted request simply prefills cold —
    outputs are bit-identical regardless of placement
    (docs/serving-cluster.md).

Replica construction contract: every engine in one set must share
`block_size` (router keys and engine keys must agree — enforced here).
Tensor-parallel widths may MIX freely (docs/sharded-decode.md): a tp=2
replica and a tp=1 replica serve bit-identical streams (the sharded
engine's exactness oracle), checkpoints/spill payloads are
width-agnostic host bytes, so drain/migrate crosses widths — the probe
carries each replica's `tp_devices` for capacity accounting, and
`fleet_report()` sums it
and, for temperature traffic to survive drain/migrate bit-identically,
the same params/config/sampling seed (a migrated checkpoint keeps its
serial and PRNG step, which only reproduces the stream on an engine
sampling from the same base key — documented, not enforced: greedy
traffic has no such requirement). For request-lifecycle tracing
(nos_tpu/tracing.py, docs/tracing.md) the same shape of contract
applies: give every replica's EngineTracing bundle — and the
PrefixRouter — ONE shared Tracer, so a drain-migrated stream's trace id
(riding its SlotCheckpoint) keeps appending to the trace the router
opened; flight recorders and tick profilers stay per-engine, and
`fleet_report()` pools their host-overhead/dispatch samples like every
other tail.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import logging

from nos_tpu_torch import constants
from nos_tpu_torch.runtime.faults import classify_fault
from nos_tpu_torch.runtime.radix_tree import RadixTree
from nos_tpu_torch.telemetry import ServingReport, collect_serving

logger = logging.getLogger(__name__)


class ReplicaHandle:
    """One serving replica: the engine, its router-visible identity and
    drain state, and the router's shadow of its prefix index. Mutable
    state (state, shadow, counters) is owned by the router/set layer —
    the handle itself takes no locks; PrefixRouter serializes mutation
    under its own lock."""

    def __init__(
        self,
        replica_id: str,
        engine,
        role: str = constants.REPLICA_ROLE_UNIFIED,
    ):
        if role not in constants.REPLICA_ROLES:
            raise ValueError(
                f"unknown replica role {role!r}; expected one of "
                f"{constants.REPLICA_ROLES}"
            )
        self.replica_id = replica_id
        self.engine = engine
        #: Placement role (docs/disaggregation.md): which PHASE of work
        #: the router sends here. `unified` (default) serves both
        #: phases — the pre-disaggregation fleet byte-for-byte. A role
        #: is a routing preference, not a capability limit: every
        #: engine can run both phases, which is why failover may land a
        #: decode stream on a prefill-role survivor.
        self.role = role
        self.state = constants.REPLICA_STATE_ACTIVE
        #: Health axis (serving/supervisor.py, docs/robustness.md):
        #: what PROBING observed of the replica, beside the lifecycle
        #: axis above (what the operator asked of it). active ->
        #: suspect (K consecutive probe failures) -> dead (failover);
        #: suspect -> active only after a full healthy window. Without
        #: a supervisor it stays `active` forever — the pre-supervisor
        #: fleet byte-for-byte.
        self.health = constants.REPLICA_HEALTH_ACTIVE
        #: Router-side shadow of the replica's content-addressed prefix
        #: index: chain keys believed resident (device or host tier).
        self.shadow: set = set()
        #: Structural shadow: the routed prompts' token-block
        #: edges, for deepest-tree-match scoring. Residency stays in
        #: `shadow` — the tree walk takes it as a predicate, exactly
        #: like the engine's tree takes its index.
        self.shadow_tree = RadixTree()
        #: Requests the router has placed on this replica (lifetime).
        self.routed_requests = 0

    @property
    def admitting(self) -> bool:
        """Whether the router may place new work here: lifecycle ACTIVE
        *and* health ACTIVE — a suspect replica is excluded from
        placement until it clears a full healthy probe window, a dead
        one forever (the router-never-selects-a-dead-replica half of
        the failover contract)."""
        return (
            self.state == constants.REPLICA_STATE_ACTIVE
            and self.health == constants.REPLICA_HEALTH_ACTIVE
        )

    def serves_phase(self, phase: Optional[str]) -> bool:
        """Whether this replica's role accepts `phase` placements
        (constants.ROUTER_PHASES; None = any role — the pre-disagg
        select). Unified replicas serve every phase; specialized ones
        serve their own."""
        if phase is None or self.role == constants.REPLICA_ROLE_UNIFIED:
            return True
        return self.role == phase

    def probe(self) -> Dict[str, object]:
        """The engine's load snapshot (constants.PROBE_KEY_*)."""
        return self.engine.probe()

    def load(self) -> float:
        """Scalar load estimate for routing penalties, in slot-ish
        units: active slots + queued requests + prefill backlog scaled
        by the engine's block size (a 4k-token backlog weighs more than
        an idle slot's worth of queue depth)."""
        p = self.probe()
        backlog = p[constants.PROBE_KEY_PREFILL_BACKLOG]
        return (
            p[constants.PROBE_KEY_ACTIVE_SLOTS]
            + p[constants.PROBE_KEY_QUEUED_REQUESTS]
            + backlog / max(1, self.engine.block_size)
        )

    def shadow_hit_blocks(self, keys: List[str]) -> int:
        """Longest leading run of `keys` present in the shadow — the
        flat-chain prediction, kept for consumers that score in whole
        blocks (and as the flat-chain baseline shape)."""
        hit = 0
        for key in keys:
            if key not in self.shadow:
                break
            hit += 1
        return hit

    def shadow_hit_tokens(self, prompt: Sequence[int]) -> int:
        """Deepest-tree-match prediction, in TOKENS: the resident run's
        full blocks plus the partial-block COW match the engine would
        stage at the divergence point — the same walk
        (`RadixTree.match`) the engine's admission runs, against the
        shadow's believed-resident key set."""
        resident_keys, _, cow = self.shadow_tree.match(
            prompt, self.engine.block_size, lambda key: key in self.shadow
        )
        return len(resident_keys) * self.engine.block_size + (
            cow[1] if cow is not None else 0
        )

    def note_routed(self, keys: Iterable[str], prompt: Optional[Sequence[int]] = None) -> None:
        """Optimistic shadow update at routing time: the routed prompt's
        full blocks will be indexed as its prefill dispatches. With the
        prompt given, its token-block edges join the shadow tree too
        (deepest-match scoring needs content, not just hashes)."""
        keys = list(keys)
        self.shadow.update(keys)
        if prompt is not None and keys:
            self.shadow_tree.insert_path(
                prompt, self.engine.block_size, len(keys)
            )
        self.routed_requests += 1

    def reconcile_shadow(self) -> None:
        """Replace the shadow with engine truth (device index + host
        tier) and prune the shadow tree's dead structure against it.
        Host-side reads only — the 'no new device traffic' contract of
        the shadow design."""
        self.shadow = set(self.engine.prefix_keys())
        self.shadow_tree.sweep(lambda key: key in self.shadow)

    def snapshot(self) -> Dict[str, object]:
        """Wire-format view of the replica for fleet telemetry. An
        unreachable engine's probe must not take the whole fleet
        snapshot down with it: the failure classifies through the fault
        taxonomy and the row carries `probe_error` instead of load
        keys — identity and state always report."""
        try:
            probe = self.probe()
        except Exception as exc:
            probe = {"probe_error": classify_fault(exc)}
        return {
            constants.REPLICA_KEY_ID: self.replica_id,
            constants.REPLICA_KEY_STATE: self.state,
            constants.REPLICA_KEY_HEALTH: self.health,
            constants.REPLICA_KEY_ROLE: self.role,
            constants.REPLICA_KEY_SHADOW_KEYS: len(self.shadow),
            constants.REPLICA_KEY_ROUTED_REQUESTS: self.routed_requests,
            **probe,
        }


class ReplicaSet:
    """Owns N serving replicas. Construction validates the cross-replica
    contract (equal block sizes — the router computes ONE key chain per
    prompt); `start=True` spins each engine's loop thread, `start=False`
    leaves them for deterministic manual ticking (tests)."""

    def __init__(
        self,
        engines: Iterable,
        start: bool = False,
        roles: Optional[Sequence[str]] = None,
    ):
        engines = list(engines)
        if not engines:
            raise ValueError("ReplicaSet needs at least one engine")
        sizes = {e.block_size for e in engines}
        if len(sizes) != 1:
            raise ValueError(
                f"replicas must share one block_size (router keys and "
                f"engine keys agree by construction), got {sorted(sizes)}"
            )
        if roles is not None and len(list(roles)) != len(engines):
            raise ValueError(
                f"roles ({len(list(roles))}) must match engines "
                f"({len(engines)}) one-to-one"
            )
        self.block_size = engines[0].block_size
        self._next_ordinal = 0
        self.handles: List[ReplicaHandle] = []
        for i, engine in enumerate(engines):
            self._add_handle(
                engine,
                role=(
                    roles[i] if roles is not None
                    else constants.REPLICA_ROLE_UNIFIED
                ),
            )
        if start:
            for h in self.handles:
                h.engine.start()

    def _add_handle(
        self, engine, role: str = constants.REPLICA_ROLE_UNIFIED
    ) -> ReplicaHandle:
        handle = ReplicaHandle(
            f"{constants.REPLICA_ID_PREFIX}{self._next_ordinal}",
            engine,
            role=role,
        )
        self._next_ordinal += 1
        self.handles.append(handle)
        return handle

    # -- registry -------------------------------------------------------------
    def get(self, replica_id: str) -> ReplicaHandle:
        for h in self.handles:
            if h.replica_id == replica_id:
                return h
        raise KeyError(f"no such replica: {replica_id}")

    def active_handles(self) -> List[ReplicaHandle]:
        return [h for h in self.handles if h.admitting]

    def add(
        self,
        engine,
        start: bool = False,
        prewarm: bool = True,
        role: str = constants.REPLICA_ROLE_UNIFIED,
    ) -> ReplicaHandle:
        """Register a new replica (the CREATE step of the move protocol:
        grow the fleet first, then drain the source into it).

        An engine wired to the fleet KV store (serving/kv_store.py)
        PREWARMS on registration: its hot-subtree revives are queued
        from the shared store before any traffic routes here, so the
        created replica — the drain destination, the scale-out target —
        starts with the fleet's working set instead of stone cold
        (copy-ins drain through the engine's own prefill budget; this
        call only stages them). `prewarm=False` opts out (the cold-arm
        A/B baseline); engines without the hook are unaffected."""
        if engine.block_size != self.block_size:
            raise ValueError(
                f"new replica block_size {engine.block_size} != fleet "
                f"block_size {self.block_size}"
            )
        handle = self._add_handle(engine, role=role)
        pw = getattr(engine, "prewarm_from_store", None)
        if prewarm and pw is not None:
            try:
                pw()
            except Exception:  # nos-lint: ignore[NOS012] prewarm is best-effort, not a recovery path
                # Prewarm is a performance head start, never a liveness
                # dependency: a cold replica is still a correct replica.
                logger.warning(
                    "replica %s: prewarm_from_store failed; starting cold",
                    handle.replica_id,
                    exc_info=True,
                )
        if start:
            engine.start()
        return handle

    # -- fleet telemetry ------------------------------------------------------
    def fleet_report(self) -> ServingReport:
        """One merged ServingReport over every non-retired replica:
        counters summed, latency percentiles re-derived from pooled raw
        samples (telemetry.ServingReport.merge)."""
        return ServingReport.merge(
            collect_serving(h.engine)
            for h in self.handles
            if h.state != constants.REPLICA_STATE_RETIRED
        )

    def snapshot(self) -> List[Dict[str, object]]:
        """Per-replica wire-format rows (id, state, load, shadow size)."""
        return [h.snapshot() for h in self.handles]

    # -- lifecycle ------------------------------------------------------------
    def retire(self, replica_id: str) -> ReplicaHandle:
        """Stop one replica and mark it RETIRED (the bare DELETE step —
        callers that need its in-flight work preserved drain first via
        serving/drain.py). Retirement is the gauge-hygiene boundary:
        `fleet_report` stops merging the replica immediately, and a
        `FleetMonitor` observing the set drops the replica's rate rings
        and removes its per-replica `nos_tpu_fleet_*` gauge series on
        its next sample — a retired replica must disappear from
        /metrics, not freeze at its last value."""
        handle = self.get(replica_id)
        if handle.state != constants.REPLICA_STATE_RETIRED:
            try:
                handle.engine.stop()
            except Exception as exc:
                # A DEAD replica's stop may itself be unreachable; the
                # retirement (and its gauge hygiene) must proceed
                # anyway — the supervisor already took ownership of the
                # streams (forsake/failover) before retiring it.
                logger.warning(
                    "retire(%s): engine.stop failed (%s); retiring anyway",
                    replica_id,
                    classify_fault(exc),
                )
            handle.state = constants.REPLICA_STATE_RETIRED
        return handle

    def stop(self, drain: bool = False, drain_timeout_s: Optional[float] = None):
        """Stop every non-retired replica (drain=True: gracefully)."""
        for h in self.handles:
            if h.state == constants.REPLICA_STATE_RETIRED:
                continue
            h.engine.stop(drain=drain, drain_timeout_s=drain_timeout_s)
            h.state = constants.REPLICA_STATE_RETIRED
