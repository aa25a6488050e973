"""Port of the serving half of `nos_tpu/telemetry.py`: `ServingReport`
(:88), `percentile` (:376), `report_counter_fields` (:425), `report_delta`
(:435), `report_rates` (:470), `collect_serving` (:487) and
`export_serving` (:633), copied near verbatim.

`collect_serving` snapshots a DecodeServer's engine counters into a
`ServingReport`: pure numbers, never tokens or prompts. It duck-types
with `getattr`; the port's engine has every counter it reads, the fleet
KV store's included (`store_*`, `prewarm_tokens`,
`failover_revive_tokens`) and phase disaggregation's handoff counters.
The supervisor's and the handoff coordinator's counters come from their
`report()`, merged beside the replicas' reports.
`export_serving` ships the report only when the caller opts in.

The cluster half (:33-84), copied verbatim over the port's control plane:
`ClusterReport`, whose `version` is the port's `__version__`, `collect`,
which counts nodes, TPU chips, partitioning modes and quotas on a
`nos_tpu_torch.cluster.Cluster` (or a `KubeCluster`), and `export`, which
ships that report only when the caller opts in.
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict, dataclass, field, fields
from typing import Callable, Dict, Iterable, List, Optional

import nos_tpu_torch
from nos_tpu_torch import constants
from nos_tpu_torch.cluster.client import Cluster

logger = logging.getLogger(__name__)


@dataclass
class ClusterReport:
    version: str = nos_tpu_torch.__version__
    node_count: int = 0
    tpu_nodes: int = 0
    gpu_nodes: int = 0
    tpu_chips: int = 0
    partitioning_modes: Dict[str, int] = field(default_factory=dict)
    elastic_quotas: int = 0
    composite_quotas: int = 0


def collect(cluster: Cluster) -> ClusterReport:
    report = ClusterReport()
    for node in cluster.list("Node"):
        report.node_count += 1
        labels = node.metadata.labels
        if constants.LABEL_TPU_ACCELERATOR in labels:
            report.tpu_nodes += 1
            report.tpu_chips += int(
                node.status.allocatable.get(constants.RESOURCE_TPU, 0)
            )
        if constants.LABEL_GPU_PRODUCT in labels:
            report.gpu_nodes += 1
        mode = labels.get(constants.LABEL_PARTITIONING)
        if mode:
            report.partitioning_modes[mode] = report.partitioning_modes.get(mode, 0) + 1
    report.elastic_quotas = len(cluster.list("ElasticQuota"))
    report.composite_quotas = len(cluster.list("CompositeElasticQuota"))
    return report


def export(
    cluster: Cluster,
    share_telemetry: bool = False,
    sink: Optional[Callable[[str], None]] = None,
) -> Optional[ClusterReport]:
    """Collect and (when opted in) ship the report. Returns the report, or
    None when telemetry is disabled."""
    if not share_telemetry:
        logger.debug("telemetry disabled (share_telemetry=false)")
        return None
    report = collect(cluster)
    payload = json.dumps(asdict(report), sort_keys=True)
    if sink is None:
        # Zero-egress default: log instead of POSTing.
        logger.info("telemetry report: %s", payload)
    else:
        sink(payload)
    return report


@dataclass
class ServingReport:
    """Counter snapshot of one DecodeServer engine. The field list IS the
    schema — counts only, never request content."""

    steps_run: int = 0
    macro_dispatches: int = 0
    spec_rounds: int = 0
    spec_tokens_accepted: int = 0
    spec_demotions: int = 0
    # Per-draft-source speculation split (docs/speculation.md): verify
    # windows, accepted tokens, and demotions by which source drafted —
    # the radix tree's stored continuation vs the slot's prompt-lookup
    # history. Sources partition the totals (tree + history accepted ==
    # spec_tokens_accepted).
    spec_tree_rounds: int = 0
    spec_history_rounds: int = 0
    spec_tree_tokens_accepted: int = 0
    spec_history_tokens_accepted: int = 0
    spec_tree_demotions: int = 0
    spec_history_demotions: int = 0
    # Budgeted-prefill shape: bounded chunk dispatches per tick, and the
    # ticks where prefill and a macro window landed together (the
    # prompt-axis analogue of both_dispatch_ticks).
    prefill_dispatches: int = 0
    prefill_tokens: int = 0
    ticks_with_prefill_and_macro: int = 0
    # Shared-prefix KV reuse: admissions that looked up the
    # content index, full blocks served from cache, the prompt tokens
    # those hits saved the prefill budget, blocks evicted from the
    # cached-free LRU under allocation pressure — plus a pool-state
    # snapshot (free / cached-but-reusable / mapped-by->=2-tables).
    prefix_lookups: int = 0
    prefix_hit_blocks: int = 0
    prefix_hit_tokens: int = 0
    prefix_evictions: int = 0
    kv_blocks_free: int = 0
    kv_blocks_cached: int = 0
    kv_blocks_shared: int = 0
    # Radix-tree prefix cache (docs/radix-cache.md): admissions
    # that staged a mid-block copy-on-write match, the prompt tokens
    # those copies served instead of recompute (prefix_hit_tokens's
    # partial-block sibling — total cached tokens = hit + cow),
    # generated-token blocks keyed at request completion (the
    # multi-turn re-admission enabler), and the tree's node count
    # (a gauge; 0 in flat-chain mode).
    prefix_cow_hits: int = 0
    prefix_cow_tokens: int = 0
    output_blocks_registered: int = 0
    radix_nodes: int = 0
    # Tiered KV + elastic quotas: blocks spilled device -> host
    # instead of destroyed, host-resident blocks revived by copy-in,
    # host entries dropped under host-capacity pressure, bytes resident
    # in the host tier, device blocks in the spilled (host-backed,
    # reusable) state, quota-driven slot preemptions, and ticks where a
    # tenant borrowed capacity above its guaranteed share.
    spills: int = 0
    revives: int = 0
    spill_drops: int = 0
    spill_host_bytes: int = 0
    kv_blocks_spilled: int = 0
    preemptions: int = 0
    borrowed_ticks: int = 0
    # Quantized-KV tier (docs/quantized-kv.md): whether the pool
    # stores int8 codes (gauge 0/1; a fleet merge's sum counts quantized
    # replicas), the pool's actual HBM bytes including scale arrays
    # (gauge; merge sums fleet HBM), and tier payloads rejected for a
    # wire-dtype mismatch (counter; nonzero means a mis-wired fleet —
    # dtype-salted chain keys make it unreachable through the store).
    kv_quant_enabled: int = 0
    kv_pool_bytes: int = 0
    kv_quant_payload_rejected: int = 0
    # Fleet KV store (serving/kv_store.py, docs/kv-store.md):
    # per-engine traffic against the SHARED content-addressed cold tier
    # — revive reads served / staged revives the store had retired /
    # blocks pushed (spill + write-through publish) / puts that found
    # the key already resident (the N-replicas-one-copy dedup witness)
    # — plus prewarm copy-in tokens (cold replica warming from the
    # store) and failover replay tokens served from store bytes instead
    # of recompute. All zero on a private SpillTier. store_bytes /
    # store_entries are GAUGES on the one shared store: every replica
    # reports the same store, so a fleet merge's sum reads ~N x the
    # store (divide by `replicas`, or read one replica — the tp_devices
    # caveat one tier down).
    store_hits: int = 0
    store_misses: int = 0
    store_puts: int = 0
    store_dedup_hits: int = 0
    store_published_blocks: int = 0
    prewarm_tokens: int = 0
    failover_revive_tokens: int = 0
    store_bytes: int = 0
    store_entries: int = 0
    # Per-request latency tails (seconds; 0.0 when no samples yet).
    # TTFT is submit -> final-prefill-chunk dispatch; queue wait is
    # submit -> slot reservation.
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    queue_wait_p50_s: float = 0.0
    queue_wait_p95_s: float = 0.0
    # Failure model (docs/robustness.md): surgical recoveries run
    # (transient retries counted separately — a retry tears nothing
    # down), slots checkpointed+re-admitted, prompt+generated tokens
    # replayed through prefill to re-derive KV, requests failed as
    # poison, legacy fail-all sweeps (0 while surgical recovery holds),
    # and the restore-latency tails (fault detection -> the restored
    # slot's replayed final chunk dispatches).
    recoveries: int = 0
    slots_restored: int = 0
    replay_tokens: int = 0
    requests_poisoned: int = 0
    transient_retries: int = 0
    fail_all_recoveries: int = 0
    restore_latency_p50_s: float = 0.0
    restore_latency_p95_s: float = 0.0
    # Fleet failure domains (nos_tpu/serving/supervisor.py,
    # docs/robustness.md): replicas demoted to suspect / declared dead
    # by the supervisor's health machine, streams re-homed onto a
    # survivor (failovers == futures_failed_over today; kept separate so
    # a future partial-failover can diverge them), checkpointed tokens
    # replayed by failovers, and futures resolved with a classified
    # ReplicaLostError (no checkpoint — client resubmits). Zero on plain
    # engines; populated by FleetSupervisor.report() and pooled by
    # `merge` like every other counter. The failover-latency percentiles
    # re-derive from pooled samples (detection -> last stream placed).
    replica_suspects: int = 0
    replica_deaths: int = 0
    failovers: int = 0
    failover_replay_tokens: int = 0
    futures_failed_over: int = 0
    futures_errored: int = 0
    failover_latency_p50_s: float = 0.0
    failover_latency_p95_s: float = 0.0
    # Phase-disaggregated handoff plane (nos_tpu/serving/disagg.py,
    # docs/disaggregation.md): prefill-complete slots EXPORTED by a
    # prefill-role engine (checkpoint captured, chain published,
    # slot released), checkpoints INGESTED by a decode-role engine
    # through transfer_in_checkpoint, KV blocks force-published at the
    # export point, prompt tokens the destination REVIVED from store
    # payloads instead of recomputing (the "shipped, not replayed"
    # witness — an export whose destination recomputed shows up as
    # handoff_exports > 0 with revived tokens ~0), completed handoffs
    # seen by the coordinator, destination re-routes after a mid-revive
    # death, and handoffs resolved with a classified error (no
    # survivor). Latency percentiles re-derive from pooled samples
    # (export capture -> destination accepted), same contract as
    # failover latency.
    handoff_exports: int = 0
    handoff_ingests: int = 0
    handoff_published_blocks: int = 0
    handoff_revived_tokens: int = 0
    handoffs: int = 0
    handoff_reroutes: int = 0
    handoffs_errored: int = 0
    handoff_latency_p50_s: float = 0.0
    handoff_latency_p95_s: float = 0.0
    # Total wall seconds spent inside handoffs (export capture ->
    # destination accepted), summed across replicas by `merge` (a
    # MERGE_FLOAT_FIELDS member): the in-transfer exposure window the
    # failover machinery must cover, as an accumulated-seconds quantity
    # beside the per-handoff percentiles above.
    handoff_wall_s: float = 0.0
    # Decoupled-round shape: ticks that dispatched a verify AND a macro
    # window (neighbors kept the pipeline while a slot speculated), and
    # the per-slot split totals.
    both_dispatch_ticks: int = 0
    macro_tokens_by_slot: Dict[str, int] = field(default_factory=dict)
    spec_rounds_by_slot: Dict[str, int] = field(default_factory=dict)
    # Fused macro bursts + the host-sync budget (runtime/staging.py):
    # burst programs dispatched and the macro
    # windows they fused (steps_run counts a burst as ONE dispatch —
    # dispatches-per-token is the point), host->device uploads through
    # the counted staging funnel, packed TickState syncs (<= 1 per
    # host-event tick), blocking device->host materializations, and
    # ticks served by the O(1) idle fast path.
    burst_dispatches: int = 0
    burst_windows_run: int = 0
    h2d_uploads: int = 0
    staging_syncs: int = 0
    blocking_syncs: int = 0
    idle_ticks: int = 0
    # Tensor-parallel width (docs/sharded-decode.md): devices this
    # engine's mesh spans (1 = single-device). Merge SUMS the field —
    # the fleet total is "devices serving", the capacity denominator
    # for per-chip-hour accounting. Pool/spill gauges deliberately do
    # NOT scale with it: kv_blocks_* count LOGICAL blocks (each block's
    # head-slices live on every shard) and spill_host_bytes measures
    # the gathered full-width payloads, so reports from replicas of
    # different tp widths stay comparable (pinned by the mixed-tp merge
    # test).
    tp_devices: int = 1
    # Cost-attribution plane (nos_tpu/serving/accounting.py,
    # docs/telemetry.md "Utilization & cost accounting"): busy
    # slot-seconds accumulated at slot release (the conservation law's
    # engine side — per-tenant ledger charges must sum to this),
    # pool-block x tick products accumulated per tick while a CostLedger
    # is armed (a fused burst of N windows counts N), and receipts
    # closed at the req.finish/failure terminus. All zero on an engine
    # without a ledger — the accounting plane is default-off.
    slot_seconds_total: float = 0.0
    kv_block_ticks: int = 0
    cost_receipts: int = 0
    # Queue depths at snapshot time.
    inflight_dispatches: int = 0
    pending_verifies: int = 0
    waiting_requests: int = 0
    # Fleet aggregation (nos_tpu/serving/): how many engine snapshots
    # this report summarizes (1 for a single engine), and the RAW
    # latency samples backing the percentiles (seconds — counts only,
    # never request content). Carried so `merge` can POOL samples across
    # replicas and re-derive fleet percentiles: averaging per-replica
    # p95s weights a one-request replica like a thousand-request one
    # and has no statistical meaning for tails (pinned by the
    # pooled-vs-averaged divergence test).
    replicas: int = 1
    ttft_samples: List[float] = field(default_factory=list)
    queue_wait_samples: List[float] = field(default_factory=list)
    restore_latency_samples: List[float] = field(default_factory=list)
    failover_latency_samples: List[float] = field(default_factory=list)
    handoff_latency_samples: List[float] = field(default_factory=list)
    # Tick-phase profiler (nos_tpu_torch/tracing.py): profiled engine
    # ticks, total measured wall, the per-tick host-overhead vs dispatch
    # split (dispatch = wall inside program invocations, host issue time
    # on CUDA; host overhead = everything else), per-phase exclusive wall totals keyed by
    # constants.TICK_PHASES, and the per-tick raw samples backing the
    # split percentiles. All zeros/empty when the engine ran untraced.
    # `merge` sums the totals, sums the phase dict per key, POOLS the
    # samples, and re-derives the percentiles — same contract as the
    # latency tails above.
    ticks_profiled: int = 0
    tick_wall_s: float = 0.0
    tick_dispatch_s: float = 0.0
    tick_host_overhead_s: float = 0.0
    tick_phase_s: Dict[str, float] = field(default_factory=dict)
    host_overhead_p50_s: float = 0.0
    host_overhead_p95_s: float = 0.0
    dispatch_p50_s: float = 0.0
    dispatch_p95_s: float = 0.0
    host_overhead_samples: List[float] = field(default_factory=list)
    dispatch_samples: List[float] = field(default_factory=list)

    @staticmethod
    def merge(reports: Iterable["ServingReport"]) -> "ServingReport":
        """Fleet-level aggregation of per-replica reports: integer
        counters/gauges SUM (pool-state gauges sum to the fleet's pool),
        per-slot maps re-key as "<replica index>:<slot>", raw latency
        samples concatenate, and every percentile field is RE-DERIVED
        from the pooled samples — never averaged across replicas. A
        report built without samples (hand-constructed, or a foreign
        snapshot) contributes its counters but no tail information; the
        pooled percentiles are 0.0 when no samples exist at all."""
        merged = ServingReport(replicas=0, tp_devices=0)
        for i, rep in enumerate(reports):
            for f in fields(ServingReport):
                cur = getattr(merged, f.name)
                # Tolerate reports missing optional fields entirely (an
                # old-version snapshot rehydrated as a duck-typed object,
                # or a foreign collector that predates a field): absent
                # contributes nothing rather than raising mid-merge.
                val = getattr(rep, f.name, None)
                if val is None:
                    continue
                if f.name.endswith("_samples"):
                    cur.extend(float(v) for v in val)
                elif f.name in ("macro_tokens_by_slot", "spec_rounds_by_slot"):
                    for slot, n in val.items():
                        cur[f"{i}:{slot}"] = int(n)
                elif f.name == "tick_phase_s":
                    for phase, s in val.items():
                        cur[phase] = cur.get(phase, 0.0) + float(s)
                elif f.name in MERGE_FLOAT_FIELDS:
                    setattr(merged, f.name, cur + float(val))
                elif isinstance(cur, int):
                    setattr(merged, f.name, cur + int(val))
        for prefix, samples in (
            ("ttft", merged.ttft_samples),
            ("queue_wait", merged.queue_wait_samples),
            ("restore_latency", merged.restore_latency_samples),
            ("failover_latency", merged.failover_latency_samples),
            ("handoff_latency", merged.handoff_latency_samples),
            ("host_overhead", merged.host_overhead_samples),
            ("dispatch", merged.dispatch_samples),
        ):
            setattr(merged, f"{prefix}_p50_s", percentile(samples, 50))
            setattr(merged, f"{prefix}_p95_s", percentile(samples, 95))
        return merged


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile of a sequence (0.0 when empty) — enough for
    counter snapshots without dragging numpy into the telemetry surface."""
    values = sorted(float(v) for v in samples)
    if not values:
        return 0.0
    rank = max(0, min(len(values) - 1, round(q / 100.0 * (len(values) - 1))))
    return values[int(rank)]


#: Float-typed ServingReport fields that fleet `merge` SUMS across
#: replicas (accumulated seconds). Percentile fields are re-derived from
#: pooled samples instead, and every other float is per-replica detail.
#: A float field a registry entry snapshots into must appear here or
#: merge silently drops it.
MERGE_FLOAT_FIELDS = (
    "tick_wall_s",
    "tick_dispatch_s",
    "tick_host_overhead_s",
    "slot_seconds_total",
    "handoff_wall_s",
)

#: ServingReport integer fields that are POINT-IN-TIME gauges, not
#: monotonic counters: differencing two snapshots of these is meaningless
#: (`report_delta` passes the current value through instead). Everything
#: else integer-typed on the report accumulates monotonically over an
#: engine's life and differences into per-window work.
REPORT_GAUGE_FIELDS = frozenset(
    {
        "kv_blocks_free",
        "kv_blocks_cached",
        "kv_blocks_shared",
        "kv_blocks_spilled",
        "radix_nodes",
        "spill_host_bytes",
        "kv_quant_enabled",
        "kv_pool_bytes",
        "store_bytes",
        "store_entries",
        "inflight_dispatches",
        "pending_verifies",
        "waiting_requests",
        "tp_devices",
        "replicas",
    }
)


def report_counter_fields() -> tuple:
    """The monotonic integer counter fields of ServingReport, in schema
    order — the delta/rate surface the fleet monitor windows over."""
    return tuple(
        f.name
        for f in fields(ServingReport)
        if f.type == "int" and f.name not in REPORT_GAUGE_FIELDS
    )


def report_delta(cur: ServingReport, prev: Optional[ServingReport]) -> Dict[str, int]:
    """Per-window work between two cumulative snapshots of ONE engine:
    every monotonic counter differenced (clamped at 0 — an engine restart
    resets its counters, and a negative 'rate' would poison a planner),
    gauges passed through at their current value, and the decode-token
    production derived from the per-slot map sums as `tokens` (macro +
    fused-burst executed tokens) plus `spec_tokens_accepted` — together
    the window's generated-token count, the tok/s numerator. `prev=None`
    (the first sample) yields zero deltas with current gauges."""
    out: Dict[str, int] = {}
    for name in report_counter_fields():
        if prev is None:
            # First sample: no baseline, so no work attributable to a
            # window yet — the engine's whole life is not "this window".
            out[name] = 0
        else:
            # BOTH sides tolerate absent fields: an old-version snapshot
            # (rehydrated journal, foreign collector) on either end of
            # the diff contributes zero rather than raising mid-window.
            out[name] = max(
                0,
                int(getattr(cur, name, 0) or 0)
                - int(getattr(prev, name, 0) or 0),
            )
    if prev is None:
        out["tokens"] = 0
    else:
        macro_cur = sum(dict(getattr(cur, "macro_tokens_by_slot", {}) or {}).values())
        macro_prev = sum(dict(getattr(prev, "macro_tokens_by_slot", {}) or {}).values())
        out["tokens"] = max(0, macro_cur - macro_prev) + out["spec_tokens_accepted"]
    for name in REPORT_GAUGE_FIELDS:
        out[name] = int(getattr(cur, name, 0) or 0)
    return out


def report_rates(
    cur: ServingReport, prev: Optional[ServingReport], dt_s: float
) -> Dict[str, float]:
    """`report_delta` divided through by the window length: per-second
    rates for every counter (gauges still passed through undivided).
    Zero-length windows (first sample, clock stall) report zero rates —
    never a division blowup."""
    delta = report_delta(cur, prev)
    rates: Dict[str, float] = {}
    for name, val in delta.items():
        if name in REPORT_GAUGE_FIELDS:
            rates[name] = float(val)
        else:
            rates[name] = float(val) / dt_s if dt_s > 0.0 else 0.0
    return rates


def collect_serving(server) -> ServingReport:
    """Snapshot `server`'s engine counters (duck-typed: anything exposing
    the DecodeServer counter attributes works, so tests and future engines
    need no import cycle through the runtime package)."""
    ttft = list(getattr(server, "ttft_s", ()))
    queue_wait = list(getattr(server, "queue_wait_s", ()))
    restore = list(getattr(server, "restore_latency_s", ()))
    failover = list(getattr(server, "failover_latency_s", ()))
    host_over = [float(v) for v in getattr(server, "host_overhead_samples", ())]
    dispatch = [float(v) for v in getattr(server, "dispatch_samples", ())]
    report = ServingReport(
        steps_run=int(getattr(server, "steps_run", 0)),
        macro_dispatches=int(getattr(server, "macro_dispatches", 0)),
        spec_rounds=int(getattr(server, "spec_rounds", 0)),
        spec_tokens_accepted=int(getattr(server, "spec_tokens_accepted", 0)),
        spec_demotions=int(getattr(server, "spec_demotions", 0)),
        spec_tree_rounds=int(getattr(server, "spec_tree_rounds", 0)),
        spec_history_rounds=int(getattr(server, "spec_history_rounds", 0)),
        spec_tree_tokens_accepted=int(
            getattr(server, "spec_tree_tokens_accepted", 0)
        ),
        spec_history_tokens_accepted=int(
            getattr(server, "spec_history_tokens_accepted", 0)
        ),
        spec_tree_demotions=int(getattr(server, "spec_tree_demotions", 0)),
        spec_history_demotions=int(
            getattr(server, "spec_history_demotions", 0)
        ),
        both_dispatch_ticks=int(getattr(server, "both_dispatch_ticks", 0)),
        burst_dispatches=int(getattr(server, "burst_dispatches", 0)),
        tp_devices=int(getattr(server, "tp", 1)),
        burst_windows_run=int(getattr(server, "burst_windows_run", 0)),
        h2d_uploads=int(getattr(server, "h2d_uploads", 0)),
        staging_syncs=int(getattr(server, "staging_syncs", 0)),
        blocking_syncs=int(getattr(server, "blocking_syncs", 0)),
        idle_ticks=int(getattr(server, "idle_ticks", 0)),
        prefill_dispatches=int(getattr(server, "prefill_dispatches", 0)),
        prefill_tokens=int(getattr(server, "prefill_tokens", 0)),
        ticks_with_prefill_and_macro=int(
            getattr(server, "ticks_with_prefill_and_macro", 0)
        ),
        prefix_lookups=int(getattr(server, "prefix_lookups", 0)),
        prefix_hit_blocks=int(getattr(server, "prefix_hit_blocks", 0)),
        prefix_hit_tokens=int(getattr(server, "prefix_hit_tokens", 0)),
        prefix_evictions=int(getattr(server, "prefix_evictions", 0)),
        prefix_cow_hits=int(getattr(server, "prefix_cow_hits", 0)),
        prefix_cow_tokens=int(getattr(server, "prefix_cow_tokens", 0)),
        output_blocks_registered=int(
            getattr(server, "output_blocks_registered", 0)
        ),
        radix_nodes=int(getattr(server, "radix_nodes", 0)),
        spills=int(getattr(server, "spills", 0)),
        revives=int(getattr(server, "revives", 0)),
        spill_drops=int(getattr(server, "spill_drops", 0)),
        spill_host_bytes=int(getattr(server, "spill_host_bytes", 0)),
        kv_quant_enabled=int(getattr(server, "kv_quant_enabled", 0)),
        kv_pool_bytes=int(getattr(server, "kv_pool_bytes", 0)),
        kv_quant_payload_rejected=int(
            getattr(server, "kv_quant_payload_rejected", 0)
        ),
        store_hits=int(getattr(server, "store_hits", 0)),
        store_misses=int(getattr(server, "store_misses", 0)),
        store_puts=int(getattr(server, "store_puts", 0)),
        store_dedup_hits=int(getattr(server, "store_dedup_hits", 0)),
        store_published_blocks=int(
            getattr(server, "store_published_blocks", 0)
        ),
        prewarm_tokens=int(getattr(server, "prewarm_tokens", 0)),
        failover_revive_tokens=int(
            getattr(server, "failover_revive_tokens", 0)
        ),
        store_bytes=int(getattr(server, "store_bytes", 0)),
        store_entries=int(getattr(server, "store_entries", 0)),
        preemptions=int(getattr(server, "preemptions", 0)),
        borrowed_ticks=int(getattr(server, "borrowed_ticks", 0)),
        recoveries=int(getattr(server, "recoveries", 0)),
        slots_restored=int(getattr(server, "slots_restored", 0)),
        replay_tokens=int(getattr(server, "replay_tokens", 0)),
        requests_poisoned=int(getattr(server, "requests_poisoned", 0)),
        transient_retries=int(getattr(server, "transient_retries", 0)),
        fail_all_recoveries=int(getattr(server, "fail_all_recoveries", 0)),
        replica_suspects=int(getattr(server, "replica_suspects", 0)),
        replica_deaths=int(getattr(server, "replica_deaths", 0)),
        failovers=int(getattr(server, "failovers", 0)),
        failover_replay_tokens=int(
            getattr(server, "failover_replay_tokens", 0)
        ),
        futures_failed_over=int(getattr(server, "futures_failed_over", 0)),
        futures_errored=int(getattr(server, "futures_errored", 0)),
        handoff_exports=int(getattr(server, "handoff_exports", 0)),
        handoff_ingests=int(getattr(server, "handoff_ingests", 0)),
        handoff_published_blocks=int(
            getattr(server, "handoff_published_blocks", 0)
        ),
        handoff_revived_tokens=int(
            getattr(server, "handoff_revived_tokens", 0)
        ),
        failover_latency_p50_s=percentile(failover, 50),
        failover_latency_p95_s=percentile(failover, 95),
        failover_latency_samples=[float(v) for v in failover],
        restore_latency_p50_s=percentile(restore, 50),
        restore_latency_p95_s=percentile(restore, 95),
        ttft_p50_s=percentile(ttft, 50),
        ttft_p95_s=percentile(ttft, 95),
        queue_wait_p50_s=percentile(queue_wait, 50),
        queue_wait_p95_s=percentile(queue_wait, 95),
        ttft_samples=[float(v) for v in ttft],
        queue_wait_samples=[float(v) for v in queue_wait],
        restore_latency_samples=[float(v) for v in restore],
        slot_seconds_total=float(getattr(server, "slot_seconds_total", 0.0)),
        kv_block_ticks=int(getattr(server, "kv_block_ticks", 0)),
        cost_receipts=int(getattr(server, "cost_receipts", 0)),
        ticks_profiled=int(getattr(server, "ticks_profiled", 0)),
        tick_wall_s=float(getattr(server, "tick_wall_s", 0.0)),
        tick_dispatch_s=float(getattr(server, "tick_dispatch_s", 0.0)),
        tick_host_overhead_s=float(getattr(server, "tick_host_overhead_s", 0.0)),
        tick_phase_s={
            str(k): float(v)
            for k, v in dict(getattr(server, "tick_phase_s", {}) or {}).items()
        },
        host_overhead_p50_s=percentile(host_over, 50),
        host_overhead_p95_s=percentile(host_over, 95),
        dispatch_p50_s=percentile(dispatch, 50),
        dispatch_p95_s=percentile(dispatch, 95),
        host_overhead_samples=host_over,
        dispatch_samples=dispatch,
        inflight_dispatches=len(getattr(server, "_inflight", ())),
        pending_verifies=len(getattr(server, "_pending_verifies", ())),
        waiting_requests=len(getattr(server, "_waiting", ())),
    )
    for name, into in (
        ("macro_tokens_by_slot", report.macro_tokens_by_slot),
        ("spec_rounds_by_slot", report.spec_rounds_by_slot),
    ):
        for idx, value in enumerate(getattr(server, name, ())):
            into[str(idx)] = int(value)
    mgr = getattr(server, "_block_mgr", None)
    if mgr is not None:
        pool = mgr.counts()
        report.kv_blocks_free = int(pool["free"])
        report.kv_blocks_cached = int(pool["cached"])
        report.kv_blocks_shared = int(pool["shared"])
        report.kv_blocks_spilled = int(pool.get("spilled", 0))
    return report


def export_serving(
    server,
    share_telemetry: bool = False,
    sink: Optional[Callable[[str], None]] = None,
) -> Optional[ServingReport]:
    """Collect and (when opted in) ship the serving report — the same
    opt-in/zero-egress contract as `export`."""
    if not share_telemetry:
        logger.debug("serving telemetry disabled (share_telemetry=false)")
        return None
    report = collect_serving(server)
    payload = json.dumps(asdict(report), sort_keys=True)
    if sink is None:
        logger.info("serving telemetry report: %s", payload)
    else:
        sink(payload)
    return report
