"""Port of the metrics half of `nos_tpu/observability.py`, copied near
verbatim: `MetricSpec` (:42), `METRIC_SERIES` (:59) and `Metrics` (:255),
a Prometheus-text registry of counters, gauges and bucketed duration
histograms. `DecodeServer(..., metrics=Metrics())` publishes its
`nos_tpu_decode_*` series onto it. The reference's `HealthManager` (:387)
and `ObservabilityServer` (:428) belong to the serving plane and are not
ported yet (ROADMAP A8 step 5); `METRIC_SERIES` keeps the fleet series
those will emit, so the schema stays the reference's.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# Metric schema registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MetricSpec:
    """One registered metric series. `name` ending in `*` declares a FAMILY
    (a dynamic suffix, e.g. the per-tenant cost gauges built as
    f"nos_tpu_tenant_cost_{field}"). `report_field` names the ServingReport
    field the series snapshots into, when it has one — fleet-derived gauges
    (computed by the monitor from report windows) carry None."""

    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    report_field: Optional[str] = None


#: Every metric series the serving plane (runtime/ + serving/) may emit,
#: with the ServingReport field it snapshots into. Adding a metric = emit
#: it and list it here (tests/test_torch_tracing.py holds every name the
#: engine emits to this list).
METRIC_SERIES: Tuple[MetricSpec, ...] = (
    # -- engine counters (DecodeServer), snapshotting into ServingReport --
    MetricSpec("nos_tpu_decode_steps", "counter", "steps_run"),
    MetricSpec("nos_tpu_decode_macro_dispatches", "counter", "macro_dispatches"),
    MetricSpec("nos_tpu_decode_spec_rounds", "counter", "spec_rounds"),
    MetricSpec("nos_tpu_decode_spec_tokens_accepted", "counter", "spec_tokens_accepted"),
    # Per-draft-source speculation series (docs/speculation.md): verify
    # windows, accepted tokens, and demotions split by which source
    # drafted the window — the radix tree's stored continuation vs the
    # slot's own prompt-lookup history. Sources partition the totals
    # (tree + history accepted == spec_tokens_accepted).
    MetricSpec(
        "nos_tpu_decode_draft_source_tree_rounds", "counter", "spec_tree_rounds"
    ),
    MetricSpec(
        "nos_tpu_decode_draft_source_history_rounds",
        "counter",
        "spec_history_rounds",
    ),
    MetricSpec(
        "nos_tpu_decode_draft_source_tree_accepted",
        "counter",
        "spec_tree_tokens_accepted",
    ),
    MetricSpec(
        "nos_tpu_decode_draft_source_history_accepted",
        "counter",
        "spec_history_tokens_accepted",
    ),
    MetricSpec(
        "nos_tpu_decode_draft_source_tree_demotions",
        "counter",
        "spec_tree_demotions",
    ),
    MetricSpec(
        "nos_tpu_decode_draft_source_history_demotions",
        "counter",
        "spec_history_demotions",
    ),
    MetricSpec("nos_tpu_decode_prefill_dispatches", "counter", "prefill_dispatches"),
    MetricSpec("nos_tpu_decode_prefill_tokens", "counter", "prefill_tokens"),
    MetricSpec(
        "nos_tpu_decode_ticks_with_prefill_and_macro",
        "counter",
        "ticks_with_prefill_and_macro",
    ),
    MetricSpec("nos_tpu_decode_prefix_lookups", "counter", "prefix_lookups"),
    MetricSpec("nos_tpu_decode_prefix_hit_blocks", "counter", "prefix_hit_blocks"),
    MetricSpec("nos_tpu_decode_prefix_hit_tokens", "counter", "prefix_hit_tokens"),
    MetricSpec("nos_tpu_decode_prefix_evictions", "counter", "prefix_evictions"),
    MetricSpec("nos_tpu_decode_prefix_cow_hits", "counter", "prefix_cow_hits"),
    MetricSpec("nos_tpu_decode_prefix_cow_tokens", "counter", "prefix_cow_tokens"),
    MetricSpec(
        "nos_tpu_decode_output_blocks_registered",
        "counter",
        "output_blocks_registered",
    ),
    MetricSpec("nos_tpu_decode_preemptions", "counter", "preemptions"),
    MetricSpec("nos_tpu_decode_borrowed_ticks", "counter", "borrowed_ticks"),
    MetricSpec("nos_tpu_decode_recoveries", "counter", "recoveries"),
    MetricSpec("nos_tpu_decode_replay_tokens", "counter", "replay_tokens"),
    MetricSpec("nos_tpu_decode_requests_poisoned", "counter", "requests_poisoned"),
    MetricSpec("nos_tpu_decode_slots_restored", "counter", "slots_restored"),
    MetricSpec("nos_tpu_decode_transient_retries", "counter", "transient_retries"),
    MetricSpec("nos_tpu_decode_burst_dispatches", "counter", "burst_dispatches"),
    MetricSpec("nos_tpu_decode_burst_windows", "counter", "burst_windows_run"),
    MetricSpec("nos_tpu_decode_spills", "counter", "spills"),
    MetricSpec("nos_tpu_decode_revives", "counter", "revives"),
    MetricSpec("nos_tpu_decode_spill_drops", "counter", "spill_drops"),
    MetricSpec("nos_tpu_decode_h2d_uploads", "counter", "h2d_uploads"),
    MetricSpec("nos_tpu_decode_staging_syncs", "counter", "staging_syncs"),
    MetricSpec("nos_tpu_decode_blocking_syncs", "counter", "blocking_syncs"),
    MetricSpec("nos_tpu_decode_idle_ticks", "counter", "idle_ticks"),
    # -- engine gauges (per-tick state), snapshotting into ServingReport --
    MetricSpec("nos_tpu_decode_kv_blocks_free", "gauge", "kv_blocks_free"),
    MetricSpec("nos_tpu_decode_kv_blocks_cached", "gauge", "kv_blocks_cached"),
    MetricSpec("nos_tpu_decode_kv_blocks_shared", "gauge", "kv_blocks_shared"),
    MetricSpec("nos_tpu_decode_kv_blocks_spilled", "gauge", "kv_blocks_spilled"),
    MetricSpec("nos_tpu_decode_radix_nodes", "gauge", "radix_nodes"),
    MetricSpec("nos_tpu_decode_spill_host_bytes", "gauge", "spill_host_bytes"),
    # -- quantized-KV tier (docs/quantized-kv.md) --
    MetricSpec("nos_tpu_decode_kv_quant_enabled", "gauge", "kv_quant_enabled"),
    MetricSpec("nos_tpu_decode_kv_quant_pool_bytes", "gauge", "kv_pool_bytes"),
    MetricSpec(
        "nos_tpu_decode_kv_quant_payload_rejected",
        "counter",
        "kv_quant_payload_rejected",
    ),
    MetricSpec("nos_tpu_decode_inflight_dispatches", "gauge", "inflight_dispatches"),
    MetricSpec("nos_tpu_decode_pending_verifies", "gauge", "pending_verifies"),
    MetricSpec("nos_tpu_decode_waiting_requests", "gauge", "waiting_requests"),
    MetricSpec("nos_tpu_decode_tp_devices", "gauge", "tp_devices"),
    # -- per-tick slot-split gauges (no snapshot field: instantaneous) --
    MetricSpec("nos_tpu_decode_slots_drafting", "gauge"),
    MetricSpec("nos_tpu_decode_slots_macro", "gauge"),
    MetricSpec("nos_tpu_decode_slots_prefilling", "gauge"),
    # -- tick-profiling histograms (tracing.py), accumulated seconds --
    MetricSpec("nos_tpu_decode_tick_phase_seconds", "histogram"),
    MetricSpec("nos_tpu_decode_tick_seconds", "histogram", "tick_wall_s"),
    MetricSpec("nos_tpu_decode_tick_dispatch_seconds", "histogram", "tick_dispatch_s"),
    MetricSpec(
        "nos_tpu_decode_tick_host_overhead_seconds",
        "histogram",
        "tick_host_overhead_s",
    ),
    # -- fleet KV store traffic (per-engine counters vs the shared tier) --
    MetricSpec("nos_tpu_fleet_kv_store_hits", "counter", "store_hits"),
    MetricSpec("nos_tpu_fleet_kv_store_misses", "counter", "store_misses"),
    MetricSpec("nos_tpu_fleet_kv_store_puts", "counter", "store_puts"),
    MetricSpec("nos_tpu_fleet_kv_store_dedup_hits", "counter", "store_dedup_hits"),
    MetricSpec("nos_tpu_fleet_kv_prewarm_tokens", "counter", "prewarm_tokens"),
    MetricSpec(
        "nos_tpu_fleet_kv_failover_revive_tokens",
        "counter",
        "failover_revive_tokens",
    ),
    MetricSpec("nos_tpu_fleet_kv_store_bytes", "gauge", "store_bytes"),
    MetricSpec("nos_tpu_fleet_kv_store_entries", "gauge", "store_entries"),
    # -- fleet failure domains (supervisor) --
    MetricSpec("nos_tpu_fleet_replica_suspects", "counter", "replica_suspects"),
    MetricSpec("nos_tpu_fleet_replica_deaths", "counter", "replica_deaths"),
    MetricSpec("nos_tpu_fleet_failovers", "counter", "failovers"),
    MetricSpec(
        "nos_tpu_fleet_failover_replay_tokens", "counter", "failover_replay_tokens"
    ),
    MetricSpec("nos_tpu_fleet_futures_failed_over", "counter", "futures_failed_over"),
    MetricSpec("nos_tpu_fleet_futures_errored", "counter", "futures_errored"),
    MetricSpec("nos_tpu_fleet_failover_latency", "histogram"),
    # -- phase-disaggregated handoff (serving/disagg.py + engine export/
    # ingest counters; docs/disaggregation.md) --
    MetricSpec("nos_tpu_fleet_handoff_exports", "counter", "handoff_exports"),
    MetricSpec("nos_tpu_fleet_handoff_ingests", "counter", "handoff_ingests"),
    MetricSpec(
        "nos_tpu_fleet_handoff_published_blocks",
        "counter",
        "handoff_published_blocks",
    ),
    MetricSpec(
        "nos_tpu_fleet_handoff_revived_tokens",
        "counter",
        "handoff_revived_tokens",
    ),
    MetricSpec("nos_tpu_fleet_handoffs", "counter", "handoffs"),
    MetricSpec("nos_tpu_fleet_handoff_reroutes", "counter", "handoff_reroutes"),
    MetricSpec("nos_tpu_fleet_handoffs_errored", "counter", "handoffs_errored"),
    MetricSpec("nos_tpu_fleet_handoff_latency", "histogram"),
    MetricSpec("nos_tpu_fleet_handoff_seconds", "histogram", "handoff_wall_s"),
    # -- fleet pressure plane (monitor-derived gauges; computed from
    # report windows, so no single report_field backs them) --
    MetricSpec("nos_tpu_fleet_replicas_active", "gauge"),
    MetricSpec("nos_tpu_fleet_windows_sampled", "gauge"),
    MetricSpec("nos_tpu_fleet_tok_s", "gauge"),
    MetricSpec("nos_tpu_fleet_prefill_tok_s", "gauge"),
    MetricSpec("nos_tpu_fleet_admissions_s", "gauge"),
    MetricSpec("nos_tpu_fleet_queue_depth", "gauge"),
    MetricSpec("nos_tpu_fleet_slots_active", "gauge"),
    MetricSpec("nos_tpu_fleet_slots_free", "gauge"),
    MetricSpec("nos_tpu_fleet_kv_blocks_free", "gauge"),
    MetricSpec("nos_tpu_fleet_headroom", "gauge"),
    MetricSpec("nos_tpu_fleet_replica_state", "gauge"),
    MetricSpec("nos_tpu_fleet_tenant_state", "gauge"),
    MetricSpec("nos_tpu_fleet_tenant_tok_s", "gauge"),
    MetricSpec("nos_tpu_fleet_tenant_waiting", "gauge"),
    MetricSpec("nos_tpu_fleet_tenant_ttft_p95_s", "gauge"),
    MetricSpec("nos_tpu_fleet_tenant_slo_breached", "gauge"),
    # -- utilization & cost accounting --
    MetricSpec("nos_tpu_fleet_util_busy_chip_s", "gauge"),
    MetricSpec("nos_tpu_fleet_util_waste_chip_s", "gauge"),
    MetricSpec("nos_tpu_fleet_util_waste_fraction", "gauge"),
    MetricSpec("nos_tpu_fleet_util_tok_s_per_chip_hour", "gauge"),
    MetricSpec("nos_tpu_tenant_cost_*", "gauge"),
)

#: Histogram bucket upper bounds (seconds) for `observe`d durations —
#: sub-millisecond through 10s, the range an engine tick phase or a plan
#: pass actually spans. Cumulative `_bucket{le=...}` series (plus +Inf)
#: render in Prometheus text format alongside the exact _count/_sum.
DURATION_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: Raw samples retained per duration series. Histogram buckets carry the
#: distribution and _count/_sum stay exact, so the raw samples are only a
#: recent window for debugging — the fixed cap is what fixes the old
#: unbounded `observe()` append (every observation kept forever).
DURATION_RESERVOIR = 512


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------
class Metrics:
    """Counters, gauges and bucketed duration histograms with label
    support. Durations keep exact `_count`/`_sum`, per-bucket counts
    (Prometheus `_bucket{le=...}` series), and a bounded reservoir of
    recent raw samples — memory is constant regardless of how many
    observations a long-lived process makes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._durations: Dict[Tuple[str, Tuple], deque] = {}
        self._dur_count: Dict[Tuple[str, Tuple], int] = defaultdict(int)
        self._dur_sum: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        # Non-cumulative per-bucket counts; index len(DURATION_BUCKETS)
        # is the +Inf overflow bucket.
        self._dur_buckets: Dict[Tuple[str, Tuple], list] = {}

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]) -> Tuple[str, Tuple]:
        return name, tuple(sorted((labels or {}).items()))

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._counters[self._key(name, labels)] += value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def remove_gauge(self, name: str, **labels) -> None:
        """Drop one labeled gauge series. For per-entity gauges whose
        entity stopped reporting: a frozen last value on /metrics is worse
        than the series disappearing."""
        with self._lock:
            self._gauges.pop(self._key(name, labels), None)

    def observe(self, name: str, seconds: float, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            if key not in self._durations:
                self._durations[key] = deque(maxlen=DURATION_RESERVOIR)
                self._dur_buckets[key] = [0] * (len(DURATION_BUCKETS) + 1)
            self._durations[key].append(seconds)
            self._dur_count[key] += 1
            self._dur_sum[key] += seconds
            self._dur_buckets[key][bisect.bisect_left(DURATION_BUCKETS, seconds)] += 1

    def time(self, name: str, **labels):
        """Context manager recording a duration."""
        metrics = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                metrics.observe(name, time.perf_counter() - self.t0, **labels)
                return False

        return _Timer()

    def get(self, name: str, **labels) -> float:
        with self._lock:
            key = self._key(name, labels)
            if key in self._counters:
                return self._counters[key]
            return self._gauges.get(key, 0.0)

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4): `# TYPE`
        metadata per metric family, cumulative `_bucket{le=...}` series
        (with the mandatory `+Inf` bucket) for every observed duration,
        and exact `_count`/`_sum` regardless of the raw-sample cap."""
        def fmt(name, labels, value):
            if labels:
                inner = ",".join(f'{k}="{v}"' for k, v in labels)
                return f"{name}{{{inner}}} {value:g}"
            return f"{name} {value:g}"

        lines = []
        with self._lock:
            prev = None
            for (name, labels), value in sorted(self._counters.items()):
                if name != prev:
                    lines.append(f"# TYPE {name}_total counter")
                    prev = name
                lines.append(fmt(name + "_total", labels, value))
            prev = None
            for (name, labels), value in sorted(self._gauges.items()):
                if name != prev:
                    lines.append(f"# TYPE {name} gauge")
                    prev = name
                lines.append(fmt(name, labels, value))
            prev = None
            for (name, labels) in sorted(self._dur_count):
                key = (name, labels)
                if name != prev:
                    lines.append(f"# TYPE {name}_seconds histogram")
                    prev = name
                cumulative = 0
                for le, count in zip(
                    DURATION_BUCKETS, self._dur_buckets[key]
                ):
                    cumulative += count
                    lines.append(
                        fmt(
                            name + "_seconds_bucket",
                            labels + (("le", format(le, "g")),),
                            cumulative,
                        )
                    )
                lines.append(
                    fmt(
                        name + "_seconds_bucket",
                        labels + (("le", "+Inf"),),
                        self._dur_count[key],
                    )
                )
                lines.append(fmt(name + "_seconds_count", labels, self._dur_count[key]))
                lines.append(fmt(name + "_seconds_sum", labels, self._dur_sum[key]))
        return "\n".join(lines) + "\n"
