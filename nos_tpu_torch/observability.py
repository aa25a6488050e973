"""Port of `nos_tpu/observability.py`, copied near verbatim: `MetricSpec`
(:42), `METRIC_SERIES` (:59) and `Metrics` (:255), a Prometheus-text
registry of counters, gauges and bucketed duration histograms, onto which
`DecodeServer(..., metrics=Metrics())` publishes its `nos_tpu_decode_*`
series and the fleet modules their `nos_tpu_fleet_*` series, and the
module-level default registry `metrics` (:381); the health
checks `HealthManager` (:387); `ObservabilityServer` (:428), an HTTP
server of `/metrics` (text exposition format 0.0.4), `/healthz` and
`/readyz`, and of the debug surface when its sources are attached:
`/debug` (the index of the armed surfaces), `/debug/events` (a
`FlightRecorder`), `/debug/trace/<id>` (a `Tracer`, with the cost
ledger's receipt), `/debug/pressure` (a `FleetMonitor`) and
`/debug/accounting` (a `CostLedger`), `/metrics` and `/debug/*` behind an
optional bearer token; and `setup_logging` (:642). The server's threads
start only in `start()`.
"""

from __future__ import annotations

import bisect
import http.server
import json
import logging
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from nos_tpu_torch import constants


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
    # report_field mirrors the ServingReport ATTRIBUTE, which happens to
    # share its spelling with the cost-charge key; same exemption
    # telemetry.py gets from the accounting-literal rule.
    MetricSpec("nos_tpu_decode_replay_tokens", "counter", "replay_tokens"),  # nos-lint: ignore[NOS018]
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
    # report_field mirrors the ServingReport attribute (see replay_tokens).
    MetricSpec("nos_tpu_decode_tick_seconds", "histogram", "tick_wall_s"),  # nos-lint: ignore[NOS018]
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


# Global default registry (components may also carry their own).
metrics = Metrics()


# ---------------------------------------------------------------------------
# Health
# ---------------------------------------------------------------------------
class HealthManager:
    """healthz/readyz checks (AddHealthzCheck/AddReadyzCheck analog)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._healthz: Dict[str, Callable[[], Optional[str]]] = {}
        self._readyz: Dict[str, Callable[[], Optional[str]]] = {}

    def add_healthz(self, name: str, check: Callable[[], Optional[str]]) -> None:
        with self._lock:
            self._healthz[name] = check

    def add_readyz(self, name: str, check: Callable[[], Optional[str]]) -> None:
        with self._lock:
            self._readyz[name] = check

    def _run(self, checks) -> Tuple[bool, Dict[str, str]]:
        failures = {}
        for name, check in list(checks.items()):
            try:
                reason = check()
            except Exception as e:  # noqa: BLE001
                reason = f"check raised: {e}"
            if reason is not None:
                failures[name] = reason
        return not failures, failures

    def healthz(self) -> Tuple[bool, Dict[str, str]]:
        with self._lock:
            checks = dict(self._healthz)
        return self._run(checks)

    def readyz(self) -> Tuple[bool, Dict[str, str]]:
        with self._lock:
            checks = dict(self._readyz)
        return self._run(checks)


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------
class ObservabilityServer:
    """Serves /metrics, /healthz, /readyz (kube-rbac-proxy-less analog),
    plus the serving-plane debug surface (/debug/events — the engine
    flight recorder's ring + postmortem dumps; /debug/trace/<id> — one
    request's lifecycle span events; /debug/pressure — the fleet
    monitor's latest PressureReport, window rows, SLO state and journal
    bookkeeping) when a tracing.FlightRecorder / tracing.Tracer /
    serving.FleetMonitor is attached."""

    def __init__(
        self,
        metrics_registry: Metrics,
        health: HealthManager,
        port: int = 0,
        host: str = "127.0.0.1",
        metrics_token: Optional[str] = None,
        tracer=None,
        recorder=None,
        pressure=None,
        accounting=None,
    ):
        """In-cluster deployments bind host='0.0.0.0' on the configured
        health_probe_port so kubelet httpGet probes can reach the pod IP;
        tests/demos keep loopback + ephemeral.

        `metrics_token` guards /metrics AND /debug/* with bearer-token
        auth (the kube-rbac-proxy-guarded pattern without the sidecar:
        Prometheus authenticates via the ServiceMonitor's
        bearerTokenSecret, everyone else gets 401 — and the debug
        surface, which exposes per-request timing, is at least as
        sensitive as the metrics). /healthz and /readyz stay open —
        kubelet httpGet probes cannot attach credentials.

        `tracer`/`recorder` (optional, duck-typed to tracing.py's
        Tracer/FlightRecorder) arm the /debug endpoints; without them
        the paths answer 404. Payloads are JSON and carry counts/ids
        only — the recorder/tracer never stored request content to
        begin with (docs/tracing.md privacy contract).

        `pressure` (optional, duck-typed to serving.FleetMonitor —
        anything exposing `pressure_snapshot()`) arms /debug/pressure:
        the latest PressureReport, per-replica/per-tenant window rows,
        SLO state, and journal bookkeeping (docs/fleet-monitor.md).
        Same auth posture as the other debug paths — fleet pressure is
        capacity-planning intelligence, at least as sensitive as the
        metrics.

        `accounting` (optional, duck-typed to
        serving/accounting.py CostLedger — anything exposing
        `snapshot()` and `receipt(trace_id)`) arms /debug/accounting
        (the per-tenant cost roll-up + recent receipts) and attaches
        each request's cost RECEIPT to its /debug/trace/<id> payload.
        Billing data is tenant-identifying — same auth posture again.

        GET /debug (constants.DEBUG_PATH_INDEX) is the discoverability
        index: a JSON list of whichever debug surfaces above are armed,
        404 when none is (the same bearer-token and 404-unarmed
        semantics as the surfaces it lists)."""
        self.metrics = metrics_registry
        self.health = health
        self.metrics_token = metrics_token
        self.tracer = tracer
        self.recorder = recorder
        self.pressure = pressure
        self.accounting = accounting
        obs = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _authorized(self) -> bool:
                if obs.metrics_token is None:
                    return True
                import hmac

                presented = self.headers.get("Authorization", "")
                return hmac.compare_digest(
                    presented, f"Bearer {obs.metrics_token}"
                )

            def _reply_401(self):
                body = b"unauthorized"
                self.send_response(401)
                self.send_header("WWW-Authenticate", "Bearer")
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # Prometheus scrapers key the exposition-format parser
                # off the Content-Type version; plain probes and the
                # JSON debug surface declare theirs too.
                ctype = "text/plain"
                if self.path == "/metrics":
                    if not self._authorized():
                        self._reply_401()
                        return
                    body = obs.metrics.render().encode()
                    ctype = constants.METRICS_CONTENT_TYPE
                    self.send_response(200)
                elif self.path == "/healthz":
                    ok, failures = obs.health.healthz()
                    body = (b"ok" if ok else repr(failures).encode())
                    self.send_response(200 if ok else 500)
                elif self.path == "/readyz":
                    ok, failures = obs.health.readyz()
                    body = (b"ok" if ok else repr(failures).encode())
                    self.send_response(200 if ok else 500)
                elif self.path == constants.DEBUG_PATH_EVENTS:
                    if not self._authorized():
                        self._reply_401()
                        return
                    if obs.recorder is None:
                        body = b"flight recorder not attached"
                        self.send_response(404)
                    else:
                        payload = {
                            "events": obs.recorder.snapshot(),
                            "postmortems": obs.recorder.postmortem_dumps(),
                        }
                        if obs.tracer is not None:
                            payload["traces"] = obs.tracer.trace_ids()
                        body = json.dumps(payload).encode()
                        ctype = "application/json"
                        self.send_response(200)
                elif self.path == constants.DEBUG_PATH_PRESSURE:
                    if not self._authorized():
                        self._reply_401()
                        return
                    if obs.pressure is None:
                        body = b"fleet monitor not attached"
                        self.send_response(404)
                    else:
                        body = json.dumps(obs.pressure.pressure_snapshot()).encode()
                        ctype = "application/json"
                        self.send_response(200)
                elif self.path == constants.DEBUG_PATH_ACCOUNTING:
                    if not self._authorized():
                        self._reply_401()
                        return
                    if obs.accounting is None:
                        body = b"cost ledger not attached"
                        self.send_response(404)
                    else:
                        body = json.dumps(obs.accounting.snapshot()).encode()
                        ctype = "application/json"
                        self.send_response(200)
                elif self.path == constants.DEBUG_PATH_INDEX:
                    # Discoverability: which debug surfaces are armed.
                    if not self._authorized():
                        self._reply_401()
                        return
                    surfaces = []
                    if obs.recorder is not None:
                        surfaces.append(constants.DEBUG_PATH_EVENTS)
                    if obs.tracer is not None:
                        surfaces.append(
                            constants.DEBUG_PATH_TRACE_PREFIX + "<id>"
                        )
                    if obs.pressure is not None:
                        surfaces.append(constants.DEBUG_PATH_PRESSURE)
                    if obs.accounting is not None:
                        surfaces.append(constants.DEBUG_PATH_ACCOUNTING)
                    if not surfaces:
                        body = b"no debug surface armed"
                        self.send_response(404)
                    else:
                        body = json.dumps({"surfaces": surfaces}).encode()
                        ctype = "application/json"
                        self.send_response(200)
                elif self.path.startswith(constants.DEBUG_PATH_TRACE_PREFIX):
                    if not self._authorized():
                        self._reply_401()
                        return
                    tid = self.path[len(constants.DEBUG_PATH_TRACE_PREFIX):]
                    events = (
                        obs.tracer.trace(tid) if obs.tracer is not None else None
                    )
                    if events is None:
                        body = b"no such trace"
                        self.send_response(404)
                    else:
                        payload = {"trace_id": tid, "events": events}
                        if obs.accounting is not None:
                            # The request's cost receipt rides its trace
                            # (None while open / for unknown ids).
                            payload["receipt"] = obs.accounting.receipt(tid)
                        body = json.dumps(payload).encode()
                        ctype = "application/json"
                        self.send_response(200)
                else:
                    body = b"not found"
                    self.send_response(404)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_port
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObservabilityServer":
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def setup_logging(level: str = "INFO") -> None:
    """Leveled structured logging (zap-options analog)."""
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)-5s %(name)s %(message)s",
    )
