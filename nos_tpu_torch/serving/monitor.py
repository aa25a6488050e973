"""Port of `nos_tpu/serving/monitor.py`: the fleet monitor, copied near
verbatim with the port's imports (host-only code: every input is a host
counter or probe read, nothing touches the device).

`FleetMonitor` (:369) samples a `ReplicaSet`: per non-retired replica
`collect_serving`, `probe()` and `tenant_probe()`, diffed against the
previous sample (`telemetry.report_delta`/`report_rates`) into one window
row per replica and per tenant in bounded rings: tok/s, admissions/s,
prefill tokens/s, spill/revive/recovery rates, queue depth, slots in use,
and the duty-cycle inputs of `serving/accounting.py`. A replica whose
probe raises gets an unreachable row, journaled, and the rest of the
fleet keeps sampling. From the rows: `classify_replica` (:121, hot | ok |
idle | draining | unreachable), `classify_tenant` (:151, starved |
borrowing | within, read from the engine's own QuotaPolicy through
`tenant_probe`), `fleet_headroom` (:170), and per-tenant SLOs with
K-of-N sustained-breach semantics (`SLOTarget`/`SLOTracker`, :209-330)
into a `PressureReport` (:331). Exports: the `nos_tpu_fleet_*` gauges
(`PER_REPLICA_GAUGES`/`PER_TENANT_GAUGES`, :82-112) on a `Metrics`
registry, removed on the first sample after a replica retires
(`ReplicaSet.retire`; `_drop_replica_locked` also drops its rings and
baselines) or once a tenant stays idle past `tenant_idle_windows`, with
the ledger's `nos_tpu_tenant_cost_*` gauges beside them; the
`pressure_snapshot()` behind `/debug/pressure`; and a bounded JSONL
journal, one line a window, frozen when a window shows an engine
recovery and replayable (`FleetMonitor.replay` re-derives the verdicts
from the journal alone). `sample()` is manual and clock-injectable;
`start()` runs it on a background thread. The monitor only reads: fleet
outputs and dispatch counters are the same with it sampling or not.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.runtime.faults import classify_fault
from nos_tpu_torch.serving.accounting import duty_cycle, fleet_utilization
from nos_tpu_torch.telemetry import (
    collect_serving,
    percentile,
    report_delta,
    report_rates,
)

logger = logging.getLogger(__name__)

#: Per-replica gauge families the monitor publishes (labeled
#: ``replica=<id>``). Kept in one tuple so retirement removes exactly
#: what sampling published — the gauge-hygiene contract.
PER_REPLICA_GAUGES = (
    "nos_tpu_fleet_tok_s",
    "nos_tpu_fleet_admissions_s",
    "nos_tpu_fleet_prefill_tok_s",
    "nos_tpu_fleet_queue_depth",
    "nos_tpu_fleet_slots_active",
    "nos_tpu_fleet_kv_blocks_free",
    # Utilization plane (serving/accounting.py): per-replica busy /
    # waste chip-seconds of the latest window.
    "nos_tpu_fleet_util_busy_chip_s",
    "nos_tpu_fleet_util_waste_chip_s",
)

#: Per-tenant gauge families (labeled ``tenant=<name>``), the tenant
#: mirror of PER_REPLICA_GAUGES: the idle-tenant sweep removes exactly
#: these (plus the one-hot state series and, with a ledger attached,
#: the nos_tpu_tenant_cost_* series) so label cardinality stays bounded
#: by the ACTIVE tenant set, not the historical one.
PER_TENANT_GAUGES = (
    "nos_tpu_fleet_tenant_tok_s",
    "nos_tpu_fleet_tenant_waiting",
    "nos_tpu_fleet_tenant_slo_breached",
    "nos_tpu_fleet_tenant_ttft_p95_s",
)

#: Per-tenant cost gauge name for one CostLedger charge field.
def _cost_gauge(field: str) -> str:
    return f"nos_tpu_tenant_cost_{field}"


# ---------------------------------------------------------------------------
# Pure classification (shared by live sampling and journal replay)
# ---------------------------------------------------------------------------
def classify_replica(row: Dict[str, object]) -> str:
    """Pressure verdict for one replica window row. A pure function of
    the journaled fields, so `replay` re-derives exactly what `sample`
    concluded: UNREACHABLE when the window's probe raised/timed out
    (`probe_error` carries the classified fault kind), DRAINING when
    the lifecycle says so, HOT when the replica is slot-saturated AND
    work is waiting it cannot host, IDLE when the window moved no
    tokens with nothing admitted or queued, OK otherwise."""
    if row.get("probe_error"):
        return constants.PRESSURE_REPLICA_UNREACHABLE
    if (
        row.get(constants.PROBE_KEY_DRAINING)
        or row.get("lifecycle") != constants.REPLICA_STATE_ACTIVE
    ):
        return constants.PRESSURE_REPLICA_DRAINING
    slots_total = int(row.get("slots_total", 0) or 0)
    slots_active = int(row.get("slots_active", 0) or 0)
    queue_depth = int(row.get("queue_depth", 0) or 0)
    if queue_depth > 0 and slots_total > 0 and slots_active >= slots_total:
        return constants.PRESSURE_REPLICA_HOT
    if (
        slots_active == 0
        and queue_depth == 0
        and not row.get("tokens", 0)
        and not row.get("prefill_tokens", 0)
    ):
        return constants.PRESSURE_REPLICA_IDLE
    return constants.PRESSURE_REPLICA_OK


def classify_tenant(row: Dict[str, object]) -> str:
    """Pressure verdict for one tenant window row: STARVED when some
    engine's QuotaPolicy holds the tenant under its guarantee WHILE it
    has work waiting there (the same conjunction quota preemption acts
    on — `tenant_probe` carries the policy's own accounting, so this
    verdict cannot disagree with enforcement), BORROWING when it ran
    above its guaranteed share this window, WITHIN otherwise (including
    quota-less fleets)."""
    if row.get("quota_starved"):
        return constants.PRESSURE_TENANT_STARVED
    if (
        row.get("quota_borrower")
        and float(row.get("usage", 0.0) or 0.0) > float(row.get("min_share", 0.0) or 0.0)
        and int(row.get("tokens", 0) or 0) > 0
    ):
        return constants.PRESSURE_TENANT_BORROWING
    return constants.PRESSURE_TENANT_WITHIN


def fleet_headroom(replica_rows: Dict[str, Dict[str, object]]) -> Dict[str, object]:
    """Headroom estimate over the ADMITTING replicas of a window: free
    decode-slot fraction, free KV-block fraction, and their min as the
    single planner-facing scalar (capacity is gone when either pool
    is). Draining/retired rows are excluded — their capacity is already
    leaving the fleet."""
    slots_free = slots_total = kv_free = kv_total = 0
    active = 0
    for row in replica_rows.values():
        if row.get("pressure") in (
            constants.PRESSURE_REPLICA_DRAINING,
            # Unknown is not zero, but it is not capacity either: an
            # unreachable replica must not count toward headroom the
            # planner would spend.
            constants.PRESSURE_REPLICA_UNREACHABLE,
        ):
            continue
        active += 1
        st = int(row.get("slots_total", 0) or 0)
        slots_total += st
        slots_free += max(0, st - int(row.get("slots_active", 0) or 0))
        kv_total += int(row.get("kv_blocks_total", 0) or 0)
        kv_free += int(row.get("kv_blocks_free", 0) or 0)
    slot_headroom = slots_free / slots_total if slots_total else 0.0
    kv_headroom = kv_free / kv_total if kv_total else 0.0
    return {
        "headroom": min(slot_headroom, kv_headroom),
        "slot_headroom": slot_headroom,
        "kv_headroom": kv_headroom,
        "slots_free": slots_free,
        "slots_total": slots_total,
        "replicas_active": active,
    }


# ---------------------------------------------------------------------------
# SLO tracking
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SLOTarget:
    """One tenant's service-level targets, each optional (None = not
    tracked): TTFT p95 over a sampling window, queue-wait p95, and a
    minimum decode rate that only applies while the tenant actually has
    demand (an idle tenant producing nothing is not a breach)."""

    ttft_p95_s: Optional[float] = None
    queue_wait_p95_s: Optional[float] = None
    min_tok_s: Optional[float] = None


class SLOTracker:
    """Sliding-window SLO evaluation with sustained-breach semantics.

    `observe_window` folds one sampling window's per-tenant measurements
    against the tenant's `SLOTarget` and returns whether THAT window
    breached; `breached` reports the sustained verdict — at least
    `breach_k` of the last `breach_n` windows over target. Point spikes
    (one bad window) therefore never trip the SLO; a real regression
    does within `breach_k` windows. Verdict flips append
    `constants.SLO_EV_BREACH`/`SLO_EV_RECOVER` entries to a bounded
    event log (counts/ids only)."""

    def __init__(
        self,
        targets: Dict[str, SLOTarget],
        breach_k: int = 3,
        breach_n: int = 5,
        max_events: int = 256,
    ):
        if not (1 <= breach_k <= breach_n):
            raise ValueError(
                f"need 1 <= breach_k <= breach_n, got k={breach_k} n={breach_n}"
            )
        self.targets = dict(targets)
        self.breach_k = int(breach_k)
        self.breach_n = int(breach_n)
        self._history: Dict[str, deque] = {}
        self._sustained: Dict[str, bool] = {}
        self.events: deque = deque(maxlen=int(max_events))

    def observe_window(
        self,
        tenant: str,
        ttft_p95_s: Optional[float] = None,
        queue_wait_p95_s: Optional[float] = None,
        tok_s: float = 0.0,
        demand: bool = False,
        window: Optional[int] = None,
    ) -> bool:
        """Fold one window; returns True when this WINDOW breached any
        target (the sustained verdict is `breached()`). Latency inputs
        of None mean "no samples arrived this window" and cannot
        breach."""
        target = self.targets.get(tenant)
        if target is None:
            return False
        reasons: List[str] = []
        if (
            target.ttft_p95_s is not None
            and ttft_p95_s is not None
            and ttft_p95_s > target.ttft_p95_s
        ):
            reasons.append("ttft_p95_s")
        if (
            target.queue_wait_p95_s is not None
            and queue_wait_p95_s is not None
            and queue_wait_p95_s > target.queue_wait_p95_s
        ):
            reasons.append("queue_wait_p95_s")
        if target.min_tok_s is not None and demand and tok_s < target.min_tok_s:
            reasons.append("min_tok_s")
        breached = bool(reasons)
        hist = self._history.setdefault(tenant, deque(maxlen=self.breach_n))
        hist.append(breached)
        sustained = sum(hist) >= self.breach_k
        if sustained != self._sustained.get(tenant, False):
            self._sustained[tenant] = sustained
            self.events.append(
                {
                    "event": (
                        constants.SLO_EV_BREACH
                        if sustained
                        else constants.SLO_EV_RECOVER
                    ),
                    "tenant": tenant,
                    "window": window,
                    "reasons": reasons,
                }
            )
        return breached

    def breached(self, tenant: str) -> bool:
        """The sustained verdict: K-of-N windows over target."""
        return self._sustained.get(tenant, False)

    def snapshot(self) -> Dict[str, object]:
        return {
            "breach_k": self.breach_k,
            "breach_n": self.breach_n,
            "tenants": {
                t: {
                    "target": asdict(target),
                    "sustained": self._sustained.get(t, False),
                    "recent": [bool(b) for b in self._history.get(t, ())],
                }
                for t, target in self.targets.items()
            },
            "events": list(self.events),
        }


def _coerce_slo(slo) -> Optional[SLOTracker]:
    if slo is None or isinstance(slo, SLOTracker):
        return slo
    return SLOTracker(dict(slo))


# ---------------------------------------------------------------------------
# The planner-facing verdict
# ---------------------------------------------------------------------------
@dataclass
class PressureReport:
    """One sampling window's typed verdict — what the item-2 replanning
    loop consumes. Verdict strings are the `constants.PRESSURE_*`
    vocabulary; everything here is derived purely from host-side
    telemetry already collected."""

    window: int
    t: float
    replicas: Dict[str, str]
    tenants: Dict[str, str]
    slo_breached: Dict[str, bool]
    headroom: float
    slot_headroom: float
    kv_headroom: float
    slots_free: int
    slots_total: int
    replicas_active: int
    # Utilization plane (serving/accounting.py, the `metricsexporter`
    # port): this window's generated tokens per chip-HOUR of wall
    # capacity — the "tok/s per chip-hour" denominator ROADMAP item 2's
    # autoscale loop scores carves on — and the fraction of the
    # window's wall chip-seconds the duty-cycle decomposition classed
    # as waste (idle/draining/unreachable/recovery/spill traffic).
    # Both derive purely from the journaled window rows, so replay
    # reproduces them. The wall denominator (dt_s x tp_devices) exists
    # for any sampled fleet; an UNPROFILED engine contributes zero
    # busy, so its whole wall reads as idle waste — arm the tick
    # profiler (EngineTracing) for a real decomposition.
    tok_s_per_chip_hour: float = 0.0
    waste_fraction: float = 0.0

    def to_dict(self) -> Dict[str, object]:
        return asdict(self)


# ---------------------------------------------------------------------------
# The monitor
# ---------------------------------------------------------------------------
class FleetMonitor:
    """Samples a `ReplicaSet` on a cadence and derives the pressure
    plane. Thread-safe: `sample()` (manual or from the optional
    background thread) and every reader serialize on one lock. The
    monitor only READS engine state — outputs are bit-identical
    monitor-on vs monitor-off."""

    def __init__(
        self,
        replica_set,
        slo=None,
        metrics=None,
        max_windows: int = 128,
        journal_windows: int = 512,
        max_frozen: int = 4,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        ledger=None,
        tenant_idle_windows: int = 8,
    ):
        """`slo` is an `SLOTracker` or a plain ``{tenant: SLOTarget}``
        dict (None = no SLO evaluation). `metrics` is an
        `observability.Metrics` registry for the ``nos_tpu_fleet_*``
        series (None = no publishing). `max_windows` bounds the
        per-replica/per-tenant rate rings, `journal_windows` the JSONL
        journal, `max_frozen` the recovery-frozen journal snapshots.
        `interval_s` paces the optional `start()` thread; manual
        `sample()` ignores it. `clock` is injectable for deterministic
        window math in tests.

        `ledger` (optional, serving/accounting.py CostLedger — the one
        shared with the fleet's engines) adds the per-tenant
        ``nos_tpu_tenant_cost_*`` gauge series to each sample's
        publish. `tenant_idle_windows` is the label-hygiene horizon:
        a tenant with NO activity (tokens, admissions, waiting, or
        fresh latency samples) for more than this many consecutive
        windows has every per-tenant gauge series removed and its rate
        ring dropped — bounded label cardinality over the ACTIVE tenant
        set; a returning tenant re-seeds cleanly because the cumulative
        per-replica baselines are kept (its first active window diffs
        against the last snapshot, never against zero)."""
        self.replica_set = replica_set
        self.slo = _coerce_slo(slo)
        self.metrics = metrics
        self.ledger = ledger
        self.tenant_idle_windows = int(tenant_idle_windows)
        self.max_windows = int(max_windows)
        self.journal_windows = int(journal_windows)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        # Previous cumulative snapshots, per replica id.
        self._prev_report: Dict[str, object] = {}
        self._prev_tenant: Dict[str, Dict[str, dict]] = {}
        self._prev_t: Dict[str, float] = {}
        # Latency-sample read cursors: (replica, tenant, kind) -> count
        # of samples already folded into earlier windows.
        self._cursors: Dict[Tuple[str, str, str], int] = {}
        # Bounded window rings.
        self._rings: Dict[str, deque] = {}
        self._tenant_rings: Dict[str, deque] = {}
        self._journal: deque = deque(maxlen=self.journal_windows)
        self._frozen: deque = deque(maxlen=int(max_frozen))
        # Which replica ids currently own published gauge series.
        self._published: set = set()
        # Tenant label hygiene: which tenants own published series, and
        # the last window each showed activity (the idle-sweep clock).
        self._tenant_published: set = set()
        self._tenant_last_active: Dict[str, int] = {}
        self.windows_sampled = 0
        self.sample_wall_s = 0.0
        self.last_report: Optional[PressureReport] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()

    # -- sampling -------------------------------------------------------------
    def sample(self, now: Optional[float] = None) -> PressureReport:
        """Take one sampling window across every non-retired replica and
        return the derived `PressureReport`. `now` overrides the clock
        (deterministic window math in tests/replayable benches)."""
        t0 = time.perf_counter()
        with self._lock:
            report = self._sample_locked(now)
            self.sample_wall_s += time.perf_counter() - t0
        return report

    def _unreachable_row_locked(
        self, rid: str, handle, now: float, kind: str
    ) -> Dict[str, object]:
        """The window row of a replica whose probe raised/timed out:
        every rate and gauge zero (unknown, and deliberately not
        counted as capacity — see `fleet_headroom`), `probe_error`
        carrying the classified kind so `classify_replica` — live and
        on replay — derives the UNREACHABLE verdict from the row
        alone. `dt_s` still spans the window (clock since the last
        GOOD sample) so the duty-cycle decomposition can account the
        wall as WASTE_UNREACHABLE — a provisional verdict: baselines
        are kept, so the window after the replica returns re-attributes
        the gap with real counter deltas."""
        prev_t = self._prev_t.get(rid)
        dt = max(0.0, now - prev_t) if prev_t is not None else 0.0
        row: Dict[str, object] = {
            "replica_id": rid,
            "lifecycle": handle.state,
            "t": now,
            "dt_s": round(dt, 6),
            "probe_error": kind,
            "tokens": 0,
            "prefill_tokens": 0,
            "admissions": 0,
            "recoveries": 0,
            "tok_s": 0.0,
            "prefill_tok_s": 0.0,
            "admissions_s": 0.0,
            "spills_s": 0.0,
            "revives_s": 0.0,
            "recoveries_s": 0.0,
            "preemptions_s": 0.0,
            "queue_depth": 0,
            "slots_active": 0,
            "slots_total": 0,
            "prefill_backlog": 0,
            "kv_blocks_free": 0,
            "kv_blocks_total": 0,
            constants.PROBE_KEY_DRAINING: False,
        }
        # Last-known width, so the unreachable wall scales to the chips
        # that went dark (a fleet loses tp chip-seconds, not 1).
        prev = self._prev_report.get(rid)
        row[constants.PROBE_KEY_TP_DEVICES] = int(
            getattr(prev, "tp_devices", 1) or 1
        )
        row["pressure"] = classify_replica(row)
        row[constants.ACCT_KEY_DUTY] = duty_cycle(row)
        return row

    def _sample_locked(self, now: Optional[float]) -> PressureReport:
        now = float(self._clock() if now is None else now)
        self.windows_sampled += 1
        window = self.windows_sampled
        replica_rows: Dict[str, Dict[str, object]] = {}
        tenant_acc: Dict[str, Dict[str, object]] = {}
        recovered: List[str] = []

        def _tacc(tenant: str) -> Dict[str, object]:
            return tenant_acc.setdefault(
                tenant,
                {
                    "tokens": 0,
                    "admissions": 0,
                    "waiting": 0,
                    "usage": 0.0,
                    "min_share": 0.0,
                    "quota_starved": False,
                    "quota_borrower": False,
                    "ttft": [],
                    "queue_wait": [],
                },
            )

        for handle in list(self.replica_set.handles):
            rid = handle.replica_id
            if handle.state == constants.REPLICA_STATE_RETIRED:
                self._drop_replica_locked(rid)
                continue
            engine = handle.engine
            try:
                report = collect_serving(engine)
                probe = engine.probe()
                tprobe = (
                    engine.tenant_probe()
                    if hasattr(engine, "tenant_probe")
                    else {}
                )
            except Exception as exc:
                # An unreachable replica must not be silently swallowed
                # (the old thread-level backstop hid the death) NOR take
                # the rest of the fleet's window down with it: classify
                # the fault, emit an UNREACHABLE row (one-hot state
                # gauge included via the normal publish path), journal
                # the event, and keep sampling the other replicas. The
                # cumulative baselines are KEPT so a replica that comes
                # back diffs against its last good sample.
                kind = classify_fault(exc)
                row = self._unreachable_row_locked(rid, handle, now, kind)
                replica_rows[rid] = row
                self._rings.setdefault(
                    rid, deque(maxlen=self.max_windows)
                ).append(row)
                self._journal.append(
                    json.dumps(
                        {
                            "v": 1,
                            "event": constants.FLEET_EV_UNREACHABLE,
                            "window": window,
                            "t": now,
                            "replica": rid,
                            "kind": kind,
                        },
                        sort_keys=True,
                    )
                )
                logger.warning(
                    "fleet monitor: probe of %s failed (%s); marked "
                    "unreachable for this window",
                    rid,
                    kind,
                )
                continue
            prev = self._prev_report.get(rid)
            prev_t = self._prev_t.get(rid)
            dt = max(0.0, now - prev_t) if prev_t is not None else 0.0
            delta = report_delta(report, prev)
            rates = report_rates(report, prev, dt)
            prev_tenants = self._prev_tenant.get(rid, {})
            adm_delta = sum(
                max(
                    0,
                    int(row.get(constants.TENANT_KEY_ADMISSIONS, 0))
                    - int(
                        prev_tenants.get(t, {}).get(
                            constants.TENANT_KEY_ADMISSIONS, 0
                        )
                    ),
                )
                for t, row in tprobe.items()
            )
            row: Dict[str, object] = {
                "replica_id": rid,
                "lifecycle": handle.state,
                "t": now,
                "dt_s": round(dt, 6),
                # Window work (deltas) and rates.
                "tokens": delta["tokens"],
                "prefill_tokens": delta["prefill_tokens"],
                "admissions": adm_delta,
                "recoveries": delta["recoveries"],
                "tok_s": rates["tokens"],
                "prefill_tok_s": rates["prefill_tokens"],
                "admissions_s": adm_delta / dt if dt > 0 else 0.0,
                "spills_s": rates["spills"],
                "revives_s": rates["revives"],
                "recoveries_s": rates["recoveries"],
                "preemptions_s": rates["preemptions"],
                # Point-in-time gauges.
                "queue_depth": int(
                    probe.get(constants.PROBE_KEY_QUEUED_REQUESTS, 0)
                ),
                "slots_active": int(
                    probe.get(constants.PROBE_KEY_ACTIVE_SLOTS, 0)
                ),
                "slots_total": int(probe.get(constants.PROBE_KEY_SLOTS_TOTAL, 0)),
                "prefill_backlog": int(
                    probe.get(constants.PROBE_KEY_PREFILL_BACKLOG, 0)
                ),
                "kv_blocks_free": int(report.kv_blocks_free),
                "kv_blocks_total": int(
                    probe.get(constants.PROBE_KEY_KV_BLOCKS_TOTAL, 0)
                ),
                constants.PROBE_KEY_DRAINING: bool(
                    probe.get(constants.PROBE_KEY_DRAINING, False)
                ),
            }
            # Duty-cycle inputs (serving/accounting.py): profiler and
            # recovery-time deltas over the window, journaled so replay
            # re-derives the exact decomposition. All zeros when the
            # engine runs unprofiled — the window then decomposes to
            # idle waste, never raises.
            def _fdelta(attr: str) -> float:
                cur_v = float(getattr(report, attr, 0.0) or 0.0)
                prev_v = float(getattr(prev, attr, 0.0) or 0.0) if prev else 0.0
                return max(0.0, cur_v - prev_v)

            def _phase_delta(phase: str) -> float:
                cur_v = float(
                    dict(getattr(report, "tick_phase_s", {}) or {}).get(phase, 0.0)
                )
                prev_v = (
                    float(
                        dict(getattr(prev, "tick_phase_s", {}) or {}).get(
                            phase, 0.0
                        )
                    )
                    if prev
                    else 0.0
                )
                return max(0.0, cur_v - prev_v)

            def _restore_sum(rep) -> float:
                return sum(
                    float(v)
                    for v in getattr(rep, "restore_latency_samples", ()) or ()
                )

            row[constants.PROBE_KEY_TP_DEVICES] = int(report.tp_devices or 1)
            # ACCT_KEY_TICK_WALL_S's value deliberately mirrors the
            # ServingReport field name it windows over.
            row[constants.ACCT_KEY_TICK_WALL_S] = _fdelta(
                constants.ACCT_KEY_TICK_WALL_S
            )
            row[constants.ACCT_KEY_DISPATCH_S] = _fdelta("tick_dispatch_s")
            row[constants.ACCT_KEY_HOST_S] = _fdelta("tick_host_overhead_s")
            row[constants.ACCT_KEY_IDLE_S] = _phase_delta(
                constants.TICK_PHASE_IDLE
            )
            row[constants.ACCT_KEY_REVIVE_S] = _phase_delta(
                constants.TICK_PHASE_PUMP_REVIVES
            )
            row[constants.ACCT_KEY_RESTORE_S] = max(
                0.0,
                _restore_sum(report) - (_restore_sum(prev) if prev else 0.0),
            )
            row[constants.ACCT_KEY_KV_BLOCK_TICKS] = delta.get(
                constants.ACCT_KEY_KV_BLOCK_TICKS, 0
            )
            row["pressure"] = classify_replica(row)
            row[constants.ACCT_KEY_DUTY] = duty_cycle(row)
            replica_rows[rid] = row
            self._rings.setdefault(rid, deque(maxlen=self.max_windows)).append(row)
            if delta["recoveries"] > 0:
                recovered.append(rid)
            # Per-tenant accumulation (fleet-pooled).
            for tenant, prow in tprobe.items():
                acc = _tacc(tenant)
                prev_row = prev_tenants.get(tenant, {})
                acc["tokens"] += max(
                    0,
                    int(prow.get(constants.TENANT_KEY_TOKENS, 0))
                    - int(prev_row.get(constants.TENANT_KEY_TOKENS, 0)),
                )
                acc["admissions"] += max(
                    0,
                    int(prow.get(constants.TENANT_KEY_ADMISSIONS, 0))
                    - int(prev_row.get(constants.TENANT_KEY_ADMISSIONS, 0)),
                )
                waiting = int(prow.get(constants.TENANT_KEY_WAITING, 0))
                acc["waiting"] += waiting
                acc["usage"] = max(
                    float(acc["usage"]),
                    float(prow.get(constants.TENANT_KEY_USAGE, 0.0)),
                )
                acc["min_share"] = max(
                    float(acc["min_share"]),
                    float(prow.get(constants.TENANT_KEY_MIN_SHARE, 0.0)),
                )
                # Starvation requires the quota conjunction on ONE
                # replica: under guarantee there AND waiting there —
                # the same condition quota preemption fires on.
                if prow.get(constants.TENANT_KEY_QUOTA_STARVED) and waiting > 0:
                    acc["quota_starved"] = True
                if prow.get(constants.TENANT_KEY_QUOTA_BORROWER):
                    acc["quota_borrower"] = True
            # Fresh latency samples this window (per-tenant lists grow
            # append-only on the engine; the cursor marks what earlier
            # windows consumed).
            for kind, attr in (
                ("ttft", "ttft_s_by_tenant"),
                ("queue_wait", "queue_wait_s_by_tenant"),
            ):
                for tenant, samples in dict(getattr(engine, attr, {}) or {}).items():
                    key = (rid, tenant, kind)
                    seen = self._cursors.get(key, 0)
                    fresh = [float(v) for v in list(samples)[seen:]]
                    self._cursors[key] = seen + len(fresh)
                    if fresh:
                        _tacc(tenant)[kind].extend(fresh)
            self._prev_report[rid] = report
            self._prev_tenant[rid] = tprobe
            self._prev_t[rid] = now

        # Per-tenant window rows.
        fleet_tokens = sum(int(a["tokens"]) for a in tenant_acc.values())
        fleet_dt = max(
            (float(r["dt_s"]) for r in replica_rows.values()), default=0.0
        )
        tenant_rows: Dict[str, Dict[str, object]] = {}
        for tenant, acc in sorted(tenant_acc.items()):
            ttft = acc.pop("ttft")
            queue_wait = acc.pop("queue_wait")
            trow: Dict[str, object] = dict(acc)
            trow["tenant"] = tenant
            trow["tok_s"] = (
                int(acc["tokens"]) / fleet_dt if fleet_dt > 0 else 0.0
            )
            trow["admissions_s"] = (
                int(acc["admissions"]) / fleet_dt if fleet_dt > 0 else 0.0
            )
            trow["share"] = (
                int(acc["tokens"]) / fleet_tokens if fleet_tokens > 0 else 0.0
            )
            trow["ttft_p95_s"] = percentile(ttft, 95) if ttft else None
            trow["queue_wait_p95_s"] = (
                percentile(queue_wait, 95) if queue_wait else None
            )
            trow["verdict"] = classify_tenant(trow)
            if self.slo is not None:
                demand = bool(
                    int(acc["waiting"])
                    or int(acc["tokens"])
                    or int(acc["admissions"])
                )
                trow["slo_window_breach"] = self.slo.observe_window(
                    tenant,
                    ttft_p95_s=trow["ttft_p95_s"],
                    queue_wait_p95_s=trow["queue_wait_p95_s"],
                    tok_s=float(trow["tok_s"]),
                    demand=demand,
                    window=window,
                )
                trow["slo_breached"] = self.slo.breached(tenant)
            else:
                trow["slo_window_breach"] = False
                trow["slo_breached"] = False
            tenant_rows[tenant] = trow
            # Label-hygiene clock: any activity this window (work done,
            # work waiting, or fresh latency samples) re-arms the
            # tenant's gauge series; pure idleness ages it toward the
            # sweep.
            if (
                int(acc["tokens"])
                or int(acc["admissions"])
                or int(acc["waiting"])
                or ttft
                or queue_wait
            ):
                self._tenant_last_active[tenant] = window
            # A tenant past the idle horizon stops accumulating ring
            # rows too (the engines' probe surface remembers every
            # historical tenant forever — the monitor must not).
            if (
                self._tenant_last_active.get(tenant, -1)
                >= window - self.tenant_idle_windows
            ):
                self._tenant_rings.setdefault(
                    tenant, deque(maxlen=self.max_windows)
                ).append(trow)

        head = fleet_headroom(replica_rows)
        # Fleet utilization roll-up (serving/accounting.py): pure over
        # the same rows the journal carries, so replay reproduces it.
        util = fleet_utilization(replica_rows)
        pressure = PressureReport(
            window=window,
            t=now,
            replicas={rid: str(r["pressure"]) for rid, r in replica_rows.items()},
            tenants={t: str(r["verdict"]) for t, r in tenant_rows.items()},
            slo_breached={
                t: bool(r["slo_breached"]) for t, r in tenant_rows.items()
            },
            headroom=float(head["headroom"]),
            slot_headroom=float(head["slot_headroom"]),
            kv_headroom=float(head["kv_headroom"]),
            slots_free=int(head["slots_free"]),
            slots_total=int(head["slots_total"]),
            replicas_active=int(head["replicas_active"]),
            tok_s_per_chip_hour=float(
                util[constants.ACCT_KEY_TOK_S_PER_CHIP_HOUR]
            ),
            waste_fraction=float(util[constants.ACCT_KEY_WASTE_FRACTION]),
        )
        self._journal.append(
            json.dumps(
                {
                    "v": 1,
                    "event": constants.FLEET_EV_WINDOW,
                    "window": window,
                    "t": now,
                    "replicas": replica_rows,
                    "tenants": tenant_rows,
                    "pressure": pressure.to_dict(),
                },
                sort_keys=True,
            )
        )
        if recovered:
            # The monitor-plane postmortem: an engine recovery froze the
            # flight recorder's ring; the windows LEADING UP to
            # the fault deserve the same treatment, so a future
            # autoscaler can replay what the fleet looked like before a
            # replica went down.
            self._frozen.append(
                {
                    "event": constants.FLEET_EV_FREEZE,
                    "window": window,
                    "t": now,
                    "replicas": sorted(recovered),
                    "lines": list(self._journal),
                }
            )
        if self.metrics is not None:
            self._publish_locked(replica_rows, tenant_rows, pressure)
        self.last_report = pressure
        return pressure

    # -- gauge publishing / hygiene -------------------------------------------
    def _publish_locked(self, replica_rows, tenant_rows, pressure) -> None:
        m = self.metrics
        for rid, row in replica_rows.items():
            m.set_gauge("nos_tpu_fleet_tok_s", float(row["tok_s"]), replica=rid)
            m.set_gauge(
                "nos_tpu_fleet_admissions_s",
                float(row["admissions_s"]),
                replica=rid,
            )
            m.set_gauge(
                "nos_tpu_fleet_prefill_tok_s",
                float(row["prefill_tok_s"]),
                replica=rid,
            )
            m.set_gauge(
                "nos_tpu_fleet_queue_depth", float(row["queue_depth"]), replica=rid
            )
            m.set_gauge(
                "nos_tpu_fleet_slots_active",
                float(row["slots_active"]),
                replica=rid,
            )
            m.set_gauge(
                "nos_tpu_fleet_kv_blocks_free",
                float(row["kv_blocks_free"]),
                replica=rid,
            )
            for state in constants.PRESSURE_REPLICA_STATES:
                m.set_gauge(
                    "nos_tpu_fleet_replica_state",
                    1.0 if row["pressure"] == state else 0.0,
                    replica=rid,
                    state=state,
                )
            m.set_gauge(
                "nos_tpu_fleet_util_busy_chip_s",
                float(
                    row[constants.ACCT_KEY_DUTY][constants.ACCT_KEY_BUSY_CHIP_S]
                ),
                replica=rid,
            )
            m.set_gauge(
                "nos_tpu_fleet_util_waste_chip_s",
                float(
                    row[constants.ACCT_KEY_DUTY][constants.ACCT_KEY_WASTE_CHIP_S]
                ),
                replica=rid,
            )
            self._published.add(rid)
        # Tenant label hygiene: publish only tenants ACTIVE within the
        # idle horizon; everyone else is swept below — per-tenant label
        # cardinality stays bounded by the live tenant set.
        horizon = self.windows_sampled - self.tenant_idle_windows
        cost_totals = (
            self.ledger.tenant_totals() if self.ledger is not None else {}
        )
        for tenant, trow in tenant_rows.items():
            if self._tenant_last_active.get(tenant, -1) < horizon:
                continue
            self._tenant_published.add(tenant)
            for field, value in cost_totals.get(tenant, {}).items():
                m.set_gauge(_cost_gauge(field), float(value), tenant=tenant)
            m.set_gauge(
                "nos_tpu_fleet_tenant_tok_s", float(trow["tok_s"]), tenant=tenant
            )
            m.set_gauge(
                "nos_tpu_fleet_tenant_waiting",
                float(trow["waiting"]),
                tenant=tenant,
            )
            m.set_gauge(
                "nos_tpu_fleet_tenant_slo_breached",
                1.0 if trow["slo_breached"] else 0.0,
                tenant=tenant,
            )
            if trow["ttft_p95_s"] is not None:
                m.set_gauge(
                    "nos_tpu_fleet_tenant_ttft_p95_s",
                    float(trow["ttft_p95_s"]),
                    tenant=tenant,
                )
            for state in constants.PRESSURE_TENANT_STATES:
                m.set_gauge(
                    "nos_tpu_fleet_tenant_state",
                    1.0 if trow["verdict"] == state else 0.0,
                    tenant=tenant,
                    state=state,
                )
        m.set_gauge("nos_tpu_fleet_headroom", pressure.headroom)
        m.set_gauge("nos_tpu_fleet_slots_free", float(pressure.slots_free))
        m.set_gauge(
            "nos_tpu_fleet_replicas_active", float(pressure.replicas_active)
        )
        m.set_gauge("nos_tpu_fleet_windows_sampled", float(self.windows_sampled))
        m.set_gauge(
            "nos_tpu_fleet_util_tok_s_per_chip_hour",
            float(pressure.tok_s_per_chip_hour),
        )
        m.set_gauge(
            "nos_tpu_fleet_util_waste_fraction", float(pressure.waste_fraction)
        )
        self._sweep_idle_tenants_locked()

    def _sweep_idle_tenants_locked(self) -> None:
        """The tenant mirror of replica-retirement gauge hygiene: every
        per-tenant series of a tenant idle beyond `tenant_idle_windows`
        is REMOVED from the registry (a quiet tenant frozen at its last
        rate reads as live load and its label set grows without bound),
        and its rate ring is dropped. Cumulative baselines are KEPT —
        a returning tenant's first active window diffs against its last
        snapshot, so its series re-seed with correct deltas."""
        horizon = self.windows_sampled - self.tenant_idle_windows
        stale = [
            t
            for t in self._tenant_published
            if self._tenant_last_active.get(t, -1) < horizon
        ]
        for tenant in stale:
            for name in PER_TENANT_GAUGES:
                self.metrics.remove_gauge(name, tenant=tenant)
            for state in constants.PRESSURE_TENANT_STATES:
                self.metrics.remove_gauge(
                    "nos_tpu_fleet_tenant_state", tenant=tenant, state=state
                )
            for field in constants.COST_FIELDS:
                self.metrics.remove_gauge(_cost_gauge(field), tenant=tenant)
            self._tenant_published.discard(tenant)
            self._tenant_rings.pop(tenant, None)
            self._tenant_last_active.pop(tenant, None)

    def _drop_replica_locked(self, rid: str) -> None:
        """Gauge/ring hygiene for a retired replica: its rate rings,
        cumulative baselines and sample cursors are dropped, and every
        per-replica gauge series it owned is REMOVED from the registry —
        a retired replica frozen at its last value on /metrics reads as
        live capacity and poisons fleet merges."""
        self._rings.pop(rid, None)
        self._prev_report.pop(rid, None)
        self._prev_tenant.pop(rid, None)
        self._prev_t.pop(rid, None)
        for key in [k for k in self._cursors if k[0] == rid]:
            del self._cursors[key]
        if self.metrics is not None and rid in self._published:
            for name in PER_REPLICA_GAUGES:
                self.metrics.remove_gauge(name, replica=rid)
            for state in constants.PRESSURE_REPLICA_STATES:
                self.metrics.remove_gauge(
                    "nos_tpu_fleet_replica_state", replica=rid, state=state
                )
        self._published.discard(rid)

    # -- background cadence ---------------------------------------------------
    def start(self) -> "FleetMonitor":
        """Spin the optional background sampling thread (deployments;
        tests and the bench tick `sample()` manually)."""
        if self._thread is not None:
            return self
        self._stop_ev.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.sample()
            except Exception as exc:
                # Last-resort backstop: per-replica probe failures are
                # already handled INSIDE `sample()` (unreachable rows),
                # so only monitor-internal faults land here — classify
                # them like every other fleet-loop error instead of
                # hiding the death behind a bare log line.
                logger.exception(
                    "fleet monitor sample failed (%s)", classify_fault(exc)
                )

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- readers --------------------------------------------------------------
    def replica_windows(self, replica_id: str) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._rings.get(replica_id, ()))

    def tenant_windows(self, tenant: str) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._tenant_rings.get(tenant, ()))

    def journal_lines(self) -> List[str]:
        """The bounded JSONL journal, oldest first — one
        `constants.FLEET_EV_WINDOW` line per sampling window."""
        with self._lock:
            return list(self._journal)

    def frozen_journals(self) -> List[Dict[str, object]]:
        """Journal snapshots frozen on observed engine recoveries."""
        with self._lock:
            return list(self._frozen)

    def pressure_snapshot(self) -> Dict[str, object]:
        """The `/debug/pressure` payload: the latest verdict, latest
        per-replica/per-tenant window rows, SLO state, and journal
        bookkeeping. Counts/ids/seconds only."""
        with self._lock:
            return {
                "windows_sampled": self.windows_sampled,
                "report": (
                    self.last_report.to_dict()
                    if self.last_report is not None
                    else None
                ),
                "replicas": {
                    rid: ring[-1] for rid, ring in self._rings.items() if ring
                },
                "tenants": {
                    t: ring[-1] for t, ring in self._tenant_rings.items() if ring
                },
                "slo": self.slo.snapshot() if self.slo is not None else None,
                "journal_lines": len(self._journal),
                "journal_capacity": self.journal_windows,
                "frozen_journals": len(self._frozen),
                "sample_wall_s": round(self.sample_wall_s, 6),
            }

    # -- journal replay -------------------------------------------------------
    @staticmethod
    def replay(lines, slo=None) -> List[PressureReport]:
        """Re-derive `PressureReport`s (and optionally SLO state) from
        recorded journal lines alone. The classification functions are
        pure functions of the journaled window rows, so replaying a
        journal reproduces exactly the verdicts the live monitor
        emitted — which is what lets a future autoscaler be unit-tested
        against recorded traffic instead of a live fleet."""
        tracker = _coerce_slo(slo)
        reports: List[PressureReport] = []
        for line in lines:
            rec = json.loads(line) if isinstance(line, str) else dict(line)
            if rec.get("event") != constants.FLEET_EV_WINDOW:
                continue
            replica_rows = rec.get("replicas", {})
            tenant_rows = rec.get("tenants", {})
            replicas = {
                rid: classify_replica(row) for rid, row in replica_rows.items()
            }
            # Recompute headroom from rows carrying the REPLAYED verdicts.
            head_rows = {
                rid: {**row, "pressure": replicas[rid]}
                for rid, row in replica_rows.items()
            }
            tenants: Dict[str, str] = {}
            slo_map: Dict[str, bool] = {}
            for tenant, trow in tenant_rows.items():
                tenants[tenant] = classify_tenant(trow)
                if tracker is not None:
                    demand = bool(
                        int(trow.get("waiting", 0) or 0)
                        or int(trow.get("tokens", 0) or 0)
                        or int(trow.get("admissions", 0) or 0)
                    )
                    tracker.observe_window(
                        tenant,
                        ttft_p95_s=trow.get("ttft_p95_s"),
                        queue_wait_p95_s=trow.get("queue_wait_p95_s"),
                        tok_s=float(trow.get("tok_s", 0.0) or 0.0),
                        demand=demand,
                        window=int(rec.get("window", 0)),
                    )
                    slo_map[tenant] = tracker.breached(tenant)
                else:
                    slo_map[tenant] = bool(trow.get("slo_breached", False))
            head = fleet_headroom(head_rows)
            # Re-derive the utilization roll-up from the journaled raw
            # fields (duty_cycle is pure over them — the attached
            # `duty` dicts are ignored), so replay == live extends to
            # the accounting plane. Rows from journals predating the
            # plane decompose to zero and contribute nothing.
            util = fleet_utilization(replica_rows)
            reports.append(
                PressureReport(
                    window=int(rec.get("window", 0)),
                    t=float(rec.get("t", 0.0)),
                    replicas=replicas,
                    tenants=tenants,
                    slo_breached=slo_map,
                    headroom=float(head["headroom"]),
                    slot_headroom=float(head["slot_headroom"]),
                    kv_headroom=float(head["kv_headroom"]),
                    slots_free=int(head["slots_free"]),
                    slots_total=int(head["slots_total"]),
                    replicas_active=int(head["replicas_active"]),
                    tok_s_per_chip_hour=float(
                        util[constants.ACCT_KEY_TOK_S_PER_CHIP_HOUR]
                    ),
                    waste_fraction=float(
                        util[constants.ACCT_KEY_WASTE_FRACTION]
                    ),
                )
            )
        return reports
