"""Port of `nos_tpu/serving/accounting.py`: the cost ledger `CostLedger`
(:253) and the fleet half, copied near verbatim, with the port's own
constants.

Per-tenant cost attribution: the engine (`DecodeServer(...,
cost_ledger=CostLedger())`) charges slot-seconds, decode tokens, charged
and cached prefill tokens, KV-block-tick products, spill and revive
bytes and replay tokens to the request's tenant at its existing
bookkeeping sites, and closes a bounded per-request receipt, keyed by
the trace id, at the request's finish or failure. Tenant and trace
identity ride `SlotCheckpoint`, so a preempted or restored stream's
charges follow it. The ledger only observes host bookkeeping the engine
already does: outputs and dispatch counters are the same with it armed
or not, and it never touches the device.

The fleet half, `duty_cycle` (:88), `fleet_utilization` (:152) and
`utilization_block` (:193), copied near verbatim: per replica window, the
wall chip-seconds (``tp_devices x dt``) split into busy (the tick
profiler's dispatch wall), host overhead and a named waste taxonomy
(`constants.WASTE_*`: idle and unmeasured slack, draining, unreachable
windows, recovery, spill/revive copies). The split is a pure function of
the journaled window-row fields, so `FleetMonitor.replay` reproduces the
live verdict from the journal alone, and it is exact by construction:
busy + overhead + waste == wall. On CUDA the profiler's dispatch wall is
host issue time (tracing.py), so "busy" is the host's time inside device
calls, not the card's busy share.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, Optional

from nos_tpu_torch import constants

#: ServingReport float/dict fields the duty-cycle decomposition windows
#: over (monitor-side deltas). Kept here so the monitor and the bench
#: block derive from one list.
_PHASE_IDLE = constants.TICK_PHASE_IDLE
_PHASE_REVIVES = constants.TICK_PHASE_PUMP_REVIVES


def _nonneg(value) -> float:
    try:
        v = float(value or 0.0)
    except (TypeError, ValueError):
        return 0.0
    return v if v > 0.0 else 0.0


# ---------------------------------------------------------------------------
# Duty-cycle decomposition (pure over journaled rows)
# ---------------------------------------------------------------------------
def duty_cycle(row: Dict[str, object]) -> Dict[str, object]:
    """Decompose one replica window row's wall chip-seconds into
    busy / host-overhead / named-waste buckets.

    Pure over the journaled fields (`constants.ACCT_KEY_*` inputs +
    ``dt_s`` / ``probe_error`` / lifecycle), so replaying a journal
    reproduces exactly the live decomposition; a row missing the inputs
    (an old journal) decomposes to zero busy with the whole window in
    `WASTE_IDLE` — absent data contributes nothing, never raises.

    The partition is exact by construction: every term is clamped into
    what remains of the window, and the residual lands in a waste
    bucket, so ``busy + overhead + sum(waste) == wall`` (the coverage
    the acceptance gate demands, via counter math rather than a
    tolerance). Recovery time overlapping replay dispatches is
    attributed BUSY first — the recovery bucket captures the host-side
    remainder of the restore-latency window."""
    tp = max(1, int(row.get(constants.PROBE_KEY_TP_DEVICES, 1) or 1))
    dt = _nonneg(row.get("dt_s"))
    waste = {cause: 0.0 for cause in constants.WASTE_CAUSES}
    if row.get("probe_error"):
        # The window is UNKNOWN, not zero: its whole wall is waste the
        # operator should see (the replica's baselines are kept, so the
        # next good window attributes the work done meanwhile).
        busy = overhead = 0.0
        waste[constants.WASTE_UNREACHABLE] = dt
    else:
        busy = min(dt, _nonneg(row.get(constants.ACCT_KEY_DISPATCH_S)))
        host_raw = min(dt - busy, _nonneg(row.get(constants.ACCT_KEY_HOST_S)))
        # Wall the engine never even ticked through (thread sleeping,
        # manual-tick gaps): unmeasured slack.
        slack = max(0.0, dt - busy - host_raw)
        idle = min(host_raw, _nonneg(row.get(constants.ACCT_KEY_IDLE_S)))
        revive = min(
            host_raw - idle, _nonneg(row.get(constants.ACCT_KEY_REVIVE_S))
        )
        recovery = min(
            host_raw - idle - revive,
            _nonneg(row.get(constants.ACCT_KEY_RESTORE_S)),
        )
        overhead = host_raw - idle - revive - recovery
        draining = bool(
            row.get(constants.PROBE_KEY_DRAINING)
            or (
                row.get("lifecycle") is not None
                and row.get("lifecycle") != constants.REPLICA_STATE_ACTIVE
            )
        )
        if draining:
            waste[constants.WASTE_DRAINING] = slack + idle
        else:
            waste[constants.WASTE_IDLE] = slack + idle
        waste[constants.WASTE_SPILL_REVIVE] = revive
        waste[constants.WASTE_RECOVERY] = recovery
    waste_chip = {k: v * tp for k, v in waste.items()}
    return {
        constants.ACCT_KEY_WALL_CHIP_S: dt * tp,
        constants.ACCT_KEY_BUSY_CHIP_S: busy * tp,
        constants.ACCT_KEY_OVERHEAD_CHIP_S: overhead * tp,
        constants.ACCT_KEY_WASTE_CHIP_S: sum(waste_chip.values()),
        constants.ACCT_KEY_WASTE: waste_chip,
    }


def fleet_utilization(
    replica_rows: Dict[str, Dict[str, object]], tokens: Optional[int] = None
) -> Dict[str, object]:
    """Sum `duty_cycle` over one window's replica rows and derive the
    planner-facing normalizations: chip-hours, generated tokens per
    chip-hour (`tok_s_per_chip_hour` — the ROADMAP item-2 scoring
    denominator), and the waste fraction. `tokens` defaults to the sum
    of the rows' windowed token deltas. Pure over the rows — replay and
    live derive identical roll-ups."""
    wall = busy = overhead = waste_total = 0.0
    waste = {cause: 0.0 for cause in constants.WASTE_CAUSES}
    row_tokens = 0
    for row in replica_rows.values():
        duty = duty_cycle(row)
        wall += float(duty[constants.ACCT_KEY_WALL_CHIP_S])
        busy += float(duty[constants.ACCT_KEY_BUSY_CHIP_S])
        overhead += float(duty[constants.ACCT_KEY_OVERHEAD_CHIP_S])
        waste_total += float(duty[constants.ACCT_KEY_WASTE_CHIP_S])
        for cause, v in duty[constants.ACCT_KEY_WASTE].items():
            waste[cause] = waste.get(cause, 0.0) + float(v)
        row_tokens += int(row.get("tokens", 0) or 0)
    if tokens is None:
        tokens = row_tokens
    chip_hours = wall / 3600.0
    return {
        constants.ACCT_KEY_CHIP_SECONDS: wall,
        constants.ACCT_KEY_CHIP_HOURS: chip_hours,
        constants.ACCT_KEY_BUSY_CHIP_S: busy,
        constants.ACCT_KEY_OVERHEAD_CHIP_S: overhead,
        constants.ACCT_KEY_WASTE_CHIP_S: waste_total,
        constants.ACCT_KEY_WASTE: waste,
        "tokens": int(tokens),
        constants.ACCT_KEY_TOK_S_PER_CHIP_HOUR: (
            float(tokens) / chip_hours if chip_hours > 0.0 else 0.0
        ),
        constants.ACCT_KEY_WASTE_FRACTION: (
            waste_total / wall if wall > 0.0 else 0.0
        ),
    }


def utilization_block(
    reports: Iterable, tokens: Optional[int] = None
) -> Dict[str, object]:
    """The bench-artifact form of the decomposition: chip-second
    accounting over CUMULATIVE per-engine ServingReports (profiler
    totals rather than monitor-window deltas). Wall here is the
    engines' PROFILED tick wall — counter math end to end, so the
    busy + overhead + waste == wall identity is exact regardless of
    machine load. A duty cycle is not MFU: its busy share is host time
    inside device calls (runtime/mfu.py computes MFU)."""
    rows: Dict[str, Dict[str, object]] = {}
    derived_tokens = 0
    for i, rep in enumerate(reports):
        phase = dict(getattr(rep, "tick_phase_s", {}) or {})
        derived_tokens += sum(
            int(v)
            for v in dict(getattr(rep, "macro_tokens_by_slot", {}) or {}).values()
        ) + int(getattr(rep, "spec_tokens_accepted", 0) or 0)
        rows[str(i)] = {
            # ACCT_KEY_TICK_WALL_S's value deliberately mirrors the
            # ServingReport field name it reads.
            "dt_s": float(
                getattr(rep, constants.ACCT_KEY_TICK_WALL_S, 0.0) or 0.0
            ),
            constants.PROBE_KEY_TP_DEVICES: int(
                getattr(rep, "tp_devices", 1) or 1
            ),
            constants.ACCT_KEY_DISPATCH_S: float(
                getattr(rep, "tick_dispatch_s", 0.0) or 0.0
            ),
            constants.ACCT_KEY_HOST_S: float(
                getattr(rep, "tick_host_overhead_s", 0.0) or 0.0
            ),
            constants.ACCT_KEY_IDLE_S: float(phase.get(_PHASE_IDLE, 0.0)),
            constants.ACCT_KEY_REVIVE_S: float(
                phase.get(_PHASE_REVIVES, 0.0)
            ),
            constants.ACCT_KEY_RESTORE_S: sum(
                float(v)
                for v in getattr(rep, "restore_latency_samples", ()) or ()
            ),
        }
    block = fleet_utilization(
        rows, tokens=derived_tokens if tokens is None else tokens
    )
    wall = float(block[constants.ACCT_KEY_CHIP_SECONDS])
    attributed = (
        float(block[constants.ACCT_KEY_BUSY_CHIP_S])
        + float(block[constants.ACCT_KEY_OVERHEAD_CHIP_S])
        + float(block[constants.ACCT_KEY_WASTE_CHIP_S])
    )
    # The counter-math identity witness the smoke gates on.
    block["identity_residual_s"] = wall - attributed
    return block



class CostLedger:
    """Per-tenant cost attribution + bounded per-request receipts.

    ALL ledger state (`_cost_tenants`, `_cost_open`, `_cost_receipts`)
    is mutated ONLY inside this class, the same single-mutator
    discipline the pool, the spill tier and the radix tree keep. The
    invariants it buys: every charge lands in exactly one tenant total
    and at most one receipt, receipts stay bounded, and the charge
    vocabulary is closed over `constants.COST_FIELDS` (an unknown field
    raises at the charge site instead of silently minting a new
    column).

    Thread-safe: engine threads charge, client/debug threads read.
    Share ONE ledger across a replica fleet (like the Tracer) so a
    stream's charges follow it across preemption, drain migration, and
    failover — the receipt key is the trace id, which rides
    SlotCheckpoint.

    Charges on a key whose receipt already CLOSED fold into the closed
    receipt (a release's trailing slot-seconds arrive after the finish
    terminus); charges with key None update tenant totals only (an
    engine without a tracer still bills tenants)."""

    def __init__(self, max_receipts: int = 512):
        self.max_receipts = int(max_receipts)
        self._lock = threading.Lock()
        # tenant -> {COST_* field: value}
        self._cost_tenants: Dict[str, Dict[str, float]] = {}
        # open per-request accumulators / closed receipts, both keyed by
        # trace id; closed receipts are a bounded FIFO ring.
        self._cost_open: "OrderedDict[str, dict]" = OrderedDict()
        self._cost_receipts: "OrderedDict[str, dict]" = OrderedDict()
        self.receipts_issued = 0
        self.dropped_receipts = 0

    # -- mutation (the single-mutator surface) --------------------------------
    def _tenant_locked(self, tenant: str) -> Dict[str, float]:
        acct = self._cost_tenants.get(tenant)
        if acct is None:
            acct = {f: 0.0 for f in constants.COST_FIELDS}
            self._cost_tenants[tenant] = acct
        return acct

    def open_request(self, key: Optional[str], tenant: Optional[str]) -> None:
        """Begin (or CONTINUE — restores/migrations re-open) a
        request's receipt accumulator. No-op for key None."""
        if key is None:
            return
        tenant = tenant or ""
        with self._lock:
            if key in self._cost_receipts or key in self._cost_open:
                return
            self._cost_open[key] = {
                "key": key,
                "tenant": tenant,
                "t_open": time.monotonic(),
                **{f: 0.0 for f in constants.COST_FIELDS},
            }

    def charge(
        self, key: Optional[str], tenant: Optional[str], **fields
    ) -> None:
        """Bill `fields` (a subset of `constants.COST_FIELDS`) to the
        tenant's totals and, when `key` names a known receipt, to that
        receipt. Unknown fields raise — the charge vocabulary is the
        protocol."""
        for name in fields:
            if name not in constants.COST_FIELDS:
                raise ValueError(
                    f"unknown cost field {name!r}; the charge vocabulary is "
                    f"constants.COST_FIELDS"
                )
        tenant = tenant or ""
        with self._lock:
            acct = self._tenant_locked(tenant)
            for name, value in fields.items():
                acct[name] += float(value)
            if key is None:
                return
            target = self._cost_open.get(key)
            if target is None:
                target = self._cost_receipts.get(key)
            if target is None:
                # A charge racing ahead of open_request (or after a
                # receipt aged out of the ring): keep the tenant totals,
                # open an accumulator so the stream's receipt survives.
                target = {
                    "key": key,
                    "tenant": tenant,
                    "t_open": time.monotonic(),
                    **{f: 0.0 for f in constants.COST_FIELDS},
                }
                self._cost_open[key] = target
            for name, value in fields.items():
                target[name] += float(value)

    def close_request(
        self,
        key: Optional[str],
        tenant: Optional[str],
        status: str = constants.RECEIPT_STATUS_OK,
        tokens: Optional[int] = None,
    ) -> Optional[dict]:
        """Finalize the request's receipt at the req.finish/failure
        terminus and move it into the bounded receipt ring. Returns the
        receipt (also retrievable via `receipt(key)`), or None for key
        None / an already-closed key."""
        if key is None:
            return None
        with self._lock:
            rec = self._cost_open.pop(key, None)
            if rec is None:
                return None
            rec["tenant"] = tenant or rec.get("tenant") or ""
            rec["status"] = str(status)
            rec["dur_s"] = time.monotonic() - rec.pop("t_open")
            if tokens is not None:
                rec["tokens"] = int(tokens)
            self._cost_receipts[key] = rec
            self.receipts_issued += 1
            while len(self._cost_receipts) > self.max_receipts:
                self._cost_receipts.popitem(last=False)
                self.dropped_receipts += 1
            return dict(rec)

    # -- readers --------------------------------------------------------------
    def receipt(self, key: str) -> Optional[dict]:
        """The request's receipt: closed if available, else the live
        open accumulator (status absent until the terminus)."""
        with self._lock:
            rec = self._cost_receipts.get(key)
            if rec is None:
                rec = self._cost_open.get(key)
            return dict(rec) if rec is not None else None

    def tenant_totals(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {t: dict(acct) for t, acct in self._cost_tenants.items()}

    def charged_slot_seconds(self) -> float:
        """Sum of per-tenant charged slot-seconds — the left side of the
        conservation law (the right side is the fleet's summed
        `slot_seconds_total`)."""
        with self._lock:
            return sum(
                acct[constants.COST_SLOT_SECONDS]
                for acct in self._cost_tenants.values()
            )

    def snapshot(self) -> Dict[str, object]:
        """The `/debug/accounting` payload: per-tenant totals plus
        receipt bookkeeping and the most recent receipts. Counts, ids
        and seconds only — the house privacy contract."""
        with self._lock:
            return {
                "tenants": {
                    t: dict(acct) for t, acct in self._cost_tenants.items()
                },
                "open_requests": len(self._cost_open),
                "receipts_issued": self.receipts_issued,
                "dropped_receipts": self.dropped_receipts,
                "receipt_capacity": self.max_receipts,
                "receipts": [
                    dict(rec) for rec in list(self._cost_receipts.values())[-32:]
                ],
            }
