"""Port of the cost ledger of `nos_tpu/serving/accounting.py`: `CostLedger`
(:253), copied near verbatim, with the port's own constants.

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

The reference module's fleet half, `duty_cycle` (:88),
`fleet_utilization` (:152) and `utilization_block` (:193), reads the
fleet monitor's window rows and waits for the serving plane (ROADMAP A8
step 5).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

from nos_tpu_torch import constants


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
