"""Port of `nos_tpu/runtime/quota.py`, copied near verbatim: `TenantShare`
(:54), `QuotaPolicy` (:93) and `DEFAULT_TENANT`; only the constants come
from the port's own copy.

Elastic tenant quotas for the serving engine — the paper's second
feature (ElasticQuota min/max, over-quota borrowing, preemption-based
fair sharing) ported from the batch scheduler onto decode ticks.

`nos_tpu/controllers/quota.py` reconciles the SAME semantics against simulated
pods: sort the quota's consumers deterministically, label each
`in-quota` while cumulative usage stays within `min` and `over-quota`
beyond it, and let preemption key on the over-quota labels
(capacity_scheduling.go:550,574 upstream). Here the resource is
the engine's decode token throughput instead of accelerator memory, the
reconcile interval is the tick instead of a watch event, and the
preemption mechanism is a slot checkpoint (runtime/checkpoint.py) + KV
spill (runtime/spill.py) instead of a pod delete — reversible by
construction, so fair sharing costs a replay, never a request.

Semantics:

  - every tenant holds a `TenantShare(min_share, max_share)` over the
    engine's recent decode-token throughput (a sliding window of ticks);
  - **borrowing**: idle capacity is free — a tenant may run past its
    `min_share` whenever nobody under-min is waiting (the engine counts
    such ticks as `borrowed_ticks`);
  - **ceiling**: a tenant at/over `max_share` (< 1.0) is not admitted
    further work until its share decays — admission skips its queued
    requests in place (order otherwise preserved);
  - **preemption**: when a *starved* tenant (share < min_share) has a
    request waiting that the engine cannot host, borrowers are preempted
    lowest-priority-first — most-over-quota tenant first, youngest slot
    (largest serial) first within it — until the request fits. Slots of
    the starved tenant and of other under-min tenants are never victims.

Tenancy is optional at every level: requests without a tenant map to the
default share (min 0, max 1 — "best effort": always a borrower, never
guaranteed), and an engine constructed without a policy has zero quota
behavior at all.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from nos_tpu_torch import constants

#: Tenant name requests without an explicit tenant are accounted under.
DEFAULT_TENANT = ""

#: The shared immutable idle-tick window entry (`observe_idle_tick`):
#: appended by reference so an idle tick allocates nothing. Never
#: mutated — `observe_tick` always builds a fresh dict for real entries.
_EMPTY_TICK: Dict[str, int] = {}


@dataclass(frozen=True)
class TenantShare:
    """One tenant's elastic quota over the engine's decode token rate.

    `min_share` is the GUARANTEED fraction of the window's decode tokens
    (the ElasticQuota `min`): while the tenant's observed share is below
    it and it has work waiting, the engine may preempt borrowers to make
    room. `max_share` is the CEILING (`max`): admission stops feeding
    the tenant once its share reaches it. `max_share >= 1.0` means "may
    borrow everything" — a sole tenant's share is 1.0 by definition, so
    only sub-1.0 ceilings ever throttle.

    `kv_dtype` (optional) PINS the tenant to a KV-pool quality tier
    (docs/quantized-kv.md): "fp16" keeps a guaranteed tenant on exact
    native pools in a mixed fleet, "int8" opts a cost-tier tenant into
    the cheaper quantized pools. None (default) = no preference, any
    pool serves. Engines REJECT a submit whose pin contradicts their
    pool at admission time, and the prefix router filters candidate
    replicas by the pin — the knob routes, it never silently degrades."""

    min_share: float = 0.0
    max_share: float = 1.0
    kv_dtype: Optional[str] = None

    def __post_init__(self):
        if not (0.0 <= self.min_share <= self.max_share):
            raise ValueError(
                f"need 0 <= min_share <= max_share, got "
                f"min={self.min_share} max={self.max_share}"
            )
        if self.kv_dtype is not None:
            if self.kv_dtype not in constants.KV_DTYPES:
                raise ValueError(
                    f"kv_dtype must be None or one of {constants.KV_DTYPES}: "
                    f"{self.kv_dtype!r}"
                )


class QuotaPolicy:
    """Deterministic per-tenant token-rate accounting + victim selection.

    Pure host-side state driven by `observe_tick`; every query is a
    function of the window contents, so the same traffic produces the
    same admission/preemption decisions — which is what lets the quota
    tests demand bit-identical outputs vs solo runs."""

    def __init__(
        self,
        tenants: Dict[str, TenantShare],
        window_ticks: int = 128,
        default: TenantShare = TenantShare(0.0, 1.0),
    ):
        if window_ticks < 1:
            raise ValueError("window_ticks must be >= 1")
        self.tenants = dict(tenants)
        self.default = default
        self._window: Deque[Dict[str, int]] = deque(maxlen=int(window_ticks))
        self._totals: Dict[str, int] = {}
        self._window_total = 0
        self.ticks = 0
        #: Ticks where some tenant dispatched tokens while over its min —
        #: the "idle capacity is borrowable" witness.
        self.borrowed_ticks = 0

    # -- accounting ----------------------------------------------------------
    def share_of(self, tenant: Optional[str]) -> TenantShare:
        return self.tenants.get(tenant or DEFAULT_TENANT, self.default)

    def observe_tick(self, tokens_by_tenant: Dict[str, int]) -> None:
        """Fold one tick's decode-token production into the window."""
        self.ticks += 1
        entry = {t: int(n) for t, n in tokens_by_tenant.items() if n > 0}
        if len(self._window) == self._window.maxlen:
            old = self._window[0]
            for t, n in old.items():
                self._totals[t] -= n
                if self._totals[t] <= 0:
                    del self._totals[t]
                self._window_total -= n
        self._window.append(entry)
        for t, n in entry.items():
            self._totals[t] = self._totals.get(t, 0) + n
            self._window_total += n
        if any(
            self.usage(t) > self.share_of(t).min_share and n > 0
            for t, n in entry.items()
        ):
            self.borrowed_ticks += 1

    def observe_idle_tick(self) -> None:
        """O(1), allocation-free fold of a tick that produced no tokens
        (the idle-tick fast path): appends the shared immutable
        empty entry so the window still advances — a ceiling-blocked
        tenant's share keeps decaying across idle ticks — without
        rebuilding a dict, scanning tenants, or running the borrow
        check per tick. Equivalent to ``observe_tick({})`` by
        construction (an empty entry has no totals to add and can never
        witness borrowing); the idle-tick counter test pins the shared-
        entry identity."""
        self.ticks += 1
        if len(self._window) == self._window.maxlen:
            old = self._window[0]
            if old:
                for t, n in old.items():
                    self._totals[t] -= n
                    if self._totals[t] <= 0:
                        del self._totals[t]
                    self._window_total -= n
        self._window.append(_EMPTY_TICK)

    def usage(self, tenant: Optional[str]) -> float:
        """The tenant's fraction of all decode tokens in the window
        (0.0 while the window is empty)."""
        if self._window_total <= 0:
            return 0.0
        return self._totals.get(tenant or DEFAULT_TENANT, 0) / self._window_total

    # -- labels (the in-quota / over-quota classification) -------------------
    def is_borrower(self, tenant: Optional[str]) -> bool:
        """Over-quota label: running at/above its guaranteed share —
        preemptible when a guaranteed tenant is starved. min 0 tenants
        are borrowers even at zero usage (no guarantee at all)."""
        return self.usage(tenant) >= self.share_of(tenant).min_share

    def is_starved(self, tenant: Optional[str]) -> bool:
        """Under its guarantee: only tenants with min_share > 0 qualify."""
        return self.usage(tenant) < self.share_of(tenant).min_share

    def over_ceiling(self, tenant: Optional[str]) -> bool:
        share = self.share_of(tenant)
        if share.max_share >= 1.0:
            return False
        return self.usage(tenant) >= share.max_share

    def admission_blocked(self, tenant: Optional[str], starved_waiting: bool) -> bool:
        """Whether admission should SKIP this tenant's queued requests
        right now: at its ceiling, or borrowing while a starved
        guaranteed tenant has work waiting (the freed capacity belongs
        to the guarantee, not to the borrower's re-admission)."""
        if self.over_ceiling(tenant):
            return True
        return starved_waiting and self.is_borrower(tenant) and not self.is_starved(tenant)

    # -- preemption ----------------------------------------------------------
    def select_victim(
        self,
        candidates: List[Tuple[int, Optional[str], int]],
        protect: Optional[str],
    ) -> Optional[int]:
        """Pick the active slot to preempt for a starved `protect`
        tenant, from `(slot_idx, tenant, serial)` candidates.
        Lowest-priority-first, deterministically: borrowers only, the
        most-over-quota tenant's slots first (largest usage - min
        excess), youngest admission (largest serial) within a tenant —
        the serving analog of the reference's over-quota-label +
        deterministic-sort preemption order. Returns None when no
        candidate is preemptible (the starved tenant then simply
        waits)."""
        protect = protect or DEFAULT_TENANT
        best = None
        best_key = None
        for idx, tenant, serial in candidates:
            name = tenant or DEFAULT_TENANT
            if name == protect or not self.is_borrower(name) or self.is_starved(name):
                continue
            excess = self.usage(name) - self.share_of(name).min_share
            key = (excess, serial)
            if best_key is None or key > best_key:
                best_key = key
                best = idx
        return best
