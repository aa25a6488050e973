"""Port of `nos_tpu/scheduler/scheduler.py:1` (:1-1137): `Scheduler` (:63).
Copied verbatim; only the imports point at the port, which imports nothing
of the JAX package.

The quota- and topology-aware scheduler loop (nos-scheduler analog).

Wires the plugin framework over the in-memory cluster: pending pods are
scheduled priority-first; infeasible pods get the Unschedulable PodScheduled
condition — which is exactly the signal the partitioner controller batches on,
closing the loop of SURVEY.md §3.1/§3.2 — and PostFilter preemption may evict
victims and nominate a node.
"""

from __future__ import annotations

import logging
import time as _time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Node, Pod, PodCondition, PodPhase
from nos_tpu_torch.api.resources import ResourceList
from nos_tpu_torch.cluster.client import Cluster, NotFoundError
from nos_tpu_torch.partitioning.core.interface import NodeInfo
from nos_tpu_torch.scheduler.framework import CycleState, Framework, Status
from nos_tpu_torch.scheduler.plugins.capacity import CapacityScheduling
from nos_tpu_torch.scheduler.plugins.noderesources import (
    EndAlignedScore,
    LeastAllocatedScore,
    NodeResourcesFit,
    NodeSelectorFilter,
)
from nos_tpu_torch.scheduler.plugins.topology import TpuTopologyFilter, TpuTopologyScore
from nos_tpu_torch.scheduler.resource_calculator import ResourceCalculator
from nos_tpu_torch.util import pod as podutil

logger = logging.getLogger(__name__)


from nos_tpu_torch.tpu.profile import chips_of_resources as _tpu_chips


@dataclass
class _Reservation:
    """Drain-set backfill reservation for the head capacity-blocked unit.

    The reference has no temporal model at all — an unschedulable pod just
    waits (SURVEY.md §2.3), which on a TPU mesh lets small late arrivals
    starve pod-scale gangs into an all-large drain tail that idles whole
    sub-meshes. One reservation per pass bounds that. `protected` is the
    cheapest node set whose drain covers the holder's chips (earliest
    drain-complete first, from the running pods' bound-at +
    expected-duration stamps) and `start_at` is when that drain completes.
    A later unit schedules normally EXCEPT it may not take capacity on a
    protected node unless it provably completes before `start_at` — so
    work keeps flowing everywhere else (consolidation victims rebind, small
    gangs fill the remainder) while the drain the holder needs actually
    converges."""

    holder: str
    chips: float
    start_at: float
    protected: frozenset


class Scheduler:
    def __init__(
        self,
        cluster: Cluster,
        calculator: Optional[ResourceCalculator] = None,
        scheduler_name: str = constants.SCHEDULER_NAME,
        bind_starts_pods: bool = True,
        now=None,
        backfill_min_fraction: Optional[float] = 0.9,
        backfill_after_s: float = 30.0,
        backfill_bypass_factor: float = 2.0,
        queue_policy: str = "fifo",
        swf_aging_chips: float = 16.0,
        swf_default_duration_s: float = 600.0,
        checkpoint_preempt_after_s: Optional[float] = 120.0,
        checkpoint_min_gain_s: float = 60.0,
        checkpoint_victim_cooldown_s: float = 300.0,
        checkpoint_victim_budget: int = 3,
        checkpoint_victim_window_s: float = 3600.0,
    ):
        self.cluster = cluster
        self._now = now if now is not None else _time.time
        # Drain-set reservations (None = never arm) default to arming only
        # for near-whole-cluster units (>= 0.9): smaller units churn through
        # free capacity, and reserving for them during saturation idles more
        # chips than their tail wait costs (docs/dynamic-partitioning.md has
        # the measurement matrix); a full-mesh gang, by contrast, can starve
        # INDEFINITELY behind a stream of smaller gangs — nothing short of a
        # reservation ever drains the whole mesh for it.
        # When enabled: only units at least `backfill_min_fraction` of the
        # cluster's chips, pending at least `backfill_after_s`, AND provably
        # starving arm one. Starvation is MEASURED, not timed: a unit arms
        # only after `backfill_bypass_factor` x its own chips have bound past
        # it while it sat blocked. Time-based arming can't discriminate the
        # two tail regimes (measured on the north-star trace): a stuck
        # full-mesh gang watching an endless 8x8 stream (arm: +21 points
        # busy-window) vs one whose supply dries up so the mesh drains
        # naturally anyway (arming there forces a pointless mid-run drain,
        # -7 points).
        self.backfill_min_fraction = backfill_min_fraction
        self.backfill_after_s = backfill_after_s
        self.backfill_bypass_factor = backfill_bypass_factor
        # Queue ordering within a priority band. "fifo" is arrival order
        # (kube-scheduler semantics). "aged-swf" is shortest-work-first with
        # aging: units rank by estimated chip-seconds (chips x stamped
        # expected-duration; unstamped pods assume `swf_default_duration_s`)
        # minus an aging credit of `swf_aging_chips` chip-seconds per pending
        # second — so small work binds first (an oversubscribed backlog's p50
        # is queue-depth-bound, and most of the queue is small), while every
        # unit's rank monotonically rises to the front: starvation-free by
        # construction, on top of the drain-set reservation for pod-scale
        # units. Priority still dominates: aging never crosses bands.
        if queue_policy not in ("fifo", "aged-swf"):
            raise ValueError(f"unknown queue_policy {queue_policy!r}")
        self.queue_policy = queue_policy
        self.swf_aging_chips = swf_aging_chips
        self.swf_default_duration_s = swf_default_duration_s
        # Checkpoint-aware reservation drain (the scheduler-side sibling of
        # the partitioner's consolidation fallback, same discipline and
        # defaults): an aged sticky holder whose protected drain set is
        # occupied ENTIRELY by declared-checkpointable workloads may evict
        # them — they resume from checkpoint, so the drain completes now
        # instead of at the natural end. Round 3 shipped this WITHOUT the
        # gain gate and churn ledger and had to revert it (mass evictions
        # at full-mesh scale live-locked the north-star trace); the gates
        # are what make it deployable. None disables.
        self.checkpoint_preempt_after_s = checkpoint_preempt_after_s
        self.checkpoint_min_gain_s = checkpoint_min_gain_s
        from nos_tpu_torch.util.churn import ChurnLedger

        self._churn = ChurnLedger(
            checkpoint_victim_cooldown_s,
            checkpoint_victim_budget,
            checkpoint_victim_window_s,
        )
        self._last_ckpt_drain_at: Optional[float] = None
        self._bypassed: dict = {}  # blocked unit name -> chips bound past it
        # Sticky drain set: re-picking the cheapest block every pass lets the
        # target drift as backfill lands, so no block ever finishes draining.
        # The holder keeps its block until it binds or vanishes. The sort key
        # scopes enforcement: only units RANKED BELOW the holder are gated.
        self._sticky_holder: Optional[str] = None
        self._sticky_protected: Optional[frozenset] = None
        self._sticky_chips: float = 0.0
        self._sticky_key: Optional[tuple] = None
        self.calculator = calculator or ResourceCalculator()
        self.scheduler_name = scheduler_name
        self.bind_starts_pods = bind_starts_pods
        self.capacity = CapacityScheduling(self.calculator, evict_fn=self._evict)
        self.framework = Framework(
            pre_filters=[self.capacity],
            filters=[
                NodeSelectorFilter(),
                NodeResourcesFit(self.calculator.compute_pod_request),
                TpuTopologyFilter(),
            ],
            scores=[
                LeastAllocatedScore(),
                TpuTopologyScore(),
                EndAlignedScore(self._now),
            ],
            reserves=[self.capacity],
            post_filters=[self.capacity],
            request_fn=self.calculator.compute_pod_request,
        )
        self.capacity.framework = self.framework
        # Pass-level node snapshot, kept coherent by binds AND evictions so
        # later pods in the same pass (incl. the preemptor on its nominated
        # node) don't filter against stale occupancy.
        self._pass_nodes: Optional[List[NodeInfo]] = None
        # No-op fast path: a pass that bound nothing and changed nothing is
        # pure recomputation — until the cluster mutates, rerunning it yields
        # the same nothing. Saturated-backlog simulations spend most ticks
        # exactly there.
        self._noop_at_version: Optional[int] = None
        # Aging makes scheduling time-driven, not just store-driven: a
        # capacity-blocked pod-scale unit arms a reservation once it is old
        # enough, with no store write involved. A recorded no-op pass
        # therefore expires when the youngest such candidate comes of age.
        self._noop_until: float = float("inf")
        self._capacity_version: Optional[int] = None

    # -- cluster views -------------------------------------------------------
    def node_infos(self) -> List[NodeInfo]:
        infos = []
        pods = [p for p in self.cluster.list("Pod") if podutil.is_active(p)]
        for node in self.cluster.list("Node"):
            requested = ResourceList()
            node_pods = []
            for p in pods:
                if p.spec.node_name == node.metadata.name:
                    requested = requested.add(self.calculator.compute_pod_request(p))
                    node_pods.append(p)
            infos.append(
                NodeInfo(
                    name=node.metadata.name,
                    labels=dict(node.metadata.labels),
                    allocatable=ResourceList(node.status.allocatable),
                    requested=requested,
                    pods=node_pods,
                )
            )
        return infos

    def pending_pods(self) -> List[Pod]:
        pods = self.cluster.list(
            "Pod",
            predicate=lambda p: (
                p.status.phase == PodPhase.PENDING
                and not p.spec.node_name
                and p.spec.scheduler_name == self.scheduler_name
            ),
        )
        return sorted(
            pods,
            key=lambda p: (
                -p.spec.priority,
                p.metadata.creation_timestamp,
                p.metadata.namespaced_name,
            ),
        )

    # -- scheduling ----------------------------------------------------------
    def schedule_pending(self) -> dict:
        """One full pass over the pending queue. Returns a summary dict.

        Node infos are snapshotted ONCE per pass (the kube-scheduler snapshot
        model) and updated incrementally as pods bind — re-listing the cluster
        per pod is O(pods^2 x objects) and dominated saturated-backlog runs."""
        version_at_start = self.cluster.version
        if version_at_start == self._noop_at_version and self._now() < self._noop_until:
            return {"bound": [], "unschedulable": [], "nominated": [], "skipped": True}
        self.refresh_capacity()
        bound, unschedulable, nominated = [], [], []
        pending = self.pending_pods()
        self.capacity.nominated_pods = [p for p in pending if p.status.nominated_node_name]
        nodes = self.node_infos()
        self._pass_nodes = nodes
        # Gangs are scheduling UNITS interleaved with single pods in priority
        # order (a gang handled before higher-priority singles would consume
        # shared quota out of turn). A gang's priority is its best member's.
        units: List[tuple] = []
        gangs: dict = {}
        for pod in pending:
            gang = podutil.gang_of(pod)
            if gang is None:
                units.append((self._unit_key([pod]), "pod", pod))
            else:
                gangs.setdefault(gang, []).append(pod)
        for gang_name, pods in gangs.items():
            units.append((self._unit_key(pods), "gang", (gang_name, pods)))
        # A live sticky reservation protects its drain set for the WHOLE
        # pass — seeded up front so units sorting ahead of the holder cannot
        # refill the protected nodes every pass and re-starve it. Rank still
        # wins: only units sorting BELOW the holder are gated. Under aged-swf
        # the keys drift between passes, so the holder's rank is re-read from
        # THIS pass's key (a stale key would mis-scope the gate as the holder
        # ages toward the front).
        reservation: Optional[_Reservation] = self._refresh_sticky(nodes)
        if self._sticky_holder is not None:
            for key, kind, item in units:
                name = item.metadata.namespaced_name if kind == "pod" else item[0]
                if name == self._sticky_holder:
                    self._sticky_key = key
                    break
        # Once the holder's checkpoint drain is imminent (aged, or within
        # one min-gain of aging) AND feasible (every current occupant of
        # the protected set declares checkpoint-resume — at fraction 0 the
        # drain can never fire and blocking backfill would only starve the
        # mesh), stop admitting even provably-short backfill onto the
        # protected set: a pod bound there now would be drained moments
        # later — a bind/requeue round trip the scheduler itself created.
        protect_hard = False
        if reservation is not None and self.checkpoint_preempt_after_s is not None:
            pre_holder = self._holder_pods(pending)
            if pre_holder:
                now = self._now()
                ready_at, victims = self._drain_assessment(nodes, pre_holder, now)
                protect_hard = (
                    victims is not None
                    and ready_at - now <= self.checkpoint_min_gain_s
                )
        next_arm_at: Optional[float] = None
        sticky_seen = False
        failed_large: List[Tuple[str, float]] = []  # blocked this pass
        pass_bound_chips = 0.0
        total_chips = sum(_tpu_chips(n.allocatable) for n in nodes)
        for unit in sorted(units, key=lambda u: u[0]):
            unit_key, kind, item = unit
            unit_pods = [item] if kind == "pod" else item[1]
            unit_name = (
                item.metadata.namespaced_name if kind == "pod" else item[0]
            )
            unit_chips = sum(
                _tpu_chips(self.calculator.compute_pod_request(p))
                for p in unit_pods
            )
            unit_nodes = nodes
            if (
                reservation is not None
                and unit_chips > 0
                and (self._sticky_key is None or unit_key > self._sticky_key)
            ):
                if protect_hard or not self._finishes_before(
                    unit_pods, reservation.start_at
                ):
                    # May not take capacity the holder's drain is producing:
                    # schedule against the unprotected remainder only.
                    unit_nodes = [
                        n for n in nodes if n.name not in reservation.protected
                    ]
            if kind == "gang":
                gang_name, pods = item
                g_bound, g_unsched, capacity_blocked = self._schedule_gangs(
                    {gang_name: pods}, unit_nodes
                )
                bound.extend(g_bound)
                unschedulable.extend(g_unsched)
                unit_ok = bool(g_bound)
            else:
                pod = item
                result = self.schedule_one(pod, unit_nodes)
                if result is None:
                    if pod.status.nominated_node_name:
                        nominated.append(pod.metadata.namespaced_name)
                        capacity_blocked = False  # preemption will free room
                    else:
                        unschedulable.append(pod.metadata.namespaced_name)
                        capacity_blocked = True
                    unit_ok = False
                else:
                    bound.append((pod.metadata.namespaced_name, result))
                    unit_ok = True
            if unit_name == self._sticky_holder:
                sticky_seen = True
                if unit_ok:
                    self._clear_sticky()
                    reservation = None
                    sticky_seen = False
            if unit_ok:
                if unit_chips > 0:
                    pass_bound_chips += unit_chips
            elif (
                capacity_blocked
                and self.backfill_min_fraction is not None
                and total_chips > 0
                and unit_chips >= self.backfill_min_fraction * total_chips
            ):
                bypassed = self._bypassed.setdefault(unit_name, 0.0)
                failed_large.append((unit_name, unit_chips))
                if (
                    reservation is None
                    and bypassed >= self.backfill_bypass_factor * unit_chips
                ):
                    arm_at = (
                        min(p.metadata.creation_timestamp for p in unit_pods)
                        + self.backfill_after_s
                    )
                    if self._now() >= arm_at:
                        reservation = self._try_reserve(
                            nodes, unit_pods, unit_name, unit_chips
                        )
                        if reservation is not None:
                            self._sticky_holder = unit_name
                            self._sticky_protected = reservation.protected
                            self._sticky_chips = unit_chips
                            self._sticky_key = unit_key
                            # Just armed: the pass-end stale-holder sweep
                            # must not clear it (the holder was processed
                            # before the sticky name existed).
                            sticky_seen = True
                    elif next_arm_at is None or arm_at < next_arm_at:
                        next_arm_at = arm_at  # too young: expires the no-op
        # Measured starvation: every chip bound in a pass where a pod-scale
        # unit stayed blocked counts against it — including binds of units
        # ahead of it in pass order (an old small-gang stream draining down
        # the queue starves a younger full-mesh gang just as surely).
        still_blocked = {name for name, _ in failed_large}
        if pass_bound_chips > 0:
            for name in still_blocked:
                self._bypassed[name] += pass_bound_chips
        self._bypassed = {
            n: v for n, v in self._bypassed.items() if n in still_blocked
        }
        if not sticky_seen and self._sticky_holder is not None:
            # The holder left the pending queue without binding through this
            # scheduler (deleted, or bound elsewhere): release its drain set.
            self._clear_sticky()
        if self._sticky_holder is not None:
            # Resolved from the PASS's pending list, not a pre-loop capture:
            # on the very pass that ARMS the reservation the holder name
            # only exists after the loop, and skipping the drain evaluation
            # there would freeze its age wake-up out of the no-op expiry.
            holder_pods = self._holder_pods(pending)
            if holder_pods:
                drain_retry = self._maybe_checkpoint_drain(nodes, holder_pods)
                if drain_retry is not None and (
                    next_arm_at is None or drain_retry < next_arm_at
                ):
                    # Time-driven drain condition (holder aging, pacing,
                    # victim cooldown): expire the no-op record when due.
                    next_arm_at = drain_retry
        if not bound and self.cluster.version == version_at_start:
            self._noop_at_version = version_at_start
            self._noop_until = next_arm_at if next_arm_at is not None else float("inf")
        return {"bound": bound, "unschedulable": unschedulable, "nominated": nominated}

    def _unit_key(self, pods: List[Pod]) -> tuple:
        """Queue rank of a scheduling unit (a pod, or a gang's members).
        FIFO: (-priority, oldest creation, name). aged-swf: (-priority,
        estimated chip-seconds minus the aging credit, creation, name) —
        see `queue_policy` in __init__ for the rationale."""
        prio, creation, nsname = min(
            (-p.spec.priority, p.metadata.creation_timestamp,
             p.metadata.namespaced_name)
            for p in pods
        )
        if self.queue_policy == "fifo":
            return (prio, creation, nsname)
        work = 0.0
        for p in pods:
            duration = podutil.expected_duration_s(p)
            if duration is None:
                duration = self.swf_default_duration_s
            work += _tpu_chips(self.calculator.compute_pod_request(p)) * duration
        age = max(0.0, self._now() - creation)
        return (prio, work - self.swf_aging_chips * age, creation, nsname)

    def refresh_capacity(self) -> None:
        """Rebuild quota infos from the cluster, at most once per store
        version (reserve/unreserve bookkeeping between refreshes nets out:
        every committed reservation also bumps the store via its bind)."""
        version = self.cluster.version
        if version != self._capacity_version:
            self.capacity.refresh_from_cluster(self.cluster)
            self._capacity_version = version

    def schedule_one(self, pod: Pod, nodes: Optional[List[NodeInfo]] = None) -> Optional[str]:
        state = CycleState()
        status = self.framework.run_pre_filter(state, pod)
        if not status.is_success:
            self._mark_unschedulable(pod, status)
            return None
        if nodes is None:
            nodes = self.node_infos()
        feasible = []
        for node in nodes:
            s = self.framework.run_filters_with_nominated_pods(
                state, pod, node, self.capacity.nominated_pods
            )
            if s.is_success:
                feasible.append(node)
        if not feasible:
            nominated_node, post_status = self.framework.run_post_filters(state, pod, nodes)
            if nominated_node:
                self._nominate(pod, nominated_node)
            else:
                self._mark_unschedulable(
                    pod,
                    Status.unschedulable(
                        f"0/{len(nodes)} nodes available", *post_status.reasons
                    ),
                )
            return None
        best = max(
            feasible,
            key=lambda n: (self.framework.run_scores(state, pod, n), n.name),
        )
        reserve_status = self.framework.run_reserve(state, pod, best.name)
        if not reserve_status.is_success:
            self._mark_unschedulable(pod, reserve_status)
            return None
        try:
            self._bind(pod, best.name)
        except Exception:
            self.framework.run_unreserve(state, pod, best.name)
            raise
        # Keep the pass-level snapshot coherent with the bind.
        best.requested = best.requested.add(self.calculator.compute_pod_request(pod))
        best.pods.append(pod)
        return best.name

    def _protected_victims(self, nodes: List[NodeInfo]) -> Optional[List[Pod]]:
        """TPU-consuming occupants of the sticky protected set, or None when
        a protected node vanished from the snapshot."""
        if not self._sticky_protected:
            return None
        by_name = {n.name: n for n in nodes}
        victims: List[Pod] = []
        for name in self._sticky_protected:
            node = by_name.get(name)
            if node is None:
                return None
            for p in node.pods:
                if _tpu_chips(self.calculator.compute_pod_request(p)) > 0:
                    victims.append(p)
        return victims

    def _holder_pods(self, pending: List[Pod]) -> List[Pod]:
        """The sticky holder's pending pods (a gang's members, or the one
        pod), by unit name."""
        if self._sticky_holder is None:
            return []
        return [
            p
            for p in pending
            if (podutil.gang_of(p) or p.metadata.namespaced_name)
            == self._sticky_holder
        ]

    def _drain_assessment(self, nodes, holder_pods: List[Pod], now: float):
        """(ready_at, victims) for the checkpoint drain: victims is the
        eviction set when every NON-temporal gate passes (occupants exist,
        none outranks the holder, ALL checkpointable, and the natural drain
        is provably further out than `checkpoint_min_gain_s` — unknown
        stamps count as unbounded), else None. ready_at is the earliest
        time every TIME gate clears (holder age, global pacing, the churn
        ledger). protect_hard and the drain itself share this assessment —
        two divergent copies once froze mesh-wide admission for a drain the
        gain gate would never allow (measured busy 0.90 -> 0.81)."""
        if self.checkpoint_preempt_after_s is None or not self._sticky_protected:
            return None, None
        victims = self._protected_victims(nodes)
        if not victims:  # vanished node (None) or already drained ([])
            return None, None
        holder_prio = max(p.spec.priority for p in holder_pods)
        if any(p.spec.priority > holder_prio for p in victims):
            return None, None
        if not all(podutil.is_checkpointable(p) for p in victims):
            return None, None
        end = podutil.latest_expected_end(victims, now)
        if end is not None and end - now <= self.checkpoint_min_gain_s:
            # The natural drain is imminent; eviction would buy less than
            # a requeue costs. Only writes change this.
            return None, None
        ready_at = (
            min(p.metadata.creation_timestamp for p in holder_pods)
            + self.checkpoint_preempt_after_s
        )
        if self._last_ckpt_drain_at is not None:
            ready_at = max(
                ready_at, self._last_ckpt_drain_at + self.checkpoint_min_gain_s
            )
        ready_at = max(
            ready_at,
            max(
                self._churn.eligible_at(p.metadata.namespaced_name, now)
                for p in victims
            ),
        )
        return ready_at, victims

    def _maybe_checkpoint_drain(
        self, nodes: List[NodeInfo], holder_pods: List[Pod]
    ) -> Optional[float]:
        """Evict the sticky holder's drain-set occupants when the shared
        assessment passes; returns the next time a time-driven gate
        unblocks (for the no-op expiry), or None when the drain fired /
        can only unblock via a store write."""
        now = self._now()
        ready_at, victims = self._drain_assessment(nodes, holder_pods, now)
        if victims is None:
            return None
        if ready_at > now:
            return ready_at
        end = podutil.latest_expected_end(victims, now)
        logger.info(
            "checkpoint drain: evicting %d checkpointable occupant(s) of "
            "%s's drain set (natural drain %s)",
            len(victims),
            self._sticky_holder,
            "unknown" if end is None else f"in {end - now:.0f}s",
        )
        for p in victims:
            self._churn.note(p.metadata.namespaced_name, now)
            self._evict(p)
        self._last_ckpt_drain_at = now
        from nos_tpu_torch.observability import metrics

        metrics.inc("nos_tpu_checkpoint_drains")
        return None

    # -- duration-aware backfill (drain-set reservation) ---------------------
    def _clear_sticky(self) -> None:
        self._sticky_holder = None
        self._sticky_protected = None
        self._sticky_chips = 0.0
        self._sticky_key = None

    def _drain_time(self, node: NodeInfo, now: float) -> Optional[float]:
        """When this node's TPU occupancy fully drains per the bound-at +
        expected-duration stamps; None when any occupant is unknown."""
        return podutil.latest_expected_end(
            node.pods,
            now,
            count_pod=lambda p: _tpu_chips(self.calculator.compute_pod_request(p)) > 0,
        )

    def _refresh_sticky(self, nodes: List[NodeInfo]) -> Optional[_Reservation]:
        """Rebuild the live reservation from the sticky drain set with a
        fresh drain-complete estimate; clears the sticky state (and returns
        None) if the set became unusable — a protected node gone, or an
        unknown-duration occupant landed on it."""
        if not self._sticky_holder or not self._sticky_protected:
            return None
        now = self._now()
        by_name = {n.name: n for n in nodes}
        start_at = now
        for name in self._sticky_protected:
            node = by_name.get(name)
            drain_at = self._drain_time(node, now) if node is not None else None
            if drain_at is None:
                self._clear_sticky()
                return None
            start_at = max(start_at, drain_at)
        return _Reservation(
            holder=self._sticky_holder,
            chips=self._sticky_chips,
            start_at=start_at,
            protected=self._sticky_protected,
        )

    def _finishes_before(self, pods: List[Pod], deadline: float) -> bool:
        """True iff every member carries an expected duration and the unit
        would provably complete before `deadline` if bound now. Unknown
        durations could run forever — never admit them onto a drain."""
        durations = [podutil.expected_duration_s(p) for p in pods]
        if any(d is None for d in durations):
            return False
        return self._now() + max(durations) <= deadline + 1e-9

    def _try_reserve(
        self,
        nodes: List[NodeInfo],
        pods: List[Pod],
        unit_name: str,
        unit_chips: float,
    ) -> Optional[_Reservation]:
        """Pick the holder's drain set: nodes in earliest-drain-complete
        order (a node's drain time = the latest expected end among its TPU
        pods; free capacity counts immediately) until their combined chip
        capacity covers the holder. Returns None when the unit is not
        genuinely capacity-blocked (quota rejects it, it can never fit) or
        unknown-duration occupancy makes every estimate undefined — backfill
        then stays unrestricted (the pre-reservation behavior). The estimate
        is count-level per node and deliberately optimistic about carve
        geometry: an early `start_at` only makes backfill MORE conservative,
        so fragmentation can delay the holder but never re-starve it."""
        state = CycleState()
        if not self.framework.run_pre_filter(state, pods[0]).is_success:
            return None
        now = self._now()
        drain_of: dict = {}  # node name -> drain-complete time (absent: unknown)
        cap_of: dict = {}
        for node in nodes:
            cap = _tpu_chips(node.allocatable)
            if cap <= 0:
                continue
            cap_of[node.name] = cap
            drain_at = self._drain_time(node, now)
            if drain_at is not None:
                drain_of[node.name] = drain_at
        profile = podutil.wanted_subslice_topology(pods[0])
        if profile is not None:
            if podutil.multislice_count(pods[0]) > 1:
                return None  # N-group spread: no single drain set to protect
            choice = self._cheapest_gang_block(nodes, profile, drain_of, now)
        else:
            # Single-node workload (a profile or whole-chip request carves
            # within one node's mesh): the earliest-draining node that alone
            # covers it. A scattered multi-node set would protect capacity
            # the holder can never combine.
            candidates = [
                (drain_of[n.name], n.name)
                for n in nodes
                if n.name in drain_of and cap_of.get(n.name, 0.0) >= unit_chips
            ]
            if not candidates:
                return None
            drain_at, name = min(candidates)
            choice = (frozenset([name]), max(drain_at, now))
        if choice is None:
            return None
        protected, start_at = choice
        logger.info(
            "backfill reservation: %s needs %g chips; draining %d node(s) "
            "until t=%.0f",
            unit_name,
            unit_chips,
            len(protected),
            start_at,
        )
        return _Reservation(
            holder=unit_name,
            chips=unit_chips,
            start_at=start_at,
            protected=frozenset(protected),
        )

    @staticmethod
    def _cheapest_gang_block(
        nodes: List[NodeInfo], profile, drain_of: dict, now: float
    ):
        """The gang analog of "earliest-draining node": among every legal
        placement of the gang's host-block footprint on each slice group's
        host grid (the same host-aligned orientation rule the
        GroupPartitioner packs with), pick the window whose occupants drain
        soonest. Protecting anything non-contiguous would idle hosts the
        holder can never combine into one ICI mesh. Returns (host names,
        drain-complete time) or None."""
        import itertools

        from nos_tpu_torch import constants as C
        from nos_tpu_torch.tpu.shape import Shape
        from nos_tpu_torch.tpu.slice_group import parse_host_coord

        by_group: dict = {}
        for n in nodes:
            sid = n.labels.get(C.LABEL_TPU_SLICE)
            raw_coord = n.labels.get(C.LABEL_TPU_HOST_COORD)
            host_topo = n.labels.get(C.LABEL_TPU_HOST_TOPOLOGY)
            if not sid or raw_coord is None or not host_topo:
                continue
            try:
                coord = parse_host_coord(raw_coord)
            except ValueError:
                continue
            group = by_group.setdefault(sid, {"hosts": {}, "host_topo": host_topo})
            group["hosts"][coord] = n.name
        best = None
        for group in by_group.values():
            try:
                host_shape = Shape.parse(group["host_topo"])
            except ValueError:
                continue
            coords = group["hosts"]
            rank = host_shape.rank
            if any(len(c) != rank for c in coords):
                continue
            # Host-aligned orientations of the chip profile (the planner's
            # congruence rule, slice_group.py plan_subslices).
            allowed = set()
            for o in profile.shape.orientations():
                if len(o.dims) == rank and all(
                    c % h == 0 for c, h in zip(o.dims, host_shape.dims)
                ):
                    allowed.add(
                        tuple(c // h for c, h in zip(o.dims, host_shape.dims))
                    )
            if not allowed or not coords:
                continue
            grid = tuple(max(c[i] for c in coords) + 1 for i in range(rank))
            for dims in allowed:
                if any(d > g for d, g in zip(dims, grid)):
                    continue
                # Buddy-aligned origins only, matching the planner's
                # pack_into(align=True): protecting a window the carve can
                # never land on would pin hosts the holder cannot use.
                for origin in itertools.product(
                    *(range(0, g - d + 1, d) for g, d in zip(grid, dims))
                ):
                    window = [
                        tuple(o + i for o, i in zip(origin, offset))
                        for offset in itertools.product(*(range(d) for d in dims))
                    ]
                    names = [coords.get(c) for c in window]
                    if any(n is None or n not in drain_of for n in names):
                        continue  # hole in the grid / unknown occupancy
                    drain_at = max(max(drain_of[n] for n in names), now)
                    if best is None or drain_at < best[1]:
                        best = (frozenset(names), drain_at)
        return best

    # -- gang scheduling (multi-host workloads) ------------------------------
    def _schedule_gangs(self, gangs: dict, nodes: List[NodeInfo]):
        """All-or-nothing binding of complete gangs onto ONE carved sub-slice:
        every member pod lands on a distinct host carrying the same
        subslice-id label. A multi-host JAX job is a single ICI mesh; pods
        scattered across different sub-slices (which plain per-pod scheduling
        would happily do, since every host of the right topology matches the
        node selector) would not be connected. The third return value reports
        whether any gang failed for CAPACITY (placement) reasons — the signal
        that arms a backfill reservation; membership/label misconfigurations
        must not (more chips would not help them)."""
        bound, unschedulable = [], []
        capacity_blocked = False
        for gang_name in sorted(gangs):
            pods = sorted(gangs[gang_name], key=lambda p: p.metadata.name)
            size = podutil.gang_size_of(pods[0])
            if len(pods) != size:
                # Too few: wait for the rest. Too many: mis-labeled gang —
                # either way every member gets a visible condition instead of
                # silent starvation.
                for pod in pods:
                    self._mark_unschedulable(
                        pod,
                        Status.unschedulable(
                            f"gang {gang_name}: {len(pods)}/{size} members present"
                        ),
                    )
                    unschedulable.append(pod.metadata.namespaced_name)
                continue
            count = podutil.multislice_count(pods[0])
            if size % count != 0:
                # Label misconfiguration, not a capacity problem: say so.
                for pod in pods:
                    self._mark_unschedulable(
                        pod,
                        Status.unschedulable(
                            f"gang {gang_name}: gang-size {size} not divisible "
                            f"by multislice-count {count}"
                        ),
                    )
                    unschedulable.append(pod.metadata.namespaced_name)
                continue
            placed = self._try_place_gang(gang_name, pods, nodes)
            if placed is None:
                capacity_blocked = True
                for pod in pods:
                    self._mark_unschedulable(
                        pod,
                        Status.unschedulable(
                            f"gang {gang_name}: no sub-slice with {size} free hosts"
                        ),
                    )
                    unschedulable.append(pod.metadata.namespaced_name)
            else:
                bound.extend(placed)
        return bound, unschedulable, capacity_blocked

    def _try_place_gang(
        self, gang_name: str, pods: List[Pod], nodes: List[NodeInfo]
    ) -> Optional[List]:
        """Find sub-slice(s) with enough feasible hosts and bind every pod;
        rolls back reservations if any member fails. A multislice gang
        (multislice-count=N) splits evenly over N same-topology sub-slices in
        N DISTINCT slice groups — ICI inside each sub-slice, DCN between
        them; two sub-slices of one pod would not be DCN peers."""
        from nos_tpu_torch import constants as C

        wanted = podutil.wanted_subslice_topology(pods[0])
        count = podutil.multislice_count(pods[0])
        by_subslice: dict = {}
        slice_group_of: dict = {}
        for node in nodes:
            sid = node.labels.get(C.LABEL_TPU_SUBSLICE_ID)
            if not sid:
                continue
            if wanted is not None and (
                node.labels.get(C.LABEL_TPU_SUBSLICE_TOPOLOGY) != wanted.name
            ):
                continue
            by_subslice.setdefault(sid, []).append(node)
            slice_group_of[sid] = node.labels.get(C.LABEL_TPU_SLICE, "")
        # Drop ids whose host set is not one contiguous block (see
        # _hosts_contiguous) — binding onto them would tear the gang's mesh.
        by_subslice = {
            sid: hosts
            for sid, hosts in by_subslice.items()
            if self._hosts_contiguous(hosts)
        }
        if count > 1:
            return self._try_place_multislice_gang(
                gang_name, pods, by_subslice, slice_group_of, count
            )
        for sid in sorted(by_subslice, key=lambda s: (len(by_subslice[s]), s)):
            hosts = by_subslice[sid]
            if len(hosts) < len(pods):
                continue
            state = CycleState()
            assignment = self._reserve_chunk(state, pods, hosts)
            if assignment is None:
                continue
            result = self._bind_assignment(state, gang_name, assignment)
            if result is not None:
                logger.info(
                    "gang %s bound to sub-slice %s (%d hosts)",
                    gang_name,
                    sid,
                    len(assignment),
                )
            return result
        return None

    @staticmethod
    def _hosts_contiguous(hosts: List[NodeInfo]) -> bool:
        """True iff the hosts' coord labels form one dense axis-aligned block
        (unknown coords => trust the label grouping, e.g. single-host tests)."""
        from nos_tpu_torch import constants as C
        from nos_tpu_torch.tpu.slice_group import parse_host_coord

        coords = []
        for h in hosts:
            raw = h.labels.get(C.LABEL_TPU_HOST_COORD)
            if raw is None:
                return True
            try:
                coords.append(parse_host_coord(raw))
            except ValueError:
                # One mislabeled host must not take down the scheduling pass
                # (same posture as GroupPartitioner's from_nodes guard):
                # treat its sub-slice as unusable.
                return False
        rank = len(coords[0])
        if any(len(c) != rank for c in coords):
            return False
        lo = tuple(min(c[i] for c in coords) for i in range(rank))
        hi = tuple(max(c[i] for c in coords) for i in range(rank))
        volume = 1
        for a, b in zip(lo, hi):
            volume *= b - a + 1
        return volume == len(set(coords)) == len(coords)

    def _reserve_chunk(
        self, state: CycleState, chunk: List[Pod], hosts: List[NodeInfo]
    ) -> Optional[List]:
        """Feasibility + reservation per member, in order: reserving against
        LIVE quota usage makes each subsequent member's PreFilter see its
        gang-mates' share (the same semantics the per-pod path gets from
        reserve-after-bind). On failure every reservation made here is rolled
        back and None is returned."""
        hosts = sorted(hosts, key=lambda n: n.name)
        assignment: List = []
        used_hosts: set = set()
        for pod in chunk:
            target = None
            if self.framework.run_pre_filter(state, pod).is_success:
                for host in hosts:
                    if host.name in used_hosts:
                        continue
                    if self.framework.run_filters_with_nominated_pods(
                        state, pod, host, self.capacity.nominated_pods
                    ).is_success:
                        target = host
                        break
            if target is None or not self.framework.run_reserve(
                state, pod, target.name
            ).is_success:
                for p, h in assignment:
                    self.framework.run_unreserve(state, p, h.name)
                return None
            used_hosts.add(target.name)
            assignment.append((pod, target))
        return assignment

    def _bind_assignment(
        self, state: CycleState, gang_name: str, assignment: List
    ) -> Optional[List]:
        """Commit a fully-reserved assignment: bind every member, keep the
        pass-level node snapshot coherent, roll everything back on failure."""
        bound_members = []
        try:
            for pod, host in assignment:
                self._bind(pod, host.name)
                bound_members.append((pod, host))
                host.requested = host.requested.add(
                    self.calculator.compute_pod_request(pod)
                )
                host.pods.append(pod)
        except Exception:
            for pod, host in assignment:
                self.framework.run_unreserve(state, pod, host.name)
            for pod, _ in bound_members:
                self._unbind(pod)
            logger.exception("gang %s: rollback", gang_name)
            return None
        return [
            (pod.metadata.namespaced_name, host.name) for pod, host in assignment
        ]

    def _try_place_multislice_gang(
        self,
        gang_name: str,
        pods: List[Pod],
        by_subslice: dict,
        slice_group_of: dict,
        count: int,
    ) -> Optional[List]:
        """Multislice placement: `count` sub-slices in DISTINCT slice groups,
        each hosting size/count members, under one CycleState so quota sees
        the whole gang. Candidate (group combination x sub-slice choice)
        sets are tried with backtracking, bounded to 20 attempts — the same
        cap the reference puts on NVML creation-order permutations
        (nvml/client.go:291-331) — so one occupied sub-slice cannot starve a
        feasible gang."""
        import itertools

        if len(pods) % count != 0:
            return None
        per = len(pods) // count
        eligible = [
            sid for sid, hosts in by_subslice.items() if len(hosts) >= per
        ]
        by_group: dict = {}
        for sid in sorted(eligible):
            by_group.setdefault(slice_group_of[sid], []).append(sid)
        if len(by_group) < count:
            return None
        groups_sorted = sorted(by_group, key=lambda g: (len(by_group[g]), g))
        attempts = 0
        for combo in itertools.combinations(groups_sorted, count):
            for sids in itertools.product(*(by_group[g] for g in combo)):
                attempts += 1
                if attempts > 20:
                    return None
                state = CycleState()
                assignment: List = []
                ok = True
                for chunk_idx, sid in enumerate(sids):
                    chunk = pods[chunk_idx * per:(chunk_idx + 1) * per]
                    got = self._reserve_chunk(state, chunk, by_subslice[sid])
                    if got is None:
                        ok = False
                        break
                    assignment.extend(got)
                if not ok:
                    for p, h in assignment:
                        self.framework.run_unreserve(state, p, h.name)
                    continue
                result = self._bind_assignment(state, gang_name, assignment)
                if result is not None:
                    logger.info(
                        "multislice gang %s bound across %s", gang_name, list(sids)
                    )
                return result
        return None

    # -- cluster mutations ---------------------------------------------------
    def _bind(self, pod: Pod, node_name: str) -> None:
        bound_at = self._now()

        def mutate(p: Pod) -> None:
            p.spec.node_name = node_name
            # Temporal stamp for duration-aware backfill: with the pod's
            # expected-duration annotation this yields its estimated end.
            p.metadata.annotations[constants.ANNOTATION_BOUND_AT] = f"{bound_at:.3f}"
            p.status.conditions = [
                c for c in p.status.conditions if c.type != "PodScheduled"
            ]
            p.status.conditions.append(
                PodCondition(type="PodScheduled", status="True", reason="Scheduled")
            )
            p.status.nominated_node_name = ""
            if self.bind_starts_pods:
                # Kubelet stand-in: bound pods start running immediately.
                p.status.phase = PodPhase.RUNNING

        self.cluster.patch("Pod", pod.metadata.namespace, pod.metadata.name, mutate)
        pod.spec.node_name = node_name
        logger.info("bound %s to %s", pod.metadata.namespaced_name, node_name)

    def _unbind(self, pod: Pod) -> None:
        """Gang rollback: return an already-bound member to pending."""

        def mutate(p: Pod) -> None:
            p.spec.node_name = ""
            p.status.phase = PodPhase.PENDING
            p.status.conditions = [
                c for c in p.status.conditions if c.type != "PodScheduled"
            ]

        try:
            self.cluster.patch("Pod", pod.metadata.namespace, pod.metadata.name, mutate)
        except NotFoundError:
            pass

    def _mark_unschedulable(self, pod: Pod, status: Status) -> None:
        # Only patch on transition: re-stamping an already-Unschedulable pod
        # every pass floods the watch bus (and the partitioner batcher) with
        # no-op events — O(backlog) patches per scheduling pass.
        if any(
            c.type == "PodScheduled" and c.status == "False" and c.reason == "Unschedulable"
            for c in pod.status.conditions
        ):
            return

        def mutate(p: Pod) -> None:
            p.status.conditions = [
                c for c in p.status.conditions if c.type != "PodScheduled"
            ]
            p.status.conditions.append(
                PodCondition(
                    type="PodScheduled",
                    status="False",
                    reason="Unschedulable",
                )
            )

        try:
            self.cluster.patch("Pod", pod.metadata.namespace, pod.metadata.name, mutate)
        except NotFoundError:
            pass

    def _nominate(self, pod: Pod, node_name: str) -> None:
        def mutate(p: Pod) -> None:
            p.status.nominated_node_name = node_name

        try:
            self.cluster.patch("Pod", pod.metadata.namespace, pod.metadata.name, mutate)
            pod.status.nominated_node_name = node_name
        except NotFoundError:
            return
        # Later pods in the SAME pass must account for this nomination — the
        # eviction already freed the victim's occupancy in the pass snapshot,
        # and without this the freed capacity looks up for grabs, starving
        # the preemptor in a re-preemption loop.
        if all(
            p.metadata.namespaced_name != pod.metadata.namespaced_name
            for p in self.capacity.nominated_pods
        ):
            self.capacity.nominated_pods.append(pod)

    def _evict(self, victim: Pod) -> None:
        """Preemption eviction: delete the pod (workload controllers recreate)."""
        try:
            self.cluster.delete("Pod", victim.metadata.namespace, victim.metadata.name)
        except NotFoundError:
            pass
        # Mirror what _bind_assignment does for binds: the snapshot must stop
        # showing the victim's occupancy or the preemptor waits an extra pass.
        if self._pass_nodes is not None and victim.spec.node_name:
            for info in self._pass_nodes:
                if info.name != victim.spec.node_name:
                    continue
                before = len(info.pods)
                info.pods = [
                    p
                    for p in info.pods
                    if p.metadata.namespaced_name != victim.metadata.namespaced_name
                ]
                if len(info.pods) != before:
                    info.requested = info.requested.subtract_non_negative(
                        self.calculator.compute_pod_request(victim)
                    )
                break
