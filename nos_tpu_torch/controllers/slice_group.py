"""Port of `nos_tpu/controllers/slice_group.py:1` (:1-866): `GroupPartitioner`
(:38), `HostAgent` (:740). Copied verbatim; only the imports point at the
port, which imports nothing of the JAX package.

Multi-host podslice controllers: group partitioner + host agent.

The multi-host analogs of the partitioner controller and node agent
(partitioner_controller.go:81-232, migagent actuator/reporter): the
GroupPartitioner watches gang pods that cannot schedule, derives sub-slice
demand per *gang* (one 4x8 sub-slice per 8-pod gang — not one per pod),
plans host-block assignments through SliceGroup, and writes per-host spec
annotations. The HostAgent acknowledges its host's assignment by mirroring
spec -> status and flipping the scheduling labels. Re-planning a group is
gated on EVERY member host having reported the current plan — the
slice-level barrier a per-node handshake cannot provide (SURVEY.md §7).
"""

from __future__ import annotations

import logging
import threading
import time as _time
import uuid
from typing import Dict, List, Optional, Tuple

from nos_tpu_torch import constants
from nos_tpu_torch.api.objects import Node, Pod, PodPhase
from nos_tpu_torch.cluster.client import Cluster, Event, EventType, NotFoundError
from nos_tpu_torch.tpu import Profile
from nos_tpu_torch.tpu.slice_group import SliceGroup, SubSlice, chip_to_host_block
from nos_tpu_torch.util import pod as podutil
from nos_tpu_torch.util.batcher import Batcher

logger = logging.getLogger(__name__)


gang_of = podutil.gang_of
gang_size_of = podutil.gang_size_of
wanted_subslice_topology = podutil.wanted_subslice_topology


class GroupPartitioner:
    """Carves multi-host slice groups toward pending gang demand."""

    def __init__(
        self,
        cluster: Cluster,
        batch_timeout_s: float = constants.DEFAULT_BATCH_WINDOW_TIMEOUT_S,
        batch_idle_s: float = constants.DEFAULT_BATCH_WINDOW_IDLE_S,
        resync_s: float = constants.DEFAULT_PARTITIONER_RESYNC_S,
        unit_key=None,
        defrag_budget: int = 0,
        defrag_after_s: float = 120.0,
        migration_hold_s: float = 120.0,
        defrag_min_gain_s: float = 60.0,
        defrag_victim_cooldown_s: float = 300.0,
        defrag_victim_budget: int = 3,
        defrag_victim_window_s: float = 3600.0,
        now=None,
    ):
        self.cluster = cluster
        # The scheduler's unit-rank function (Scheduler._unit_key). Carve
        # demand MUST rank gangs exactly as the scheduler's queue does —
        # under a non-FIFO queue policy (aged-swf), a hardcoded
        # (-priority, creation) order here carves for a gang the scheduler
        # ranks below its reservation holder: the holder can't bind (wrong
        # carve), the carved-for gang is reservation-gated, no write ever
        # lands, and both version gates freeze the deadlock in place.
        self._unit_key = unit_key
        self._now = now if now is not None else _time.monotonic
        # Wall clock for pending-age math (pod creation timestamps are
        # epoch-based on the wire); the injected simulation clock drives
        # both timelines at once.
        self._wall = now if now is not None else _time.time
        kwargs = {"now": now} if now is not None else {}
        self.batcher: Batcher[Pod] = Batcher(batch_timeout_s, batch_idle_s, **kwargs)
        self.resync_s = resync_s
        # Defragmentation (sub-slice migration): after the normal carve pass
        # leaves a gang's demand unplaced, up to `defrag_budget` whole-gang
        # migrations per cycle may relocate a small ALL-checkpointable
        # running gang (evict-and-resume) into a pre-carved destination
        # block so its freed block coalesces a window for the stranded
        # gang. Gated on the stranded gang's age (`defrag_after_s`), the
        # mover's remaining natural runtime (`defrag_min_gain_s` — an
        # almost-done mover frees its block cheaper by finishing), and the
        # same churn-ledger discipline as checkpoint drains. 0 disables.
        self.defrag_budget = defrag_budget
        self.defrag_after_s = defrag_after_s
        self.migration_hold_s = migration_hold_s
        self.defrag_min_gain_s = defrag_min_gain_s
        # Cost-model gates (see _defrag_pass): minimum stranded-gang size as
        # a fraction of the group mesh, and an optional natural-drain ETA
        # check — skip the move when an aligned window clears by itself
        # within the horizon. The ETA gate defaults OFF: on the judged
        # combined-levers traces it also vetoed moves whose "imminent"
        # natural window was then consumed by queue competition, forgoing
        # measured gains (seed 0: +1.7 busy pts with the gate off).
        # Operators who value minimum churn over utilization can arm it.
        self.defrag_size_divisor = 8
        self.defrag_eta_gate = False
        self.defrag_eta_horizon_s = 20.0
        from nos_tpu_torch.util.churn import ChurnLedger

        self._churn = ChurnLedger(
            defrag_victim_cooldown_s,
            defrag_victim_budget,
            defrag_victim_window_s,
        )
        # In-flight migration destinations AND the pending carves they
        # unblock: sub-slice id -> (reservation expiry, the gang whose
        # capacity the carve reserves). While held, the sub-slice reads as
        # pinned to replans (no drop, no double-claim) and the gang's demand
        # reads as satisfied (no duplicate carve) until a workload binds
        # onto it or the hold lapses.
        self._migration_holds: Dict[str, Tuple[float, str]] = {}
        # Per-stranded-gang attempt pacing: gang key -> last migration time.
        # A freed window takes a few control rounds to ack + bind; without
        # this gate the pass re-migrates a fresh mover for the same gang
        # every cycle while the first window is still in flight.
        self._defrag_attempts: Dict[str, float] = {}
        # Global pacing (the scheduler's _last_ckpt_drain_at analog): at
        # most one migration per defrag_min_gain_s across ALL gangs.
        # Per-gang pacing alone lets a deep backlog sustain one migration
        # per batch window — an eviction storm wearing a defrag label.
        self._last_defrag_at: Optional[float] = None
        self._last_cycle_at = self._now()
        self._version_at_last_cycle: Optional[int] = None
        self._unsub = None
        self._stop = threading.Event()

    # -- watch wiring --------------------------------------------------------
    def start_watching(self) -> None:
        def on_pod(ev: Event) -> None:
            if ev.type == EventType.DELETED:
                return
            pod = ev.obj
            if wanted_subslice_topology(pod) is None:
                return
            if not podutil.extra_resources_could_help_scheduling(pod):
                return
            self.batcher.add(pod)

        self._unsub = self.cluster.watch("Pod", on_pod)

    def stop(self) -> None:
        self._stop.set()
        if self._unsub:
            self._unsub()

    # -- group views ---------------------------------------------------------
    def member_nodes(self) -> Dict[str, List[Node]]:
        groups: Dict[str, List[Node]] = {}
        for node in self.cluster.list(
            "Node",
            label_selector={
                constants.LABEL_PARTITIONING: constants.KIND_TPU_MULTIHOST
            },
        ):
            slice_id = node.metadata.labels.get(constants.LABEL_TPU_SLICE)
            if slice_id:
                groups.setdefault(slice_id, []).append(node)
        return groups

    def _pods_snapshot(self):
        """ONE pod list per cycle feeds both demand derivation and the
        active-node set (each extra list deep-copies every pod)."""
        return self.cluster.list("Pod")

    # -- demand --------------------------------------------------------------
    def pending_gang_demand(self, pods: Optional[List[Pod]] = None) -> List[dict]:
        """Sub-slice demand per COMPLETE pending gang (a gang is one
        workload, not N pods). A plain gang needs one sub-slice anywhere; a
        multislice gang needs `multislice-count` sub-slices SPREAD over
        distinct slice groups (at most one per group — DCN connects slices,
        not sub-slices within one)."""
        if pods is None:
            pods = self._pods_snapshot()
        gangs: Dict[str, List[Pod]] = {}
        for pod in pods:
            if not podutil.extra_resources_could_help_scheduling(pod):
                continue
            profile = wanted_subslice_topology(pod)
            gang = gang_of(pod)
            if profile is None or gang is None:
                continue
            gangs.setdefault(gang, []).append(pod)
        items: List[dict] = []
        # Carve in the SCHEDULER'S bind order (priority desc, oldest first) —
        # not name order: if the carve choice disagrees with bind order, the
        # planner can cover the grid with a lower-priority gang's sub-slice
        # that the scheduler will never bind first, deadlocking the queue
        # behind a backfill reservation.
        def _order(entry):
            # EXACTLY the scheduler's unit key (Scheduler._unit_key, injected
            # at wiring time so a queue-policy change cannot desynchronize
            # the two rankings). Fallback: the FIFO tuple — min over per-pod
            # (-priority, creation, name), i.e. the best member's tuple.
            _, pods = entry
            if self._unit_key is not None:
                return self._unit_key(pods)
            return min(
                (
                    -p.spec.priority,
                    p.metadata.creation_timestamp,
                    p.metadata.namespaced_name,
                )
                for p in pods
            )

        for gang, pods in sorted(gangs.items(), key=_order):
            size = gang_size_of(pods[0])
            if len(pods) < size:
                continue  # incomplete gang: wait for all members
            count = podutil.multislice_count(pods[0])
            items.append(
                {
                    "gang": gang,
                    "profile": wanted_subslice_topology(pods[0]),
                    "remaining": count,
                    "spread": count > 1,
                    "pods": pods,
                }
            )
        return items

    @staticmethod
    def _group_demand(items: List[dict]) -> Dict[Profile, int]:
        """What THIS group may carve: spread gangs contribute at most one
        sub-slice per group."""
        demand: Dict[Profile, int] = {}
        for item in items:
            if item["remaining"] <= 0:
                continue
            take = 1 if item["spread"] else item["remaining"]
            demand[item["profile"]] = demand.get(item["profile"], 0) + take
        return demand

    @staticmethod
    def _absorb(items: List[dict], carved: Dict[Profile, int]) -> None:
        """Account newly carved sub-slices against demand: spread gangs take
        at most one each (per group), plain gangs absorb the rest."""
        for profile, k in carved.items():
            for item in items:
                if k <= 0:
                    break
                if item["profile"] == profile and item["spread"] and item["remaining"] > 0:
                    item["remaining"] -= 1
                    k -= 1
            for item in items:
                if k <= 0:
                    break
                if item["profile"] == profile and not item["spread"]:
                    took = min(k, item["remaining"])
                    item["remaining"] -= took
                    k -= took

    # -- the planning cycle --------------------------------------------------
    def process_batch_if_ready(self) -> bool:
        ready = bool(self.batcher.drain_if_ready())
        if not ready:
            if not self._resync_due():
                return False
            # Resync retries transient refusals (host-report lag, in-use
            # pins) — each resolves via some write. Unchanged store version
            # since the last cycle means the replan is a guaranteed no-op —
            # UNLESS migration holds are live: they lapse purely by TIME,
            # and capacity they pin un-pins without any store write
            # (skipping here once froze a fully-pending cluster forever:
            # the last cycle refused to carve while stale holds pinned the
            # grid, and no write ever re-triggered it). Kept narrow — an
            # unconditional bypass while defrag is merely ARMED re-plans on
            # every resync and measurably perturbs plan-id churn.
            if (
                self.cluster.version == self._version_at_last_cycle
                and not self._migration_holds
            ):
                self._last_cycle_at = self._now()
                return False
        self._version_at_last_cycle = self.cluster.version
        pods = self._pods_snapshot()
        items = self.pending_gang_demand(pods)
        groups = self.member_nodes()
        # A multislice gang needing more slice groups than exist can never
        # bind; carving for it would tie up hosts the scheduler will not use.
        for item in list(items):
            if item["spread"] and item["remaining"] > len(groups):
                logger.info(
                    "group partitioner: gang %s needs %d slice groups, only "
                    "%d exist — skipping",
                    item["gang"],
                    item["remaining"],
                    len(groups),
                )
                items.remove(item)
        if not items:
            self._last_cycle_at = self._now()
            return False
        plan_id = f"{int(self._now())}-{uuid.uuid4().hex[:8]}"
        planned_any = False
        active = {
            p.spec.node_name for p in pods if podutil.is_active(p) and p.spec.node_name
        }
        # In-flight migration holds: lapse expired ones, retire ones whose
        # mover rebound (an active pod landed on a destination host), and
        # pin the still-held destinations — a replan must treat a reserved
        # sub-slice exactly like an in-use one (no drop, no double-claim).
        reserved_hosts = self._reserved_hosts(groups, pods)

        def node_has_workload(name: str) -> bool:
            return name in active or name in reserved_hosts

        # Demand covered by a surviving hold is already capacitized: the
        # reserved carve exists for exactly that gang (the mover's dest, or
        # the stranded gang's freed window), so carving again would
        # double-claim the grid for one workload — the group-path analog of
        # the single-host snapshot's reserved_pod_keys.
        held_gangs = {gang for _, gang in self._migration_holds.values()}
        if held_gangs:
            for item in items:
                if item["gang"] in held_gangs:
                    item["remaining"] = 0

        for slice_id, nodes in sorted(groups.items()):
            demand = self._group_demand(items)
            if not demand:
                break
            try:
                group = SliceGroup.from_nodes(slice_id, nodes)
            except ValueError:
                # One mislabeled group must not take down planning for the
                # rest of the cluster.
                logger.exception(
                    "group partitioner: slice %s has invalid member labels",
                    slice_id,
                )
                continue
            if not group.all_reported():
                logger.info(
                    "group partitioner: slice %s waiting on host reports", slice_id
                )
                continue
            desired = group.plan_subslices(demand, node_has_workload)
            if desired is None:
                continue
            current = group.current_subslices(node_has_workload)
            current_ids = {s.id for s in current}
            if {s.id for s in desired} == current_ids:
                # No patch needed — but demand this group's existing FREE
                # carves already satisfy must not be re-counted against later
                # groups (they would carve duplicates for the same gangs):
                # absorb them exactly as if they were newly carved.
                satisfied: Dict[Profile, int] = {}
                for s in current:
                    if not s.in_use and s.profile in demand:
                        satisfied[s.profile] = satisfied.get(s.profile, 0) + 1
                if satisfied:
                    self._absorb(items, satisfied)
                continue
            self._actuate(group, desired, plan_id)
            planned_any = True
            # Satisfied demand is satisfied once; don't double-carve on the
            # next group (spread gangs take at most one per group).
            carved: Dict[Profile, int] = {}
            for s in desired:
                if s.id not in current_ids:
                    carved[s.profile] = carved.get(s.profile, 0) + 1
            self._absorb(items, carved)
        if self.defrag_budget > 0 and any(i["remaining"] > 0 for i in items):
            if self._defrag_pass(items, pods, node_has_workload, plan_id):
                planned_any = True
        self._last_cycle_at = self._now()
        return planned_any

    # -- defragmentation (whole-gang sub-slice migration) --------------------
    def _reserved_hosts(
        self, groups: Dict[str, List[Node]], pods: List[Pod]
    ) -> set:
        """Hosts of in-flight migration DESTINATIONS (and the pending carves
        they unblock). Retires holds as a side effect: a hold lapses at
        expiry (lost mover), when its sub-slice left every spec annotation
        (a later plan superseded it), or when ITS OWN gang landed on a hold
        host — from then on the workload itself pins the sub-slice. The
        gang check is deliberate: retiring on just ANY active pod let an
        alien bind (via a source host's stale label) dissolve the hold and
        hand the reserved window back to the replanner. Survivors read as
        workload-bearing to this cycle's planning, so a concurrent replan
        can neither drop the reserved carve nor count it free for other
        demand — the no-double-claim half of the move protocol."""
        if not self._migration_holds:
            return set()
        now = self._wall()
        hosts_by_id: Dict[str, set] = {}
        for nodes in groups.values():
            for node in nodes:
                sid = node.metadata.annotations.get(
                    constants.ANNOTATION_SPEC_SUBSLICE_ID
                )
                if sid in self._migration_holds:
                    hosts_by_id.setdefault(sid, set()).add(node.metadata.name)
        gangs_by_host: Dict[str, set] = {}
        for p in pods:
            if podutil.is_active(p) and p.spec.node_name:
                gangs_by_host.setdefault(p.spec.node_name, set()).add(
                    gang_of(p)
                )
        reserved: set = set()
        for sid, (expires_at, gang) in list(self._migration_holds.items()):
            hosts = hosts_by_id.get(sid, set())
            landed = any(gang in gangs_by_host.get(h, ()) for h in hosts)
            if now >= expires_at or not hosts or landed:
                del self._migration_holds[sid]
                continue
            reserved |= hosts
        return reserved

    def _defrag_pass(
        self,
        items: List[dict],
        pods: List[Pod],
        node_has_workload,
        plan_id: str,
    ) -> bool:
        """Slice migration for stranded gangs: when the carve pass left a
        gang's demand unplaced on every group, relocate ONE small running
        gang per migration (whole gang — never a member alone) into a
        pre-carved destination block so its freed block coalesces a window
        for the stranded gang. Ordered move protocol: the destination carve
        lands in the same spec write that re-targets the source hosts, the
        host agents refuse to drop the in-use source until the drain below
        empties it, and the destination is held against concurrent replans
        until the mover rebinds. Cost model: at most `defrag_budget` moves
        per cycle, checkpointable movers only (evict-and-resume), smallest
        footprint first (SliceGroup.plan_defrag), aged stranded gangs only,
        churn-ledger pacing per mover gang."""
        now = self._wall()
        if (
            self._last_defrag_at is not None
            and now - self._last_defrag_at < self.defrag_min_gain_s
        ):
            return False  # global pacing: one move per gain window, fleet-wide
        budget = self.defrag_budget
        # Who runs where (one pass over the cycle's pod list): host ->
        # active gang pods. Non-gang pods on a host disqualify it as a
        # mover, so they're recorded under gang None.
        by_host: Dict[str, List[Pod]] = {}
        for p in pods:
            if podutil.is_active(p) and p.spec.node_name:
                by_host.setdefault(p.spec.node_name, []).append(p)
        moved = False
        # BIND-ORDER discipline (the same rule the carve pass follows):
        # only the scheduler's top-ranked unplaced gang is a defrag
        # candidate — `items` is already sorted by the scheduler's unit
        # key, so the first unplaced item IS the queue head. A window
        # freed for a lower-ranked gang parks behind the scheduler's
        # reservation/admission protection of the units above it —
        # measured: the mover rebound in 1s while the rescued gang sat
        # queued for 120s+, the reserved carve idling the whole time.
        head = [item for item in items if item["remaining"] > 0][:1]
        for item in head:
            if budget <= 0:
                break
            age = now - min(
                p.metadata.creation_timestamp for p in item["pods"]
            )
            if age < self.defrag_after_s:
                break
            last_attempt = self._defrag_attempts.get(item["gang"])
            if (
                last_attempt is not None
                and now - last_attempt < self.defrag_min_gain_s
            ):
                continue  # a freed window for this gang is still in flight
            # Re-list AFTER the carve pass's actuation: plan_defrag must see
            # the spec annotations this cycle already wrote.
            for slice_id, nodes in sorted(self.member_nodes().items()):
                try:
                    group = SliceGroup.from_nodes(slice_id, nodes)
                except ValueError:
                    continue
                if not group.all_reported():
                    continue
                # Size gate: only gangs at least 1/defrag_size_divisor of
                # the group mesh are defrag candidates. Small gangs are
                # never indefinitely fragmentation-blocked — routine
                # completions open small windows constantly, so migrating
                # for them trades a near-term natural bind for guaranteed
                # drain churn (measured on the combined-levers trace, seed
                # 2: ten micro-migrations at 88-95% packed cost 2.6 busy
                # points).
                if (
                    item["profile"].chips * self.defrag_size_divisor
                    < group.topology.chips
                ):
                    continue
                # Fragmentation-blocked gate: migration is the DEFRAG lever,
                # not a preemption lever. It may fire only when the group's
                # free capacity already fits the stranded demand and the
                # blocker is contiguity alone — on a capacity-packed mesh a
                # move just idles the mover's chips for a drain/rebind round
                # trip (measured: window utilization 0.99 -> 0.93 without
                # this gate).
                block = chip_to_host_block(item["profile"], group.host_shape)
                if block is None:
                    continue
                needed_hosts = 1
                for d in block.dims:
                    needed_hosts *= d
                free_hosts = sum(
                    1
                    for h in group.hosts.values()
                    if not node_has_workload(h.node_name)
                )
                if free_hosts < needed_hosts:
                    continue
                # Natural-drain gate (the cost model's other half): when an
                # aligned window for the stranded demand clears by itself
                # within the gain horizon — every blocking occupant's
                # stamped end is imminent — a migration buys almost nothing
                # and still pays a full drain/rebind round trip (measured
                # on seed 0: two migrations against blockers with <60s
                # left delivered zero extra chip-seconds while stretching
                # the backlog window).
                if self.defrag_eta_gate:
                    eta = self._natural_window_eta(
                        group, item["profile"], node_has_workload, by_host, now
                    )
                    if eta is not None and eta - now <= self.defrag_eta_horizon_s:
                        continue

                group_chips = group.topology.chips

                def movable(ss: SubSlice) -> bool:
                    return self._movable_subslice(
                        ss, item, by_host, now, group_chips
                    )

                got = group.plan_defrag(
                    item["profile"], node_has_workload, movable
                )
                if got is None:
                    continue
                desired, mover, dest_ss, pending_ss = got
                mover_pods = [
                    p for h in mover.hosts for p in by_host.get(h, [])
                ]
                gang_key = gang_of(mover_pods[0])
                logger.info(
                    "group defrag: migrating gang %s (%s, %s) to %s so %s "
                    "can host stranded gang %s (%s)",
                    gang_key,
                    mover.profile.name,
                    mover.id,
                    dest_ss.id,
                    pending_ss.id,
                    item["gang"],
                    item["profile"].name,
                )
                # Create-destination first: the spec write carries the dest
                # carve; the source hosts' agents refuse the re-target until
                # the drain empties them (delete-source last).
                self._actuate(group, desired, plan_id)
                expiry = now + self.migration_hold_s
                self._migration_holds[dest_ss.id] = (expiry, gang_key)
                # The pending carve is reserved too: a replan racing the
                # stranded gang's bind must not drop or re-purpose the very
                # window the migration just paid for.
                self._migration_holds[pending_ss.id] = (expiry, item["gang"])
                self._defrag_attempts[item["gang"]] = now
                self._last_defrag_at = now
                if len(self._defrag_attempts) > 4096:
                    self._defrag_attempts = {
                        k: t
                        for k, t in self._defrag_attempts.items()
                        if now - t < self.defrag_min_gain_s
                    }
                self._churn.note(gang_key, now)
                for p in mover_pods:
                    try:
                        self.cluster.delete(
                            "Pod", p.metadata.namespace, p.metadata.name
                        )
                    except NotFoundError:
                        pass
                from nos_tpu_torch.observability import metrics

                metrics.inc(
                    "nos_tpu_slice_migrations",
                    kind=constants.KIND_TPU_MULTIHOST,
                )
                budget -= 1
                item["remaining"] -= 1
                moved = True
                break
        return moved

    def _natural_window_eta(
        self,
        group: SliceGroup,
        profile: Profile,
        node_has_workload,
        by_host: Dict[str, List[Pod]],
        now: float,
    ) -> Optional[float]:
        """Earliest time an ALIGNED host window for `profile` opens with no
        migration: for every aligned placement of every legal orientation,
        the window clears when the last overlapping in-use sub-slice's
        occupants hit their stamped expected end (free sub-slices clear
        instantly — they are droppable). A reserved (podless-but-held) or
        unstamped blocker never clears. Returns the minimum over
        placements, or None when no placement naturally clears — the case
        migration exists for."""
        block = chip_to_host_block(profile, group.host_shape)
        if block is None:
            return None
        allowed = group._allowed_block_dims(profile)
        current = group.current_subslices(node_has_workload)
        etas = []
        for s in current:
            if not s.in_use:
                eta = now
            else:
                occupants = [p for h in s.hosts for p in by_host.get(h, [])]
                end = (
                    podutil.latest_expected_end(occupants, now)
                    if occupants
                    else None  # held reservation: never clears on its own
                )
                eta = end  # None = unknown/never
            etas.append((s.host_origin, s.host_dims, eta))
        grid = group.host_grid.dims
        best: Optional[float] = None
        for dims in allowed:
            if any(w > g for w, g in zip(dims, grid)):
                continue
            anchors = [range(0, g - w + 1, w) for g, w in zip(grid, dims)]
            stack = [()]
            for axis in anchors:
                stack = [o + (a,) for o in stack for a in axis]
            for origin in stack:
                eta = now
                for s_origin, s_dims, s_eta in etas:
                    if all(
                        so < o + d and o < so + sd
                        for so, sd, o, d in zip(s_origin, s_dims, origin, dims)
                    ):
                        if s_eta is None:
                            eta = None
                            break
                        eta = max(eta, s_eta)
                if eta is not None and (best is None or eta < best):
                    best = eta
        return best

    def _movable_subslice(
        self,
        subslice: SubSlice,
        item: dict,
        by_host: Dict[str, List[Pod]],
        now: float,
        group_chips: int,
    ) -> bool:
        """Migration movers must hold exactly ONE complete running gang that
        is strictly smaller than the stranded demand (the cost model never
        swaps equals) AND small in absolute terms — at most 1/8 of the
        group mesh: a migration's cost is the mover's drain/rebind gap
        times its chip count, so big movers pay more than the coalesced
        window returns. Movers must also be ALL-checkpointable (the drain
        is evict-and-resume, never lost work), single-slice (migrating one
        sub-slice of a multislice gang tears its DCN mesh mid-gang), not
        outranking the gang they unblock, not about to free their block
        naturally, and within the churn ledger's eviction pacing."""
        if subslice.profile.chips >= item["profile"].chips:
            return False
        if subslice.profile.chips * 8 > group_chips:
            return False
        occupants = [p for h in subslice.hosts for p in by_host.get(h, [])]
        if not occupants:
            return False  # a held (reserved) destination: pinned, podless
        gangs = {gang_of(p) for p in occupants}
        if len(gangs) != 1 or None in gangs:
            return False
        if len(occupants) < gang_size_of(occupants[0]):
            return False  # partial view of the gang: never tear it mid-gang
        if podutil.multislice_count(occupants[0]) > 1:
            return False
        if not all(podutil.is_checkpointable(p) for p in occupants):
            return False
        stranded_prio = max(p.spec.priority for p in item["pods"])
        if any(p.spec.priority > stranded_prio for p in occupants):
            return False
        end = podutil.latest_expected_end(occupants, now)
        if end is not None and end - now <= self.defrag_min_gain_s:
            return False  # finishing anyway: the move buys less than it costs
        gang_key = gangs.pop()
        return self._churn.eligible_at(gang_key, now) <= now

    def _resync_due(self) -> bool:
        if self.resync_s <= 0:
            return False
        return (self._now() - self._last_cycle_at) >= self.resync_s

    # -- actuation -----------------------------------------------------------
    def _actuate(
        self, group: SliceGroup, subslices: List[SubSlice], plan_id: str
    ) -> None:
        assignment = group.assignment(subslices)
        for node_name, subslice in assignment.items():
            def mutate(node: Node, subslice=subslice) -> None:
                ann = node.metadata.annotations
                if subslice is None:
                    ann.pop(constants.ANNOTATION_SPEC_SUBSLICE_ID, None)
                    ann.pop(constants.ANNOTATION_SPEC_SUBSLICE_TOPOLOGY, None)
                    ann.pop(constants.ANNOTATION_SPEC_SUBSLICE_ORIGIN, None)
                else:
                    ann[constants.ANNOTATION_SPEC_SUBSLICE_ID] = subslice.id
                    ann[constants.ANNOTATION_SPEC_SUBSLICE_TOPOLOGY] = (
                        subslice.profile.name
                    )
                    ann[constants.ANNOTATION_SPEC_SUBSLICE_ORIGIN] = ",".join(
                        str(o * h)
                        for o, h in zip(
                            subslice.host_origin, group.host_shape.dims
                        )
                    )
                ann[constants.ANNOTATION_SPEC_PLAN] = plan_id

            try:
                self.cluster.patch("Node", "", node_name, mutate)
            except NotFoundError:
                continue
        logger.info(
            "group partitioner: slice %s plan %s -> %d sub-slices",
            group.slice_id,
            plan_id,
            len(subslices),
        )

    def run(self, poll_s: float = 0.5) -> None:
        while not self._stop.is_set():
            self.process_batch_if_ready()
            self._stop.wait(poll_s)


class HostAgent:
    """Per-host acknowledger: mirrors the spec sub-slice assignment into
    status annotations + scheduling labels. The real-device analog would also
    (re)initialize the local TPU runtime for the new ICI neighbor set; the
    fake path models that as instantaneous."""

    def __init__(self, cluster: Cluster, node_name: str):
        self.cluster = cluster
        self.node_name = node_name
        self._unsub = None

    def start_watching(self) -> None:
        def on_node(ev: Event) -> None:
            if ev.type == EventType.DELETED or ev.obj.metadata.name != self.node_name:
                return
            spec_keys = (
                constants.ANNOTATION_SPEC_SUBSLICE_ID,
                constants.ANNOTATION_SPEC_SUBSLICE_TOPOLOGY,
                constants.ANNOTATION_SPEC_PLAN,
            )
            new = {k: ev.obj.metadata.annotations.get(k) for k in spec_keys}
            old = (
                {k: ev.old_obj.metadata.annotations.get(k) for k in spec_keys}
                if ev.old_obj is not None
                else None
            )
            if new != old:
                self.reconcile()

        self._unsub = self.cluster.watch("Node", on_node, replay=False)

    def stop(self) -> None:
        if self._unsub:
            self._unsub()

    def reconcile(self) -> None:
        node = self.cluster.try_get("Node", "", self.node_name)
        if node is None:
            return
        ann = node.metadata.annotations
        spec_id = ann.get(constants.ANNOTATION_SPEC_SUBSLICE_ID)
        spec_topo = ann.get(constants.ANNOTATION_SPEC_SUBSLICE_TOPOLOGY)
        spec_plan = ann.get(constants.ANNOTATION_SPEC_PLAN)

        # Never tear a sub-slice out from under a running workload: refuse to
        # ack an UNASSIGNMENT (or re-assignment) while a pod on this host is
        # still active. The group planner keeps in-use sub-slices pinned, so
        # this only triggers on planner/agent races.
        current_id = node.metadata.labels.get(constants.LABEL_TPU_SUBSLICE_ID)
        if current_id and spec_id != current_id and self._has_active_pod():
            logger.warning(
                "host agent %s: refusing to drop in-use sub-slice %s",
                self.node_name,
                current_id,
            )
            # A re-target while a workload is live is a DRAIN IN FLIGHT
            # (the planner pins in-use sub-slices; only the migration
            # protocol re-targets an occupied host). Close the bind window
            # immediately: with the topology label still up, the scheduler
            # can match a NEW gang onto this host's stale identity mid-
            # drain, planting a fresh pod inside the window the migration
            # is assembling (measured: an alien 2x2 bind re-fragmented a
            # freed 8x8 and re-stranded its gang). The id label stays for
            # the running workload; the ack path rebuilds both labels.
            if (
                node.metadata.labels.get(constants.LABEL_TPU_SUBSLICE_TOPOLOGY)
                is not None
            ):
                def close_window(n: Node) -> None:
                    n.metadata.labels.pop(
                        constants.LABEL_TPU_SUBSLICE_TOPOLOGY, None
                    )

                try:
                    self.cluster.patch("Node", "", self.node_name, close_window)
                except NotFoundError:
                    pass
            return

        # No-op guard: reconcile also runs periodically (to retry a refused
        # ack once the blocking workload completes), so a patch must only
        # happen when something actually changes.
        unchanged = (
            ann.get(constants.ANNOTATION_STATUS_SUBSLICE_ID) == spec_id
            and ann.get(constants.ANNOTATION_STATUS_SUBSLICE_TOPOLOGY)
            == (spec_topo if spec_id else None)
            and node.metadata.labels.get(constants.LABEL_TPU_SUBSLICE_ID) == spec_id
            and (spec_plan is None or ann.get(constants.ANNOTATION_STATUS_PLAN) == spec_plan)
        )
        if unchanged:
            return

        def mutate(n: Node) -> None:
            a = n.metadata.annotations
            if spec_id:
                a[constants.ANNOTATION_STATUS_SUBSLICE_ID] = spec_id
                a[constants.ANNOTATION_STATUS_SUBSLICE_TOPOLOGY] = spec_topo or ""
                n.metadata.labels[constants.LABEL_TPU_SUBSLICE_ID] = spec_id
                n.metadata.labels[constants.LABEL_TPU_SUBSLICE_TOPOLOGY] = (
                    spec_topo or ""
                )
            else:
                a.pop(constants.ANNOTATION_STATUS_SUBSLICE_ID, None)
                a.pop(constants.ANNOTATION_STATUS_SUBSLICE_TOPOLOGY, None)
                n.metadata.labels.pop(constants.LABEL_TPU_SUBSLICE_ID, None)
                n.metadata.labels.pop(constants.LABEL_TPU_SUBSLICE_TOPOLOGY, None)
            if spec_plan is not None:
                a[constants.ANNOTATION_STATUS_PLAN] = spec_plan

        try:
            self.cluster.patch("Node", "", self.node_name, mutate)
        except NotFoundError:
            return

    def _has_active_pod(self) -> bool:
        return any(
            True
            for _ in self.cluster.list(
                "Pod",
                predicate=lambda p: (
                    p.spec.node_name == self.node_name and podutil.is_active(p)
                ),
            )
        )

    def startup(self) -> None:
        self.reconcile()
